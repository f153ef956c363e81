from graphembedding_tpu_torch.train.skipgram import (
    SkipGramConfig,
    SkipGramTrainer,
)

__all__ = ["SkipGramConfig", "SkipGramTrainer"]

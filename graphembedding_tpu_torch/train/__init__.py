from graphembedding_tpu_torch.train.dense import (
    DenseSGNSConfig,
    DenseSGNSTrainer,
)
from graphembedding_tpu_torch.train.skipgram import (
    SkipGramConfig,
    SkipGramTrainer,
)

__all__ = ["DenseSGNSConfig", "DenseSGNSTrainer", "SkipGramConfig",
           "SkipGramTrainer"]

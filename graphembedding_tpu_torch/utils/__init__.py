from graphembedding_tpu_torch.utils.vocab import IdentityVocab, Vocab

__all__ = ["Vocab", "IdentityVocab"]

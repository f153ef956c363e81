from graphembedding_tpu_torch.data.datasets import (
    Dataset,
    load_dataset,
    synthetic_wiki,
    synthetic_wiki_hard,
)

__all__ = ["Dataset", "load_dataset", "synthetic_wiki", "synthetic_wiki_hard"]

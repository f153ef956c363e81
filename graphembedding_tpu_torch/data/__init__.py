from graphembedding_tpu_torch.data.datasets import (
    Dataset,
    load_dataset,
    synthetic_blogcatalog,
    synthetic_flight,
    synthetic_flight_hard,
    synthetic_wiki,
    synthetic_wiki_hard,
)

__all__ = ["Dataset", "load_dataset", "synthetic_blogcatalog",
           "synthetic_flight", "synthetic_flight_hard", "synthetic_wiki",
           "synthetic_wiki_hard"]

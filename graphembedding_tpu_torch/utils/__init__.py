from graphembedding_tpu_torch.utils.debug import (
    checked,
    debug_guard,
    validate_graph,
    validate_walks,
)
from graphembedding_tpu_torch.utils.io import (
    load_npz,
    load_word2vec_format,
    save_npz,
    save_word2vec_format,
)
from graphembedding_tpu_torch.utils.simquery import (
    most_similar,
    similarity,
)
from graphembedding_tpu_torch.utils.vocab import (
    IdentityVocab,
    Vocab,
    partition_dict,
    partition_list,
    partition_num,
    preprocess_nxgraph,
)

__all__ = [
    "Vocab",
    "IdentityVocab",
    "most_similar",
    "similarity",
    "save_word2vec_format",
    "load_word2vec_format",
    "save_npz",
    "load_npz",
    "preprocess_nxgraph",
    "partition_dict",
    "partition_list",
    "partition_num",
    "validate_graph",
    "validate_walks",
    "checked",
    "debug_guard",
]

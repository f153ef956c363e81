from graphembedding_tpu_torch.eval.classify import Classifier, read_node_label

__all__ = ["Classifier", "read_node_label"]

"""The benchmark of graphembedding_tpu_torch on an NVIDIA H100: whole
DeepWalk and Node2Vec fits (see `harness.py`, `BENCHMARK.json`)."""

"""The benchmark of graphembedding_tpu_torch on an NVIDIA H100: whole
fits of the port's models, one module a model family in `models/` (see
`harness.py`, `BENCHMARK.json`)."""

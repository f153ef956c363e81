"""Microbenchmarks of the port's row kernels and sparse products on a CUDA
card.

Ports of the JAX package's `benchmarks/dma_gather.py` and
`benchmarks/pallas_scatter_bench.py`; `spmm_bench` times SDNE's sparse
products against cuSPARSE; `train_profile` breaks warm trains down by
kernel. Each needs a card and exits non-zero
without one; each prints one JSON line a measurement, with the card's
name and power limit.
"""

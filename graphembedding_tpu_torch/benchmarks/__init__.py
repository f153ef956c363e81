"""Microbenchmarks of the port's row kernels on a CUDA card.

Ports of the JAX package's `benchmarks/dma_gather.py` and
`benchmarks/pallas_scatter_bench.py`. Each needs a card and exits non-zero
without one; each prints one JSON line a measurement, with the card's
name and power limit.
"""

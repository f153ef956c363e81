"""Port's uniform walks: the conventions of tests/test_walks.py.

The port draws from a torch.Generator, so its walks match the JAX
package's in distribution, not in values.
"""

import numpy as np
import torch

from graphembedding_tpu.graph import Graph as JaxGraph
from graphembedding_tpu_torch.graph import Graph
from graphembedding_tpu_torch.ops.walk import simulate_walks, uniform_walks


def star_graph(k=5):
    return Graph(np.zeros(k, dtype=int), np.arange(1, k + 1), directed=False)


def triangle_with_tail():
    return Graph(np.array([0, 1, 2, 2]), np.array([1, 2, 0, 3]),
                 directed=False)


def walk(g, starts, length, seed, device="cpu"):
    dg = g.to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return uniform_walks(dg.row_ptr, dg.col_idx, dg.degree,
                         torch.as_tensor(starts, device=device),
                         length=length, generator=gen).cpu().numpy()


def test_csr_equals_jax_graph():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    w = rng.random(300).astype(np.float32)
    for directed in (True, False):
        a = Graph(src, dst, w, num_nodes=55, directed=directed)
        b = JaxGraph(src, dst, w, num_nodes=55, directed=directed)
        for name in ("row_ptr", "col_idx", "edge_weight", "degree"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name))
        assert a.max_degree == b.max_degree


def test_uniform_walks_shape_and_validity():
    walks = walk(star_graph(), np.zeros(64, dtype=np.int64), 8, seed=0)
    assert walks.shape == (64, 8) and walks.dtype == np.int32
    assert np.all(walks[:, 0] == 0)
    # star: the walk alternates hub <-> leaf
    assert np.all(walks[:, 1] >= 1)
    assert np.all(walks[:, 2] == 0)


def test_uniform_walks_dead_end():
    # directed path 0 -> 1 -> 2 stops at 2; node 2 has row_ptr == E
    g = Graph(np.array([0, 1]), np.array([1, 2]), num_nodes=3,
              directed=True)
    walks = walk(g, np.zeros(8, dtype=np.int64), 6, seed=1)
    np.testing.assert_array_equal(walks[0], [0, 1, 2, -1, -1, -1])


def test_uniform_transition_distribution():
    walks = walk(triangle_with_tail(), np.full(20000, 2), 2, seed=2)
    # from node 2: neighbours {0, 1, 3}, uniform
    counts = np.bincount(walks[:, 1], minlength=4)
    freq = counts / counts.sum()
    assert counts[2] == 0
    np.testing.assert_allclose(freq[[0, 1, 3]], 1 / 3, atol=0.02)


def test_simulate_walks_starts_every_node():
    g = triangle_with_tail()
    gen = torch.Generator().manual_seed(3)
    walks = simulate_walks(g, 3, 5, generator=gen).numpy()
    assert walks.shape == (12, 5)
    np.testing.assert_array_equal(walks[:, 0], np.tile(np.arange(4), 3))
    # every hop follows an edge
    adj = {(u, v) for u in range(4) for v in g.neighbors(u)}
    for row in walks:
        for u, v in zip(row[:-1], row[1:]):
            assert (u, v) in adj

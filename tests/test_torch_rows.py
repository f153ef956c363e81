"""Port's row gather (K3) and row scatter-add (K2) against the JAX package.

Plain gather: bit-equal to indexing. Plain scatter-add: allclose at
rtol=1e-5 to `jnp.ndarray.at[].add` and to the Pallas
`scatter_add_rows(interpret=True)` (f32 sums in another order), with ids
outside [0, V) dropped as XLA's scatter drops them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphembedding_tpu.ops.pallas_scatter import (
    scatter_add_rows as jax_scatter_add_rows,
)
from graphembedding_tpu_torch.ops.rows import gather_rows, scatter_add_rows


def make_case(v=704, c=256, n=3000, seed=0, id_range=None):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, c)).astype(np.float32)
    ids = rng.integers(0, id_range or v, size=n).astype(np.int32)
    grads = rng.normal(size=(n, c)).astype(np.float32)
    return table, ids, grads


def test_gather_bit_equal_to_indexing():
    table, ids, _ = make_case()
    out = gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(out.numpy(), table[ids])


def test_gather_column_slice():
    table, ids, _ = make_case(c=64)
    t = torch.from_numpy(table)
    out = gather_rows(t[:, 32:], torch.from_numpy(ids))
    np.testing.assert_array_equal(out.numpy(), table[ids][:, 32:])


@pytest.mark.parametrize("oracle", ["xla", "pallas"])
@pytest.mark.parametrize("id_range", [None, 9])  # 9: duplicate-heavy
def test_scatter_add_matches_jax(oracle, id_range):
    table, ids, grads = make_case(seed=1, id_range=id_range)
    if oracle == "xla":
        want = jnp.asarray(table).at[ids].add(grads)
    else:
        want = jax_scatter_add_rows(jnp.asarray(table), jnp.asarray(ids),
                                    jnp.asarray(grads), block=512,
                                    window=4, interpret=True)
    got = scatter_add_rows(torch.from_numpy(table.copy()),
                           torch.from_numpy(ids), torch.from_numpy(grads))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_scatter_add_drops_out_of_range_ids():
    table, ids, grads = make_case(v=64, c=8, n=500, seed=2)
    ids[3::11] = 64
    ids[5::13] = 1 << 30
    want = jnp.asarray(table).at[ids].add(grads)  # XLA drops ids >= V
    got = scatter_add_rows(torch.from_numpy(table.copy()),
                           torch.from_numpy(ids), torch.from_numpy(grads))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # negative ids are dropped too (JAX would wrap them numpy-style;
    # the trainer never passes one)
    ids[::7] = -1
    got = scatter_add_rows(torch.from_numpy(table.copy()),
                           torch.from_numpy(ids), torch.from_numpy(grads))
    keep = (ids >= 0) & (ids < 64)
    ref = table.copy()
    np.add.at(ref, ids[keep], grads[keep])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_wrappers_check_inputs():
    table, ids, grads = make_case(v=16, c=8, n=10)
    t, i, g = map(torch.from_numpy, (table, ids, grads))
    with pytest.raises(ValueError):
        gather_rows(t, i.long())
    with pytest.raises(ValueError):
        scatter_add_rows(t, i, g[:, :4])

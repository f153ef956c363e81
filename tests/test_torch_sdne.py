"""The port's SDNE and sparse ops against graphembedding_tpu's.

Both packages start from the same parameters (`interop.sdne_params_from_jax`)
and train in float32 on the CPU; the products and sums run in another order,
so values are compared allclose:
  - `ops.spmm` products, the SDDMM and the Laplacian form: rtol 1e-5;
  - per-layer activations, the loss and its parameter gradients: rtol 1e-5,
    atol 1e-6 (the gradients reach 0.14 in size);
  - parameters after five Adam steps of each trainer (full batch, minibatch
    on the JAX package's own permutation, train_sparse): rtol 1e-5, atol
    5e-6. Adam's step is about lr * sign(grad) while the gradient is far
    above eps, so rounding in the gradients moves a parameter by much less
    than lr, and the measured gap is under 5e-7.
The A and L matrices and the symmetrized edges are equal, and the hard-SBM
gate is the one of tests/test_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphembedding_tpu.data import datasets as jds
from graphembedding_tpu.graph import Graph as JGraph
from graphembedding_tpu.models import SDNE as JSDNE
from graphembedding_tpu.models import sdne as jsdne
from graphembedding_tpu.ops import spmm as jspmm
from graphembedding_tpu_torch import SDNE
from graphembedding_tpu_torch.data import datasets as tds
from graphembedding_tpu_torch.eval.classify import Classifier
from graphembedding_tpu_torch.graph import Graph
from graphembedding_tpu_torch.interop import (
    sdne_params_from_jax,
    sdne_params_to_numpy,
)
from graphembedding_tpu_torch.models import sdne as tsdne
from graphembedding_tpu_torch.ops import spmm as tspmm
from graphembedding_tpu_torch.parity import reference as ref

CONSTS = dict(alpha=1e-4, beta=5.0, nu1=1e-5, nu2=1e-4)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads for this file's CPU training (several test
    processes run at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def toy(cls):
    # directed: 0->1 (2.0), 1->2 (1.0), 2->0 (3.0), plus 0->2 (1.0)
    return cls(np.array([0, 1, 2, 0]), np.array([1, 2, 0, 2]),
               np.array([2.0, 1.0, 3.0, 1.0], dtype=np.float32),
               num_nodes=3, directed=True)


def duplicated(cls):
    # 0->1 listed twice (1.0 and 2.5), an undirected pair, a self-loop
    return cls(np.array([0, 0, 1, 3, 2]), np.array([1, 1, 2, 3, 0]),
               np.array([1.0, 2.5, 1.0, 4.0, 2.0], dtype=np.float32),
               num_nodes=4, directed=True)


def small(mod, num_nodes=75):
    return mod.synthetic_wiki(num_nodes=num_nodes, num_classes=3,
                              avg_degree=5, seed=11)


GRAPHS = {
    "toy": lambda: (toy(JGraph), toy(Graph)),
    "duplicated": lambda: (duplicated(JGraph), duplicated(Graph)),
    "undirected": lambda: (JGraph(np.array([0, 1]), np.array([1, 2]),
                                  directed=False),
                           Graph(np.array([0, 1]), np.array([1, 2]),
                                 directed=False)),
    "small": lambda: (small(jds).graph, small(tds).graph),
}


def pair(mod_graph=None, hidden=(16, 8), seed=0, **kw):
    """A JAX SDNE and the port's, the port's holding the JAX parameters."""
    jg, tg = mod_graph or GRAPHS["small"]()
    jm = JSDNE(jg, hidden_size=list(hidden), seed=seed, **kw)
    tm = SDNE(tg, hidden_size=list(hidden), seed=seed, device="cpu", **kw)
    tm.net.load_state_dict(sdne_params_from_jax(jm.params))
    return jm, tm


def assert_params_close(jparams, net, rtol, atol):
    got = sdne_params_to_numpy(net)
    for stack in ("enc", "dec"):
        for a, b in zip(jparams[stack], got[stack]):
            for k in ("w", "b"):
                np.testing.assert_allclose(b[k], np.asarray(a[k]), rtol=rtol,
                                           atol=atol, err_msg=f"{stack} {k}")


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("sym", [False, True])
def test_spmm_matches_jax(name, sym):
    jg, tg = GRAPHS[name]()
    X = np.random.default_rng(0).standard_normal(
        (tg.num_nodes, 5)).astype(np.float32)
    want = np.asarray(jspmm.spmm(jspmm.adjacency_bcoo(jg, sym=sym),
                                 jnp.asarray(X)))
    A = tspmm.adjacency(tg, sym=sym, device="cpu")
    assert A.layout == torch.sparse_csr
    X = torch.from_numpy(X)
    src, dst, w = tg.edges()
    At = A if sym else tspmm.csr_from_edges(dst, src, w, tg.num_nodes, "cpu")
    got = tspmm.spmm(A, X, At).numpy()
    np.testing.assert_array_equal(tspmm.csr_rows_matmul(A, X).numpy(), got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_spmm_gradient_is_the_transpose_product(name):
    """The gradient to X is A^T @ g (the row-wise product by the CSR
    transpose)."""
    _, tg = GRAPHS[name]()
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.standard_normal(
        (tg.num_nodes, 4)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal(
        (tg.num_nodes, 4)).astype(np.float32))
    A = tspmm.adjacency(tg, device="cpu")
    src, dst, w = tg.edges()
    At = tspmm.csr_from_edges(dst, src, w, tg.num_nodes, "cpu")
    assert At.layout == torch.sparse_csr
    np.testing.assert_array_equal(At.to_dense().numpy(),
                                  A.to_dense().numpy().T)
    (tspmm.spmm(A, X, At) * g).sum().backward()
    np.testing.assert_allclose(X.grad.numpy(),
                               A.to_dense().numpy().T @ g.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sym_edges_equal_jax(name):
    jg, tg = GRAPHS[name]()
    for got, want in zip(tspmm.sym_edges(tg, device="cpu"),
                         jspmm.sym_edges(jg)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_csr_row_sums_are_the_jax_degrees(name):
    """The degrees train_sparse takes from A_sym's rows equal the JAX
    package's deg_w."""
    jg, tg = GRAPHS[name]()
    got = tspmm.csr_row_sums(tspmm.adjacency(tg, sym=True, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(jspmm.sym_edges(jg)[3]),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sddmm_and_laplacian_match_jax(name):
    """sddmm on the symmetrized edges, and tr(Y^T L Y) by the CSR form
    against the JAX package's SDDMM form and the dense trace."""
    jg, tg = GRAPHS[name]()
    Y = np.random.default_rng(2).standard_normal(
        (tg.num_nodes, 6)).astype(np.float32)
    jsrc, jdst, jw, jdeg = jspmm.sym_edges(jg)
    src, dst, w, deg = tspmm.sym_edges(tg, device="cpu")
    np.testing.assert_allclose(
        tspmm.sddmm(src, dst, torch.from_numpy(Y)).numpy(),
        np.asarray(jspmm.sddmm(jsrc, jdst, jnp.asarray(Y))), rtol=1e-5,
        atol=1e-6)
    got = float(tspmm.laplacian_quadratic(
        tspmm.adjacency(tg, sym=True, device="cpu"), deg,
        torch.from_numpy(Y)))
    want = float(jspmm.laplacian_quadratic(jsrc, jdst, jw, jdeg,
                                           jnp.asarray(Y)))
    A_sym = tspmm.adjacency(tg, sym=True, device="cpu").to_dense().numpy()
    trace = np.trace(Y.T @ (np.diag(A_sym.sum(1)) - A_sym) @ Y)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, trace, rtol=1e-4, atol=1e-4)


def test_adjacency_sums_duplicates():
    """Duplicate edges sum, as BCOO and scipy's COO sum them."""
    A = tspmm.adjacency(duplicated(Graph), device="cpu").to_dense().numpy()
    assert A[0, 1] == 3.5 and A[3, 3] == 4.0 and A[2, 0] == 2.0
    A_sym = tspmm.adjacency(duplicated(Graph), sym=True,
                            device="cpu").to_dense().numpy()
    np.testing.assert_array_equal(A_sym, A + A.T)


def test_sym_edges_no_double_count_for_undirected():
    """The port's copy of tests/test_spmm.py's regression: an undirected
    graph lists both directions already; neither the edges nor SDNE's L
    may double a weight."""
    g = Graph(np.array([0, 1]), np.array([1, 2]), directed=False)
    src, dst, w, deg_w = tspmm.sym_edges(g, device="cpu")
    A = np.zeros((3, 3))
    np.add.at(A, (src.numpy(), dst.numpy()), w.numpy())
    np.testing.assert_array_equal(A, [[0, 1, 0], [1, 0, 1], [0, 1, 0]])
    np.testing.assert_array_equal(deg_w.numpy(), [1, 2, 1])
    np.testing.assert_array_equal(
        tspmm.adjacency(g, sym=True, device="cpu").to_dense().numpy(), A)
    m = SDNE(g, hidden_size=[4, 2], device="cpu")
    np.testing.assert_array_equal(m.L.numpy(), np.diag([1, 2, 1]) - A)


@pytest.mark.parametrize("name", ["duplicated", "undirected", "small"])
def test_A_and_L_equal_jax(name):
    jm, tm = pair(GRAPHS[name](), hidden=(4, 2))
    np.testing.assert_array_equal(tm.A.numpy(), np.asarray(jm.A))
    np.testing.assert_array_equal(tm.L.numpy(), np.asarray(jm.L))


def test_init_is_glorot_and_device_independent():
    """Glorot-uniform weights inside sqrt(6 / (in + out)), zero biases,
    [in, out] orientation, the same from one seed and another from the
    next."""
    g = small(tds).graph
    a = SDNE(g, hidden_size=[16, 8], seed=3, device="cpu").net
    b = SDNE(g, hidden_size=[16, 8], seed=3, device="cpu").net
    c = SDNE(g, hidden_size=[16, 8], seed=4, device="cpu").net
    shapes = [(75, 16), (16, 8), (8, 16), (16, 75)]
    assert [tuple(w.shape) for w in a.weights()] == shapes
    for (fi, fo), w in zip(shapes, a.weights()):
        limit = np.sqrt(6.0 / (fi + fo))
        top = float(w.detach().abs().max())
        assert 0.8 * limit < top <= limit
    for x, y, z in zip(a.state_dict().values(), b.state_dict().values(),
                       c.state_dict().values()):
        assert torch.equal(x, y)
        assert x.abs().sum() == 0 or not torch.equal(x, z)
    assert all(not layer.b.any() for layer in (*a.enc, *a.dec))


def test_per_layer_activations_match_reference_and_jax():
    """Encoder and decoder activations, layer by layer, against
    `parity.reference.sdne_forward`/`mlp_forward` and the JAX package's
    `mlp_activations`, from the same parameters."""
    jm, tm = pair()
    a = np.asarray(jm.A)
    params = sdne_params_to_numpy(tm.net)
    want_enc, want_dec = ref.sdne_forward(params["enc"], params["dec"], a)
    assert len(want_enc) == len(ref.mlp_forward(params["enc"], a)) == 2
    jax_enc = jsdne.mlp_activations(jm.params["enc"], jnp.asarray(a))
    jax_dec = jsdne.mlp_activations(jm.params["dec"], jax_enc[-1])
    with torch.no_grad():
        got_enc = tsdne.mlp_activations(tm.net.enc, tm.A)
        got_dec = tsdne.mlp_activations(tm.net.dec, got_enc[-1])
        np.testing.assert_array_equal(tm.net.encode(tm.A).numpy(),
                                      got_enc[-1].numpy())
    for got, want, jwant in zip(got_enc + got_dec, want_enc + want_dec,
                                list(jax_enc) + list(jax_dec)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant),
                                   rtol=1e-5, atol=1e-6)


def test_sdne_loss_and_gradients_match_jax():
    """The loss, its two terms and every parameter's gradient against JAX
    `sdne_loss` and `jax.grad`, and the loss against the numpy reference,
    on full-batch A and L and on a minibatch block."""
    jm, tm = pair(**CONSTS)
    consts = tuple(CONSTS.values())
    idx = np.random.default_rng(3).permutation(75)[:20]
    for rows in (slice(None), idx):
        a, L = np.asarray(jm.A), np.asarray(jm.L)
        if not isinstance(rows, slice):
            a, L = a[rows], L[rows][:, rows]
        (jl, (j2, j1)), jgrads = jax.value_and_grad(
            jsdne.sdne_loss, has_aux=True)(
                jm.params, jnp.asarray(a), jnp.asarray(L),
                *map(jnp.float32, consts))
        tm.net.zero_grad()
        loss, (l2, l1) = tsdne.sdne_loss(tm.net, torch.tensor(a),
                                         torch.tensor(L), *consts)
        loss.backward()
        for got, want in ((loss, jl), (l2, j2), (l1, j1)):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                       atol=1e-6)
        params = sdne_params_to_numpy(tm.net)
        enc_acts, dec_acts = ref.sdne_forward(params["enc"], params["dec"],
                                              a)
        r2, r1 = ref.sdne_losses(a, dec_acts[-1], enc_acts[-1], L,
                                 CONSTS["alpha"], CONSTS["beta"])
        reg = ref.sdne_reg(params["enc"], params["dec"], CONSTS["nu1"],
                           CONSTS["nu2"])
        np.testing.assert_allclose(float(loss), r2 + r1 + reg, rtol=1e-5)
        for stack in ("enc", "dec"):
            for jlayer, layer in zip(jgrads[stack], getattr(tm.net, stack)):
                for k in ("w", "b"):
                    np.testing.assert_allclose(
                        getattr(layer, k).grad.numpy(),
                        np.asarray(jlayer[k]), rtol=1e-5, atol=1e-6)


def test_evaluate_matches_jax():
    jm, tm = pair(**CONSTS)
    got, want = tm.evaluate(), jm.evaluate()
    assert set(got) == set(want) == {"loss", "l_2nd", "l_1st"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


def test_adam_matches_optax():
    """The written-out Adam (`train/adam.py`) against `optax.adam` on one
    stream of ten gradients, at SDNE's constants and at the dense
    trainer's (b2 = 0.99): rtol 1e-5, atol 1e-7. The bias corrections are
    float32 powers that numpy and XLA may round an ulp apart, and
    1 - 0.999^t magnifies that ulp up to 999 times at t = 1."""
    import optax

    from graphembedding_tpu_torch.train.adam import Adam, AdamConfig

    rng = np.random.default_rng(12)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [(rng.standard_normal((6, 5)) * 10.0 ** rng.integers(
        -6, 1, (6, 5))).astype(np.float32) for _ in range(10)]
    for lr, b2 in ((1e-3, 0.999), (0.1, 0.99)):
        tx = optax.adam(lr, b2=b2)
        jp = {"p": jnp.asarray(p0)}
        state = tx.init(jp)
        p = torch.tensor(p0)
        opt = Adam({"p": p}, AdamConfig(lr, b2=b2))
        for g in grads:
            updates, state = tx.update({"p": jnp.asarray(g)}, state, jp)
            jp = optax.apply_updates(jp, updates)
            opt.step({"p": torch.tensor(g)})
            np.testing.assert_allclose(p.numpy(), np.asarray(jp["p"]),
                                       rtol=1e-5, atol=1e-7)
        assert opt.count == 10 and int(state[0].count) == 10
        np.testing.assert_allclose(opt.m["p"].numpy(),
                                   np.asarray(state[0].mu["p"]), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(opt.v["p"].numpy(),
                                   np.asarray(state[0].nu["p"]), rtol=1e-5,
                                   atol=1e-7)


def test_five_full_batch_steps_match_jax():
    jm, tm = pair(**CONSTS)
    jm.train(batch_size=100, epochs=5)
    tm.train(batch_size=100, epochs=5)
    assert tuple(tm.losses.shape) == (5,)
    np.testing.assert_allclose(tm.losses.numpy(), np.asarray(jm.losses),
                               rtol=1e-5)
    assert_params_close(jm.params, tm.net, 1e-5, 5e-6)


def test_five_minibatch_steps_match_jax():
    """batch_size 16 over V = 75: five steps an epoch, the permutation
    padded by its first five ids; the port's epoch body runs on the JAX
    package's own permutation for epoch 0."""
    jm, tm = pair(**CONSTS)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0 + 2),
                                                0), 0)
    perm = torch.from_numpy(
        np.asarray(jax.random.permutation(key, 75)).astype(np.int64))
    jm.train(batch_size=16, epochs=1)
    losses = tsdne.minibatch_epoch(tm.net, tm._adam(1e-3), tm.A, tm.L, perm,
                                   16, *CONSTS.values())
    assert len(losses) == 5
    np.testing.assert_allclose(torch.stack(losses).numpy(),
                               np.asarray(jm.losses), rtol=1e-5)
    assert_params_close(jm.params, tm.net, 1e-5, 5e-6)


def test_minibatch_train_draws_its_permutations():
    """train(batch_size < V): ceil(V / batch) losses an epoch, the same from
    one seed, and the CPU generator's permutations."""
    g = small(tds).graph
    runs = [SDNE(g, hidden_size=[8, 4], device="cpu").train(
        batch_size=16, epochs=2) for _ in range(2)]
    assert tuple(runs[0].losses.shape) == (10,)
    assert torch.equal(runs[0].losses, runs[1].losses)
    m = SDNE(g, hidden_size=[8, 4], device="cpu")
    gen = torch.Generator().manual_seed(2)
    opt = m._adam(1e-3)
    want = [tsdne.minibatch_epoch(m.net, opt, m.A, m.L,
                                  torch.randperm(75, generator=gen), 16,
                                  m.alpha, m.beta, m.nu1, m.nu2)
            for _ in range(2)]
    assert torch.equal(runs[0].losses, torch.stack(sum(want, [])))


def test_five_sparse_steps_match_jax():
    """train_sparse with row_chunk 32 < V = 75 (three chunks, the last
    short) against the JAX package's."""
    jm, tm = pair(**CONSTS)
    jm.train_sparse(epochs=5, row_chunk=32)
    tm.train_sparse(epochs=5, row_chunk=32)
    np.testing.assert_allclose(tm.losses.numpy(), np.asarray(jm.losses),
                               rtol=1e-5)
    assert_params_close(jm.params, tm.net, 1e-5, 5e-6)


def test_sparse_loss_equals_dense_loss():
    """The sparse objective is the full-batch one: the same loss and terms
    as sdne_loss on the dense A and L (the Laplacian summed another way)."""
    _, tm = pair(**CONSTS)
    consts = tuple(CONSTS.values())
    with torch.no_grad():
        dense = tsdne.sdne_loss(tm.net, tm.A, tm.L, *consts)
        sparse = tsdne.sparse_sdne_loss(tm.net, tm.sparse_inputs(), *consts,
                                        row_chunk=20)
    for a, b in ((dense[0], sparse[0]), *zip(dense[1], sparse[1])):
        np.testing.assert_allclose(float(b), float(a), rtol=1e-5, atol=1e-7)


def test_train_sparse_never_builds_dense():
    """After train_sparse and get_embeddings, A and L were never built, and
    the sparse encode equals the dense one (the port's copy of
    tests/test_spmm.py's memory contract)."""
    g = tds.synthetic_wiki(num_nodes=60, num_classes=2, avg_degree=5,
                           seed=7).graph
    m = SDNE(g, hidden_size=[16, 8], device="cpu")
    m.train_sparse(epochs=5, row_chunk=32)
    emb = m.get_embeddings()
    assert len(emb) == 60 and next(iter(emb.values())).shape == (8,)
    assert m._A is None and m._L is None
    sparse_table = m.embedding_table
    with torch.no_grad():
        dense_table = m.net.encode(m.A)
    np.testing.assert_allclose(sparse_table.numpy(), dense_table.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_checkpointed_chunks_give_the_unchecked_gradients():
    """The sparse loss's checkpointed chunks against the same chunks run
    without a checkpoint: the same loss bit for bit (the recomputed forward
    is the same arithmetic), and the same gradients within rtol 1e-6,
    atol 1e-6 (gradients up to 8 in size; the chunks' contributions
    accumulate in another order, a few ulp)."""
    _, tm = pair(**CONSTS)
    consts = tuple(CONSTS.values())
    inputs = tm.sparse_inputs()
    A, At, A_sym, deg_w, nbr, nbr_w = inputs
    V, C = 75, 32

    def grads(loss):
        tm.net.zero_grad(set_to_none=True)
        loss.backward()
        return [p.grad.clone() for p in tm.net.parameters()]

    checked, _ = tsdne.sparse_sdne_loss(tm.net, inputs, *consts,
                                        row_chunk=C)
    g_checked = grads(checked)
    y = tm.net.encode_sparse(A, At)
    l2 = 0.0
    for lo in range(0, V, C):
        l2 = l2 + tsdne.chunk_reconstruction(
            tm.net, y[lo:lo + C], nbr[lo:lo + C], nbr_w[lo:lo + C],
            CONSTS["beta"])
    unchecked = (l2 / V + CONSTS["alpha"] * 2.0 * tspmm.laplacian_quadratic(
        A_sym, deg_w, y) / V + tsdne.weight_penalty(
            tm.net, CONSTS["nu1"], CONSTS["nu2"]))
    g_unchecked = grads(unchecked)
    assert float(checked) == float(unchecked)
    for a, b in zip(g_checked, g_unchecked):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_chunk_rows_rebuild_the_adjacency():
    """A chunk's rows, rebuilt from the padded neighbor matrix, are the
    dense A's rows (duplicate edges summed)."""
    g = small(tds).graph
    m = SDNE(g, hidden_size=[4, 2], device="cpu")
    nbr, nbr_w = g.neighbor_matrix("cpu")
    V = g.num_nodes
    cols = torch.where(nbr >= 0, nbr, V).long()
    rows = torch.zeros((V, V + 1)).scatter_add_(1, cols, nbr_w)[:, :V]
    np.testing.assert_array_equal(rows.numpy(), m.A.numpy())


def test_unported_options_raise(tmp_path):
    g = small(tds).graph
    m = SDNE(g, hidden_size=[4, 2], device="cpu")
    # mesh= is ported (tests/test_torch_parallel_models.py) and takes a
    # parallel.mesh.Mesh only
    for fn in (m.train, m.train_sparse):
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            fn(epochs=1, mesh=object())
    # checkpoints are ported (tests/test_torch_checkpoint.py)
    for name, fn in (("train", m.train), ("sparse", m.train_sparse)):
        fn(epochs=2, checkpoint_dir=str(tmp_path / name),
           checkpoint_every=1)
        assert m.losses.shape[0] > 0
        fn(epochs=2, checkpoint_dir=str(tmp_path / name))
        assert m.losses.shape == (0,)


def test_signature_defaults_equal_jax():
    import inspect

    def defaults(fn, drop=()):
        return {k: p.default for k, p in inspect.signature(fn).parameters
                .items() if p.default is not inspect.Parameter.empty
                and k not in drop}

    assert defaults(SDNE.__init__, ("device",)) == defaults(JSDNE.__init__)
    assert defaults(SDNE.train) == defaults(JSDNE.train)
    assert defaults(SDNE.train_sparse) == defaults(JSDNE.train_sparse)
    assert SDNE(small(tds).graph, device="cpu").hidden_size == [256, 128]


def test_sdne_hard_sbm_gate():
    """The gate of tests/test_models.py::test_sdne_hard_sbm_gate on the
    port: seeds 0 and 1, min >= 0.40, mean >= 0.45."""
    ds = tds.synthetic_wiki_hard()
    scores = []
    for seed in (0, 1):
        m = SDNE(ds.graph, hidden_size=[128, 64], seed=seed, device="cpu")
        m.train(batch_size=1024, epochs=150)
        scores.append(Classifier(m.get_embeddings()).split_train_evaluate(
            ds.X, ds.Y, 0.8, seed=0)["micro"])
    assert min(scores) >= 0.40, scores
    assert sum(scores) / len(scores) >= 0.45, scores

"""SDNE (Wang et al., KDD'16): a deep autoencoder over adjacency rows.

Counterpart of `graphembedding_tpu/models/sdne.py`. The encoder maps a
row of the adjacency A through relu Dense layers V -> 256 -> 128 = Y, and
the decoder mirrors it back to V, relu after every layer including the
last. The objective is
  - l_2nd: the beta-weighted reconstruction, mean over rows of
    sum(((A - A_hat) * b)^2) with b = beta where A != 0 else 1;
  - l_1st: alpha * 2 * tr(Y^T L Y) / batch, L = D - A_sym on the
    symmetrized adjacency;
  - the L1 and L2 weight penalty (nu1, nu2) over every layer's weights.

Three trainers, each Adam in the form of optax.adam (`train/adam.py`):
  - `train(batch_size >= V)`: full batch, one step an epoch on the dense
    [V, V] A and L;
  - `train(batch_size < V)`: the reference's minibatch loop,
    ceil(V / batch_size) steps an epoch over a permutation padded by its
    own head, each step on A[idx] and the block L[idx][:, idx]
    (`minibatch_epoch` takes the permutation as an input);
  - `train_sparse`: never builds [V, V]. The first layer is a CSR SpMM,
    the Laplacian term `ops.spmm.laplacian_quadratic`, and the
    reconstruction is summed in row chunks, each rebuilt from the padded
    neighbor matrix and run under `torch.utils.checkpoint`, so autograd
    keeps no chunk's [C, V].

Each chunk of epochs (all of them without checkpoints) runs as the JAX
package's one `lax.scan`: on a card its steps replay one captured CUDA
graph (`train/chunk_graph.py`), on the CPU they are launched one by one,
the graph's plain version. A step (`adam_step`) reads the weights, Adam's
state and its inputs from the graph's buffers: the parameters as
autograd leaves aliasing those buffers, the gradients by
`torch.autograd.grad`, the update in place. The inputs are the dense A and
L, the minibatch loop's batches of a chunk (its permutations drawn before
the chunk, in the order of its epochs) or the CSRs as their three dense
tensors each, and the steps' bias corrections. Over a mesh the step also
sums the gradients and the loss over the data axis (`parallel/sdne.py`):
over NCCL inside the graph, over gloo with CUDA tensors step by step.

Weights are Glorot-uniform with zero biases, drawn from a
`torch.Generator(seed)` on the CPU and then moved, so the initial
parameters do not depend on the device; permutations come from a CPU
`torch.Generator(seed + 2)`. Weights keep the JAX package's [in, out]
orientation. Every product runs in full float32 (matmul precision
"highest"); TF32 would change the results. On the card, training is
bit-identical from run to run.

The three trainers checkpoint and resume (`SDNE._run_checkpointed`),
bit-identical to an uninterrupted train. `train(mesh=m)` (full batch only,
as in the JAX package) and `train_sparse(mesh=m)` shard the adjacency's rows
over a (n, 1) mesh with exact data parallelism (`parallel/sdne.py`), each
rank checkpointing its own file.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from graphembedding_tpu_torch.models.base import as_graph, model_device
from graphembedding_tpu_torch.ops.spmm import (
    Csr,
    adjacency,
    csr_from_edges,
    csr_parts,
    csr_row_sums,
    laplacian_quadratic,
    spmm,
)
from graphembedding_tpu_torch.parallel import comm
from graphembedding_tpu_torch.parallel.mesh import check_mesh, put_global
from graphembedding_tpu_torch.parallel.sdne import (
    pad_sparse_inputs,
    shard_dense,
    sharded_sdne_sparse_train,
    sharded_sdne_train,
)
from graphembedding_tpu_torch.train.adam import Adam, AdamConfig, adam_update
from graphembedding_tpu_torch.train.chunk_graph import run_chunk
from graphembedding_tpu_torch.utils.checkpoint import (
    save_sharded,
    save_state,
    try_restore,
    try_restore_sharded,
)
from graphembedding_tpu_torch.utils.precision import f32_matmul

# what a checkpoint of an SDNE trainer holds (the minibatch loop's also its
# permutation generator's state, "rng"); "opt_state/count" is a key of
# opt_state, which a checkpoint of torch.optim.Adam's state lacks
SDNE_STATE_KEYS = ("params", "opt_state/m", "opt_state/v",
                   "opt_state/count", "epoch")


def dense_layer(x, w, b):
    return torch.relu(x @ w + b)


class Dense(nn.Module):
    """relu(x @ w + b); w is [in, out], Glorot-uniform with the limit
    sqrt(6 / (in + out)), b zeros."""

    def __init__(self, fan_in, fan_out, generator):
        super().__init__()
        limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
        u = torch.rand((fan_in, fan_out), generator=generator)
        self.w = nn.Parameter(u * (2.0 * limit) - limit)
        self.b = nn.Parameter(torch.zeros(fan_out))

    def forward(self, x):
        return dense_layer(x, self.w, self.b)


class Layer(NamedTuple):
    """A Dense layer as its two tensors."""
    w: torch.Tensor
    b: torch.Tensor

    def __call__(self, x):
        return dense_layer(x, self.w, self.b)


class Stacks:
    """The encoder and decoder passes over `self.enc` and `self.dec`,
    sequences of layers with `w`, `b` and a call."""

    def encode(self, a_rows):
        return run_stack(self.enc, a_rows)

    def encode_sparse(self, A, At):
        """The encoder on all of a CSR adjacency: the first layer as a CSR
        SpMM (At carries its gradient), the rest dense."""
        first = self.enc[0]
        h = torch.relu(spmm(A, first.w, At) + first.b)
        return run_stack(self.enc[1:], h)

    def decode(self, y):
        return run_stack(self.dec, y)

    def weights(self):
        return [layer.w for layer in (*self.enc, *self.dec)]


class Autoencoder(Stacks, nn.Module):
    """The encoder stack V -> hidden_size and the decoder back to V."""

    def __init__(self, num_nodes, hidden_size, seed):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        enc = [num_nodes] + list(hidden_size)
        dec = list(reversed(hidden_size)) + [num_nodes]
        self.enc = nn.ModuleList(
            Dense(a, b, gen) for a, b in zip(enc, enc[1:]))
        self.dec = nn.ModuleList(
            Dense(a, b, gen) for a, b in zip(dec, dec[1:]))


class LayerStacks(Stacks):
    """The autoencoder on given tensors: `tensors` maps the module's
    parameter names ("enc.0.w", ...) to them."""

    def __init__(self, tensors):
        stacks = {"enc": {}, "dec": {}}
        for name, t in tensors.items():
            stack, i, k = name.split(".")
            stacks[stack].setdefault(int(i), {})[k] = t
        self.enc, self.dec = ([Layer(d[i]["w"], d[i]["b"]) for i in sorted(d)]
                              for d in (stacks["enc"], stacks["dec"]))


def run_stack(layers, x):
    for layer in layers:
        x = layer(x)
    return x


def mlp_activations(layers, x):
    """Per-layer activations of a Dense stack (for allclose parity against
    `parity.reference.mlp_forward`)."""
    acts = []
    for layer in layers:
        x = layer(x)
        acts.append(x)
    return acts


def weight_penalty(net, nu1, nu2):
    """nu1 * sum|w| + nu2 * sum(w^2) over every layer's weights."""
    reg = 0.0
    for w in net.weights():
        reg = reg + nu1 * w.abs().sum() + nu2 * w.square().sum()
    return reg


def sdne_loss(net, a_rows, l_block, alpha, beta, nu1, nu2):
    """The reference objective on one batch (rows of A and the L block):
    (loss, (l_2nd, l_1st))."""
    y = net.encode(a_rows)
    a_hat = net.decode(y)
    b_ = torch.where(a_rows != 0, beta, 1.0)
    l2nd = ((a_rows - a_hat) * b_).square().sum(-1).mean()
    # tr(Y^T L Y) as its diagonal's sum: torch.trace's gradient reads the
    # incoming gradient back to the host, which a CUDA graph's capture
    # refuses (on the card torch.trace is this same sum)
    l1st = (alpha * 2.0 * torch.diagonal(y.T @ l_block @ y).sum()
            / a_rows.shape[0])
    return l2nd + l1st + weight_penalty(net, nu1, nu2), (l2nd, l1st)


def chunk_reconstruction(net, y_c, nbr_c, nbr_w_c, beta):
    """sum(((A_c - A_hat_c) * b)^2) over a chunk of rows: A_c is rebuilt
    from their padded neighbor ids (-1 pads) and weights by a scatter into
    [C, V + 1] whose last column (the pads') is dropped."""
    a_hat = net.decode(y_c)
    C, V = a_hat.shape
    cols = torch.where(nbr_c >= 0, nbr_c, V).long()
    rows = torch.zeros((C, V + 1), device=a_hat.device).scatter_add_(
        1, cols, nbr_w_c)[:, :V]
    b_ = torch.where(rows != 0, beta, 1.0)
    return ((rows - a_hat) * b_).square().sum(-1).sum()


def sparse_sdne_loss(net, inputs, alpha, beta, nu1, nu2, row_chunk):
    """The full-batch objective without [V, V]: (loss, (l_2nd, l_1st)).

    inputs: (A, At, A_sym, deg_w, nbr, nbr_w), see `SDNE.sparse_inputs`.
    Each chunk of `row_chunk` rows runs under a checkpoint: its [C, V]
    reconstruction is recomputed in the backward pass, not kept.
    """
    A, At, A_sym, deg_w, nbr, nbr_w = inputs
    V = deg_w.shape[0]
    y = net.encode_sparse(A, At)
    l1st = alpha * 2.0 * laplacian_quadratic(A_sym, deg_w, y) / V
    l2nd = 0.0
    for lo in range(0, V, row_chunk):
        hi = min(lo + row_chunk, V)
        # the chunk draws nothing, so no RNG state to keep
        l2nd = l2nd + checkpoint(
            chunk_reconstruction, net, y[lo:hi], nbr[lo:hi], nbr_w[lo:hi],
            beta, use_reentrant=False, preserve_rng_state=False)
    l2nd = l2nd / V
    return l2nd + l1st + weight_penalty(net, nu1, nu2), (l2nd, l1st)


def full_batch_objective(net, b, s, *, alpha, beta, nu1, nu2):
    return sdne_loss(net, b["A"], b["L"], alpha, beta, nu1, nu2)[0]


def minibatch_objective(net, b, s, *, alpha, beta, nu1, nu2):
    """The loss of step s's batch b["idx"][s]: A[idx] and L[idx][:, idx]."""
    idx = b["idx"][s]
    return sdne_loss(net, b["A"][idx], b["L"][idx][:, idx], alpha, beta,
                     nu1, nu2)[0]


SPARSE_INPUTS = ("A", "At", "A_sym")  # the CSRs of `SDNE.sparse_inputs`


def buffer_csrs(b, names=SPARSE_INPUTS):
    """The CSRs `names` of a chunk's buffers (`sparse_buffers`)."""
    return [Csr(*(b[f"{k}.{f}"] for f in Csr._fields)) for k in names]


def sparse_objective(net, b, s, *, alpha, beta, nu1, nu2, row_chunk):
    inputs = (*buffer_csrs(b), b["deg_w"], b["nbr"], b["nbr_w"])
    return sparse_sdne_loss(net, inputs, alpha, beta, nu1, nu2,
                            row_chunk)[0]


def sparse_buffers(inputs, names=SPARSE_INPUTS):
    """Sparse inputs (CSRs `names`, then deg_w, nbr and nbr_w; as
    `SDNE.sparse_inputs` gives them) as dense tensors by name: each CSR as
    its three ("A.crow", "A.col", "A.values", ...)."""
    *csrs, deg_w, nbr, nbr_w = inputs
    return {**{f"{k}.{f}": t for k, csr in zip(names, csrs)
               for f, t in zip(Csr._fields, csr_parts(csr))},
            "deg_w": deg_w, "nbr": nbr, "nbr_w": nbr_w}


def summed_grads(grads, group):
    """The gradients summed over `group` in one flat buffer, as views of
    it shaped as the gradients."""
    flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return out


def adam_step(b, s, ops, *, objective, names, adam, **kw):
    """Step s of a chunk (`chunk_graph.run_chunk`) on its buffers: the
    parameters "p/<name>" as autograd leaves, `objective(net, b, s, **kw)`
    and its gradients by `torch.autograd.grad`, then Adam on "p/", "m/"
    and "v/<name>" in place with the bias corrections b["bc1"][s] and
    b["bc2"][s]. A mesh objective's `group` (kw; the process group its
    rows are split over) sums the gradients over it before Adam, and the
    loss after. Returns (loss,)."""
    del ops  # no kernel of the port
    group = kw.get("group")
    leaves = {k: b[f"p/{k}"].detach().requires_grad_() for k in names}
    with torch.enable_grad():
        loss = objective(LayerStacks(leaves), b, s, **kw)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    if group is not None:
        grads = summed_grads(grads, group)
    ps, ms, vs = ([b[f"{kind}/{k}"] for k in names] for kind in "pmv")
    with torch.no_grad():
        adam_update(ps, list(grads), ms, vs, b["bc1"][s], b["bc2"][s], adam)
    loss = loss.detach()
    return (loss if group is None else comm.all_reduce(loss, group),)


def adam_chunk(opt, objective, n_steps, inputs, **kw):
    """n_steps Adam steps of `objective` (`adam_step`) on the parameters
    and state of `opt` (an `Adam`), with the tensors `inputs` (name ->
    tensor); on a card one CUDA graph, on the CPU the loop, and the loop
    too when kw's `group` (a mesh objective's) stages its exchanges
    through the host. kw: the objective's constants. Returns the losses
    [n_steps]."""
    bc1, bc2 = opt.bias_corrections(n_steps)
    group = kw.get("group")
    losses, = run_chunk(
        adam_step, n_steps, opt.tables(), {**inputs, "bc1": bc1,
                                           "bc2": bc2},
        consts=dict(objective=objective, names=tuple(opt.params),
                    adam=opt.cfg, **kw),
        groups=() if group is None else (group,))
    opt.count += n_steps
    return losses


def epoch_batches(perm, batch_size):
    """An epoch's batches [ceil(V / batch_size), batch_size]: the
    permutation padded by its own head."""
    V = perm.shape[0]
    steps = -(-V // batch_size)
    return torch.cat([perm, perm[:steps * batch_size - V]]).view(
        steps, batch_size)


def minibatch_epoch(net, opt, A, L, perm, batch_size, alpha, beta, nu1,
                    nu2):
    """One epoch of the reference minibatch loop on a given permutation:
    ceil(V / batch_size) steps over perm padded by its own head, each on
    A[idx] and L[idx][:, idx]. Returns the steps' losses."""
    del net  # opt holds the parameters
    idx = epoch_batches(perm, batch_size).to(A.device)
    return list(adam_chunk(opt, minibatch_objective, idx.shape[0],
                           {"A": A, "L": L, "idx": idx}, alpha=alpha,
                           beta=beta, nu1=nu1, nu2=nu2))


class SDNE:
    def __init__(self, graph, hidden_size=None, alpha=1e-6, beta=5.0,
                 nu1=1e-5, nu2=1e-4, seed=0, device="cuda"):
        # [256, 128] by default, the reference's size
        self.device = model_device(device)
        self.graph = as_graph(graph)
        self.hidden_size = list(hidden_size or [256, 128])
        self.alpha = alpha
        self.beta = beta
        self.nu1 = nu1
        self.nu2 = nu2
        self.seed = seed
        self.net = Autoencoder(self.graph.num_nodes, self.hidden_size,
                               seed).to(self.device)
        self.losses = None
        self._embeddings: Optional[Dict] = None
        # the dense [V, V] A and L, and the sparse trainer's inputs, are
        # built on first use: train_sparse never builds A or L
        self._A = None
        self._L = None
        self._sparse = None

    @property
    def A(self):
        """Dense [V, V] adjacency with the reference's `A[src, dst] = w`
        (an assignment). Built on first use."""
        if self._A is None:
            V = self.graph.num_nodes
            src, dst, w = self.graph.edges()
            A = np.zeros((V, V), dtype=np.float32)
            A[src, dst] = w
            self._A = torch.as_tensor(A, device=self.device)
        return self._A

    @property
    def L(self):
        """Dense Laplacian L = D - A_sym with duplicates summed (scipy COO
        semantics); the transpose is added only for a directed graph, whose
        edges() lists one direction. Built on first use."""
        if self._L is None:
            V = self.graph.num_nodes
            src, dst, w = self.graph.edges()
            A_sym = np.zeros((V, V), dtype=np.float32)
            np.add.at(A_sym, (src, dst), w)
            if self.graph.directed:
                np.add.at(A_sym, (dst, src), w)
            D = np.diag(A_sym.sum(axis=1))
            self._L = torch.as_tensor((D - A_sym).astype(np.float32),
                                      device=self.device)
        return self._L

    def sparse_inputs(self):
        """(A, A^T, A_sym as CSR; deg_w; padded neighbor ids and weights)
        on the model's device, built once."""
        if self._sparse is None:
            g, dev = self.graph, self.device
            src, dst, w = g.edges()
            A_sym = adjacency(g, sym=True, device=dev)
            self._sparse = (csr_from_edges(src, dst, w, g.num_nodes, dev),
                            csr_from_edges(dst, src, w, g.num_nodes, dev),
                            A_sym, csr_row_sums(A_sym),
                            *g.neighbor_matrix(dev))
        return self._sparse

    def _consts(self):
        return dict(alpha=self.alpha, beta=self.beta, nu1=self.nu1,
                    nu2=self.nu2)

    def _adam(self, learning_rate):
        """A fresh Adam (optax.adam's constants) on the parameters."""
        return Adam({k: p.detach() for k, p in self.net.named_parameters()},
                    AdamConfig(float(learning_rate)))

    def train(self, batch_size=1024, epochs=1, initial_epoch=0, verbose=0,
              learning_rate=1e-3, checkpoint_dir=None, checkpoint_every=0,
              mesh=None):
        """The reference signature: full batch when batch_size >= V, else
        the minibatch loop. A fresh Adam each call, as in the JAX package.
        checkpoint_dir / checkpoint_every: see `_run_checkpointed`; the
        minibatch loop's checkpoints also hold its permutation generator's
        state. mesh: the full batch's rows sharded over the data axis
        (`parallel/sdne.py`); the minibatch loop stays single-device."""
        del initial_epoch, verbose
        V = self.graph.num_nodes
        if mesh is not None:
            self._on_mesh(mesh)
            if batch_size < V:
                raise NotImplementedError(
                    "mesh= shards the full-batch mode (batch_size >= node "
                    "count); the minibatch loop's L[idx][:, idx] coupling "
                    "depends on the batch and stays single-device")
        opt = self._adam(learning_rate)
        A, L = self.A, self.L
        consts = self._consts()
        gen = None
        if mesh is not None:
            shards = shard_dense(A, L, mesh, V)

            def run_epochs(n):
                return sharded_sdne_train(
                    opt, *shards, mesh=mesh, num_nodes=V, n_epochs=n,
                    **consts)
        elif batch_size >= V:
            def run_epochs(n):
                return adam_chunk(opt, full_batch_objective, n,
                                  {"A": A, "L": L}, **consts)
        else:
            gen = torch.Generator().manual_seed(self.seed + 2)

            def run_epochs(n):
                # the chunk's permutations, drawn in the order of its epochs
                idx = torch.cat([epoch_batches(torch.randperm(
                    V, generator=gen), batch_size) for _ in range(n)])
                return adam_chunk(opt, minibatch_objective, idx.shape[0],
                                  {"A": A, "L": L,
                                   "idx": idx.to(self.device)}, **consts)
        return self._trained(self._run_checkpointed(
            run_epochs, opt, epochs, checkpoint_dir, checkpoint_every, gen,
            mesh))

    def train_sparse(self, epochs=1, learning_rate=1e-3, row_chunk=512,
                     checkpoint_dir=None, checkpoint_every=0, mesh=None):
        """The full-batch objective without dense [V, V] matrices (see the
        module docstring); one Adam step an epoch. checkpoint_dir /
        checkpoint_every: see `_run_checkpointed`. mesh: the rows sharded
        over the data axis (`parallel/sdne.py`)."""
        opt = self._adam(learning_rate)
        if mesh is not None:
            self._on_mesh(mesh)
            inputs = pad_sparse_inputs(self.graph, mesh, self.device)

            def run_epochs(n):
                return sharded_sdne_sparse_train(
                    opt, inputs, mesh=mesh, num_nodes=self.graph.num_nodes,
                    n_epochs=n, row_chunk=row_chunk, **self._consts())
        else:
            inputs = sparse_buffers(self.sparse_inputs())

            def run_epochs(n):
                return adam_chunk(opt, sparse_objective, n, inputs,
                                  row_chunk=row_chunk, **self._consts())
        return self._trained(self._run_checkpointed(
            run_epochs, opt, epochs, checkpoint_dir, checkpoint_every,
            mesh=mesh))

    def _on_mesh(self, mesh):
        """Check the mesh and start every rank from rank 0's parameters."""
        check_mesh(mesh)
        with torch.no_grad():
            for p in self.net.parameters():
                p.copy_(put_global(p, mesh))

    def _run_checkpointed(self, run_epochs, opt, epochs, checkpoint_dir,
                          checkpoint_every, gen=None, mesh=None):
        """Run `epochs` epochs by `run_epochs(n)` (which returns the steps'
        losses, a tensor) with checkpoint and resume, the JAX package's
        `_run_checkpointed`: with `checkpoint_dir` and `checkpoint_every`,
        the epochs run in chunks of `checkpoint_every` (else in one chunk),
        and after each the parameters, `opt.state_dict()`, the epoch count
        and, when given, the permutation generator `gen`'s state are
        saved; a checkpoint already in `checkpoint_dir` is restored first
        (into the fresh Adam `opt`) and only the epochs it lacks run. The chunks draw from one
        stream in order, so a resumed train equals an uninterrupted one,
        with or without checkpoints, bit for bit (the JAX package keys its
        checkpointed minibatch chunks by their first epoch, so its
        permutations there differ from its run without checkpoints)."""
        start = 0
        keys = SDNE_STATE_KEYS + (("rng",) if gen is not None else ())
        if mesh is None:
            restore, save = try_restore, save_state
        else:  # over a mesh: a file a rank
            def restore(path, keys):
                return try_restore_sharded(path, dict.fromkeys(keys), mesh)

            def save(path, state):
                save_sharded(path, state, mesh)
        state = restore(checkpoint_dir, keys) if checkpoint_dir else None
        if state is not None:
            self.net.load_state_dict(state["params"])
            opt.load_state_dict(state["opt_state"])
            if gen is not None:
                gen.set_state(state["rng"])
            start = int(state["epoch"])
        every = checkpoint_every if checkpoint_dir else 0
        losses = []
        e = start
        with f32_matmul():
            while e < epochs:
                n = min(every or epochs - e, epochs - e)
                losses.append(run_epochs(n))
                e += n
                if every:
                    save(checkpoint_dir, {
                        "params": self.net.state_dict(),
                        "opt_state": opt.state_dict(), "epoch": e,
                        **({"rng": gen.get_state()} if gen is not None
                           else {})})
        return losses

    def _trained(self, losses):
        self.losses = torch.cat(losses) if losses else torch.zeros(
            0, device=self.device)
        self._embeddings = None
        return self

    def evaluate(self):
        """The full-batch loss components on the current parameters."""
        with torch.no_grad(), f32_matmul():
            loss, (l2nd, l1st) = sdne_loss(self.net, self.A, self.L,
                                           **self._consts())
        return {"loss": float(loss), "l_2nd": float(l2nd),
                "l_1st": float(l1st)}

    def _encode_table(self):
        """Encoder output for all nodes: the sparse first layer when the
        dense adjacency was never built (after train_sparse)."""
        with torch.no_grad(), f32_matmul():
            if self._A is not None:
                return self.net.encode(self._A)
            return self.net.encode_sparse(*self.sparse_inputs()[:2])

    def get_embeddings(self) -> Dict:
        """{node_name: np.ndarray[hidden_size[-1]]}, the reference's
        type."""
        if self._embeddings is None:
            y = self._encode_table().cpu().numpy()
            names = self.graph.vocab.idx2node
            self._embeddings = {names[i]: y[i]
                                for i in range(self.graph.num_nodes)}
        return self._embeddings

    @property
    def embedding_table(self) -> torch.Tensor:
        """The [V, hidden_size[-1]] encoder output on the model's device."""
        return self._encode_table()

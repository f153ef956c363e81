"""What DeepWalk and Node2Vec share: a walk corpus, then skip-gram (SGNS
or hs=1 by the configuration's `objective`). `deepwalk.py` and
`node2vec.py` add the walk.

Work, from the cell's sizes alone: nominal skip-gram pairs, model FLOPs,
and the bytes the walk and the trainer layers must move. Whatever
implements a layer, these stay the same, so a fused or replaced kernel
leaves the rooflines standing.

The check of a sampled fit:
- `bad_hops`: its corpus against the graph (`reference.walks.bad_hops`),
  limit 0;
- `law_z`: sampled hops of its corpus against the walk's law
  (`reference.walks.law_z`);
- `table_err`: its trained tables against the plain reference's fit over
  the same corpus from the same seed (`reference.train`): the larger over
  the two tables of ||program - reference|| / ||reference - start||, the
  Frobenius norms, `start` the reference's initial table (zeros for the
  output and tree tables). A fit that trained nothing reads 1.
"""

from __future__ import annotations

import numpy as np
import torch

from gebench.reference import train as ref_train
from gebench.reference import walks as ref_walks

CHECKS = ("bad_hops", "law_z", "table_err")
LAW_HOPS = 20000  # first hops, and as many later hops, a fit's law_z reads


def walk_args(cfg, seed, device):
    """The constructor's arguments every walk model takes."""
    return dict(walk_length=cfg["walk_length"], num_walks=cfg["num_walks"],
                seed=seed, device=device)


def train(model, cfg):
    kw = dict(embed_size=cfg["embed_size"], window_size=cfg["window_size"],
              iter=cfg["iter"], alpha=cfg["alpha"],
              min_alpha=cfg["min_alpha"], sample=cfg["sample"])
    if cfg["objective"] == "hs":
        kw["hs"] = 1
    else:
        kw["negative"] = cfg["negative"]
    model.train(**kw)


def outputs(model):
    """(corpus, input table, output or tree table)."""
    return model.walks, model.w_in, model.w_out


def run_constants(cfg, row_ptr, col):
    """hs=1: the mean Huffman code length over the degrees, which its
    FLOPs count."""
    if cfg["objective"] != "hs":
        return {}
    return {"mean_code_length": mean_code_length(
        np.diff(row_ptr.cpu().numpy()))}


def pairs_per_walk(L: int, w: int) -> float:
    """Expected (center, context) pairs of one walk of L tokens under the
    reduced window b ~ U{1..w}: sum over d = 1..w of 2 (L - d) P(b >= d),
    P(b >= d) = (w - d + 1) / w."""
    return sum(2.0 * max(L - d, 0) * (w - d + 1) / w for d in range(1, w + 1))


def nominal_pairs(cfg: dict, V: int, E: int) -> float:
    """Pairs of one fit: num_walks * V walks, each epoch once."""
    return (cfg["num_walks"] * V * cfg["iter"]
            * pairs_per_walk(cfg["walk_length"], cfg["window_size"]))


def model_flops(cfg: dict, V: int, E: int, constants: dict):
    """Model FLOPs of a fit: a dot product, the gradient of each row and
    its update, 6 D a scored row, for each nominal pair; SGNS scores 1 +
    negative rows, hs=1 the pair's Huffman path (mean code length, None
    without it)."""
    D = cfg["embed_size"]
    if cfg["objective"] == "hs":
        if "mean_code_length" not in constants:
            return None
        rows = constants["mean_code_length"]
    else:
        rows = 1 + cfg["negative"]
    return 6.0 * D * rows * nominal_pairs(cfg, V, E)


def train_bytes(cfg: dict, V: int, E: int) -> float:
    """Both tables ([V, D] input rows and [V, D] output or V - 1 inner-node
    rows, float32) read once and written once an epoch."""
    D = cfg["embed_size"]
    rows = V + (V - 1 if cfg["objective"] == "hs" else V)
    return 2.0 * rows * D * 4 * cfg["iter"]


def walk_bytes(cfg: dict, V: int, E: int) -> float:
    """The CSR read once (int32 row pointers and ids; the graph is
    unweighted, so it carries all a sampler needs) and the int32 corpus
    written once."""
    corpus = cfg["num_walks"] * V * cfg["walk_length"] * 4
    return 4.0 * (V + 1) + 4.0 * E + corpus


def mean_code_length(degrees: np.ndarray) -> float:
    """Mean Huffman code length under the uniform walk's stationary law
    (node weight = degree), the code built by the reference's own tree."""
    from gebench.reference.tables import huffman_code_lengths

    w = np.asarray(degrees, np.float64)
    lengths = huffman_code_lengths(np.maximum(w, 1e-9))
    return float((lengths * w).sum() / w.sum())


def schedule(cfg: dict) -> ref_train.Schedule:
    s = cfg["schedule"]
    return ref_train.Schedule(
        block_walks=s["block_walks"], chunk_steps=s["chunk_steps"],
        update_cap=s["update_cap"], alpha=cfg["alpha"],
        min_alpha=cfg["min_alpha"], sample=cfg["sample"],
        k_shared=s.get("k_shared", 64),
        neg_share_packs=s.get("neg_share_packs", 4),
        upscale=s.get("upscale", True))


def reference_fit(walks, V, cfg, fit_seed, matmul="exact", drop_half=False):
    """(input table, output or tree table, initial input table) of the
    reference's fit over `walks`; the program's trainer is seeded with the
    model's seed + 1."""
    kw = dict(D=cfg["embed_size"], window=cfg["window_size"],
              epochs=cfg["iter"], seed=fit_seed + 1, sched=schedule(cfg),
              matmul=matmul, drop_half=drop_half)
    if cfg["objective"] == "hs":
        return ref_train.hs_fit(walks, V, **kw)
    return ref_train.sgns_fit(walks, V, negative=cfg["negative"], **kw)


def table_err(w_in, w_out, ref):
    """max over the two tables of ||P - R|| / ||R - R0||."""
    r_in, r_out, r_in0 = ref
    errs = []
    for p, r, r0 in ((w_in, r_in, r_in0), (w_out, r_out, None)):
        p = p.to(r.device, torch.float32)
        if p.shape != r.shape:
            return float("inf")
        moved = torch.linalg.vector_norm((r - r0) if r0 is not None else r)
        errs.append(float(torch.linalg.vector_norm(p - r)
                          / moved.clamp(min=1e-30)))
    return max(errs)


def law_z(walks, csr, cfg, law_seed):
    gen = torch.Generator(device=walks.device)
    gen.manual_seed(law_seed)
    return ref_walks.law_z(walks, csr, cfg["walk"], cfg.get("p", 1.0),
                           cfg.get("q", 1.0), LAW_HOPS, gen)


def judge(outputs, fit_seed, cfg, csr: ref_walks.Csr, law_seed):
    """{name: value} of one fit's outputs."""
    walks, w_in, w_out = outputs
    V = csr.V
    out = {"bad_hops": ref_walks.bad_hops(walks, csr, cfg["num_walks"],
                                          cfg["walk_length"])}
    out["law_z"] = (float("inf") if out["bad_hops"]
                    else law_z(walks, csr, cfg, law_seed))
    if walks.numel() and int(walks.min()) >= 0 and int(walks.max()) < V:
        ref = reference_fit(walks, V, cfg, fit_seed)
        out["table_err"] = table_err(w_in, w_out, ref)
        del ref
    else:
        out["table_err"] = float("inf")
    return out


def altered(walks, csr):
    """The corpus with one token changed to a node its predecessor has no
    edge to."""
    w = walks.clone()
    a = torch.tensor([int(w[0, 4])], device=w.device)
    for b in range(csr.V):
        if b != int(a) and int(csr.count(a, a * 0 + b)[0]) == 0:
            w[0, 5] = b
            return w
    raise ValueError("a node with an edge to every other")


def controls(outputs, fit_seed, cfg, csr, law_seed, graph, device):
    """(kind, {name: value}) on the fit's corpus:
    - the control: the reference in TF32 in the program's place, its
      tables against the float32 reference's (`table_err`);
    - half of every step's walks left out, in the reference (`table_err`);
    - the state left unchanged (`table_err`, 1 by its definition);
    - a token altered where the walk produced it (`bad_hops`);
    - the other walk's law in the corpus' place (`law_z`): uniform walks
      judged as (p,q) ones, or (p,q) walks (p = 0.25, q = 4) as uniform
      ones."""
    from graphembedding_tpu_torch import DeepWalk, Node2Vec

    walks = outputs[0]
    ref = reference_fit(walks, csr.V, cfg, fit_seed)
    for kind, kw in (("control_tf32", dict(matmul="tf32")),
                     ("fault_half_batch", dict(drop_half=True))):
        other = reference_fit(walks, csr.V, cfg, fit_seed, **kw)
        yield kind, {"table_err": table_err(other[0], other[1], ref)}
        del other
    yield "fault_state_unchanged", {"table_err": table_err(
        ref[2], torch.zeros_like(ref[1]), ref)}
    del ref
    yield "fault_token_altered", {"bad_hops": ref_walks.bad_hops(
        altered(walks, csr), csr, cfg["num_walks"], cfg["walk_length"])}
    kw = walk_args(cfg, fit_seed, device)
    wrong = (DeepWalk(graph, **kw) if cfg["walk"] == "node2vec"
             else Node2Vec(graph, p=0.25, q=4, **kw)).walks
    graph.free_device()
    yield "fault_wrong_law", {"law_z": law_z(wrong, csr, cfg, law_seed)}

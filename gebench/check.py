"""The comparison that decides a run's `correct`.

A sampled fit of the window is judged by what it produced, after the
window has closed:
- `bad_hops`: its corpus against the graph (`reference.walks.bad_hops`),
  limit 0;
- `law_z`: sampled hops of its corpus against the walk's law
  (`reference.walks.law_z`);
- `table_err`: its trained tables against the plain reference's fit over
  the same corpus from the same seed (`reference.train`): the larger over
  the two tables of ||program - reference|| / ||reference - start||, the
  Frobenius norms, `start` the reference's initial table (zeros for the
  output and tree tables). A fit that trained nothing reads 1.
Each limit is in the cell's file (`cells/<workload>.json`), set from the
readings in PERF.md.
"""

from __future__ import annotations

import numpy as np
import torch

from gebench.reference import train as ref_train
from gebench.reference import walks as ref_walks

NAMES = ("bad_hops", "law_z", "table_err")
LAW_HOPS = 20000  # first hops, and as many later hops, a fit's law_z reads


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


def judge(walks, w_in, w_out, fit_seed, cfg, csr: ref_walks.Csr,
          law_seed):
    """{name: value} of one fit's outputs."""
    V = csr.V
    out = {"bad_hops": ref_walks.bad_hops(walks, csr, cfg["num_walks"],
                                          cfg["walk_length"])}
    gen = torch.Generator(device=walks.device)
    gen.manual_seed(law_seed)
    out["law_z"] = (float("inf") if out["bad_hops"] else ref_walks.law_z(
        walks, csr, cfg["walk"], cfg.get("p", 1.0), cfg.get("q", 1.0),
        LAW_HOPS, gen))
    if walks.numel() and int(walks.min()) >= 0 and int(walks.max()) < V:
        ref = reference_fit(walks, V, cfg, fit_seed)
        out["table_err"] = table_err(w_in, w_out, ref)
        del ref
    else:
        out["table_err"] = float("inf")
    return out


def verdict(values: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every value at or under its
    limit (a NaN fails)."""
    shown = {}
    ok = True
    for name in NAMES:
        v = values.get(name)
        lim = limits[name]
        good = v is not None and bool(np.isfinite(v)) and v <= lim
        ok = ok and good
        # a value that is not finite shows as null: JSON has no infinity
        shown[name] = {"value": float(v) if good or (
            v is not None and np.isfinite(v)) else None, "limit": lim}
    return ok, shown

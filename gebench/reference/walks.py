"""Checks of a walk corpus against the graph and the walk's law, in plain
PyTorch on the corpus' device.

`bad_hops` counts what no walk of the law can produce: a corpus of the
wrong shape, a node that does not start exactly `num_walks` walks, a pad
(the graphs here have no dead ends) and a hop along no edge. `law_z`
holds sampled hops against the probabilities the law gives them, each
statistic as a z-score:
- first-order (uniform) hops: the position of the chosen entry in the
  current node's row, uniform over [0, 1) with mean 1/2;
- second-order hops (t -> v -> x): how often x returns to t, and how
  often x is a neighbour of t, against their expectations under
  node2vec's weights 1/p (return), 1 (a neighbour of t), 1/q (farther)
  on the entries of v's row.
"""

from __future__ import annotations

import math

import torch


class Csr:
    """A sorted CSR (row_ptr int64 [V + 1], col int64 [E]) with the key
    src * V + dst of every entry, for membership by binary search."""

    def __init__(self, row_ptr, col):
        self.row_ptr = row_ptr.long()
        self.col = col.long()
        self.V = row_ptr.shape[0] - 1
        self.deg = self.row_ptr[1:] - self.row_ptr[:-1]
        src = torch.repeat_interleave(
            torch.arange(self.V, device=col.device), self.deg)
        self.keys = src * self.V + self.col

    def count(self, a, b):
        """How many entries of row a hold b (elementwise)."""
        k = a.long() * self.V + b.long()
        lo = torch.searchsorted(self.keys, k, right=False)
        hi = torch.searchsorted(self.keys, k, right=True)
        return hi - lo

    def first(self, a, b):
        """Offset of b's first entry within row a (b in row a)."""
        k = a.long() * self.V + b.long()
        return torch.searchsorted(self.keys, k) - self.row_ptr[a.long()]


def bad_hops(walks, csr: Csr, num_walks, walk_length):
    """Count of the corpus' faults (see the module doc); 0 when sound."""
    if walks.dim() != 2 or tuple(walks.shape) != (num_walks * csr.V,
                                                  walk_length):
        return max(walks.numel(), 1)
    bad = int((walks < 0).sum())
    starts = torch.bincount(walks[:, 0].long().clamp(min=0),
                            minlength=csr.V)
    bad += int((starts != num_walks).sum())
    a = walks[:, :-1].reshape(-1)
    b = walks[:, 1:].reshape(-1)
    ok = (a >= 0) & (b >= 0) & (a < csr.V) & (b < csr.V)
    bad += int(ok.numel() - int(ok.sum()))
    # in slices: a corpus of millions of hops needs no key array that big
    step = 1 << 24
    for i in range(0, a.numel(), step):
        sa, sb = a[i:i + step].clamp(min=0), b[i:i + step].clamp(min=0)
        bad += int(((csr.count(sa, sb) == 0) & ok[i:i + step]).sum())
    return bad


def _z(obs, expect, var):
    return float((obs - expect) / math.sqrt(max(float(var), 1e-12)))


def first_order_z(cur, nxt, csr: Csr):
    """z of the mean position (k + m / 2) / d of the chosen node's entries
    (offset k, multiplicity m) in cur's row of d entries: 1/2 under a
    uniform choice of entry; variance at most 1/12 a hop."""
    d = csr.deg[cur.long()].double()
    k = csr.first(cur, nxt).double()
    m = csr.count(cur, nxt).double()
    u = (k + m / 2) / d
    return _z(u.sum(), 0.5 * u.numel(), u.numel() / 12.0)


def uniform_return_z(prev, cur, nxt, csr: Csr):
    """z of the count of returns (nxt == prev) against sum m_prev / d."""
    d = csr.deg[cur.long()].double()
    p = csr.count(cur, prev).double() / d
    obs = (nxt == prev).double().sum()
    return _z(obs, p.sum(), (p * (1 - p)).sum())


def node2vec_z(prev, cur, nxt, csr: Csr, p, q):
    """(z of returns, z of moves to a neighbour of prev): node2vec's
    weight of an entry x of cur's row is 1/p for x == prev, 1 for x a
    neighbour of prev, 1/q otherwise."""
    n = cur.numel()
    start = csr.row_ptr[cur.long()]
    d = csr.deg[cur.long()]
    hop = torch.repeat_interleave(torch.arange(n, device=cur.device), d)
    first = torch.repeat_interleave(start - torch.cumsum(d, 0) + d, d)
    entry = csr.col[first + torch.arange(hop.numel(), device=cur.device)]
    t = prev.long()[hop]
    back = (entry == t).double()
    near = ((csr.count(t, entry) > 0) & (entry != t)).double()
    m_ret = torch.zeros(n, dtype=torch.float64, device=cur.device)
    m_near = torch.zeros_like(m_ret)
    m_ret.index_add_(0, hop, back)
    m_near.index_add_(0, hop, near)
    far = d.double() - m_ret - m_near
    z = m_ret / p + m_near + far / q
    p_ret, p_near = m_ret / p / z, m_near / z
    ret = (nxt == prev).double()
    to_near = ((csr.count(prev, nxt) > 0) & (nxt != prev)).double()
    return (_z(ret.sum(), p_ret.sum(), (p_ret * (1 - p_ret)).sum()),
            _z(to_near.sum(), p_near.sum(), (p_near * (1 - p_near)).sum()))


def law_z(walks, csr: Csr, kind, p, q, n_hops, generator):
    """Largest |z| of the law's statistics over n_hops first hops and
    n_hops later hops, each drawn without replacement with `generator`
    (a hop counted twice would count its deviation twice)."""
    NW, L = walks.shape
    dev = walks.device
    w = torch.randperm(NW, generator=generator, device=dev)[:n_hops]
    first = walks[w, 0], walks[w, 1]
    zs = [first_order_z(*first, csr)]
    if L >= 3:
        h = torch.randperm(NW * (L - 2), generator=generator,
                           device=dev)[:n_hops]
        w, j = h // (L - 2), 2 + h % (L - 2)
        prev, cur, nxt = walks[w, j - 2], walks[w, j - 1], walks[w, j]
        if kind == "uniform":
            zs += [first_order_z(cur, nxt, csr),
                   uniform_return_z(prev, cur, nxt, csr)]
        else:
            zs += list(node2vec_z(prev, cur, nxt, csr, p, q))
    return max(abs(z) for z in zs)

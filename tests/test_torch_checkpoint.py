"""Port's checkpoint/resume and metrics against graphembedding_tpu.

`utils/checkpoint.py` round trips and refusals; every trainer of the port
interrupted and resumed equals its uninterrupted train bit for bit; the
resumed SGNS and HS fits train the steps the JAX package's trainers train
from the same resume point and cadence, and log the same metrics lines.
"""

import json
import os

import numpy as np
import pytest
import torch

from graphembedding_tpu.train import hsoftmax as jhs
from graphembedding_tpu.train import skipgram as jsg
from graphembedding_tpu_torch import LINE, SDNE, DeepWalk, Node2Vec
from graphembedding_tpu_torch.data import datasets as tds
from graphembedding_tpu_torch.models import line as tline
from graphembedding_tpu_torch.models import sdne as tsdne
from graphembedding_tpu_torch.train import hsoftmax as ths
from graphembedding_tpu_torch.train import skipgram as tsg
from graphembedding_tpu_torch.utils import checkpoint as ck
from graphembedding_tpu_torch.utils.metrics import MetricsLogger


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads for this file's CPU training (several test
    processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class Interrupt(Exception):
    pass


class StopAt(MetricsLogger):
    """Records each line's (kind, epoch, step) and raises on line `n`
    (after the trainer logged it, before it saved that chunk)."""

    def __init__(self, n=None):
        super().__init__(quiet=True)
        self.n = n
        self.lines = []

    def log(self, **fields):
        super().log(**fields)
        self.lines.append((fields["kind"], fields["epoch"], fields["step"]))
        if len(self.lines) == self.n:
            raise Interrupt


def corpus(V=30, NW=128, L=6, seed=0):
    return np.random.default_rng(seed).integers(0, V, (NW, L)).astype(
        np.int32)


# 128 walks of 6: 21-walk blocks, 6 blocks an epoch, 3 chunks of 2 steps
SGNS_KW = dict(embed_size=8, window=2, epochs=3, block_walks=32,
               k_shared=8, chunk_steps=2)
HS_KW = dict(embed_size=8, window=2, epochs=3, block_walks=32,
             chunk_steps=2)


def port_fit(kind, walks, **kw):
    w = torch.from_numpy(walks)
    if kind == "sgns":
        w_cat, losses = tsg.SkipGramTrainer(tsg.SkipGramConfig(
            **SGNS_KW)).fit(w, 30, **kw)
        return (w_cat,), losses
    w_in, w_tree, losses = ths.HSTrainer(**HS_KW).fit(w, 30, **kw)
    return (w_in, w_tree), losses


def jax_fit(kind, walks, **kw):
    if kind == "sgns":
        return jsg.SkipGramTrainer(jsg.SkipGramConfig(**SGNS_KW)).fit(
            walks, 30, **kw)[2]
    return jhs.HSTrainer(**HS_KW).fit(walks, 30, **kw)[2]


def test_state_round_trip(tmp_path):
    gen = torch.Generator().manual_seed(5)
    torch.rand(3, generator=gen)
    table = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    state = {"w": table[:, :3], "step": 7, "lr": 0.5, "none": None,
             "rng": gen.get_state(),
             "nested": {"a": [torch.ones(2), 3], "b": (1, 2)}}
    ck.save_state(str(tmp_path), state)
    got = ck.load_state(str(tmp_path))
    assert torch.equal(got["w"], table[:, :3]) and got["w"].is_contiguous()
    # a column slice saves its own rows, not the wider table's storage
    assert got["w"].untyped_storage().nbytes() == 4 * 4 * 3
    assert (got["step"], got["lr"], got["none"]) == (7, 0.5, None)
    assert got["nested"]["b"] == (1, 2) and got["nested"]["a"][1] == 3
    assert torch.equal(got["nested"]["a"][0], torch.ones(2))
    again = torch.Generator()
    again.set_state(got["rng"])
    assert torch.equal(torch.rand(4, generator=again),
                       torch.rand(4, generator=gen))
    assert os.listdir(tmp_path) == [ck.STATE_FILE]


def test_failed_save_keeps_the_previous_checkpoint(tmp_path):
    ck.save_state(str(tmp_path), {"step": 1})
    with pytest.raises(Exception):
        ck.save_state(str(tmp_path), {"step": 2, "bad": lambda: None})
    assert ck.load_state(str(tmp_path)) == {"step": 1}
    assert os.listdir(tmp_path) == [ck.STATE_FILE]


def test_try_restore_refuses_missing_keys(tmp_path):
    assert ck.try_restore(str(tmp_path / "absent"), ("w",)) is None
    assert ck.try_restore(str(tmp_path), ("w",)) is None  # empty dir
    ck.save_state(str(tmp_path), {"w_in": torch.zeros(2), "step": 3})
    with pytest.raises(ValueError, match="lacks keys"):
        ck.try_restore(str(tmp_path), ("w_in", "w_tree", "step"))
    assert ck.try_restore(str(tmp_path), ("w_in", "step"))["step"] == 3
    # an HS fit refuses an SGNS checkpoint rather than start over
    tsg.SkipGramTrainer(tsg.SkipGramConfig(**SGNS_KW)).fit(
        torch.from_numpy(corpus()), 30, checkpoint_dir=str(tmp_path / "s"),
        checkpoint_every=1)
    with pytest.raises(ValueError, match="lacks keys"):
        ths.HSTrainer(**HS_KW).fit(torch.from_numpy(corpus()), 30,
                                   checkpoint_dir=str(tmp_path / "s"))


def test_maybe_save_cadence(tmp_path):
    saved = [n for n in range(1, 8)
             if ck.maybe_save(str(tmp_path), 3, n, lambda: {"n": n})]
    assert saved == [3, 6]
    assert ck.load_state(str(tmp_path)) == {"n": 6}
    assert not ck.maybe_save(None, 3, 3, lambda: {})
    assert not ck.maybe_save(str(tmp_path), 0, 3, lambda: {})


def test_artifact_cache_round_trip(tmp_path):
    key = ck.content_key(np.arange(5), extra="v1")
    assert ck.load_artifact(str(tmp_path), key) is None
    ck.cache_artifact(str(tmp_path), key, {"x": [1, 2, 3]})
    assert ck.load_artifact(str(tmp_path), key) == {"x": [1, 2, 3]}
    assert ck.content_key(np.arange(6), extra="v1") != key
    from graphembedding_tpu.utils import checkpoint as jck

    assert key == jck.content_key(np.arange(5), extra="v1")


@pytest.mark.parametrize("kind", ["sgns", "hs"])
@pytest.mark.parametrize("stop", [2, 3, 7, 9])
def test_trainer_resume_bit_identical(tmp_path, kind, stop):
    """Interrupted after chunk `stop` of 9 (3 an epoch, a checkpoint every
    2), then resumed: the same tables, and the losses of the chunks after
    the last checkpoint. Stop 2 finds none; 3 resumes inside epoch 0, 7 at
    the start of epoch 2, 9 inside epoch 2."""
    walks = corpus()
    want_tabs, want_losses = port_fit(kind, walks)
    d = str(tmp_path)
    with pytest.raises(Interrupt):
        port_fit(kind, walks, checkpoint_dir=d, checkpoint_every=2,
                 metrics=StopAt(stop))
    saved = (stop - 1) // 2 * 2
    tabs, losses = port_fit(kind, walks, checkpoint_dir=d,
                            checkpoint_every=2)
    assert all(torch.equal(a, b) for a, b in zip(tabs, want_tabs))
    assert torch.equal(losses, want_losses[2 * saved:])


@pytest.mark.parametrize("kind", ["sgns", "hs"])
def test_fully_resumed_fit_returns_no_losses(tmp_path, kind):
    walks = corpus()
    tabs, losses = port_fit(kind, walks, checkpoint_dir=str(tmp_path),
                            checkpoint_every=1)
    assert losses.shape == (18,)
    again, more = port_fit(kind, walks, checkpoint_dir=str(tmp_path),
                           checkpoint_every=1)
    assert more.shape == (0,)
    assert all(torch.equal(a, b) for a, b in zip(again, tabs))


@pytest.mark.parametrize("kind", ["sgns", "hs"])
def test_resume_and_metrics_equal_jax(tmp_path, kind):
    """From the same interrupt (after chunk 5, saved every 2) both
    packages resume at step 8 and train the same steps; every metrics
    line carries the same kind, epoch and step."""
    walks = corpus(seed=1)
    lines = {}
    for pkg, fit in (("jax", jax_fit),
                     ("port", lambda *a, **k: port_fit(*a, **k)[1])):
        full = StopAt()
        n_full = fit(kind, walks, metrics=full).shape[0]
        d = str(tmp_path / pkg)
        stopped = StopAt(5)
        with pytest.raises(Interrupt):
            fit(kind, walks, checkpoint_dir=d, checkpoint_every=2,
                metrics=stopped)
        resumed = StopAt()
        n_resumed = fit(kind, walks, checkpoint_dir=d, checkpoint_every=2,
                        metrics=resumed).shape[0]
        lines[pkg] = (n_full, full.lines, stopped.lines, n_resumed,
                      resumed.lines)
    assert lines["port"] == lines["jax"]
    n_full, full, _, n_resumed, resumed = lines["port"]
    assert (n_full, n_resumed) == (18, 10)
    assert full[0] == (f"{kind}_chunk", 0, 2) and full[-1][1:] == (2, 18)
    assert resumed[0][1:] == (1, 10)


def test_metrics_lines_and_tables_unchanged(tmp_path):
    """A MetricsLogger writes one JSONL line a chunk and changes no bit of
    the train."""
    walks = torch.from_numpy(corpus())
    cfg = tsg.SkipGramConfig(**SGNS_KW)
    want, _ = tsg.SkipGramTrainer(cfg).fit(walks, 30)
    path = str(tmp_path / "m.jsonl")
    with MetricsLogger(path, quiet=True) as m:
        got, losses = tsg.SkipGramTrainer(cfg).fit(walks, 30, metrics=m)
    assert torch.equal(got, want)
    recs = [json.loads(x) for x in open(path).read().splitlines()]
    assert len(recs) == 9 and recs[-1]["step"] == 18
    assert recs[0]["loss"] == round(float(losses[:2].mean()), 5)
    assert {"kind", "epoch", "step", "loss", "t"} <= set(recs[0])


def small_graph():
    return tds.synthetic_wiki(num_nodes=120, num_classes=3, seed=1).graph


@pytest.mark.parametrize("order", ["first", "second", "all"])
def test_line_resume_bit_identical(tmp_path, order, monkeypatch):
    """LINE interrupted inside its last order's second chunk (saved every
    chunk), then resumed: the tables of an uninterrupted train."""
    g = small_graph()
    kw = dict(batch_size=64, epochs=100)  # 3 chunks an order
    want = LINE(g, embedding_size=8, order=order, device="cpu")
    want.train(**kw)
    chunk = tline.line_train_chunk
    stop = 5 if order == "all" else 2
    calls = []

    def interrupted(*a, **k):
        calls.append(1)
        if len(calls) == stop:
            raise Interrupt
        return chunk(*a, **k)

    m = LINE(g, embedding_size=8, order=order, device="cpu")
    monkeypatch.setattr(tline, "line_train_chunk", interrupted)
    with pytest.raises(Interrupt):
        m.train(checkpoint_dir=str(tmp_path), checkpoint_every=1, **kw)
    monkeypatch.setattr(tline, "line_train_chunk", chunk)
    subdirs = {"first": ["first"], "second": ["second"],
               "all": ["first", "second"]}[order]
    assert sorted(os.listdir(tmp_path)) == subdirs
    m = LINE(g, embedding_size=8, order=order, device="cpu")
    m.train(checkpoint_dir=str(tmp_path), checkpoint_every=1, **kw)
    assert torch.equal(m.embedding_table, want.embedding_table)
    if order != "first":
        assert torch.equal(m.context_emb, want.context_emb)
    # the resumed order trained its last two chunks
    assert m.losses.shape == (2 * tline.CHUNK_STEPS,)
    assert torch.equal(m.losses, want.losses[tline.CHUNK_STEPS:])
    if order == "first":
        assert ck.load_state(str(tmp_path / "first"))["ctx"] is None
    # fully resumed: no new losses, nothing moves
    m.train(checkpoint_dir=str(tmp_path), checkpoint_every=1, **kw)
    assert m.losses.shape == (0,) and m.sampled_edges == 0
    assert torch.equal(m.embedding_table, want.embedding_table)


SDNE_TRAINS = {
    "full": (lambda m, **k: m.train(batch_size=500, epochs=9, **k), 1),
    "minibatch": (lambda m, **k: m.train(batch_size=50, epochs=9, **k), 3),
    "sparse": (lambda m, **k: m.train_sparse(epochs=9, row_chunk=50, **k),
               1),
}


@pytest.mark.parametrize("mode", list(SDNE_TRAINS))
def test_sdne_resume_bit_identical(tmp_path, mode, monkeypatch):
    """Each SDNE trainer interrupted in epoch 6 (saved every 3 epochs),
    then resumed into a fresh model and a fresh Adam: the parameters of
    an uninterrupted train, which are also those of a train without
    checkpoints (the minibatch permutations continue one stream)."""
    g = small_graph()
    train, steps_an_epoch = SDNE_TRAINS[mode]

    def params(m):
        return [p.detach().clone() for p in m.net.parameters()]

    plain = SDNE(g, hidden_size=[16, 8], device="cpu")
    train(plain)
    full = SDNE(g, hidden_size=[16, 8], device="cpu")
    train(full, checkpoint_dir=str(tmp_path / "full"), checkpoint_every=3)
    assert all(torch.equal(a, b) for a, b in zip(params(full),
                                                 params(plain)))
    assert torch.equal(full.losses, plain.losses)

    step = tsdne.adam_step
    calls = []

    def interrupted(*a, **k):
        calls.append(1)
        if len(calls) == 5 * steps_an_epoch + 1:
            raise Interrupt
        return step(*a, **k)

    d = str(tmp_path / "cut")
    m = SDNE(g, hidden_size=[16, 8], device="cpu")
    monkeypatch.setattr(tsdne, "adam_step", interrupted)
    with pytest.raises(Interrupt):
        train(m, checkpoint_dir=d, checkpoint_every=3)
    monkeypatch.setattr(tsdne, "adam_step", step)
    assert ck.load_state(d)["epoch"] == 3
    m = SDNE(g, hidden_size=[16, 8], device="cpu")
    train(m, checkpoint_dir=d, checkpoint_every=3)
    assert all(torch.equal(a, b) for a, b in zip(params(m), params(plain)))
    assert torch.equal(m.losses, plain.losses[3 * steps_an_epoch:])
    # fully resumed: no epoch left
    train(m, checkpoint_dir=d, checkpoint_every=3)
    assert m.losses.shape == (0,)
    assert all(torch.equal(a, b) for a, b in zip(params(m), params(plain)))


def test_sdne_refuses_a_checkpoint_of_torch_optim_adam(tmp_path):
    """A checkpoint whose opt_state is torch.optim.Adam's (what SDNE saved
    before its Adam was written out) is refused, not read wrongly."""
    g = small_graph()
    m = SDNE(g, hidden_size=[16, 8], device="cpu")
    opt = torch.optim.Adam(m.net.parameters(), lr=1e-3)
    ck.save_state(str(tmp_path), {"params": m.net.state_dict(),
                                  "opt_state": opt.state_dict(),
                                  "epoch": 3})
    with pytest.raises(ValueError, match="opt_state/count"):
        m.train(batch_size=500, epochs=9, checkpoint_dir=str(tmp_path),
                checkpoint_every=3)


def test_model_entry_points_pass_checkpoints_through(tmp_path):
    """DeepWalk and Node2Vec (SGNS and hs=1) checkpoint through train(),
    and a second train from the same directory resumes past the end."""
    g = tds.synthetic_wiki(num_nodes=60, num_classes=3, seed=3).graph
    for cls, hs in ((DeepWalk, 0), (DeepWalk, 1), (Node2Vec, 0)):
        d = str(tmp_path / f"{cls.__name__}{hs}")
        kw = dict(embed_size=8, window_size=2, iter=2, hs=hs,
                  checkpoint_dir=d, checkpoint_every=1)
        m = cls(g, walk_length=5, num_walks=4, device="cpu")
        m.train(**kw)
        assert ck.load_state(d)["step"] == m.losses.shape[0] > 0
        table = m.w_in.clone()
        m.train(**kw)
        assert m.losses.shape == (0,) and torch.equal(m.w_in, table)

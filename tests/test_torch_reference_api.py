"""The port's public signatures against graphembedding_tpu's.

The counterpart of tests/test_reference_api.py: instead of pinning each
default to its reference value, it holds every constructor and `train`
of the five models, the two walker classes (and their `simulate_walks`),
`Graph` and `Classifier` to the JAX package's `inspect.signature`:
the same parameters in the same order, of the same kinds, with the same
defaults. The one difference allowed is the port's `device=`, which
defaults to "cuda" (the card; the CPU only when asked for). A later drift
in either package fails here.
"""

import inspect

import pytest

import graphembedding_tpu as jpkg
import graphembedding_tpu_torch as tpkg
from graphembedding_tpu import walker as jwalker
from graphembedding_tpu.eval import classify as jclassify
from graphembedding_tpu.graph import Graph as JGraph
from graphembedding_tpu_torch import walker as twalker
from graphembedding_tpu_torch.eval import classify as tclassify
from graphembedding_tpu_torch.graph import Graph as TGraph

MODELS = ["DeepWalk", "Node2Vec", "LINE", "SDNE", "Struc2Vec"]
PAIRS = {
    **{f"{m}.__init__": (getattr(jpkg, m).__init__, getattr(tpkg, m).__init__)
       for m in MODELS},
    **{f"{m}.train": (getattr(jpkg, m).train, getattr(tpkg, m).train)
       for m in MODELS},
    **{f"{w}.{f}": (getattr(getattr(jwalker, w), f),
                    getattr(getattr(twalker, w), f))
       for w in ("RandomWalker", "BiasedWalker")
       for f in ("__init__", "simulate_walks")},
    "Graph.__init__": (JGraph.__init__, TGraph.__init__),
    "Classifier.__init__": (jclassify.Classifier.__init__,
                            tclassify.Classifier.__init__),
}
# signatures that take the port's device= (default "cuda")
WITH_DEVICE = {f"{m}.__init__" for m in MODELS} | {
    "RandomWalker.__init__", "BiasedWalker.__init__"}


def params(fn):
    return [(name, p.kind, p.default)
            for name, p in inspect.signature(fn).parameters.items()]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_signature_equals_jax(name):
    jfn, tfn = PAIRS[name]
    got = params(tfn)
    device = [p for p in got if p[0] == "device"]
    if name in WITH_DEVICE:
        assert device == [("device", inspect.Parameter.POSITIONAL_OR_KEYWORD,
                           "cuda")], got
    else:
        assert not device, got
    assert [p for p in got if p[0] != "device"] == params(jfn)


@pytest.mark.parametrize("model", ["DeepWalk", "Node2Vec", "Struc2Vec"])
def test_constructors_take_mesh(model):
    """The constructors' mesh= (distributed walks) is ported; DeepWalk's
    walk_exchange= with it."""
    sig = inspect.signature(getattr(tpkg, model).__init__).parameters
    assert sig["mesh"].default is None
    if model == "DeepWalk":
        assert sig["walk_exchange"].default is None

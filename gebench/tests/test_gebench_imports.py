"""What the benchmark loads: never JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
plain reference nothing of the port."""

import os
import subprocess
import sys
import textwrap

from conftest import ROOT
from gebench import harness


def loaded_after(code):
    """Top-level module names loaded by a fresh interpreter running
    `code` from the checkout's root."""
    prog = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        {textwrap.indent(textwrap.dedent(code), '        ').strip()}
        print(' '.join(sorted({{m.split('.')[0] for m in sys.modules}})))
    """)
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_a_rehearsed_run_loads_no_jax():
    names = loaded_after("""
        sys.path.insert(0, 'gebench/tests')
        from conftest import rehearse
        from gebench import calibrate, check, harness
        r = rehearse('deepwalk-hs.blogcatalog', seconds=0.05)
        for name in ('walk.share', 'mfu', 'train.roofline'):
            harness.metric_reader(name)
    """)
    assert "graphembedding_tpu_torch" in names and "gebench" in names
    assert not names & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    names = loaded_after("""
        from gebench.reference import tables, train, walks
    """)
    assert not names & {"graphembedding_tpu_torch", *harness.FORBIDDEN}
    ref = os.path.join(ROOT, "gebench", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            with open(os.path.join(ref, f)) as fh:
                assert "graphembedding" not in fh.read(), f


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "graphembedding_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "graphembedding_tpu.models", sys)
    assert harness.forbidden_modules() == ["graphembedding_tpu"]

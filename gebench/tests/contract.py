"""What every cell of a checkout's BENCHMARK.json is held to, whatever its
model (`problems`), and what the walk family's cells are held to besides
(`walk_problems`). Each returns a list of problems, empty where the
checkout keeps the contract, so a test can hold a copy of the tree to it
as well as the tree itself. Not on the run path: no run imports this."""

import json
import os
import re

from gebench import harness
from gebench.models import walk_skipgram

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# a model module's functions, as `gebench/models/__init__.py` documents them
INTERFACE = ("build", "train", "run_constants", "nominal_pairs",
             "model_flops", "walk_bytes", "train_bytes", "outputs", "judge")
OPTIONAL = ("controls",)
END_TO_END = ["pairs_per_s", "setup_s"]
WALK_CHECKS = {"bad_hops", "law_z", "table_err"}


def bench(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def module_problems(module):
    """What `module` lacks of the model module's interface."""
    out = [f"no function {n}" for n in INTERFACE
           if not callable(getattr(module, n, None))]
    out += [f"{n} is not a function" for n in OPTIONAL
            if hasattr(module, n) and not callable(getattr(module, n))]
    checks = getattr(module, "CHECKS", None)
    if not (isinstance(checks, tuple) and checks
            and all(isinstance(n, str) and NAME.match(n) for n in checks)):
        out.append(f"CHECKS {checks!r} is not a non-empty tuple of names")
    return out


def problems(root):
    """Each config found by its file with its `source`; each per-layer
    metric with a list of the cells it is read in, each of them real; each
    cell loaded by name, its module whole, its
    traffic, limits, end-to-end metrics and per-layer metrics as
    BENCHMARK.json names them, every reader found."""
    b = bench(root)
    out = []
    for c in b["configs"]:
        path = os.path.join(root, c["file"])
        if not (c["file"].startswith("gebench/") and os.path.exists(path)):
            out.append(f"config {c['name']}: no file {c['file']}")
            continue
        with open(path) as f:
            if json.load(f).get("source") != c["source"]:
                out.append(f"config {c['name']}: its file's source differs")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        if not isinstance(m.get("workloads"), list):
            out.append(f"metric {m['name']}: no list of the cells it is "
                       f"read in")
        elif not set(m["workloads"]) <= cells:
            out.append(f"metric {m['name']}: a cell it lists is not one")
    for w in b["workloads"]:
        name = w["name"]
        try:
            cell = harness.load_cell(root, name)
        except SystemExit as e:
            out.append(f"cell {name}: {e}")
            continue
        out += [f"cell {name}: {p}" for p in module_problems(cell.model)]
        if cell.traffic.get("name") != w["traffic"]:
            out.append(f"cell {name}: traffic file names "
                       f"{cell.traffic.get('name')!r}")
        if set(cell.limits) != set(getattr(cell.model, "CHECKS", ())):
            out.append(f"cell {name}: limits {sorted(cell.limits)} are not "
                       f"its module's CHECKS")
        if cell.end_to_end != END_TO_END:
            out.append(f"cell {name}: end-to-end {cell.end_to_end}")
        want = {m["name"]: m["unit"] for m in b["per_layer"]
                if name in m.get("workloads", ())}
        if cell.per_layer != want:
            out.append(f"cell {name}: per-layer {sorted(cell.per_layer)}, "
                       f"BENCHMARK.json lists {sorted(want)}")
        for metric in cell.per_layer:
            try:
                reader = harness.metric_reader(metric, root)
            except (OSError, AttributeError) as e:
                out.append(f"cell {name}: no reader for {metric}: {e}")
                continue
            if not callable(reader):
                out.append(f"cell {name}: {metric}'s read is not callable")
    return out


def walk_cells(root):
    """The cells whose module judges its fits by `walk_skipgram.judge`."""
    out = []
    for w in bench(root)["workloads"]:
        try:
            model = harness.load_cell(root, w["name"], limits=False).model
        except SystemExit:  # no module: `problems` names it
            continue
        if getattr(model, "judge", None) is walk_skipgram.judge:
            out.append(w["name"])
    return out


def walk_problems(root):
    """The walk family's own: walks of 10, its three checks, an
    objective, and the Huffman build's reader exactly where it is hs=1."""
    out = []
    for name in walk_cells(root):
        cell = harness.load_cell(root, name, limits=False)
        if "objective" not in cell.config:
            out.append(f"cell {name}: no objective")
        if cell.config.get("walk_length") != 10:
            out.append(f"cell {name}: walk_length "
                       f"{cell.config.get('walk_length')}")
        if set(cell.model.CHECKS) != WALK_CHECKS:
            out.append(f"cell {name}: CHECKS {cell.model.CHECKS}")
        if ("train.huffman_ms" in cell.per_layer) != (
                cell.config.get("objective") == "hs"):
            out.append(f"cell {name}: train.huffman_ms listed "
                       f"{'train.huffman_ms' in cell.per_layer}, objective "
                       f"{cell.config.get('objective')!r}")
    return out

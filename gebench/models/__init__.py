"""The benchmark's model modules, one a model family, each found by the
configuration's `model` in lower case (`harness.model_module`):
`<name>.py` here is the fit, its work counts and its check, so a new
model is a new file.

A model module provides:
- `build(graph, cfg, seed, device)`: the fit's object; the harness times
  it as the fit's first span (`walk`); a model without walks builds its
  fit's inputs here;
- `train(fit, cfg)`: the rest of the fit (the `train` span);
- `run_constants(cfg, row_ptr, col)`: {name: value} the readers need from
  the graph, worked out after the window of a traced run (`Run.constants`);
- `nominal_pairs(cfg, V, E)`: the work of one fit by the cell's sizes
  alone, what `pairs_per_s` counts;
- `model_flops(cfg, V, E, constants)`, `walk_bytes(cfg, V, E)`,
  `train_bytes(cfg, V, E)`: a fit's model FLOPs and the bytes the walk
  and trainer layers must move, or None where the layer is absent (its
  readers then read nothing);
- `outputs(fit)`: what the check keeps of the drawn fit; the rest is
  freed before the check;
- `judge(outputs, fit_seed, cfg, csr, law_seed)`: {name: value} of those
  outputs against the plain reference (`gebench/reference/`); `csr` is the
  traffic's graph as `reference.walks.Csr`;
- `CHECKS`: the names `judge` gives, each with a limit in the cell's file;
- optionally `controls(outputs, fit_seed, cfg, csr, law_seed, graph,
  device)`: (kind, {name: value}) of the control and the faults that
  `calibrate.py` reads.
"""

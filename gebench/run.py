"""Run one cell of the benchmark on this machine's card:

    python3 gebench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Prints progress and the check on standard error and, as the last line of
standard output, one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics, or with --trace 1 its per-layer ones),
device, with --trace 1 a breakdown, and last the numbers compared with
their limits. Exits non-zero, printing no result, without a CUDA card,
without the program beside it, or when JAX or the JAX package is loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    # the port, imported before any work: without it there is no run
    import graphembedding_tpu_torch  # noqa: F401

    from gebench import harness, profiling

    cell = harness.load_cell(ROOT, args.workload)
    device, card = profiling.require_card(cell.chips)
    import torch

    kind = torch.cuda.get_device_name(device)
    print(f"card: {card}; cell {cell.name}, seed {args.seed}, "
          f"{args.seconds} s, trace {args.trace}", file=sys.stderr,
          flush=True)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device, kind, STARTED)
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Needs a CUDA card (exits non-zero and prints
no result without one).  Prints progress and the numbers compared on
standard error and, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each compared number
beside its limit.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import bench


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(args, spec: dict, device, t_start: float) -> dict:
    """Drive one cell on ``device`` and return its result line."""
    run = bench.Run(spec=spec, seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), device=device, t_start=t_start)
    bench.driver(spec["mix"]["kind"]).drive(run)
    run.e2e["setup_s"] = run.setup_s
    found = bench.forbidden_modules()
    if found:
        raise bench.NoResult(f"the run loaded {found}")
    return bench.result(run)


def main(argv=None) -> int:
    t_start = bench.process_start()
    args = parse(argv)
    try:
        import torch
    except ImportError as e:
        print(f"portbench: no PyTorch: {e}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is missing: {e}", file=sys.stderr)
        return 2
    try:
        spec = bench.load_cell(args.workload)
    except (bench.NoResult, OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        out = execute(args, spec, device, t_start)
    except bench.NoResult as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 4
    print(f"# card: {bench.power_limit()}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

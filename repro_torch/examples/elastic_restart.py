"""Elastic restart: train on one mesh of processes, crash mid-checkpoint,
restart on a mesh of ANOTHER process count — the port of the JAX package's
``examples/elastic_restart.py``, with one ``torch.distributed`` process per
device of the mesh (gloo: on the card, every process of the mesh shares
it, as the tensor-parallel runs do; on the CPU with ``--device cpu``).

A run sharded over mesh (4, 2) ("data", "model"), 8 processes, checkpoints
steps 10 and 20; a second run on the same mesh dies mid-checkpoint of step
30 (a fault-injected store kills rank 0's async writer after 4 write ops,
before the commit marker lands, and every process raises); a third run on
mesh (2, 4) — another split of the axes — re-loads committed step 20 by
explicit ``restore_from(20)`` onto its own placements and runs to step 40.
The torn step-30 write never entered the step manifest.

Run:  python -m repro_torch.examples.elastic_restart [--save-mesh 4 2]
          [--load-mesh 2 4] [--device cpu]
(``--save-mesh 2 2 --load-mesh 2 1`` restarts 4 processes' checkpoint on 2.)
"""

from __future__ import annotations

import argparse
import functools
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.launch.spawn import run_processes
from repro_torch.train.elastic import Phase, run_phases

REPO = Path(__file__).resolve().parents[2]


def fault_store(kill_after_ops: int):
    """A store constructor that dies after ``kill_after_ops`` mutating ops:
    the port's fault store (``tests/helpers/torch_faultstore.py``), as the
    reference's example takes the reference's."""
    tests = str(REPO / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from helpers.torch_faultstore import FaultStore

    return functools.partial(FaultStore, kill_after_ops=kill_after_ops)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--save-mesh", type=int, nargs=2, default=(4, 2))
    ap.add_argument("--load-mesh", type=int, nargs=2, default=(2, 4))
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "ex_elastic_torch_ckpt"))
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (every process on the card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    t0 = time.perf_counter()
    save, load = tuple(args.save_mesh), tuple(args.load_mesh)
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    d = args.ckpt_dir
    n, m = int(np.prod(save)), int(np.prod(load))

    def report(res, what):
        print(f"mesh {res['mesh']} on {res['world']} processes: {what}; "
              f"param placements {res['example_placements']}")

    print(f"== phase 1: mesh {save}, {n} processes — the N side ==")
    print(f"== phase 2: crash mid-checkpoint of step 30 (fault injection) ==")
    # one set of processes runs phases 1 and 2; the async writer of phase 2
    # dies after 4 write ops of the step-30 save, well before its commit
    # marker, leaving step 20 the last committed step
    first, crashed = run_processes(
        run_phases, n, ([Phase(save, 20, d, expect_start=0,
                               device=args.device),
                         Phase(save, 30, d, expect_start=20,
                               store_factory=fault_store(4),
                               expect_crash=True, device=args.device)],),
        timeout=args.timeout)[0]
    report(first, f"restored step {first['start']}, ran to step 20, "
                  f"last loss {first['history'][-1]['loss']:.4f}")
    report(crashed, f"restored step {crashed['start']}, died "
                    f"mid-checkpoint as injected ({crashed['crash']})")
    print(f"== phase 3: mesh {load}, {m} processes — the M side "
          f"(restart from step 20) ==")
    third = run_processes(
        run_phases, m, ([Phase(load, 40, d, expect_start=20,
                               from_step=20, device=args.device)],),
        timeout=args.timeout)[0][0]
    report(third, f"restored step {third['start']}, ran to step 40, "
                  f"last loss {third['history'][-1]['loss']:.4f}")
    seconds = time.perf_counter() - t0
    print(f"on {args.device}: {seconds:.1f} s")
    print("elastic N-to-M restart after an injected crash OK")
    return {"phases": [first, crashed, third], "seconds": seconds}


if __name__ == "__main__":
    main()

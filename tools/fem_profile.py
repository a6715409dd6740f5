#!/usr/bin/env python3
"""Where the host time of the FE and post-processing paths goes, on the
card's machine, at ``chip_smoke.py``'s sizes.

    python3 tools/fem_profile.py

Profiles with ``cProfile``, one after another:
  * ``distribute`` of ``tri_mesh_fast(512, 512)`` to 8 ranks;
  * ``load_mesh`` of that mesh, saved from 8 ranks, on M = 1 and on M = 3,
    then ``load_function`` of a P4 function on M = 3;
  * one step of the post-processing sweep: ``params/embed`` of smollm-135m
    ([49152, 576] bf16, random from seed 0) and ``params/final_norm``,
    saved from one rank through ``save_torch``, swept onto the card.
For each it prints one JSON line: the wall seconds, the functions of the
port that take the most time including their callees (``cum_s``), and the
functions that take the most time themselves (``self_s``, NumPy's
included).  The engine is host code; the card only receives the results,
so the times are the host's.  Needs one CUDA card, for the sweep's copies.
"""

from __future__ import annotations

import cProfile
import json
import pstats
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
NX = NY = 512
SAVE_RANKS = 8
TOP = 12


def _field(p):
    return np.sin(3 * p[:, 0]) * (2 + np.cos(5 * p[:, 1])) + p[:, 0] * p[:, 1]


def _where(path: str) -> str:
    """A profiled function's file: relative to the checkout inside it."""
    p = Path(path)
    return str(p.relative_to(ROOT)) if p.is_relative_to(ROOT) else p.name


def profiled(label, fn):
    """Run ``fn()`` under cProfile; print and return its line and result."""
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    out = prof.runcall(fn)
    wall = time.perf_counter() - t0
    rows = [(f"{_where(f)}:{line}:{name}", tt, ct)
            for (f, line, name), (_, _, tt, ct, _) in
            pstats.Stats(prof).stats.items()]
    own = [r for r in rows if r[0].startswith("repro_torch/")]
    print(json.dumps({
        "profile": label, "wall_s": wall,
        "cum_s": [[n, ct] for n, _, ct in
                  sorted(own, key=lambda r: -r[2])[:TOP]],
        "self_s": [[n, tt] for n, tt, _ in
                   sorted(rows, key=lambda r: -r[1])[:TOP]]}), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: fem_profile.py runs on the card's machine",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from repro_torch.core.comm import Comm
    from repro_torch.core.store import DatasetStore
    from repro_torch.core.tensor_ckpt import TensorCheckpoint
    from repro_torch.core.torch_io import layout_from_torch, save_torch
    from repro_torch.core.torch_io import sweep_to_device
    from repro_torch.fem import (Element, FEMCheckpoint, FunctionSpace,
                                 distribute, interpolate, tri_mesh_fast)

    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    device = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="fem_profile_", dir=ROOT / "build")
    try:
        mesh = tri_mesh_fast(NX, NY)
        plexes, _, _ = profiled(
            "distribute", lambda: distribute(mesh, SAVE_RANKS,
                                             method="contiguous", seed=0))
        store = DatasetStore(f"{tmp}/fem", "w")
        ck = FEMCheckpoint(store)
        ck.save_mesh("m", plexes, Comm(SAVE_RANKS))
        spaces = [FunctionSpace(lp, Element("P", 4, "triangle"))
                  for lp in plexes]
        ck.save_function("m", "u", [interpolate(sp, _field)
                                    for sp in spaces], Comm(SAVE_RANKS))
        for M in (1, 3):
            loaded = profiled(f"load_mesh M={M}", lambda: ck.load_mesh(
                "m", Comm(M), partition="contiguous"))
        profiled("load_function M=3",
                 lambda: ck.load_function(loaded, "u", Comm(3)))

        g = torch.Generator(device=device).manual_seed(0)
        state = {"params/embed": torch.randn(49152, 576, generator=g,
                                             device=device)
                 .to(torch.bfloat16),
                 "params/final_norm": torch.zeros(576, dtype=torch.bfloat16,
                                                  device=device)}
        tck = TensorCheckpoint(DatasetStore(f"{tmp}/tensor", "w"))
        tck.save_layout(layout_from_torch(state))
        tck.store.begin_step(0)
        save_torch(tck, state, 0)
        tck.store.commit_step()
        rck = TensorCheckpoint(DatasetStore(f"{tmp}/tensor", "r"))

        def sweep():
            out = dict(sweep_to_device(rck, list(state), device))
            torch.cuda.synchronize()
            return out

        swept = profiled("sweep one step", sweep)
        if not all(torch.equal(swept[0][n], state[n]) for n in state):
            raise AssertionError("the swept arrays differ from the saved")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

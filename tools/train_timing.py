#!/usr/bin/env python3
"""Time smollm-135m's train step and the restore of its 1.35 GB train state
for one or more checkouts, to compare two commits in one call.

    python3 tools/train_timing.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (the parent commit unpacked with
``git archive``, say, or ``.`` for this one), timed in a process of its own
that imports that ROOT's ``repro_torch``.  Per ROOT, the train phase of
``chip_smoke.py`` cut to its timed parts: full smollm-135m at B 4, S 2048,
remat, the flash kernel under autograd, deterministic mode; 6 steps through
the ``TorchTrainer`` with one async save after the last (each step's
host-clock seconds end in a device synchronise), then a fresh trainer's
``restore_latest`` of that save onto the card.  Prints one JSON line per
ROOT, in the order given, with the card's name and power limit; needs one
CUDA card.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

B, S, STEPS, SEED = 4, 2048, 6, 0
LR, WARMUP = 3e-3, 2


def time_root(root: Path) -> dict:
    sys.path.insert(0, str(root))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.device import use_deterministic_algorithms
    from repro_torch.models.api import build_model
    from repro_torch.train import (AdamW, SyntheticLM, TorchTrainer,
                                   TrainerConfig, init_train_state,
                                   make_train_step, warmup_cosine)

    if not Path(sys.modules["repro_torch"].__file__).resolve().is_relative_to(
            root):
        raise RuntimeError(f"imported another checkout's repro_torch, not "
                           f"{root}'s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    use_deterministic_algorithms()
    device = torch.device("cuda")
    cfg = dataclasses.replace(get_config("smollm_135m"),
                              attention_impl="pallas", remat=True)
    api = build_model(cfg)
    opt = AdamW()
    step = make_train_step(
        api, opt, functools.partial(warmup_cosine, base_lr=LR, warmup=WARMUP,
                                    total=STEPS),
        ShapeConfig("train", S, B, "train"))
    step_seconds, step_fn = [], step.fn

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t0)
        return out

    step = dataclasses.replace(step, fn=timed_step)
    data = SyntheticLM(cfg.vocab, S, B, seed=SEED)
    (root / "build").mkdir(exist_ok=True)
    store = tempfile.mkdtemp(prefix="train_timing_", dir=root / "build")

    def trainer():
        return TorchTrainer(
            step, data, TrainerConfig(store, ckpt_every=STEPS, log_every=1),
            device=device, init_state_fn=lambda: init_train_state(
                api, opt, torch.Generator(device=device).manual_seed(SEED)))

    try:
        ta = trainer()
        ta.run(STEPS)
        tc = trainer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, restored = tc.restore_latest()
        torch.cuda.synchronize()
        restore = time.perf_counter() - t0
    finally:
        shutil.rmtree(store, ignore_errors=True)
    if restored != STEPS:
        raise AssertionError(f"restored step {restored}, not {STEPS}")
    median = float(np.median(step_seconds[1:]))
    return {"root": str(root), "step_seconds": step_seconds,
            "step_ms_median_2_to_6": median * 1e3,
            "tokens_per_s": B * S / median,
            "losses": [h["loss"] for h in ta.history],
            "save": ta.save_log[0],
            "writer_seconds": {j["label"]: j["seconds"]
                               for j in ta._async.job_log},
            "restore_seconds": restore}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        print(json.dumps(time_root(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for root in argv:
        out = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(f"{root}: exit {out.returncode}\n{out.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

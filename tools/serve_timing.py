#!/usr/bin/env python3
"""Time a model's serving calls (prefill and decode step, full width,
seeded weights on the card; smollm-135m unless ``--arch`` names another
ported architecture) through the serving step builders, for one or more
checkouts, to compare two commits in one call.

    python3 tools/serve_timing.py [--arch ARCH] ROOT [ROOT ...]

ARCH is any architecture in ``repro_torch.configs.ARCHS`` (the launcher's
setting: prefill attention through the flash kernel where the reference's
dispatch takes it).  A model with embeddings input (qwen2-vl-7b) prefills
from the launcher's synthetic batch (``launch/serve.py::prompt_batch``:
``embeds`` and M-RoPE ``positions``) at each prompt length, and decodes
tokens.

Each ROOT is a checkout of this repository (the parent commit unpacked with
``git archive``, say, or ``.`` for this one), timed in a process of its own
that imports that ROOT's ``repro_torch``.  Per ROOT, in three rounds: the
host-clock seconds of a B 1 prefill of each prompt that ``chip_smoke.py``
serves (the engine's admission calls), summed, and the median of 32
lockstep decode steps at B 4 against a 545-slot cache; each call ends in a
device synchronise.  Prints one JSON line per ROOT, in the order given;
needs one CUDA card.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SEED = 0
ROUNDS, DECODE_STEPS, SLOTS, MAX_SEQ = 3, 32, 4, 545


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_root(root: Path, arch: str) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    smoke = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.api import build_model
    from repro_torch.train.step import make_decode_step, make_prefill_step

    if not Path(sys.modules["repro_torch"].__file__).resolve().is_relative_to(
            root):
        raise RuntimeError(f"imported another checkout's repro_torch, not "
                           f"{root}'s")
    cfg = dataclasses.replace(get_config(arch), attention_impl="pallas")
    api = build_model(cfg)
    dev = torch.device("cuda")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def prefill(p, B):
        """The serving step's prefill of ``p`` [P] tokens at batch B (the
        tokens repeated), or of the embeddings batch of its length, as a
        call of no arguments."""
        if cfg.input_mode == "embeds":
            from repro_torch.launch.serve import prompt_batch
            batch = prompt_batch(cfg, B, len(p), dev, seed=SEED)
        else:
            batch = {"tokens": torch.from_numpy(p[None]).to(dev).expand(B, -1)}
        step = make_prefill_step(api, ShapeConfig("t", len(p), B, "prefill"),
                                 cache_len=MAX_SEQ)
        return lambda: step(params, batch)

    requests = [p for _, p, _ in smoke.make_requests(cfg.vocab)]
    prompts = [prefill(p, 1) for p in requests]
    lockstep = prefill(requests[1], SLOTS)
    decode = make_decode_step(api)
    rounds = []
    with torch.inference_mode():
        params = api.init(torch.Generator(device=dev).manual_seed(SEED))
        prompts[0]()                                            # warm up
        for _ in range(ROUNDS):
            t_prefill = sum(timed(p)[0] for p in prompts)
            _, (logits, cache) = timed(lockstep)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            pos = int(cache["length"])
            steps = []
            for i in range(DECODE_STEPS):
                batch = {"token": tok, "pos": torch.full(
                    (SLOTS,), pos + i, dtype=torch.int32, device=dev)}
                t, (logits, cache) = timed(
                    lambda: decode(params, cache, batch))
                steps.append(t)
                tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            rounds.append({"prefill_seconds": t_prefill,
                           "decode_step_ms": float(np.median(steps)) * 1e3})
    return {"root": str(root), "arch": cfg.arch,
            "device": torch.cuda.get_device_name(dev),
            "prompts": [len(p) for p in requests], "rounds": rounds}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        print(json.dumps(time_root(Path(argv[1]).resolve(), argv[2])),
              flush=True)
        return 0
    arch = "smollm_135m"
    if argv[:1] == ["--arch"]:
        arch, argv = argv[1], argv[2:]
    sys.path.insert(0, str(HERE))
    from repro_torch.configs import ARCHS

    if not argv or arch not in ARCHS:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        out = subprocess.run([sys.executable, __file__, "--one", root, arch],
                             capture_output=True, text=True, check=True,
                             timeout=900)
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

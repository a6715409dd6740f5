#!/usr/bin/env python3
"""How far ``chip_smoke.py``'s ``adafactor_mesh`` run lies from the
one-process steps it is held to, array by array, and whether its gate
catches a planted fault.

    python3 tools/adafactor_mesh_probe.py [--fault local_clip]
        [--experts N] [--f32]

Runs ``kimi_train``'s model (kimi-k2 at full width, 1 layer, 64 experts,
bf16, deterministic) for ADA_STEPS steps on one process, then on ADA_MESH's
processes sharing the card (``card_adafactor_mesh``; with ``--fault
local_clip`` each process's Adafactor takes its update clip's RMS over its
own shard alone; ``--experts`` sets the experts, ``--f32`` runs it in f32
with the attention on the blocked plain path).  Prints JSON lines:

  * per ``min_change_ulps`` in 0, 4, 8, 16, the worst values of
    ``card_errors`` (error over ``CARD_RTOL``, or over
    ``tests/test_torch_mesh_train.py``'s f32 ``RTOL``; a parameter's update over
    the elements that move at least that many spacings of their value);
  * per parameter: the update's relative 2-norm error, the cosine of the
    two updates, the share of elements whose stored values differ, the
    median change in spacings, the share moving 4, 8 and 16 spacings;
  * the embedding rows that carry most of its update's error, with each
    token's place in the batch of the step that moved it.

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def local_clip_worker(*args):
    """``card_adafactor_mesh`` with each Adafactor update's clip taken over
    this process's shard alone (the scale's RMS stays summed)."""
    from helpers import torch_adafactor_workers as W

    from repro_torch.train import optim

    plain, clip_next = optim._mean, [True]

    def planted(x, dim, split, keepdim=False):
        if dim is None:
            # ``_one`` takes the clip's whole-array mean, then the scale's
            clip, clip_next[0] = clip_next[0], not clip_next[0]
            if clip:
                return plain(x, dim, {}, keepdim)
        return plain(x, dim, split, keepdim)
    optim._mean = planted
    return W.card_adafactor_mesh(*args)


def _spacing(w):
    import torch

    return torch.finfo(w.dtype).eps * torch.exp2(torch.floor(torch.log2(
        w.double().abs().clamp_min(torch.finfo(w.dtype).tiny))))


def parameter_stats(kept: list, init: dict, final: dict) -> dict:
    import torch

    out = {}
    for key in sorted(k for k in final if k.startswith("params/")):
        num = den = dot = nu = nw = 0.0
        differ = total = 0
        moved = [0, 0, 0]
        med = []
        for r in kept:
            box = r["boxes"][key]
            w = final[key][box].cuda()
            g, s0 = r["local"][key].cuda(), init[key][box].cuda()
            du, dw = g.double() - s0.double(), w.double() - s0.double()
            num += float(((du - dw) ** 2).sum())
            den += float((dw ** 2).sum())
            dot += float((du * dw).sum())
            nu += float((du ** 2).sum())
            nw += float((dw ** 2).sum())
            differ += int((g != w).sum())
            total += w.numel()
            steps = dw.abs() / _spacing(w)
            moved = [m + int((steps >= k).sum())
                     for m, k in zip(moved, (4, 8, 16))]
            med.append(float(steps.flatten()[:10_000_000].median()))
        out[key] = {"rel2": (num / den) ** 0.5 if den else 0.0,
                    "cos": dot / (nu * nw) ** 0.5 if nu and nw else 1.0,
                    "differ": differ / total, "median_change_ulps": max(med),
                    "moved_4_8_16": [m / total for m in moved]}
    return out


def embedding_rows(kept: list, final: dict, batches) -> list:
    """The 4 embedding rows with the largest share of its update's error:
    (token, share, where the token stands in each step's batch)."""
    import numpy as np
    import torch

    errs = []
    for r in kept:
        box = r["boxes"]["params/embed"]
        g = r["local"]["params/embed"].cuda().double()
        w = final["params/embed"][box].cuda().double()
        errs.append((box[0].start, ((g - w) ** 2).sum(1).cpu()))
        del g, w
    total = sum(float(e.sum()) for _, e in errs) or 1.0
    rows = [(int(i) + start, float(e) / total)
            for start, err in errs for e, i in zip(*torch.topk(err, 4))]
    rows = sorted(rows, key=lambda te: -te[1])[:4]
    return [{"token": t, "share": e,
             "at": [[i, *map(int, p)] for i, b in enumerate(batches)
                    for p in np.argwhere(b["tokens"] == t)]}
            for t, e in rows]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fault", choices=("local_clip",))
    ap.add_argument("--experts", type=int)
    ap.add_argument("--f32", action="store_true")
    args = ap.parse_args(argv)
    for p in (ROOT, ROOT / "tests", ROOT / "tools"):
        sys.path.insert(0, str(p))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import dataclasses

    import torch

    import chip_smoke as cs
    from helpers import torch_adafactor_workers as W
    from helpers.torch_tp_workers import CARD_RTOL, card_errors
    from test_torch_mesh_train import RTOL

    from repro_torch.launch.spawn import run_processes
    from repro_torch.models.api import build_model
    from repro_torch.train import Adafactor
    from repro_torch.train.data import SyntheticLM

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    cfg = W.card_config(1, args.experts or cs.KIMI_TRAIN_EXPERTS)
    if args.f32:
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  attention_impl="xla_flash")
    train = cs.repeat_train(build_model(cfg), cs.KIMI_TRAIN_B,
                            cs.KIMI_TRAIN_S, cs.KIMI_TRAIN_STEPS,
                            cs.KIMI_REPEAT_STEPS, torch.device("cuda"),
                            opt=Adafactor(), lr=cs.KIMI_TRAIN_LR,
                            hold=cs.ADA_STEPS)
    final = train.pop("held")
    history = [{"loss": train["losses"][i],
                **{k: v[i] for k, v in train["metrics"].items()}}
               for i in range(cs.ADA_STEPS)]
    torch.cuda.empty_cache()
    worker = W.card_adafactor_mesh
    if args.fault == "local_clip":
        import adafactor_mesh_probe
        worker = adafactor_mesh_probe.local_clip_worker
    scratch = ROOT / "build" / "adafactor_mesh_probe"
    scratch.mkdir(parents=True, exist_ok=True)
    store = tempfile.mkdtemp(dir=scratch)
    kept_dir = tempfile.mkdtemp(dir=scratch)
    n = cs.ADA_MESH[0] * cs.ADA_MESH[1]
    tokens = torch.zeros((cs.KIMI_TRAIN_B, 1), dtype=torch.int32)
    try:
        ranks = run_processes(worker, n, (
            cs.ADA_MESH, cfg, cs.KIMI_TRAIN_B, cs.KIMI_TRAIN_S, cs.ADA_STEPS,
            cs.ADA_REPEAT, cs.SEED, cs.KIMI_TRAIN_LR, cs.TRAIN_WARMUP,
            cs.KIMI_TRAIN_STEPS, tokens, 64, store, kept_dir),
            timeout=cs.ADA_TIMEOUT, pg_timeout=cs.ADA_TIMEOUT)
        kept = W.load_kept(kept_dir, n)
    finally:
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(kept_dir, ignore_errors=True)
    init = {f"params/{k}": t for k, t in build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(cs.SEED)).items()}
    one = (init, final, history, [])
    tag = {"fault": args.fault, "experts": cfg.moe.num_experts,
           "dtype": cfg.dtype}
    for k in (0, 4, 8, 16):
        ratios = card_errors(ranks[0]["metrics"], kept, one, device="cuda",
                             min_change_ulps=k,
                             rtol=RTOL["float32"] if args.f32 else CARD_RTOL)
        print(json.dumps({**tag, "min_change_ulps": k,
                          "worst": sorted(ratios.items(),
                                          key=lambda kv: -kv[1])[:8]}),
              flush=True)
    print(json.dumps({**tag,
                      "parameters": parameter_stats(kept, init, final)}),
          flush=True)
    data = SyntheticLM(cfg.vocab, cs.KIMI_TRAIN_S, cs.KIMI_TRAIN_B,
                       seed=cs.SEED)
    print(json.dumps({**tag, "embedding_rows": embedding_rows(
        kept, final, [data.batch(i) for i in range(cs.ADA_STEPS)])}),
        flush=True)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(json.dumps({"device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving launcher: batched prefill + decode driver.

Greedy-decodes a batch of synthetic prompts and prints one JSON line of
per-phase timings, as the JAX package's ``launch/serve.py`` does.  Runs on
the CUDA card; ``--smoke --device cpu`` runs the reduced config on the CPU
through the plain PyTorch versions.  The port has no meshes yet: the mesh
flags are accepted and must stay at one device.

    python -m repro_torch.launch.serve --arch smollm_135m
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model, make_token_batch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.production_mesh or args.data_mesh * args.model_mesh != 1:
        ap.error("the port runs on one device: meshes are not ported yet")

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    # prefill attention through the hand-written kernel (its plain
    # version on the CPU)
    cfg = dataclasses.replace(cfg, attention_impl="pallas")
    api = build_model(cfg)
    B, P, G = args.batch, args.prompt_len, args.gen_len
    shape = ShapeConfig("serve", P, B, "prefill")
    cache_len = P + G

    batch = make_token_batch(cfg, shape, seed=0)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    tokens = torch.from_numpy(batch["tokens"]).to(device)
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, {"tokens": tokens}, cache_len)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        toks = [torch.argmax(logits, dim=-1).to(torch.int32)[:, None]]
        t1 = time.perf_counter()
        for i in range(G):
            step_batch = {"token": toks[-1],
                          "pos": torch.full((B,), P + i, dtype=torch.int32,
                                            device=device)}
            logits, cache = api.decode_step(params, cache, step_batch)
            toks.append(torch.argmax(logits, dim=-1).to(torch.int32)[:, None])
        _sync(device)
        t_decode = time.perf_counter() - t1

    out = np.concatenate([t.cpu().numpy() for t in toks], axis=1)
    print(json.dumps({
        "arch": cfg.arch,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "batch": B, "prompt_len": P, "gen_len": G,
        "prefill_seconds": round(t_prefill, 3),
        "decode_seconds": round(t_decode, 3),
        "decode_tokens_per_s": round(B * G / max(t_decode, 1e-9), 1),
        "sample_tokens": out[0, :8].tolist(),
    }))


if __name__ == "__main__":
    main()

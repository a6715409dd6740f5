"""Serving launcher: batched prefill + decode driver.

Greedy-decodes a batch of synthetic prompts and prints one JSON line of
per-phase timings, as the JAX package's ``launch/serve.py`` does: through
the step builders (``train/step.py::make_prefill_step`` and
``make_decode_step``) on a (1, 1) mesh, so an MoE model runs its
expert-parallel layer.  Runs on the CUDA card; ``--smoke --device cpu``
runs the reduced config on the CPU through the plain PyTorch versions.

Under ``torchrun`` (which sets ``WORLD_SIZE``, ``RANK`` and the rendezvous
address) it serves on a ("data", "model") mesh of ``--data-mesh`` x
``--model-mesh`` processes, which must be the world size
(``--production-mesh``: 16 x 16, 256 processes): the parameters sharded by
the rule table, each process prefilling its rows of the batch and
decoding against its shard of the cache (the KV cache's sequence dim over
the model axis); only rank 0 prints.  A world of one is a (1, 1) mesh
(NCCL on the card), which serves through the same path.

    python -m repro_torch.launch.serve --arch smollm_135m
    python -m repro_torch.launch.serve --arch recurrentgemma_9b
    python -m repro_torch.launch.serve --arch granite_moe_3b_a800m
    python -m repro_torch.launch.serve --arch qwen3_4b
    python -m repro_torch.launch.serve --arch gemma2_2b
    python -m repro_torch.launch.serve --arch qwen2_vl_7b
    python -m repro_torch.launch.serve --arch xlstm_350m
    python -m repro_torch.launch.serve --arch whisper-base
    python -m repro_torch.launch.serve --arch kimi-k2-1t-a32b --smoke \
        --device cpu
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch smollm-135m --smoke --device cpu --data-mesh 2 --model-mesh 2

qwen2-vl-7b's prefill takes the synthetic batch of its embeddings input
(``embeds`` and M-RoPE ``positions``), as the reference's launcher gives
it; decode then feeds the greedy tokens.  gemma2-2b's alternating
local/global layers take the blocked plain path, not the kernel, as the
reference's dispatch does.  xlstm-350m carries an O(1) state (mLSTM matrix
memories, sLSTM vectors) in place of a KV cache.  whisper-base's batch
carries the synthetic ``enc_frames`` [B, 1500, 512] beside its decoder
prompt; its cache keeps the cross K/V that the prefill computed.  kimi-k2
at full size (about 1 T parameters) fits no card: ``--smoke``, or a cut
config built in Python as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.distrib.rules import from_local, local_box, rules_for
from repro_torch.launch.mesh import (init_distributed, make_debug_mesh,
                                     make_production_mesh)
from repro_torch.models.api import build_model, make_token_batch
from repro_torch.train.step import (make_decode_step, make_prefill_step,
                                    shard_state, state_shardings)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_batch(cfg, B: int, P: int, device: torch.device, seed: int = 0
                 ) -> dict[str, torch.Tensor]:
    """The synthetic prefill batch of ``make_token_batch`` on ``device``:
    ``tokens`` [B, P], or ``embeds`` [B, P, D] and M-RoPE ``positions``
    under embeddings input."""
    return {k: torch.from_numpy(v).to(device) for k, v in make_token_batch(
        cfg, ShapeConfig("serve", P, B, "prefill"), seed=seed).items()}


def batch_dims(batch: dict[str, torch.Tensor]) -> tuple[int, int]:
    """(B, P) of a prefill batch, read from its ``tokens`` or ``embeds``."""
    x = batch["tokens"] if "tokens" in batch else batch["embeds"]
    return x.shape[0], x.shape[1]


def greedy(logits) -> torch.Tensor:
    """[B, 1] int32 argmax tokens of logits [B, V]; of this process's rows
    when the logits are a DTensor (the sharded steps')."""
    if isinstance(logits, DTensor):
        logits = logits.to_local()
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def decode_steps(api, params, cache, token, pos: int, steps: int,
                 device: torch.device, on_step=None, *, mesh=None,
                 rules=None) -> list[torch.Tensor]:
    """``steps`` greedy decode steps in lockstep from ``cache`` through
    ``make_decode_step(api, mesh=mesh, rules=rules)``, feeding ``token``
    [B, 1] at position ``pos`` first (on a mesh: this process's rows, the
    parameters and the cache DTensors).  Returns the tokens fed and
    produced ([B, 1] int32 each, ``steps + 1`` of them).  ``on_step(i,
    logits)``, if given, sees each step's logits (i = 1..steps)."""
    B = token.shape[0]
    decode = make_decode_step(api, mesh=mesh, rules=rules)
    toks = [token]
    for i in range(steps):
        step_batch = {"token": toks[-1],
                      "pos": torch.full((B,), pos + i, dtype=torch.int32,
                                        device=device)}
        logits, cache = decode(params, cache, step_batch)
        if on_step is not None:
            on_step(i + 1, logits)
        toks.append(greedy(logits))
    return toks


def shard_params(api, params, mesh, rules) -> dict:
    """DTensors of parameters that every process holds whole and alike
    (made from one seed), on the placements the rule table gives them."""
    return shard_state(params, mesh,
                       state_shardings(mesh, rules, api.param_specs))


def serve_batch(api, params, batch: dict[str, torch.Tensor], gen_len: int,
                device: torch.device, *, on_prefill=None, on_step=None,
                mesh=None, rules=None) -> tuple[np.ndarray, dict]:
    """One batched prefill of the prompt ``batch`` (``tokens`` [B, P], or
    ``embeds`` [B, P, D] and ``positions`` under embeddings input) through
    ``make_prefill_step``, then ``gen_len`` greedy decode steps in
    lockstep.

    On a ``mesh`` (``rules`` default ``rules_for(api.cfg.arch)``) the
    parameters are DTensors (``shard_params``), ``batch`` is the whole
    prompt batch, which every process holds alike, and each process
    serves its rows of it with the cache sharded (the sharded prefill and
    decode steps of ``train/step.py``); the tokens are gathered at the end.

    Returns (tokens [B, gen_len + 1] int32: the prefill's greedy token and
    each step's, {"prefill_seconds", "decode_seconds"}), each time taken on
    the host clock around work that ends in a device synchronise.
    ``on_prefill(logits, cache)`` sees the prefill's output before any
    decode step writes into the cache; ``on_step`` is ``decode_steps``'s."""
    B, P = batch_dims(batch)
    prefill = make_prefill_step(api, ShapeConfig("serve", P, B, "prefill"),
                                cache_len=P + gen_len, mesh=mesh, rules=rules)
    if mesh is not None:
        batch = {k: v[local_box(v.shape, mesh, prefill.batch_shardings[k])
                      .slices()] for k, v in batch.items()}
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        if on_prefill is not None:
            on_prefill(logits, cache)

        t1 = time.perf_counter()
        toks = decode_steps(api, params, cache, greedy(logits), P, gen_len,
                            device, on_step, mesh=mesh, rules=rules)
        _sync(device)
        t_decode = time.perf_counter() - t1
        toks = torch.cat(toks, dim=1)
        if mesh is not None:
            toks = from_local(toks, mesh, logits.placements,
                              (B, gen_len + 1)).full_tensor()
    return toks.cpu().numpy(), {"prefill_seconds": t_prefill,
                                "decode_seconds": t_decode}


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
    torchrun = "WORLD_SIZE" in os.environ
    world = int(os.environ.get("WORLD_SIZE", 1))
    if args.production_mesh:
        mesh_of, procs = "the production mesh", 256
    else:
        mesh_of = f"--data-mesh {args.data_mesh} x --model-mesh {args.model_mesh}"
        procs = args.data_mesh * args.model_mesh
    if procs != world:
        ap.error(f"{mesh_of} needs {procs} processes under torchrun, but the "
                 f"world size (WORLD_SIZE) is {world}")

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    # prefill attention through the hand-written kernel (its plain
    # version on the CPU); the RG-LRU family ignores the setting, as in the
    # reference
    cfg = dataclasses.replace(cfg, attention_impl="pallas")
    api = build_model(cfg)
    B, P, G = args.batch, args.prompt_len, args.gen_len
    batch = prompt_batch(cfg, B, P, device)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    mesh = rules = None
    if torchrun:
        init_distributed(device.type)
        mesh = (make_production_mesh(device_type=device.type)
                if args.production_mesh
                else make_debug_mesh(args.data_mesh, args.model_mesh,
                                     device_type=device.type))
        rules = rules_for(cfg.arch)
        params = shard_params(api, params, mesh, rules)
    try:
        out, timings = serve_batch(api, params, batch, G, device, mesh=mesh,
                                   rules=rules)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    t_prefill, t_decode = timings["prefill_seconds"], timings["decode_seconds"]
    if int(os.environ.get("RANK", 0)) != 0:
        return

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

#!/usr/bin/env python3
"""Where a train step's time goes: full smollm-135m (B 4, S 2048, remat,
the flash kernels under autograd, forward and backward) on one card, as
``chip_smoke.py``'s train phase runs it, in deterministic mode.

    python3 tools/train_profile.py

After two warm-up steps it prints one JSON line with
  * the step's host-clock time (ending in a synchronise) and, from
    ``torch.profiler`` over one more step, the device's busy time (the union
    of its kernels' intervals) and idle share, and the device time by
    kernel, largest first and grouped into the flash forward kernel, the
    flash backward kernel's two passes, the matrix products (cuBLAS) and
    the rest, with the attention backward's share of the busy time;
  * CUDA-event times of the pieces, each at the path's shape: one layer's
    attention forward (the kernel, with its log-sum-exp) and its backward
    (the backward kernel), and one vocab chunk's loss forward and
    backward.
Needs one CUDA card.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, S, SEED = 4, 2048, 0


def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _events_ms(fn, iters: int = 5) -> float:
    import numpy as np
    import torch

    fn()
    out = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def main() -> int:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.device import use_deterministic_algorithms
    from repro_torch.kernels.flash_attention.ops import flash_attention_vjp
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import chunked_softmax_xent
    from repro_torch.train import (AdamW, SyntheticLM, init_train_state,
                                   make_train_step, warmup_cosine)

    use_deterministic_algorithms()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("smollm_135m"),
                              attention_impl="pallas", remat=True)
    api = build_model(cfg)
    step = make_train_step(api, AdamW(), functools.partial(
        warmup_cosine, base_lr=3e-3, warmup=2, total=6),
        ShapeConfig("train", S, B, "train"))
    data = SyntheticLM(cfg.vocab, S, B, seed=SEED)
    state = init_train_state(api, AdamW(),
                             torch.Generator(device=dev).manual_seed(SEED))

    def batch(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()}

    for i in range(2):
        state, _ = step(state, batch(i))
    b = batch(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch(3))
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.device_time_total > 0]
    busy = _busy_ms([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    groups = {"flash_kernel": 0.0, "flash_bwd_kernel": 0.0, "gemm": 0.0,
              "other": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        if "flash_bwd" in low:
            groups["flash_bwd_kernel"] += ms
        elif "flash" in low or "fwd_kernel" in low:
            groups["flash_kernel"] += ms
        elif any(w in low for w in ("gemm", "cutlass", "xmma", "nvjet")):
            groups["gemm"] += ms
        else:
            groups["other"] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]

    # the pieces, each alone at the path's shape
    gen = torch.Generator(device=dev).manual_seed(SEED)
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q, k, v, g = (torch.randn(s, generator=gen, device=dev)
                  .to(torch.bfloat16).requires_grad_(True)
                  for s in [(B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd),
                            (B, S, Hq, hd)])
    args = (True, 0, 0.0, cfg.attn_block_q, cfg.attn_block_k, 0)
    attn_fwd = _events_ms(lambda: flash_attention_vjp(q, k, v, *args))
    out = flash_attention_vjp(q, k, v, *args)
    attn_bwd = _events_ms(lambda: torch.autograd.grad(
        out, (q, k, v), g, retain_graph=True))
    chunk = min(512, S)
    h = torch.randn((B, chunk, cfg.d_model), generator=gen, device=dev
                    ).to(torch.bfloat16).requires_grad_(True)
    table = api.init(torch.Generator(device=dev).manual_seed(SEED))["embed"]
    table_t = table.t().requires_grad_(True)
    t = torch.from_numpy(data.batch(0)["targets"][:, :chunk]).to(dev)
    m = torch.ones((B, chunk), device=dev)

    def loss_chunk():
        return chunked_softmax_xent(h, table_t, t, m)[0]

    loss_fwd = _events_ms(lambda: loss_chunk().detach())
    loss_fb = _events_ms(lambda: torch.autograd.grad(loss_chunk(),
                                                     (h, table_t)))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "config": {"arch": cfg.arch, "layers": cfg.num_layers, "batch": B,
                   "seq": S, "remat": cfg.remat},
        "step_ms": step_ms, "profiled_step_ms": profiled_ms,
        "device_busy_ms": busy, "device_idle_share": 1 - busy / profiled_ms,
        "device_kernel_ms_by_group": groups,
        "attention_backward_share_of_busy": groups["flash_bwd_kernel"] / busy,
        "device_kernel_ms_top": top,
        "pieces_ms": {
            "attention_forward_kernel_one_layer": attn_fwd,
            "attention_backward_kernel_one_layer": attn_bwd,
            "loss_chunk_forward": loss_fwd,
            "loss_chunk_forward_and_backward": loss_fb,
            "loss_chunks_per_step": -(-S // chunk)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``repro_torch``) on one card.

Drives the port's two serving paths, smollm-135m at full width, restored
N-to-M, and recurrentgemma-9b at full width and full depth, then its
training path: smollm-135m trained on the card, killed, and resumed from
its N-to-M checkpoint; then the paper's own finite-element path at full
size and the post-processing sweep of the training run's checkpoint.

  device   the card's name and power limit (nvidia-smi);
  build    the hand-written kernels, compiled from this checkout's sources;
  kernels  each kernel against its plain PyTorch version on the card, at the
           main paths' shapes, with its time, bound, plain and library times;
  ckpt     a seeded full-width smollm-135m state on the card, saved as N=4
           ranks through the N-to-M engine (ckpt_pack packs each rank's
           chunks), restored N-to-M onto this one card, checked bit for bit;
  serve    continuous batching from the restored parameters (prefill through
           the flash-attention kernel), token for token against sequential
           greedy decoding;
  hybrid_serve        recurrentgemma-9b (seeded weights on the card) through
           the launcher's ``serve_batch``: one batched prefill (every RG-LRU
           layer through the rglru_scan kernel), lockstep greedy decode;
  hybrid_state        that prefill's serving state (recurrent and conv
           states, ring-buffer K/V, length) saved as N=4 ranks and restored
           4-to-1 onto the card bit for bit; decoding from the restored state
           gives the same tokens;
  hybrid_consistency  decode-step logits against one prefill of the prompt
           plus the tokens generated so far;
  train    full smollm-135m (B 4, S 2048) trained through the TorchTrainer in
           deterministic mode, its attention forward on the flash kernel
           under autograd (dq, dk, dv first checked against autograd
           through the plain blocked path): run A takes 6 steps straight;
           run B saves every 2 steps through the async checkpointer
           (ckpt_pack packs each save) and is preempted at step 5; run C, a
           fresh trainer, restores the last committed step and runs to 6.
           C must end in A's state bit for bit.
  fem      a P4 function on tri_mesh_fast(512, 512) (1.57 M entities, 4.2 M
           DoFs) kept on the card, saved from N=8 simulated ranks at 3 time
           indices through the async facade (``save_mesh``,
           ``save_function``), loaded on M=1 (onto the card) and M=3; every
           loaded DoF equal to the field at its node point, bit for bit;
  postprocess  the committed steps of runs B and C swept on one rank
           (``sweep_steps``), only the embedding table and the final norm
           loaded onto the card, each equal to the train phase's own bit for
           bit, the store reading no other array's datasets.

Each path runs with the launch counts set to 0 just before it and read just
after; a kernel of a path that never launched fails the run (the fem and
postprocess paths run no kernel: their counts are reported).  Every phase
prints one JSON line; a failing phase raises and the script exits non-zero.
Before the last line come the {"kernels": [...]} line (``launches`` summed
over the paths that run the kernel) and the card's name and power limit;
the last line is {"ok": true, "device": {...}}.  Needs one CUDA card (80 GB:
the 9.4 B-parameter model is 18.8 GB in bf16) and the repository around it;
imports nothing of JAX.

    python3 chip_smoke.py [--kernels-only]
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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# |kernel - plain| <= ATOL + RTOL * |plain| for the attention kernel: P is
# rounded to bf16 for the PV tensor-core product (the plain version keeps it
# in f32) and the output is rounded to bf16 (1 ulp = 2^-8 relative) — the
# repo's own Pallas-vs-oracle bf16 tolerance
ATTN_ATOL = ATTN_RTOL = 2e-2
# |kernel - plain| <= SCAN_ATOL + SCAN_RTOL * |plain| for the RG-LRU scan:
# tests/test_kernels.py's f32 tolerance of the Pallas kernel against its
# oracle (the kernel runs the sequential FMA chain, the plain version a
# doubling scan: the same sums in another order)
SCAN_ATOL = SCAN_RTOL = 1e-5

# rounds of ckpt_pack's timing, each the kernel then index_select
PACK_ROUNDS = 5

# MB that time_ms writes to flush L2 before each timed call.  512 MB takes
# about 0.16 ms at the HBM rate, longer than the host takes to issue one
# small kernel (0.03-0.08 ms through a Python wrapper on the H100), so the
# events around the call time the device.  A 128 MB flush (0.04 ms) can
# end before the issue does, and then the host's time leaks into the
# reading; small kernels are also timed with it, for comparison with
# readings made that way.
FLUSH_MB = 512
SHORT_FLUSH_MB = 128

SEED = 0
NRANKS = 4
SLOTS = 4
# (prompt length, max_new) of the served requests
REQUESTS = [(16, 8), (512, 32), (77, 16), (200, 24), (33, 12), (384, 32),
            (128, 20), (250, 8)]
# the hybrid path: batch, prompt length and lockstep decode steps; the
# decode steps whose logits are held against a longer prefill
HYBRID_B, HYBRID_P, HYBRID_G = 4, 512, 32
CONSISTENCY_STEPS = (1, 16, 32)
# |decode logits - prefill logits| <= CONSISTENCY_RTOL * max |prefill
# logits|: the two paths round bf16 activations at different places over 38
# layers (the products run at other shapes, attention is decode_attention
# against flash_attention_xla).  Measured on an H100 at 0.020-0.031 of the
# largest logit for these inputs; the bound leaves 1.6x of that
CONSISTENCY_RTOL = 0.05

# the train phase: SmolLM's published context of 2,048 tokens at batch 4
# (8,192 tokens a step), AdamW under warmup_cosine(3e-3, warmup 2, total 6)
TRAIN_B, TRAIN_S = 4, 2048
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 6, 2, 5
TRAIN_LR, TRAIN_WARMUP = 3e-3, 2
# |vjp grad - plain grad| <= VJP_ATOL + VJP_RTOL * |plain grad|: both are
# autograd through the same blocked bf16 path on the same (q, k, v, dO), so
# they should agree bit for bit under deterministic algorithms; the bound is
# the attention kernel's bf16 tolerance
VJP_ATOL = VJP_RTOL = 2e-2

# the fem phase: a P4 Lagrange function on tri_mesh_fast(512, 512) (1.57 M
# entities, 4.2 M DoFs, the share of 4 of the paper's 8,192 processes),
# saved from 8 simulated ranks at 3 time indices, loaded on 1 and on 3
FEM_NX = FEM_NY = 512
FEM_DEGREE = 4
FEM_SAVE_RANKS = 8
FEM_LOAD_RANKS = (1, 3)
FEM_TIMES = 3
# the postprocess phase sweeps these arrays of the train phase's run B;
# run A's state after this step is the reference for that step
SWEEP_ARRAYS = ("params/embed", "params/final_norm")
SWEEP_CHECK_A = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3,
            flush_mb: int = FLUSH_MB) -> float:
    """Median device time of ``fn`` in ms, by CUDA events around each call,
    with the 50 MB L2 cache flushed before each (a cold caller) by writing
    ``flush_mb`` MB."""
    flush = torch.empty(flush_mb << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def host_ms(fn, iters: int = 100, rounds: int = 5) -> dict:
    """Per-call times in ms of ``fn`` called ``iters`` times back to back,
    L2 warm, in ``rounds`` loops (median and least over the loops):
    ``enqueue_ms``, the host's wall time to issue one call (the calls are
    asynchronous, so the card does not hold the host back), and
    ``back_to_back_ms``, the card's span of a loop over ``iters``: the
    larger of the host's issue time and the device's run time, which is
    what a caller launching ``fn`` in a loop gets."""
    fn()
    enqueue, span = [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueue.append((time.perf_counter() - t0) * 1e3 / iters)
        b.record()
        torch.cuda.synchronize()
        span.append(a.elapsed_time(b) / iters)
    return {"enqueue_ms": float(np.median(enqueue)),
            "enqueue_min_ms": min(enqueue),
            "back_to_back_ms": float(np.median(span)),
            "back_to_back_min_ms": min(span)}


# ------------------------------------------------------------------ device
def phase_device() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return line


# ------------------------------------------------------------------- build
def phase_build() -> None:
    from repro_torch.kernels import build

    res = build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in res["ptxas"].items()}
    # warpgroup MMA compiled in: HGMMA instructions in the flash library
    sass = subprocess.run(
        [str(Path(build.nvcc()).parent / "cuobjdump"), "-sass",
         str(build.library_path("flash_attention"))],
        capture_output=True, text=True, check=True, timeout=120).stdout
    hgmma = sum("HGMMA" in ln for ln in sass.splitlines())
    emit({"phase": "build", "seconds": res["seconds"], "built": res["built"],
          "ptxas": ptxas, "flash_attention_hgmma": hgmma})
    if not hgmma:
        raise AssertionError("no HGMMA instruction in the flash_attention "
                             "library: wgmma was not compiled in")


# ----------------------------------------------------------------- kernels
def _pairs(Sq: int, Sk: int, q_offset: int, causal: bool, window: int) -> int:
    """Query-key pairs the mask keeps (the attention's real work)."""
    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qpos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def check_ckpt_pack(params, layout, ownership) -> dict:
    from repro_torch.core.torch_io import chunk_major
    from repro_torch.kernels.ckpt_pack.ops import pack_chunks
    from repro_torch.kernels.ckpt_pack.ref import ckpt_pack_ref

    worst, checks = 0, 0

    def compare(src, idx):
        nonlocal worst, checks
        got = pack_chunks(src, idx)
        want = ckpt_pack_ref(src, torch.as_tensor(idx))
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError(f"ckpt_pack differs from its plain version "
                                 f"at src {tuple(src.shape)} {src.dtype}")
        worst = max(worst, int((got.view(torch.uint8).int()
                                - want.view(torch.uint8).int()).abs().max())
                    if got.numel() else 0)
        checks += 1

    # the issue's cases: w_gate's and embed's chunk-major views, repeated
    # and -1 indices, in bf16, f32 and int32
    rng = np.random.default_rng(SEED)
    for name in ("w_gate", "embed"):
        spec = layout.spec(name)
        for dtype in (torch.bfloat16, torch.float32, torch.int32):
            src = chunk_major(params[name].to(dtype), spec.chunk_shape)
            n = src.shape[0]
            idx = np.concatenate([rng.integers(-1, n, size=n // 4),
                                  [n - 1, n - 1, -1, 0]]).astype(np.int32)
            compare(src, idx)
    # every pack call of the main path: each rank's owned chunks of each
    # array, as the byte view the save packs
    calls = []
    for rank_own in ownership:
        for name, ords in rank_own.items():
            src = chunk_major(params[name],
                              layout.spec(name).chunk_shape).view(torch.uint8)
            compare(src, ords)
            calls.append((src.shape[1] * src.shape[2] * len(ords), name, src,
                          ords))
    # time the largest call of the main path: kernel and index_select in
    # turns over PACK_ROUNDS rounds, to see their spread beside their gap,
    # with each flush
    nbytes, name, src, ords = max(calls, key=lambda c: c[0])
    idx_dev = torch.as_tensor(ords, dtype=torch.int32, device="cuda")
    idx_long = idx_dev.long()
    times = {(who, mb): [] for who in ("kernel", "library")
             for mb in (FLUSH_MB, SHORT_FLUSH_MB)}
    for _ in range(PACK_ROUNDS):
        for mb in (FLUSH_MB, SHORT_FLUSH_MB):
            times["kernel", mb].append(
                time_ms(lambda: pack_chunks(src, idx_dev), flush_mb=mb))
            times["library", mb].append(time_ms(
                lambda: torch.index_select(src, 0, idx_long), flush_mb=mb))
    plain_ms = time_ms(lambda: ckpt_pack_ref(src, idx_dev))
    kernel, library = times["kernel", FLUSH_MB], times["library", FLUSH_MB]

    def spread(xs):
        return {"min": min(xs), "median": float(np.median(xs)),
                "max": max(xs), "rounds": xs}

    def rounds(mb):
        ks, ls = times["kernel", mb], times["library", mb]
        return {"flush_mb": mb, "kernel_ms": spread(ks),
                "index_select_ms": spread(ls),
                "kernel_over_index_select": spread(
                    [a / b for a, b in zip(ks, ls)])}
    return {"name": "ckpt_pack", "route": "cuda",
            "source": "repro_torch/kernels/ckpt_pack/kernel.cu",
            "replaces": "src/repro/kernels/ckpt_pack/kernel.py:40",
            "max_abs_err": float(worst), "ms": float(np.median(kernel)),
            "plain_ms": plain_ms,
            "bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": float(np.median(library)),
            "rounds": rounds(FLUSH_MB),
            "rounds_short_flush": rounds(SHORT_FLUSH_MB),
            "checks": checks, "timed_at": {
                "array": name, "src": list(src.shape), "chunks": len(ords),
                "bytes_moved": 2 * nbytes}}


def _sdpa(q, k, v, backend, ruler=time_ms):
    """The library yardstick: ``ruler`` (``time_ms`` or ``host_ms``) of one
    SDPA call on the same [B, S, H, hd] tensors (GQA by ``enable_gqa``),
    pinned to ``backend``; None if the backend refuses the shape."""
    from torch.nn.attention import sdpa_kernel

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with sdpa_kernel(backend):
        try:
            return ruler(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
        except RuntimeError:
            return None


def check_flash_attention(cfg) -> dict:
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def qkv(B, Sq, Sk, Hq=cfg.num_heads, Hkv=cfg.num_kv_heads,
            hd=cfg.head_dim_):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(torch.bfloat16)
        return rnd(B, Sq, Hq, hd), rnd(B, Sk, Hkv, hd), rnd(B, Sk, Hkv, hd)

    # the hd 128 case: B 4, S 2048, 16 query and 8 kv heads
    HD128 = (4, 2048, 16, 8, 128)
    cases = [
        # B, Sq, Sk, q_offset, window, softcap, (Hq, Hkv, hd)
        (4, 2048, 2048, 0, 0, 0.0, ()),    # the slice's prefill shape
        (4, 1000, 1000, 0, 0, 0.0, ()),    # ragged edges
        (2, 300, 1324, 1024, 0, 0.0, ()),  # q_offset continuation
        (1, 700, 700, 0, 256, 0.0, ()),    # sliding window
        (1, 333, 333, 0, 0, 50.0, ()),     # logit softcap
        (HD128[0], HD128[1], HD128[1], 0, 0, 0.0, HD128[2:]),
    ] + [(1, P, P, 0, 0, 0.0, ()) for P in sorted({p for p, _ in REQUESTS})]
    worst, results = 0.0, []
    for B, Sq, Sk, qoff, win, cap, heads in cases:
        q, k, v = qkv(B, Sq, Sk, *heads)
        got = flash_attention(q, k, v, causal=True, window=win, softcap=cap,
                              q_offset=qoff).float()
        want = attention_ref(q, k, v, causal=True, window=win, softcap=cap,
                             q_offset=qoff).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        bad = int((err > ATTN_ATOL + ATTN_RTOL * want.abs()).sum())
        worst = max(worst, float(err.max()))
        results.append({"shape": [B, Sq, Sk], "heads": list(q.shape[2:3])
                        + list(k.shape[2:]), "q_offset": qoff,
                        "window": win, "softcap": cap,
                        "max_abs_err": float(err.max()), "outside_tol": bad})
        if bad or not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention outside tolerance: "
                                 f"{results[-1]}")
        del q, k, v, got, want, err

    def timed(B, S, Hq, Hkv, hd, plain=False):
        """Kernel, SDPA and (optionally) plain times at one causal shape,
        with the bound of its work."""
        from torch.nn.attention import SDPBackend

        q, k, v = qkv(B, S, S, Hq, Hkv, hd)
        backends = {b.name: b for b in (SDPBackend.FLASH_ATTENTION,
                                        SDPBackend.CUDNN_ATTENTION)}
        sdpa = {name: _sdpa(q, k, v, b) for name, b in backends.items()}
        fastest = min((b for b in sdpa if sdpa[b] is not None),
                      key=sdpa.get)
        ops = 4 * B * Hq * hd * _pairs(S, S, 0, True, 0)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        t_ops, t_bytes = ops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3

        def kernel():
            return flash_attention(q, k, v, causal=True)

        line = {"shape": [B, S, S, Hq, Hkv, hd], "ms": time_ms(kernel),
                "ms_short_flush": time_ms(kernel, flush_mb=SHORT_FLUSH_MB),
                "host": host_ms(kernel),
                "library_ms": sdpa[fastest], "library": f"SDPA ({fastest})",
                "sdpa_ms_by_backend": sdpa,
                "library_host": _sdpa(q, k, v, backends[fastest], host_ms),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "flops": ops}
        line["tflops"] = ops / line["ms"] * 1e-9
        if plain:
            line["plain_ms"] = time_ms(
                lambda: attention_ref(q, k, v, causal=True), iters=5)
        return line

    # the slice's prefill shape, the main path's longest prompt (one
    # request's prefill) and the hd 128 case
    main = timed(4, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
                 plain=True)
    P = max(p for p, _ in REQUESTS)
    longest = timed(1, P, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_)
    hd128 = timed(*HD128)
    return {"name": "flash_attention", "route": "cuda",
            "source": "repro_torch/kernels/flash_attention/kernel.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
            "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "timed_at": main, "at_longest_prompt": longest, "hd128": hd128,
            "tolerance": {"atol": ATTN_ATOL, "rtol": ATTN_RTOL},
            "cases": results}


def check_rglru_scan(W: int) -> dict:
    from repro_torch.kernels.rglru_scan.ops import lru_scan
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def uni(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    def model_gates(B, S, W):
        # the model's own range: a = exp(-8 softplus(lam) r), b scaled by
        # sqrt(1 - a^2) (models/rglru.py::_lru_gates)
        lam = rnd(W)
        a = torch.exp(-8.0 * torch.logaddexp(lam, torch.zeros_like(lam))
                      * uni(B, S, W))
        return a, torch.sqrt(1.0 - a * a) * rnd(B, S, W)

    def test_gates(B, S, W):
        # tests/test_kernels.py's range, where error accumulates most
        return 0.8 + 0.199 * uni(B, S, W), rnd(B, S, W)

    # the kernel's chunk is 64 steps and its W tile 64 columns; W % 4 != 0
    # or an unaligned base stages by cp.async, the rest by TMA
    cases = [
        # B, S, W, h0, gates, unaligned base
        (HYBRID_B, HYBRID_P, W, True, model_gates, False),  # path's prefill
        (1, 2048, W, True, model_gates, False),
        (1, 1000, W, False, model_gates, False),      # ragged S, h0 = None
        (2, 300, 1000, True, model_gates, False),     # ragged W
        (HYBRID_B, HYBRID_P, W, True, test_gates, False),
        (1, 2048, W, True, test_gates, False),
        (2, 1, W, True, model_gates, False),          # S = 1
        (2, 64, W, True, test_gates, False),          # S = one chunk
        (2, 65, W, True, test_gates, False),          # S = one chunk + 1
        (1, 4096, W, True, test_gates, False),        # 64 chunks, look-back
        (2, 130, 100, True, test_gates, False),       # W % 64 != 0 (TMA)
        (2, 200, 65, True, test_gates, False),        # W % 4 != 0 (cp.async)
        (3, 200, W, False, model_gates, False),       # h0 = None, 4 chunks
        (2, 300, W, True, model_gates, True),         # unaligned (cp.async)
    ]
    worst, results = 0.0, []

    def compare(a, b, h0, h, h_last):
        want, want_last = rglru_scan_ref(a, b, h0)
        torch.cuda.synchronize()
        bad = sum(int(((got - ref).abs()
                       > SCAN_ATOL + SCAN_RTOL * ref.abs()).sum())
                  for got, ref in ((h, want), (h_last, want_last)))
        if not torch.equal(h_last, h[:, -1]):
            bad += 1
        return bad, float((h - want).abs().max()), float(want.abs().max())

    def unaligned(t):
        return torch.empty(t.numel() + 1, device="cuda")[1:].view_as(t) \
            .copy_(t)

    for B, S, Wc, with_h0, gates, shifted in cases:
        a, b = gates(B, S, Wc)
        h0 = rnd(B, Wc) if with_h0 else None
        h, h_last = (lru_scan(unaligned(a), unaligned(b), h0) if shifted
                     else lru_scan(a, b, h0))
        bad, err, top = compare(a, b, h0, h, h_last)
        worst = max(worst, err)
        results.append({"shape": [B, S, Wc], "h0": with_h0,
                        "gates": gates.__name__, "unaligned": shifted,
                        "max_abs_err": err, "max_abs_h": top,
                        "outside_tol": bad})
        if bad or not torch.isfinite(h).all():
            raise AssertionError(f"rglru_scan outside tolerance: "
                                 f"{results[-1]}")
    # calls back to back on one stream reuse the look-back scratch: each
    # must find its ticket counter and look-back words fresh
    ins = [(*test_gates(B, S, Wc), rnd(B, Wc)) for B, S, Wc in
           [(HYBRID_B, HYBRID_P, W)] * 2 + [(1, 2048, W), (2, 65, 100),
                                             (HYBRID_B, HYBRID_P, W)]]
    outs = [lru_scan(a, b, h0) for a, b, h0 in ins]
    back_to_back = [compare(*i, *o)[0] for i, o in zip(ins, outs)]
    if any(back_to_back):
        raise AssertionError(f"rglru_scan back to back outside tolerance: "
                             f"{back_to_back}")
    del ins, outs

    def timed(B, S):
        a, b = model_gates(B, S, W)
        h0 = rnd(B, W)
        h = torch.empty_like(a)
        # read a, b and h0; write h and h_last
        nbytes = 4 * (3 * B * S * W + 2 * B * W)
        return {"shape": [B, S, W], "h0": True, "bytes_moved": nbytes,
                "ms": time_ms(lambda: lru_scan(a, b, h0)),
                "plain_ms": time_ms(lambda: rglru_scan_ref(a, b, h0),
                                    iters=5),
                # the same bytes at the card's achievable rate: not the same
                # function, so not library_ms
                "ruler_add_ms": time_ms(lambda: torch.add(a, b, out=h)),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}

    # the hybrid path's prefill shape, and one long prompt at B 1
    main, long_prompt = timed(HYBRID_B, HYBRID_P), timed(1, 2048)
    return {"name": "rglru_scan", "route": "cuda",
            "source": "repro_torch/kernels/rglru_scan/kernel.cu",
            "replaces": "src/repro/kernels/rglru_scan/kernel.py:51",
            "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "library_note": "no single PyTorch call computes a first-order "
                            "linear recurrence",
            "timed_at": main, "at_b1_s2048": long_prompt,
            "tolerance": {"atol": SCAN_ATOL, "rtol": SCAN_RTOL},
            "back_to_back_calls": len(back_to_back), "cases": results}


# -------------------------------------------------------------- main path
def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtypes and equal bytes."""
    return a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def save_restore(state, target, store_dir: str, nranks: int, device):
    """Save the tensors ``state`` as ``nranks`` ranks through the N-to-M
    engine and restore them onto ``device`` into ``target``'s names, shapes
    and dtypes (meta tensors); checked bit for bit and by ``verify_step``.
    Returns the measurements and the restored tensors."""
    from repro_torch.core.comm import Comm
    from repro_torch.core.store import DatasetStore
    from repro_torch.core.tensor_ckpt import (TensorCheckpoint,
                                              balanced_chunk_partition)
    from repro_torch.core.torch_io import layout_from_torch, load_torch, save_torch

    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    ck = TensorCheckpoint(DatasetStore(store_dir, "w"))
    layout = layout_from_torch(state)
    ck.save_layout(layout)
    ownership = balanced_chunk_partition(layout, nranks)
    _sync(device)
    t0 = time.perf_counter()
    save_torch(ck, state, step=0, ownership=ownership)
    t_save = time.perf_counter() - t0

    ck_r = TensorCheckpoint(DatasetStore(store_dir, "r"))
    t0 = time.perf_counter()
    restored = load_torch(ck_r, target, step=0, device=device)
    _sync(device)
    t_load = time.perf_counter() - t0
    mismatched = [n for n in state if not _same_bits(restored[n], state[n])]
    if mismatched:
        raise AssertionError(f"restore is not bit-exact for {mismatched}")
    if not ck_r.verify_step(Comm(1), 0):
        raise AssertionError("verify_step failed on the saved store")
    gib = nbytes / 2**30
    return {"bytes": nbytes, "save_ranks": nranks, "load_ranks": 1,
            "save_seconds": t_save, "load_seconds": t_load,
            "save_gib_per_s": gib / t_save, "load_gib_per_s": gib / t_load,
            "bit_exact": True, "verify_step": True,
            "ownership_chunks": [int(sum(len(o) for o in r.values()))
                                 for r in ownership]}, restored


def phase_ckpt(api, params, store_dir: str, nranks: int, device):
    """Save ``params`` as ``nranks`` ranks, restore onto one device."""
    line, restored = save_restore(params, api.abstract_params(), store_dir,
                                  nranks, device)
    return {"phase": "ckpt", "params": sum(t.numel() for t in params.values()),
            **line}, restored


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def sequential_greedy(api, params, prompt, max_new, max_seq, rows):
    """One request alone: a B=1 prefill, then greedy decode steps in a
    ``rows``-slot batch with the request in slot 0 and the others idle — the
    engine's batch shape, so each step's products have the engine's shapes."""
    dev = params["embed"].device
    logits, one = api.prefill(
        params, {"tokens": torch.from_numpy(prompt[None, :]).to(dev)}, max_seq)
    shape = (one["k"].shape[0], rows) + tuple(one["k"].shape[2:])
    cache = {key: torch.zeros(shape, dtype=one[key].dtype, device=dev)
             for key in ("k", "v")}
    for key in ("k", "v"):
        cache[key][:, 0] = one[key][:, 0]
    cache["length"] = torch.zeros(rows, dtype=torch.int32, device=dev)
    cache["length"][0] = len(prompt)
    out = [int(torch.argmax(logits[0]))]
    for _ in range(max_new - 1):
        tok = torch.zeros((rows, 1), dtype=torch.int32, device=dev)
        tok[0, 0] = out[-1]
        logits, cache = api.decode_step(
            params, cache, {"token": tok, "pos": cache["length"].clone()})
        out.append(int(torch.argmax(logits[0])))
    return out


def phase_serve(api, params, requests, slots: int, device) -> tuple[dict, dict]:
    """Serve ``requests`` with continuous batching; returns the phase line
    and the generated tokens."""
    from repro_torch.serve import TorchServeEngine

    spent = {"prefill": 0.0, "decode": 0.0, "prefill_calls": 0,
             "decode_calls": 0}

    def timed(kind, fn):
        def call(*a, **kw):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _sync(device)
            spent[kind] += time.perf_counter() - t0
            spent[kind + "_calls"] += 1
            return out
        return call

    timed_api = dataclasses.replace(
        api, prefill=timed("prefill", api.prefill),
        decode_step=timed("decode", api.decode_step))
    max_seq = max(len(p) + n for _, p, n in requests) + 1
    engine = TorchServeEngine(timed_api, params, slots=slots, max_seq=max_seq)
    for rid, prompt, max_new in requests:
        engine.submit(rid, prompt, max_new)
    t0 = time.perf_counter()
    results = engine.run()
    _sync(device)
    wall = time.perf_counter() - t0
    prompt_tokens = sum(len(p) for _, p, _ in requests)
    generated = sum(len(v) for v in results.values())
    line = {"phase": "serve", "requests": len(requests), "slots": slots,
            "max_seq": max_seq, "prompt_tokens": prompt_tokens,
            "generated_tokens": generated, "seconds": wall,
            "prefill_seconds": spent["prefill"],
            "decode_seconds": spent["decode"],
            "decode_steps": spent["decode_calls"],
            "prefill_tokens_per_s": prompt_tokens / spent["prefill"],
            "decode_tokens_per_s": (generated - len(requests)) / spent["decode"]}
    return line, results


def make_requests(vocab: int, spec=REQUESTS):
    rng = np.random.default_rng(SEED)
    return [(rid, rng.integers(0, vocab, size=p).astype(np.int32), n)
            for rid, (p, n) in enumerate(spec)]


def check_served(api, params, requests, results, slots: int) -> dict:
    max_seq = max(len(p) + n for _, p, n in requests) + 1
    if set(results) != {rid for rid, _, _ in requests}:
        raise AssertionError(f"served {sorted(results)}")
    for rid, prompt, max_new in requests:
        want = sequential_greedy(api, params, prompt, max_new, max_seq, slots)
        if results[rid] != want:
            raise AssertionError(f"request {rid}: engine {results[rid]} != "
                                 f"sequential greedy {want}")
    return {"token_for_token": True}


def check_model_logits(api, params) -> dict:
    """The full model's prefill logits through the kernel vs the plain
    naive attention on the card: finite, same shape, close."""
    rng = np.random.default_rng(SEED + 1)
    tokens = torch.from_numpy(
        rng.integers(0, api.cfg.vocab, size=(2, 96)).astype(np.int32)).cuda()
    from repro_torch.models.api import build_model

    naive = build_model(dataclasses.replace(api.cfg, attention_impl="naive"))
    got, _ = api.prefill(params, {"tokens": tokens})
    want, _ = naive.prefill(params, {"tokens": tokens})
    if got.shape != (2, api.cfg.vocab) or not torch.isfinite(got).all():
        raise AssertionError(f"prefill logits {tuple(got.shape)} not finite")
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    if diff > 0.1 * scale:
        raise AssertionError(f"kernel-path logits differ from the naive "
                             f"path by {diff} (max |logit| {scale})")
    return {"logits_max_abs_diff_vs_naive": diff, "max_abs_logit": scale,
            "same_argmax": bool((got.argmax(-1) == want.argmax(-1)).all())}


# -------------------------------------------------------------- hybrid path
def phase_hybrid_serve(api, params, tokens, device) -> tuple[dict, dict]:
    """One batched prefill and HYBRID_G lockstep decode steps through the
    launcher's ``serve_batch``.  Returns the phase line and what the later
    phases need: the generated tokens, a clone of the prefill's cache and
    row 0's logits at the CONSISTENCY_STEPS."""
    from repro_torch.launch.serve import serve_batch

    kept = {"step_logits": {}}

    def on_prefill(logits, cache):
        kept["cache"] = {k: v.clone() for k, v in cache.items()}

    def on_step(i, logits):
        if i in CONSISTENCY_STEPS:
            kept["step_logits"][i] = logits[0].float().clone()

    B, P = tokens.shape
    torch.cuda.reset_peak_memory_stats()
    out, timings = serve_batch(api, params, tokens, HYBRID_G, device,
                               on_prefill=on_prefill, on_step=on_step)
    if out.shape != (B, HYBRID_G + 1) or not (
            (out >= 0) & (out < api.cfg.vocab)).all():
        raise AssertionError(f"served tokens {out.shape} out of range")
    if not all(torch.isfinite(t).all() for t in kept["step_logits"].values()):
        raise AssertionError("decode logits are not finite")
    kept["tokens"] = out
    t_pre, t_dec = timings["prefill_seconds"], timings["decode_seconds"]
    line = {"phase": "hybrid_serve", "arch": api.cfg.arch,
            "params": sum(t.numel() for t in params.values()),
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in params.values()),
            "layers": api.cfg.num_layers, "batch": B, "prompt_len": P,
            "decode_steps": HYBRID_G, "prefill_seconds": t_pre,
            "prefill_tokens_per_s": B * P / t_pre,
            "decode_seconds": t_dec,
            "decode_tokens_per_s": B * HYBRID_G / t_dec,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "sample_tokens": out[0, :8].tolist()}
    return line, kept


def phase_hybrid_state(api, params, kept, store_dir: str, nranks: int,
                       device) -> dict:
    """The prefill's cache saved as ``nranks`` ranks, restored onto this
    card, checked bit for bit; decoding from it must give the same tokens."""
    from repro_torch.launch.serve import decode_steps

    cache, out = kept["cache"], kept["tokens"]
    line, restored = save_restore(
        cache, api.abstract_cache(out.shape[0], HYBRID_P + HYBRID_G),
        store_dir, nranks, device)
    first = torch.from_numpy(out[:, :1].copy()).to(device)
    with torch.inference_mode():
        toks = decode_steps(api, params, restored, first, HYBRID_P, HYBRID_G,
                            device)
    if not np.array_equal(torch.cat(toks, dim=1).cpu().numpy(), out):
        raise AssertionError("decoding from the restored state gave other "
                             "tokens than the original state")
    return {"phase": "hybrid_state",
            "arrays": {k: [list(v.shape), str(v.dtype).removeprefix("torch.")]
                       for k, v in cache.items()},
            **line, "continued_tokens_identical": True}


def phase_hybrid_consistency(api, params, tokens, kept) -> dict:
    """Row 0: the logits of decode step g against one prefill of the prompt
    plus the first g generated tokens."""
    out = kept["tokens"]
    dev = params["embed"].device
    results = []
    for g in CONSISTENCY_STEPS:
        seq = torch.cat([tokens[0], torch.from_numpy(out[0, :g]).to(dev)])
        with torch.inference_mode():
            want, _ = api.prefill(params, {"tokens": seq[None]})
        want = want[0].float()
        got = kept["step_logits"][g]
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        top2 = torch.topk(want, 2).values
        results.append({"step": g, "max_abs_diff": diff,
                        "max_abs_logit": scale, "rel": diff / scale,
                        "same_argmax": int(got.argmax()) == int(want.argmax()),
                        "prefill_top2_gap": float(top2[0] - top2[1])})
    line = {"phase": "hybrid_consistency", "rtol": CONSISTENCY_RTOL,
            "cases": results}
    emit(line)
    bad = [r for r in results
           if not r["same_argmax"] or r["rel"] > CONSISTENCY_RTOL]
    if bad:
        raise AssertionError(f"decode disagrees with prefill: {bad}")
    return line


# ------------------------------------------------------------ train path
def check_flash_vjp(cfg, device) -> dict:
    """dq, dk, dv of the kernel's autograd Function against autograd through
    the plain blocked ``flash_attention_xla`` at the train path's shape, on
    the same upstream gradient; and against autograd through the plain f32
    attention (reported, not held: bf16 against f32)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_vjp
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.layers import flash_attention_xla

    gen = torch.Generator(device=device).manual_seed(SEED)
    shapes = [(TRAIN_B, TRAIN_S, cfg.num_heads, cfg.head_dim_)] + [
        (TRAIN_B, TRAIN_S, cfg.num_kv_heads, cfg.head_dim_)] * 2
    q, k, v, g = (torch.randn(s, generator=gen, device=device)
                  .to(torch.bfloat16) for s in shapes + shapes[:1])
    blocks = dict(block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)

    def grads(fn, dtype=torch.bfloat16):
        ts = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(fn(*ts), ts, g.to(dtype))

    got = grads(lambda a, b, c: flash_attention_vjp(
        a, b, c, True, 0, 0.0, cfg.attn_block_q, cfg.attn_block_k, 0))
    want = grads(lambda a, b, c: flash_attention_xla(a, b, c, causal=True,
                                                     **blocks))
    exact = grads(lambda a, b, c: attention_ref(a, b, c, causal=True),
                  torch.float32)
    torch.cuda.synchronize()
    line = {"shape": [TRAIN_B, TRAIN_S, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim_], "blocks": blocks,
            "tolerance": {"atol": VJP_ATOL, "rtol": VJP_RTOL}}
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, exact):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        line[name] = {
            "max_abs_err": float(err.max()),
            "outside_tol": int((err > VJP_ATOL + VJP_RTOL * b.abs()).sum()),
            "bit_equal": bool(torch.equal(a, b)),
            "max_abs_err_vs_f32": float((a - c).abs().max()),
            "max_abs_f32": float(c.abs().max())}
        if line[name]["outside_tol"] or not torch.isfinite(a).all():
            raise AssertionError(f"flash_attention_vjp {name} outside "
                                 f"tolerance: {line[name]}")
    return line


def phase_train(cfg, device, store_dirs) -> dict:
    """Runs A, B and C (see the module docstring) through the TorchTrainer,
    with the launch counts at 0 just before each run and read just after."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.device import use_deterministic_algorithms
    from repro_torch.kernels.ckpt_pack import ops as pack_ops
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.models.api import build_model
    from repro_torch.train import (AdamW, SimulatedPreemption, SyntheticLM,
                                   TorchTrainer, TrainerConfig,
                                   init_train_state, make_train_step,
                                   warmup_cosine)

    use_deterministic_algorithms()
    api = build_model(cfg)
    opt = AdamW()
    step = make_train_step(
        api, opt, functools.partial(warmup_cosine, base_lr=TRAIN_LR,
                                    warmup=TRAIN_WARMUP, total=TRAIN_STEPS),
        ShapeConfig("train", TRAIN_S, TRAIN_B, "train"))
    step_seconds, step_fn = [], step.fn
    # clones of the arrays the postprocess phase sweeps, for each step run
    # B or C commits: run A's after step SWEEP_CHECK_A, those run C
    # restores, and run C's at the end
    kept, capture_a = {}, False

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t0)
        if capture_a and int(out[0]["step"]) == SWEEP_CHECK_A:
            kept[SWEEP_CHECK_A] = {n: out[0][n].clone() for n in SWEEP_ARRAYS}
        return out

    step = dataclasses.replace(step, fn=timed_step)
    data = SyntheticLM(cfg.vocab, TRAIN_S, TRAIN_B, seed=SEED)

    def trainer(store_dir, ckpt_every):
        return TorchTrainer(
            step, data, TrainerConfig(store_dir, ckpt_every=ckpt_every,
                                      log_every=1), device=device,
            init_state_fn=lambda: init_train_state(
                api, opt, torch.Generator(device=device).manual_seed(SEED)))

    vjp = check_flash_vjp(cfg, device)
    per_step = 2 * cfg.num_layers     # remat re-runs each layer's forward
    launches = {"flash_attention": 0, "ckpt_pack": 0}

    def counted(run, steps_run, saves):
        """``run()`` with the counts at 0 just before and read just after;
        the attention kernel must have launched ``per_step`` times a step
        run, ckpt_pack on every save."""
        pack_ops.launches = attn_ops.launches = 0
        per_save = []
        out = run(per_save)
        got = {"flash_attention": attn_ops.launches,
               "ckpt_pack": pack_ops.launches}
        for k, n in got.items():
            launches[k] += n
        if got["flash_attention"] != per_step * steps_run:
            raise AssertionError(f"flash_attention launched "
                                 f"{got['flash_attention']} times in "
                                 f"{steps_run} steps, not "
                                 f"{per_step * steps_run}")
        if len(per_save) != saves or not all(per_save):
            raise AssertionError(f"ckpt_pack launches per save {per_save}, "
                                 f"expected {saves} saves, each above 0")
        return out, got, per_save

    def counting_saves(t, per_save):
        save = t._save

        def wrapped(state, i):
            before = pack_ops.launches
            save(state, i)
            per_save.append(pack_ops.launches - before)
        t._save = wrapped
        return t

    # ---- A: TRAIN_STEPS straight, no checkpoint
    torch.cuda.reset_peak_memory_stats()
    ta = trainer(store_dirs[0], 0)
    capture_a = True
    ra, a_counts, _ = counted(lambda ps: ta.run(TRAIN_STEPS), TRAIN_STEPS, 0)
    capture_a = False
    peak = torch.cuda.max_memory_allocated()
    a_times = list(step_seconds)
    losses = [h["loss"] for h in ta.history]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"run A's loss is not finite and falling: "
                             f"{losses}")

    # ---- B: saves every TRAIN_CKPT_EVERY steps, preempted at TRAIN_FAIL_AT
    tb = trainer(store_dirs[1], TRAIN_CKPT_EVERY)

    def run_b(per_save):
        counting_saves(tb, per_save)
        try:
            tb.run(TRAIN_STEPS, fail_at=TRAIN_FAIL_AT)
        except SimulatedPreemption:
            return None
        raise AssertionError("run B was not preempted")

    committed = TRAIN_FAIL_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
    _, b_counts, b_saves = counted(run_b, TRAIN_FAIL_AT,
                                   TRAIN_FAIL_AT // TRAIN_CKPT_EVERY)
    writes = {j["label"]: j["seconds"] for j in tb._async.job_log}

    # ---- C: a fresh trainer restores the last committed step, runs to the end
    tc = trainer(store_dirs[1], TRAIN_CKPT_EVERY)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, start = tc.restore_latest()
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    if start != committed:
        raise AssertionError(f"restored step {start}, not {committed}")
    kept[start] = {n: state[n].clone() for n in SWEEP_ARRAYS}
    rc, c_counts, c_saves = counted(
        lambda ps: counting_saves(tc, ps).run(TRAIN_STEPS, start_state=state,
                                              start_step=start),
        TRAIN_STEPS - start,
        TRAIN_STEPS // TRAIN_CKPT_EVERY - start // TRAIN_CKPT_EVERY)
    differ = [k for k in ra["state"]
              if not _same_bits(ra["state"][k], rc["state"][k])]
    if differ:
        raise AssertionError(f"the resumed run's state differs from the "
                             f"straight run's in {differ}")
    kept[TRAIN_STEPS] = {n: rc["state"][n].clone() for n in SWEEP_ARRAYS}
    resumed = {h["step"]: h["loss"] for h in tc.history}
    straight = {h["step"]: h["loss"] for h in ta.history}
    if any(resumed[s] != straight[s] for s in resumed):
        raise AssertionError(f"resumed losses {resumed} != straight "
                             f"{straight}")
    state_bytes = sum(t.numel() * t.element_size()
                      for t in ra["state"].values())
    median = float(np.median(a_times[1:]))
    return {"phase": "train", "arch": cfg.arch, "layers": cfg.num_layers,
            "params": sum(t.numel() for k, t in ra["state"].items()
                          if k.startswith("params/")),
            "state_bytes": state_bytes, "batch": TRAIN_B, "seq": TRAIN_S,
            "attention_impl": cfg.attention_impl, "remat": cfg.remat,
            "deterministic": torch.are_deterministic_algorithms_enabled(),
            "vjp_check": vjp,
            "losses": losses, "step_seconds_a": a_times,
            "step_ms_median_2_to_6": median * 1e3,
            "tokens_per_s": TRAIN_B * TRAIN_S / median,
            "peak_memory_allocated": peak,
            "saves": [{**s, "ckpt_pack_launches": n,
                       "write_seconds": writes.get(f"state/s{s['step']}")}
                      for s, n in zip(tb.save_log, b_saves)],
            "restored_step": start, "restore_seconds": t_restore,
            "restore_gib_per_s": state_bytes / 2**30 / t_restore,
            "resumed_losses": resumed, "bit_exact_with_straight_run": True,
            "launches": {"a": a_counts, "b": b_counts, "c": c_counts,
                         "c_ckpt_pack_per_save": c_saves,
                         "flash_attention_per_step": per_step},
            "total_launches": launches}, kept


def fem_field(t: int):
    """The host field saved at time index ``t``: the FE benchmark's
    sin(3x)(2 + cos 5y) + xy at t = 0, tilted by t(x - y) after."""
    def field(p):
        x, y = p[:, 0], p[:, 1]
        return np.sin(3 * x) * (2 + np.cos(5 * y)) + x * y + t * (x - y)
    return field


def phase_fem(device, store_dir: str) -> dict:
    """The paper's own path at full size: a P4 function on a 512 x 512
    triangle mesh, its DoF vectors on the card, saved N-to-M from 8
    simulated ranks at 3 time indices through the async facade, loaded on
    M = 1 (onto the card) and on M = 3; every loaded DoF is checked bit for
    bit against the field at its reconstructed node point (the paper's
    §6.1 criterion)."""
    from repro_torch.core.async_io import AsyncCheckpointer
    from repro_torch.core.comm import Comm
    from repro_torch.core.store import DatasetStore
    from repro_torch.fem import (Element, FEMCheckpoint, FunctionSpace,
                                 distribute, interpolate, node_points,
                                 tri_mesh_fast)
    from repro_torch.fem.torch_fem import (functions_from_device,
                                           functions_to_device)

    N = FEM_SAVE_RANKS
    mesh = tri_mesh_fast(FEM_NX, FEM_NY)
    t0 = time.perf_counter()
    plexes, _, _ = distribute(mesh, N, method="contiguous", seed=0)
    t_dist = time.perf_counter() - t0
    spaces = [FunctionSpace(lp, Element("P", FEM_DEGREE, "triangle"))
              for lp in plexes]
    dofs = sum(sp.ndof_owned for sp in spaces)
    # the simulation's DoF vectors live on the card, one per time index
    h2d, d2h, on_card = [], [], []
    for t in range(FEM_TIMES):
        funcs = [interpolate(sp, fem_field(t)) for sp in spaces]
        _sync(device)
        t0 = time.perf_counter()
        on_card.append(functions_to_device(funcs, device))
        _sync(device)
        h2d.append(time.perf_counter() - t0)
    del funcs

    store = DatasetStore(store_dir, "w")
    ac = AsyncCheckpointer(FEMCheckpoint(store), Comm(N))
    t_all = time.perf_counter()
    ac.save_mesh("m", plexes)
    t_save_mesh = time.perf_counter() - t_all
    t_save_fn = []
    for t, values in enumerate(on_card):
        t0 = time.perf_counter()
        host = functions_from_device(spaces, values)
        d2h.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ac.save_function("m", "u", host, time_index=t)
        t_save_fn.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    ac.wait()
    t_wait = time.perf_counter() - t0
    t_all = time.perf_counter() - t_all
    writer = {j["label"]: j["seconds"] for j in ac.job_log}
    write_calls, n_datasets = store.stats.write_calls, len(store.datasets())
    del on_card, host

    loads = []
    for M in FEM_LOAD_RANKS:
        ck = FEMCheckpoint(DatasetStore(store_dir, "r"))
        if ck.steps("m", "u") != list(range(FEM_TIMES)):
            raise AssertionError(f"committed time indices "
                                 f"{ck.steps('m', 'u')}")
        comm = Comm(M)
        t0 = time.perf_counter()
        loaded = ck.load_mesh("m", comm, partition="contiguous")
        t_mesh = time.perf_counter() - t0
        if loaded.E != mesh.num_entities:
            raise AssertionError(f"M={M}: loaded {loaded.E} entities, not "
                                 f"{mesh.num_entities}")
        row = {"load_ranks": M, "load_mesh_s": t_mesh, "load_fn_s": [],
               "h2d_s": [], "dofs_checked": 0}
        for t in range(FEM_TIMES):
            t0 = time.perf_counter()
            lspaces, lfuncs = ck.load_function(loaded, "u", comm,
                                               time_index=t)
            row["load_fn_s"].append(time.perf_counter() - t0)
            if sum(sp.ndof_owned for sp in lspaces) != dofs:
                raise AssertionError(f"M={M} t={t}: owned DoFs differ")
            wants = [fem_field(t)(node_points(sp)) for sp in lspaces]
            if M == 1:
                # the result goes to the card and is checked there
                _sync(device)
                t0 = time.perf_counter()
                got = functions_to_device(lfuncs, device)
                _sync(device)
                row["h2d_s"].append(time.perf_counter() - t0)
                ok = all(_same_bits(g, torch.from_numpy(w).to(device))
                         for g, w in zip(got, wants))
                del got
            else:
                ok = all(np.array_equal(f.values.view(np.int64),
                                        w.view(np.int64))
                         for f, w in zip(lfuncs, wants))
            if not ok:
                raise AssertionError(f"M={M} t={t}: a loaded DoF differs "
                                     f"from the field at its node")
            row["dofs_checked"] += sum(f.values.size for f in lfuncs)
        row["read_calls"] = ck.store.stats.read_calls
        row["dofs_per_s"] = [dofs / s for s in row["load_fn_s"]]
        loads.append(row)
        ck.store.close()
    store.close()
    return {"phase": "fem", "mesh": f"tri_mesh_fast({FEM_NX}, {FEM_NY})",
            "element": f"P{FEM_DEGREE} triangle", "entities":
            mesh.num_entities, "dofs": dofs, "save_ranks": N,
            "time_indices": FEM_TIMES, "distribute_s": t_dist,
            "h2d_s": h2d, "d2h_s": d2h, "save_mesh_s": t_save_mesh,
            "save_fn_s": t_save_fn, "wait_s": t_wait,
            "save_wall_s": t_all, "writer_s": writer,
            "arena_blocked_s": ac.arena.stats.blocked_seconds,
            "save_dofs_per_s": dofs * FEM_TIMES / t_all,
            "write_calls": write_calls, "datasets": n_datasets,
            "loads": loads, "bit_exact": True}


def phase_postprocess(store_dir: str, kept: dict, device) -> dict:
    """Save big, post-process small: sweep every committed step of the
    train phase's store (runs B and C: the full smollm-135m train state at
    steps 2, 4 and 6) on one rank, loading only ``SWEEP_ARRAYS`` onto the
    card; each swept array must equal the train phase's own, bit for bit,
    and the store must read no more than those arrays' datasets."""
    from repro_torch.core.store import DatasetStore, np_dtype
    from repro_torch.core.tensor_ckpt import TensorCheckpoint
    from repro_torch.core.torch_io import sweep_to_device

    def nbytes(spec):
        return int(np.prod(spec.shape)) * np_dtype(spec.dtype).itemsize

    ck = TensorCheckpoint(DatasetStore(store_dir, "r"))
    steps, layout = ck.steps(), ck.layout()
    if sorted(kept) != steps:
        raise AssertionError(f"committed steps {steps}, kept {sorted(kept)}")
    st = ck.store
    stored = 0                  # the swept arrays' datasets, every step
    for s in steps:
        for logical, phys in st.step_datasets(s).items():
            if any(logical.startswith(f"{n}/e") for n in SWEEP_ARRAYS):
                stored += (st.rows(phys) * st.dtype(phys).itemsize
                           * int(np.prod(st.row_shape(phys), initial=1)))
    array_bytes = sum(nbytes(layout.spec(n)) for n in SWEEP_ARRAYS)
    state_bytes = sum(nbytes(spec) for spec in layout.arrays)
    read0 = st.stats.bytes_read
    it = sweep_to_device(ck, SWEEP_ARRAYS, device)
    per_step = []
    while True:
        _sync(device)
        t0 = time.perf_counter()
        try:
            step, arrays = next(it)
        except StopIteration:
            break
        _sync(device)
        dt = time.perf_counter() - t0
        differ = [n for n in SWEEP_ARRAYS
                  if arrays[n].device.type != device.type
                  or not _same_bits(arrays[n], kept[step][n])]
        if differ:
            raise AssertionError(f"step {step}: swept {differ} differ from "
                                 f"the train phase's")
        per_step.append({"step": step, "seconds": dt,
                         "gib_per_s": array_bytes / 2**30 / dt})
    bytes_read = st.stats.bytes_read - read0
    if [r["step"] for r in per_step] != steps:
        raise AssertionError(f"swept {[r['step'] for r in per_step]}, "
                             f"committed {steps}")
    if bytes_read > stored:
        raise AssertionError(f"the sweep read {bytes_read} bytes, more than "
                             f"the swept arrays' {stored}: it touched "
                             f"another array's datasets")
    st.close()
    return {"phase": "postprocess", "arrays": list(SWEEP_ARRAYS),
            "layout_arrays": len(layout.names), "steps": per_step,
            "array_bytes_per_step": array_bytes,
            "state_bytes_per_step": state_bytes,
            "stored_bytes_of_swept_arrays": stored,
            "bytes_read": bytes_read, "read_calls": st.stats.read_calls,
            "bit_exact": True}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not (ROOT / "repro_torch" / "__init__.py").exists():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # before the first cuBLAS call: the train phase runs in deterministic
    # mode, which needs cuBLAS's fixed workspace
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.tensor_ckpt import balanced_chunk_partition
    from repro_torch.core.torch_io import layout_from_torch
    from repro_torch.kernels.ckpt_pack import ops as pack_ops
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.models.api import build_model, make_token_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()

    cfg = dataclasses.replace(get_config("smollm_135m"),
                              attention_impl="pallas")
    api = build_model(cfg)
    # as the launcher does; the RG-LRU family ignores attention_impl
    hcfg = dataclasses.replace(get_config("recurrentgemma_9b"),
                               attention_impl="pallas")
    hapi = build_model(hcfg)
    device = torch.device("cuda")
    scratch = ROOT / "build" / "chip_smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="store_", dir=scratch)
    hybrid_store = tempfile.mkdtemp(prefix="store_", dir=scratch)
    train_stores = [tempfile.mkdtemp(prefix="train_", dir=scratch)
                    for _ in range(2)]
    fem_store = tempfile.mkdtemp(prefix="fem_", dir=scratch)
    try:
        with torch.inference_mode():
            params = api.init(torch.Generator(device=device).manual_seed(SEED))
            layout = layout_from_torch(params)
            ownership = balanced_chunk_partition(layout, NRANKS)
            # ---- each kernel against its plain version, with its times
            kernels = [check_ckpt_pack(params, layout, ownership),
                       check_flash_attention(cfg),
                       check_rglru_scan(hcfg.lru_width)]
            for entry in kernels:
                emit({"phase": "kernels", **entry})
            if "--kernels-only" in argv:
                return 0
            # ---- the smollm path: counts at 0 just before, read just after
            pack_ops.launches = attn_ops.launches = scan_ops.launches = 0
            ckpt, restored = phase_ckpt(api, params, store_dir, NRANKS, device)
            requests = make_requests(cfg.vocab)
            serve, results = phase_serve(api, restored, requests, SLOTS, device)
            dense = {"ckpt_pack": pack_ops.launches,
                     "flash_attention": attn_ops.launches}
            ckpt["ckpt_pack_launches"] = dense["ckpt_pack"]
            emit(ckpt)
            serve["flash_attention_launches"] = dense["flash_attention"]
            serve.update(check_served(api, restored, requests, results, SLOTS))
            serve.update(check_model_logits(api, restored))
            emit(serve)
            if not all(dense.values()):
                raise AssertionError(f"a kernel of the smollm path never "
                                     f"launched: {dense}")
            del params, restored, layout, ownership
            torch.cuda.empty_cache()

            # ---- the hybrid path: counts at 0 just before, read just after
            hparams = hapi.init(
                torch.Generator(device=device).manual_seed(SEED))
            tokens = torch.from_numpy(make_token_batch(
                hcfg, ShapeConfig("serve", HYBRID_P, HYBRID_B, "prefill"),
                seed=SEED)["tokens"]).to(device)
            pack_ops.launches = attn_ops.launches = scan_ops.launches = 0
            hserve, kept = phase_hybrid_serve(hapi, hparams, tokens, device)
            # one launch per RG-LRU layer of the one prefill
            n_lru = sum(k == "lru" for k in hcfg.layer_kinds())
            hserve["rglru_scan_launches"] = scan_ops.launches
            emit(hserve)
            if scan_ops.launches != n_lru:
                raise AssertionError(f"rglru_scan launched {scan_ops.launches}"
                                     f" times in one prefill, not {n_lru}")
            hstate = phase_hybrid_state(hapi, hparams, kept, hybrid_store,
                                        NRANKS, device)
            hybrid = {"rglru_scan": scan_ops.launches,
                      "ckpt_pack": pack_ops.launches}
            hstate["ckpt_pack_launches"] = hybrid["ckpt_pack"]
            emit(hstate)
            if not all(hybrid.values()):
                raise AssertionError(f"a kernel of the hybrid path never "
                                     f"launched: {hybrid}")
            phase_hybrid_consistency(hapi, hparams, tokens, kept)
            del hparams, kept, tokens
            torch.cuda.empty_cache()

        # ---- the train path, outside inference mode (autograd needs it)
        train, kept = phase_train(dataclasses.replace(cfg, remat=True),
                                  device, train_stores)
        emit(train)

        # ---- the FE path and the post-processing sweep: no kernel of the
        # port runs on them (the engine's gathers are host code); the counts
        # are set to 0 just before each and read just after all the same
        for run in (lambda: phase_fem(device, fem_store),
                    lambda: phase_postprocess(train_stores[1], kept,
                                              device)):
            pack_ops.launches = attn_ops.launches = scan_ops.launches = 0
            t0 = time.perf_counter()
            line = run()
            line["phase_seconds"] = time.perf_counter() - t0
            line["kernel_launches"] = {"ckpt_pack": pack_ops.launches,
                                       "flash_attention": attn_ops.launches,
                                       "rglru_scan": scan_ops.launches}
            emit(line)
    finally:
        for d in [store_dir, hybrid_store, fem_store] + train_stores:
            shutil.rmtree(d, ignore_errors=True)
    launches = {"ckpt_pack": dense["ckpt_pack"] + hybrid["ckpt_pack"]
                + train["total_launches"]["ckpt_pack"],
                "flash_attention": dense["flash_attention"]
                + train["total_launches"]["flash_attention"],
                "rglru_scan": hybrid["rglru_scan"]}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: e[k] for k in keys}
                      for e in ({**e, "launches": launches[e["name"]]}
                                for e in kernels)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

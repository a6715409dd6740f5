#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``repro_torch``) on one card.

Drives the port's serving main path at the full width of smollm-135m:

  device   the card's name and power limit (nvidia-smi);
  build    the hand-written kernels, compiled from this checkout's sources;
  kernels  each kernel against its plain PyTorch version on the card, at the
           main path's shapes, with its time, bound, plain and library times;
  ckpt     a seeded full-width state on the card, saved as N=4 ranks through
           the N-to-M engine (ckpt_pack packs each rank's chunks), restored
           N-to-M onto this one card, checked bit for bit;
  serve    continuous batching from the restored parameters (prefill through
           the flash-attention kernel), token for token against sequential
           greedy decoding.

Every phase prints one JSON line; a failing phase raises and the script
exits non-zero.  Before the last line come the {"kernels": [...]} line and
the card's name and power limit; the last line is
{"ok": true, "device": {...}}.  Needs one CUDA card and the repository
around it; imports nothing of JAX.

    python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
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

SEED = 0
NRANKS = 4
SLOTS = 4
# (prompt length, max_new) of the served requests
REQUESTS = [(16, 8), (512, 32), (77, 16), (200, 24), (33, 12), (384, 32),
            (128, 20), (250, 8)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, by CUDA events around each call,
    with the 50 MB L2 cache flushed before each (a cold caller)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
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
    emit({"phase": "build", "seconds": res["seconds"], "built": res["built"],
          "ptxas": ptxas})


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
    # time the largest call of the main path
    nbytes, name, src, ords = max(calls, key=lambda c: c[0])
    idx_dev = torch.as_tensor(ords, dtype=torch.int32, device="cuda")
    ms = time_ms(lambda: pack_chunks(src, idx_dev))
    plain_ms = time_ms(lambda: ckpt_pack_ref(src, idx_dev))
    idx_long = idx_dev.long()
    library_ms = time_ms(lambda: torch.index_select(src, 0, idx_long))
    return {"name": "ckpt_pack", "route": "cuda",
            "source": "repro_torch/kernels/ckpt_pack/kernel.cu",
            "replaces": "src/repro/kernels/ckpt_pack/kernel.py:40",
            "max_abs_err": float(worst), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": library_ms,
            "checks": checks, "timed_at": {
                "array": name, "src": list(src.shape), "chunks": len(ords),
                "bytes_moved": 2 * nbytes}}


def check_flash_attention(cfg) -> dict:
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def qkv(B, Sq, Sk):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(torch.bfloat16)
        return rnd(B, Sq, Hq, hd), rnd(B, Sk, Hkv, hd), rnd(B, Sk, Hkv, hd)

    cases = [
        # B, Sq, Sk, q_offset, window, softcap
        (4, 2048, 2048, 0, 0, 0.0),        # the slice's prefill shape
        (4, 1000, 1000, 0, 0, 0.0),        # ragged edges
        (2, 300, 1324, 1024, 0, 0.0),      # q_offset continuation
        (1, 700, 700, 0, 256, 0.0),        # sliding window
        (1, 333, 333, 0, 0, 50.0),         # logit softcap
    ] + [(1, P, P, 0, 0, 0.0) for P in sorted({p for p, _ in REQUESTS})]
    worst, results = 0.0, []
    for B, Sq, Sk, qoff, win, cap in cases:
        q, k, v = qkv(B, Sq, Sk)
        got = flash_attention(q, k, v, causal=True, window=win, softcap=cap,
                              q_offset=qoff).float()
        want = attention_ref(q, k, v, causal=True, window=win, softcap=cap,
                             q_offset=qoff).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        bad = int((err > ATTN_ATOL + ATTN_RTOL * want.abs()).sum())
        worst = max(worst, float(err.max()))
        results.append({"shape": [B, Sq, Sk], "q_offset": qoff,
                        "window": win, "softcap": cap,
                        "max_abs_err": float(err.max()), "outside_tol": bad})
        if bad or not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention outside tolerance: "
                                 f"{results[-1]}")
    # timing at the slice's prefill shape
    B, S = 4, 2048
    q, k, v = qkv(B, S, S)
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=True), iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    ops = 4 * B * Hq * hd * _pairs(S, S, 0, True, 0)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    t_ops, t_bytes = ops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    # the main path's longest prompt (one request's prefill)
    P = max(p for p, _ in REQUESTS)
    q1, k1, v1 = qkv(1, P, P)
    ms_main = time_ms(lambda: flash_attention(q1, k1, v1, causal=True))
    return {"name": "flash_attention", "route": "cuda",
            "source": "repro_torch/kernels/flash_attention/kernel.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "timed_at": [B, S, S, Hq, Hkv, hd],
            "tolerance": {"atol": ATTN_ATOL, "rtol": ATTN_RTOL},
            "ms_at_longest_prompt": {"shape": [1, P, P], "ms": ms_main},
            "cases": results}


# -------------------------------------------------------------- main path
def phase_ckpt(api, params, store_dir: str, nranks: int, device):
    """Save ``params`` as ``nranks`` ranks, restore onto one device."""
    from repro_torch.core.comm import Comm
    from repro_torch.core.store import DatasetStore
    from repro_torch.core.tensor_ckpt import (TensorCheckpoint,
                                              balanced_chunk_partition)
    from repro_torch.core.torch_io import layout_from_torch, load_torch, save_torch

    nbytes = sum(t.numel() * t.element_size() for t in params.values())
    ck = TensorCheckpoint(DatasetStore(store_dir, "w"))
    layout = layout_from_torch(params)
    ck.save_layout(layout)
    ownership = balanced_chunk_partition(layout, nranks)
    _sync(device)
    t0 = time.perf_counter()
    save_torch(ck, params, step=0, ownership=ownership)
    t_save = time.perf_counter() - t0

    ck_r = TensorCheckpoint(DatasetStore(store_dir, "r"))
    t0 = time.perf_counter()
    restored = load_torch(ck_r, api.abstract_params(), step=0, device=device)
    _sync(device)
    t_load = time.perf_counter() - t0
    mismatched = [n for n in params
                  if not torch.equal(restored[n].reshape(-1).view(torch.uint8),
                                     params[n].reshape(-1).view(torch.uint8))]
    if mismatched:
        raise AssertionError(f"restore is not bit-exact for {mismatched}")
    if not ck_r.verify_step(Comm(1), 0):
        raise AssertionError("verify_step failed on the saved store")
    gib = nbytes / 2**30
    return {"phase": "ckpt", "params": sum(t.numel() for t in params.values()),
            "bytes": nbytes, "save_ranks": nranks, "load_ranks": 1,
            "save_seconds": t_save, "load_seconds": t_load,
            "save_gib_per_s": gib / t_save, "load_gib_per_s": gib / t_load,
            "bit_exact": True, "verify_step": True,
            "ownership_chunks": [int(sum(len(o) for o in r.values()))
                                 for r in ownership]}, restored


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
    from repro_torch.configs import get_config
    from repro_torch.core.tensor_ckpt import balanced_chunk_partition
    from repro_torch.core.torch_io import layout_from_torch
    from repro_torch.kernels.ckpt_pack import ops as pack_ops
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.models.api import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()

    cfg = dataclasses.replace(get_config("smollm_135m"),
                              attention_impl="pallas")
    api = build_model(cfg)
    device = torch.device("cuda")
    scratch = ROOT / "build" / "chip_smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="store_", dir=scratch)
    try:
        with torch.inference_mode():
            params = api.init(torch.Generator(device=device).manual_seed(SEED))
            layout = layout_from_torch(params)
            ownership = balanced_chunk_partition(layout, NRANKS)
            # ---- each kernel against its plain version, with its times
            kernels = [check_ckpt_pack(params, layout, ownership),
                       check_flash_attention(cfg)]
            for entry in kernels:
                emit({"phase": "kernels", **entry})
            if "--kernels-only" in argv:
                return 0
            # ---- the main path: counts at 0 just before, read just after
            pack_ops.launches = attn_ops.launches = 0
            ckpt, restored = phase_ckpt(api, params, store_dir, NRANKS, device)
            requests = make_requests(cfg.vocab)
            serve, results = phase_serve(api, restored, requests, SLOTS, device)
            launches = {"ckpt_pack": pack_ops.launches,
                        "flash_attention": attn_ops.launches}
            ckpt["ckpt_pack_launches"] = launches["ckpt_pack"]
            emit(ckpt)
            serve["flash_attention_launches"] = launches["flash_attention"]
            serve.update(check_served(api, restored, requests, results, SLOTS))
            serve.update(check_model_logits(api, restored))
            emit(serve)
            if not all(launches.values()):
                raise AssertionError(f"a kernel of the main path never "
                                     f"launched: {launches}")
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
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

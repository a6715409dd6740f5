#!/usr/bin/env python3
"""Where a dense model's kernel-path logits error comes from: the model at
full width and depth with seeded weights on one card, fed the prefill
batch of ``chip_smoke.py``'s logits check (B 2, P 96, seed 1).

    python3 tools/logits_error.py

Prints one JSON line for each of qwen3-4b and qwen2-vl-7b, each error as
max |a - b| / max |b| and as rms(a - b) / rms(b):
  * ``end_to_end``: the prefill's last-token logits through the kernel
    (``pallas``), the blocked path (``xla_flash``) and naive attention, each
    pair of the three, and each against the same weights run in f32 with
    naive attention (the bf16 model's own floor);
  * ``by_depth``: the kernel on the first k layers and naive attention on
    the rest, against naive attention on every layer, for k = 0, L/4, L/2,
    3L/4 and L (a fault at one layer shows as a step, rounding as a
    steady climb);
  * ``per_layer``: for each layer's (q, k, v) as the naive run makes them,
    the kernel's, the blocked path's and naive attention's bf16 output
    against attention in f32 on the same inputs (the error one layer
    adds).
Then one line for gemma2-2b past its window, as ``chip_smoke.py``'s
window_serve phase serves it (B 1, a prompt of 4,608 tokens): its
``window_readings`` (the first decode step against one prefill of P + 1,
and the same step with the local layers' window dropped) for the bf16
model and for the same weights in f32.  Needs one CUDA card.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3_4b", "qwen2_vl_7b")
SEED = 0
B, P = 2, 96


def _errors(a, b) -> dict:
    a, b = a.float(), b.float()
    d = a - b
    return {"max": float(d.abs().max() / b.abs().max()),
            "rms": float(d.pow(2).mean().sqrt() / b.pow(2).mean().sqrt())}


def decompose(arch: str, device) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import transformer
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import flash_attention_xla, naive_attention
    from repro_torch.train.step import make_prefill_step

    base = get_config(arch)
    apis = {impl: build_model(dataclasses.replace(base, attention_impl=impl))
            for impl in ("pallas", "xla_flash", "naive")}
    cfg = apis["pallas"].cfg
    shape = ShapeConfig("logits", P, B, "prefill")
    params = apis["pallas"].init(
        torch.Generator(device=device).manual_seed(SEED))
    batch = prompt_batch(cfg, B, P, device, seed=SEED + 1)

    def logits(api, p=None):
        return make_prefill_step(api, shape)(params if p is None else p,
                                             batch)[0]

    out = {impl: logits(api) for impl, api in apis.items()}
    f32 = build_model(dataclasses.replace(base, attention_impl="naive",
                                          dtype="float32"))
    params32 = {k: v.float() for k, v in params.items()}
    out["f32"] = logits(f32, params32)
    del params32
    end_to_end = {f"{a}_vs_{b}": _errors(out[a], out[b]) for a, b in (
        ("pallas", "naive"), ("xla_flash", "naive"), ("pallas", "xla_flash"),
        ("pallas", "f32"), ("xla_flash", "f32"), ("naive", "f32"))}

    # the kernel on the first k layers, naive attention after; the naive
    # run (k = 0) keeps each layer's (q, k, v)
    L, qkv = cfg.num_layers, []

    def mixed(k_layers, keep=False):
        calls = [0]

        def attn(q, k, v, *, causal, window, softcap, q_offset):
            i, calls[0] = calls[0], calls[0] + 1
            if keep:
                qkv.append((q.clone(), k.clone(), v.clone(), window))
            fn = flash_attention if i < k_layers else naive_attention
            return fn(q, k, v, causal=causal, window=window,
                      softcap=softcap, q_offset=q_offset)
        return attn

    by_depth = {}
    try:
        for k_layers in sorted({0, L // 4, L // 2, 3 * L // 4, L}):
            transformer.naive_attention = mixed(k_layers, keep=k_layers == 0)
            by_depth[k_layers] = _errors(logits(apis["naive"]), out["naive"])
    finally:
        transformer.naive_attention = naive_attention

    per_layer = []
    for q, k, v, window in qkv:
        kw = dict(causal=True, window=window, softcap=cfg.attn_softcap)
        truth = attention_ref(q.float(), k.float(), v.float(), **kw)
        per_layer.append({
            "pallas": _errors(flash_attention(q, k, v, **kw), truth),
            "xla_flash": _errors(flash_attention_xla(
                q, k, v, block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
                **kw), truth),
            "naive": _errors(naive_attention(q, k, v, **kw), truth)})
    worst = {impl: max(r[impl]["rms"] for r in per_layer)
             for impl in ("pallas", "xla_flash", "naive")}
    return {"arch": cfg.arch, "layers": L,
            "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_],
            "input": sorted(batch), "batch": B, "prompt_len": P,
            "max_abs_logit": float(out["naive"].abs().max()),
            "end_to_end": end_to_end, "by_depth": by_depth,
            "per_layer_worst_rms": worst, "per_layer": per_layer}


def window(device) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models.api import build_model

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    base = get_config("gemma2_2b")
    P = chip_smoke.WINDOW_P
    api = build_model(base)
    params = api.init(torch.Generator(device=device).manual_seed(SEED))
    tokens = prompt_batch(base, chip_smoke.WINDOW_B, P, device)["tokens"]
    _, kept = chip_smoke.phase_window_serve(api, params, tokens, device)
    first = torch.from_numpy(kept["tokens"][:, :1].copy()).to(device)
    return {"arch": base.arch, "window": base.local_window, "prompt_len": P,
            "bfloat16": chip_smoke.window_readings(
                api, params, tokens, first, kept["cache"],
                kept["first_step_logits"]),
            "float32": chip_smoke.window_f32_readings(api, params, tokens)}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        for arch in ARCHS:
            print(json.dumps(decompose(arch, device)), flush=True)
            torch.cuda.empty_cache()
        print(json.dumps(window(device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the flash-attention kernels of one or more checkouts on one card,
all with this checkout's rulers, to compare two commits in one call.

    python3 tools/flash_timing.py [--rounds N] [--backward-only] ROOT [ROOT ...]

Each ROOT is a checkout of this repository (the parent commit unpacked with
``git archive``, say, or ``.`` for this one).  Each is timed in a process of
its own that imports that ROOT's ``repro_torch`` and builds its kernel from
that ROOT's sources; the rulers are always this checkout's
``chip_smoke.time_ms`` (device time, L2 flushed before each call, with
the default flush and with the short one) and ``chip_smoke.host_ms`` (host
issue time and back-to-back time per call, L2 warm).  The forward's
shapes are smollm-135m's heads (Hq 9, Hkv 3, hd 64, causal) at B 1 and each
prompt length the chip smoke test serves, and at B 4, S 2048
(``--backward-only`` skips them).  Where ROOT has the backward kernel
(``flash_attention_bwd``), it is timed at the three shapes the path runs
or times it at (``BWD_SHAPES``: smollm's train step, granite's, qwen3-4b's
heads at hd 128), each beside SDPA's backward on the FlashAttention-2 and
cuDNN backends (``chip_smoke._sdpa_bwd``), with the forward that writes the
log-sum-exp, and, where ROOT has ``bwd_plan``, its schedule.
``--rounds N`` runs the ROOT list N times over (``build/parent . .
build/parent`` with 5 rounds is ten alternating pairs).  Prints one JSON
line per ROOT and round, in the order run, then one summary line: the
median backward ms per ROOT and shape over the rounds.  Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SEED = 0
# (B, S, Hq, Hkv, hd), causal
BWD_SHAPES = {"smollm": (4, 2048, 9, 3, 64), "granite": (4, 1024, 24, 8, 64),
              "qwen3_4b_hd128": (1, 512, 32, 8, 128)}


def _chip_smoke():
    """This checkout's chip_smoke module, whatever ROOT is on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_root(root: Path, backward_only: bool) -> dict:
    sys.path.insert(0, str(root))
    import torch

    smoke = _chip_smoke()
    from repro_torch.kernels.flash_attention import ops as attn_ops

    if not Path(sys.modules["repro_torch"].__file__).resolve().is_relative_to(
            root):
        raise RuntimeError(f"imported another checkout's repro_torch, not "
                           f"{root}'s")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    line = {"root": str(root), "card": torch.cuda.get_device_name(0)}
    if not backward_only:
        Hq, Hkv, hd = 9, 3, 64
        shapes = [(1, P) for P in sorted({p for p, _ in smoke.REQUESTS})]
        out = []
        for B, S in shapes + [(4, 2048)]:
            q, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda")
                       .to(torch.bfloat16) for H in (Hq, Hkv, Hkv))

            def kernel():
                return attn_ops.flash_attention(q, k, v, causal=True)

            out.append({"shape": [B, S, S, Hq, Hkv, hd],
                        "ms": smoke.time_ms(kernel),
                        "ms_short_flush": smoke.time_ms(
                            kernel, flush_mb=smoke.SHORT_FLUSH_MB),
                        **smoke.host_ms(kernel)})
        line["timings"] = out
    if hasattr(attn_ops, "flash_attention_bwd"):
        from torch.nn.attention import SDPBackend

        line["backward"] = {}
        for name, (B, S, Hq, Hkv, hd) in BWD_SHAPES.items():
            q, k, v, do = (torch.randn((B, S, H, hd), generator=gen,
                                       device="cuda").to(torch.bfloat16)
                           for H in (Hq, Hkv, Hkv, Hq))
            o, lse = attn_ops.flash_attention_fwd_lse(q, k, v)
            rec = {"shape": [B, S, S, Hq, Hkv, hd],
                   "ms": smoke.time_ms(lambda: attn_ops.flash_attention_bwd(
                       q, k, v, o, lse, do)),
                   "forward_lse_ms": smoke.time_ms(
                       lambda: attn_ops.flash_attention_fwd_lse(q, k, v)),
                   "sdpa_bwd_ms_by_backend": {
                       b.name: smoke._sdpa_bwd(q, k, v, do, b)
                       for b in (SDPBackend.FLASH_ATTENTION,
                                 SDPBackend.CUDNN_ATTENTION)}}
            if hasattr(attn_ops, "bwd_plan"):
                rec["plan"] = attn_ops.bwd_plan(B, S, S, Hq, Hkv, hd)
            line["backward"][name] = rec
            del q, k, v, do, o, lse
    return line


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        import torch

        if not torch.cuda.is_available():
            print("flash_timing: no CUDA card", file=sys.stderr)
            return 1
        print(json.dumps(time_root(Path(argv[1]).resolve(),
                                   argv[2] == "1")), flush=True)
        return 0
    ap = argparse.ArgumentParser(usage=__doc__)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--backward-only", action="store_true")
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args(argv)
    ms: dict[str, dict[str, list[float]]] = {}
    for _ in range(args.rounds):
        for root in args.roots:
            res = subprocess.run(
                [sys.executable, __file__, "--one", root,
                 str(int(args.backward_only))],
                timeout=600, capture_output=True, text=True)
            sys.stderr.write(res.stderr[-4000:] if res.returncode else "")
            if res.returncode:
                return res.returncode
            print(res.stdout.strip(), flush=True)
            line = json.loads(res.stdout.strip().splitlines()[-1])
            for name, rec in line.get("backward", {}).items():
                by_root = ms.setdefault(str(Path(root).resolve()), {})
                by_root.setdefault(name, []).append(rec["ms"])
    print(json.dumps({"summary": {
        root: {name: {"median_ms": statistics.median(v), "ms": v}
               for name, v in shapes.items()}
        for root, shapes in ms.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

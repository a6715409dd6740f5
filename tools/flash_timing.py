#!/usr/bin/env python3
"""Time the flash-attention kernel of one or more checkouts on one card,
all with this checkout's rulers, to compare two commits in one call.

    python3 tools/flash_timing.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (the parent commit unpacked with
``git archive``, say, or ``.`` for this one).  Each is timed in a process of
its own that imports that ROOT's ``repro_torch`` and builds its kernel from
that ROOT's sources; the rulers are always this checkout's
``chip_smoke.time_ms`` (device time, L2 flushed before each call, with
the default flush and with the short one) and ``chip_smoke.host_ms`` (host
issue time and back-to-back time per call, L2 warm).  The
shapes are smollm-135m's heads (Hq 9, Hkv 3, hd 64, causal) at B 1 and each
prompt length the chip smoke test serves, and at B 4, S 2048.  Where ROOT
has the backward kernel (``flash_attention_bwd``), it is timed at B 4,
S 2048 (the train step's shape) beside SDPA's backward on each backend
(``chip_smoke._sdpa_bwd``), with the forward that writes the log-sum-exp.
Prints one JSON line per ROOT, in the order given; needs one CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SEED = 0


def _chip_smoke():
    """This checkout's chip_smoke module, whatever ROOT is on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_root(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    smoke = _chip_smoke()
    from repro_torch.kernels.flash_attention.ops import flash_attention

    if not Path(sys.modules["repro_torch"].__file__).resolve().is_relative_to(
            root):
        raise RuntimeError(f"imported another checkout's repro_torch, not "
                           f"{root}'s")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    Hq, Hkv, hd = 9, 3, 64
    shapes = [(1, P) for P in sorted({p for p, _ in smoke.REQUESTS})]
    out = []
    for B, S in shapes + [(4, 2048)]:
        q, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda")
                   .to(torch.bfloat16) for H in (Hq, Hkv, Hkv))

        def kernel():
            return flash_attention(q, k, v, causal=True)

        out.append({"shape": [B, S, S, Hq, Hkv, hd],
                    "ms": smoke.time_ms(kernel),
                    "ms_short_flush": smoke.time_ms(
                        kernel, flush_mb=smoke.SHORT_FLUSH_MB),
                    **smoke.host_ms(kernel)})
    line = {"root": str(root), "card": torch.cuda.get_device_name(0),
            "timings": out}
    from repro_torch.kernels.flash_attention import ops as attn_ops

    if hasattr(attn_ops, "flash_attention_bwd"):
        from torch.nn.attention import SDPBackend

        q, k, v, do = (torch.randn((4, 2048, H, hd), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for H in (Hq, Hkv, Hkv, Hq))
        o, lse = attn_ops.flash_attention_fwd_lse(q, k, v)
        line["backward"] = {
            "shape": [4, 2048, 2048, Hq, Hkv, hd],
            "ms": smoke.time_ms(lambda: attn_ops.flash_attention_bwd(
                q, k, v, o, lse, do)),
            "forward_lse_ms": smoke.time_ms(
                lambda: attn_ops.flash_attention_fwd_lse(q, k, v)),
            "sdpa_bwd_ms_by_backend": {
                b.name: smoke._sdpa_bwd(q, k, v, do, b)
                for b in (SDPBackend.FLASH_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION)}}
    return line


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        import torch

        if not torch.cuda.is_available():
            print("flash_timing: no CUDA card", file=sys.stderr)
            return 1
        print(json.dumps(time_root(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        rc = subprocess.run([sys.executable, __file__, "--one", root],
                            timeout=600).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

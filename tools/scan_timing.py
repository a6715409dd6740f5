#!/usr/bin/env python3
"""Time the rglru_scan kernel of one or more checkouts on one card, all
with this checkout's rulers, to compare two commits in one call.

    python3 tools/scan_timing.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (the parent commit unpacked with
``git archive``, say, or ``.`` for this one).  Each is timed in a process of
its own that imports that ROOT's ``repro_torch`` and builds its kernel from
that ROOT's sources; the rulers are always this checkout's
``chip_smoke.time_ms`` (device time, L2 flushed by writing 512 MB before
each call) and ``chip_smoke.host_ms`` (host issue time and back-to-back
time per call, L2 warm).  The shapes are recurrentgemma-9b's lru_width
(W 4096, f32, with h0) at B 4, S 512 (the serving path's prefill), B 1,
S 2048 (the same bytes as one long prompt) and B 1, S 512.  Beside each
kernel time stands a bandwidth ruler on the same bytes,
``torch.add(a, b, out=h)`` (reads two f32 and writes one per element), and
the bound: those bytes over the card's published HBM rate.  Prints one
JSON line per ROOT, in the order given; needs one CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SEED = 0
W = 4096
SHAPES = [(4, 512), (1, 2048), (1, 512)]


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
    from repro_torch.kernels.rglru_scan.ops import lru_scan

    if not Path(sys.modules["repro_torch"].__file__).resolve().is_relative_to(
            root):
        raise RuntimeError(f"imported another checkout's repro_torch, not "
                           f"{root}'s")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = []
    for B, S in SHAPES:
        # the model's gate range (models/rglru.py::_lru_gates)
        lam = torch.randn(W, generator=gen, device="cuda")
        r = torch.rand((B, S, W), generator=gen, device="cuda")
        a = torch.exp(-8.0 * torch.logaddexp(lam, torch.zeros_like(lam)) * r)
        b = torch.sqrt(1.0 - a * a) * torch.randn((B, S, W), generator=gen,
                                                  device="cuda")
        h0 = torch.randn((B, W), generator=gen, device="cuda")
        h = torch.empty_like(a)
        nbytes = 4 * (3 * B * S * W + 2 * B * W)

        def kernel():
            return lru_scan(a, b, h0)

        ms = smoke.time_ms(kernel)
        out.append({"shape": [B, S, W], "bytes_moved": nbytes, "ms": ms,
                    "bound_ms": nbytes / smoke.HBM_BYTES_PER_S * 1e3,
                    "tb_per_s": nbytes / ms * 1e-9,
                    "ruler_add_ms": smoke.time_ms(
                        lambda: torch.add(a, b, out=h)),
                    **smoke.host_ms(kernel)})
    return {"root": str(root), "card": torch.cuda.get_device_name(0),
            "timings": out}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        import torch

        if not torch.cuda.is_available():
            print("scan_timing: no CUDA card", file=sys.stderr)
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

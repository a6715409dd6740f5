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
the bound: those bytes over the card's published HBM rate.

Where ROOT has the scan's gradient (``lru_scan_vjp``), its backward is
timed too at the hybrid train path's shape (B 4, S 2048, W 4096, with h0),
in default and in deterministic mode: the whole backward through autograd,
the device time of each CUDA kernel it launches (``torch.profiler``), and
PAIRS alternating pairs of two routes to the same gradient, device time
(``time_ms``) and host time (``host_ms``) each: the kernel's reverse mode
(``lru_scan_bwd``, one launch; where ROOT has it) and the three-gather
route of the first backward (``g`` and the shifted ``a`` reversed by
``index_select`` into buffers that deterministic mode does not fill, the
forward kernel on them, the result reversed, the products for da and dh0),
written out here on ROOT's forward kernel.  Prints one JSON line per ROOT,
in the order given; needs one CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
SEED = 0
W = 4096
SHAPES = [(4, 512), (1, 2048), (1, 512)]
BACKWARD_SHAPE = (4, 2048)
PROFILED_BACKWARDS = 5
PAIRS = 10


def _chip_smoke():
    """This checkout's chip_smoke module, whatever ROOT is on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gates(torch, gen, B, S):
    """a and b in the model's gate range (models/rglru.py::_lru_gates)."""
    lam = torch.randn(W, generator=gen, device="cuda")
    r = torch.rand((B, S, W), generator=gen, device="cuda")
    a = torch.exp(-8.0 * torch.logaddexp(lam, torch.zeros_like(lam)) * r)
    return a, torch.sqrt(1.0 - a * a) * torch.randn((B, S, W), generator=gen,
                                                    device="cuda")


def _kernel_ms(torch, prof, runs: int) -> list[dict]:
    """Device ms per run of each CUDA kernel that ``prof`` recorded."""
    rows = []
    for e in prof.key_averages():
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3 / runs
        if e.device_type == torch.autograd.DeviceType.CUDA and ms > 0:
            rows.append({"kernel": e.key[:120], "calls": e.count / runs,
                         "ms": ms})
    return sorted(rows, key=lambda r: -r["ms"])


def _unfilled(torch, like):
    """A tensor like ``like`` without deterministic mode's fill."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        return torch.empty_like(like)
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = fill


def gather_route(torch, scan_ops, a, h, h0, g, g_last):
    """(da, db, dh0) as the first backward computed them: three reorders
    by ``index_select``, the forward kernel on the reversed sequence, two
    products."""
    S = a.shape[1]
    reverse = torch.arange(S - 1, -1, -1, device=a.device)

    def reorder(x, index):
        return torch.index_select(x, 1, index, out=_unfilled(torch, x))

    g_rev = reorder(g, reverse)
    g_rev[:, 0] += g_last
    a_rev = reorder(a, (reverse + 1).clamp_(max=S - 1))
    lam = reorder(scan_ops.lru_scan(a_rev, g_rev)[0], reverse)
    da = _unfilled(torch, lam)
    torch.mul(lam[:, 1:], h[:, :-1], out=da[:, 1:])
    torch.mul(lam[:, 0], h0, out=da[:, 0])
    return da, lam, a[:, 0] * lam[:, 0]


def time_backward(smoke, torch, scan_ops) -> dict:
    """The scan's backward, in default and deterministic mode, at
    BACKWARD_SHAPE: through autograd, its kernels, and PAIRS pairs of the
    reverse mode and the three-gather route."""
    B, S = BACKWARD_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    a, b = _gates(torch, gen, B, S)
    h0, g_last = (torch.randn((B, W), generator=gen, device="cuda")
                  for _ in range(2))
    g = torch.randn((B, S, W), generator=gen, device="cuda")
    ins = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    h, h_last = scan_ops.lru_scan_vjp(*ins)
    hv = h.detach()

    def backward():
        return torch.autograd.grad((h, h_last), ins, (g, g_last),
                                   retain_graph=True)

    routes = {"gathers": lambda: gather_route(torch, scan_ops, a, hv, h0, g,
                                              g_last)}
    if hasattr(scan_ops, "lru_scan_bwd"):
        routes["reverse_mode"] = lambda: scan_ops.lru_scan_bwd(
            a, hv, h0, g, g_last)
    was = torch.are_deterministic_algorithms_enabled()
    out = {"shape": [B, S, W], "h0": True, "pairs": PAIRS}
    try:
        for mode in (False, True):
            torch.use_deterministic_algorithms(mode)
            line = {"ms": smoke.time_ms(backward),
                    "forward_ms": smoke.time_ms(
                        lambda: scan_ops.lru_scan(a, b, h0))}
            pairs = {name: {"ms": [], "enqueue_ms": [], "back_to_back_ms": []}
                     for name in routes}
            for i in range(PAIRS):
                # alternate which route goes first
                for name in (list(routes) if i % 2 == 0
                             else list(routes)[::-1]):
                    fn = routes[name]
                    host = smoke.host_ms(fn, iters=20, rounds=1)
                    pairs[name]["ms"].append(smoke.time_ms(fn, iters=5))
                    pairs[name]["enqueue_ms"].append(host["enqueue_ms"])
                    pairs[name]["back_to_back_ms"].append(
                        host["back_to_back_ms"])
            line["routes"] = {
                name: {k: {"median": float(np.median(v)), "min": min(v),
                           "max": max(v)} for k, v in p.items()}
                for name, p in pairs.items()}
            backward()
            torch.cuda.synchronize()
            try:
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(PROFILED_BACKWARDS):
                        backward()
                    torch.cuda.synchronize()
                line["kernels"] = _kernel_ms(torch, prof, PROFILED_BACKWARDS)
            except Exception as e:  # the timings above stand without it
                line["kernels"] = f"profiler failed: {e!r}"
            out["deterministic" if mode else "default"] = line
    finally:
        torch.use_deterministic_algorithms(was)
    # read a, h, g, g_last and h0; write da, db and dh0
    nbytes = 4 * (5 * B * S * W + 3 * B * W)
    out.update(bytes_moved=nbytes,
               bound_ms=nbytes / smoke.HBM_BYTES_PER_S * 1e3)
    return out


def time_root(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    smoke = _chip_smoke()
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.kernels.rglru_scan.ops import lru_scan

    if not Path(sys.modules["repro_torch"].__file__).resolve().is_relative_to(
            root):
        raise RuntimeError(f"imported another checkout's repro_torch, not "
                           f"{root}'s")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = []
    for B, S in SHAPES:
        a, b = _gates(torch, gen, B, S)
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
    line = {"root": str(root), "card": torch.cuda.get_device_name(0),
            "timings": out}
    if hasattr(scan_ops, "lru_scan_vjp"):
        line["backward"] = time_backward(smoke, torch, scan_ops)
    return line


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

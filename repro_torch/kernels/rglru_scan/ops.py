"""Dispatching wrapper of the RG-LRU scan, and its gradient.

A CPU tensor takes the plain version (``ref.py``).  A CUDA tensor launches
the hand-written kernel (``kernel.cu``) or raises; there is no fallback.
``launches`` counts the kernel's launches (callers may reset it to 0).
Under ``torch.use_deterministic_algorithms`` the kernel chains its chunks'
carries, so a launch repeats bit for bit (see ``kernel.cu``), and the
outputs that are written whole are allocated without that mode's fill of
new memory (``_empty``).

``lru_scan_vjp`` is ``lru_scan`` under autograd: its backward is the same
scan run once more, backwards in time (see ``_LruScan``), so both passes
take the kernel on the card and the plain version on the CPU.

The kernel chains its S-chunks by a decoupled look-back through scratch
that this module keeps, one zeroed buffer per (card, stream), grown as
shapes need: a ticket counter the kernel puts back to 0 itself, and
look-back words tagged with an epoch that is new on every launch, so
nothing is cleared between launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

#: launches of the CUDA kernel since the count was last reset
launches = 0

#: epochs run 1 .. EPOCHS - 1; then the scratch is zeroed anew
EPOCHS = 1 << 31

_fns = None
# (device index, stream handle) -> [scratch uint8 tensor, last epoch]
_scratch: dict[tuple[int, int], list] = {}


def _kernel():
    global _fns
    if _fns is None:
        lib = build.library("rglru_scan")
        size = lib.rglru_scan_scratch_bytes
        size.argtypes = [ctypes.c_longlong] * 3
        size.restype = ctypes.c_longlong
        fn = lib.rglru_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                       + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns = size, fn
    return _fns


def _scratch_for(nbytes: int, device: torch.device, stream: int):
    """The stream's scratch of at least ``nbytes`` and a new epoch."""
    key = (device.index, stream)
    entry = _scratch.get(key)
    if entry is None or entry[0].numel() < nbytes or entry[1] + 1 >= EPOCHS:
        entry = [torch.zeros(nbytes, dtype=torch.uint8, device=device), 0]
        _scratch[key] = entry
    entry[1] += 1
    return entry[0], entry[1]


def _empty(*shape: int, device: torch.device) -> torch.Tensor:
    """An f32 tensor that its caller writes whole.  Deterministic mode fills
    the memory of every ``torch.empty`` (``torch.utils.deterministic.
    fill_uninitialized_memory``), one more full write of each output that
    nothing reads: it is off for this allocation."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        return torch.empty(shape, dtype=torch.float32, device=device)
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = fill


def lru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t over time.

    a, b [B, S, W] f32; h0 [B, W] f32 or None (zeros).  Returns
    (h [B, S, W] f32, h_last [B, W] f32).
    """
    if a.dim() != 3 or a.shape != b.shape or a.shape[1] == 0:
        raise ValueError(f"rglru_scan: a and b must be one [B, S, W] shape "
                         f"with S > 0, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    B, S, W = a.shape
    if h0 is not None and tuple(h0.shape) != (B, W):
        raise ValueError(f"rglru_scan: h0 must be {(B, W)}, got "
                         f"{tuple(h0.shape)}")
    ins = [a, b] + ([] if h0 is None else [h0])
    if any(t.device != a.device for t in ins):
        raise ValueError("rglru_scan: a, b and h0 must share one device")
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {a.device}")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in ins):
        raise ValueError("rglru_scan: the kernel takes contiguous float32 "
                         "a, b and h0")
    h = _empty(B, S, W, device=a.device)
    h_last = _empty(B, W, device=a.device)
    if h.numel() == 0:
        return h, h_last
    with torch.cuda.device(a.device):
        size, fn = _kernel()
        stream = torch.cuda.current_stream().cuda_stream
        scratch, epoch = _scratch_for(size(B, S, W), a.device, stream)
        err = fn(a.data_ptr(), b.data_ptr(),
                 None if h0 is None else h0.data_ptr(),
                 h.data_ptr(), h_last.data_ptr(), B, S, W,
                 scratch.data_ptr(), scratch.numel(), epoch,
                 int(torch.are_deterministic_algorithms_enabled()), stream)
    global launches
    launches += 1
    build.check(err, "rglru_scan")
    return h, h_last


def _reorder(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x [B, S, W] with its time steps taken in ``index``'s order, as a
    contiguous copy (a gather: torch.flip's output would be filled first
    in deterministic mode)."""
    return torch.index_select(x, 1, index,
                              out=_empty(*x.shape, device=x.device))


class _LruScan(torch.autograd.Function):
    """h_t = a_t h_{t-1} + b_t with its gradient.  With g_t the gradient
    reaching h_t (plus that of h_last at t = S), the gradient of the loss
    in h_t is  l_S = g_S,  l_t = g_t + a_{t+1} l_{t+1}:  the same
    recurrence backwards in time, with a shifted one step.  So the
    backward scans the time-reversed g with the reversed, shifted a
    (contiguous copies, as the kernel takes) through ``lru_scan``, then
    db_t = l_t, da_t = l_t h_{t-1} (h_0 = h0, or 0) and dh0 = a_1 l_1.
    The reversed scan starts from zero, so its first coefficient (a_{S+1})
    multiplies 0 and any finite value serves: the reorder repeats a_S."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_last = lru_scan(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h, h_last

    @staticmethod
    def backward(ctx, g, g_last):
        a, h, h0 = ctx.saved_tensors
        S = a.shape[1]
        reverse = torch.arange(S - 1, -1, -1, device=a.device)
        g_rev = _reorder(g, reverse)
        g_rev[:, 0] += g_last
        # step r of the reversed scan takes a_{S-r} (r >= 1); step 0, a_S
        a_rev = _reorder(a, (reverse + 1).clamp_(max=S - 1))
        lam = _reorder(lru_scan(a_rev, g_rev)[0], reverse)
        da = _empty(*lam.shape, device=lam.device)
        torch.mul(lam[:, 1:], h[:, :-1], out=da[:, 1:])
        if h0 is None:
            da[:, 0] = 0.0
            dh0 = None
        else:
            torch.mul(lam[:, 0], h0, out=da[:, 0])
            dh0 = a[:, 0] * lam[:, 0]
        return da, lam, dh0


def lru_scan_vjp(a: torch.Tensor, b: torch.Tensor,
                 h0: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``lru_scan`` under autograd (gradients in a, b and h0)."""
    return _LruScan.apply(a, b, h0)

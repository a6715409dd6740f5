"""Dispatching wrapper of the RG-LRU scan, and its gradient.

A CPU tensor takes the plain version (``ref.py``).  A CUDA tensor launches
the hand-written kernel (``kernel.cu``) or raises; there is no fallback.
``launches`` counts the kernel's launches (callers may reset it to 0).
Under ``torch.use_deterministic_algorithms`` the kernel chains its chunks'
carries, so a launch repeats bit for bit (see ``kernel.cu``), and the
outputs that are written whole are allocated without that mode's fill of
new memory (``repro_torch.device.empty_unfilled``).

``lru_scan_vjp`` is ``lru_scan`` under autograd: its backward,
``lru_scan_bwd``, is the same recurrence backwards in time, the kernel's
reverse mode in one launch on the card (it reads a, g and h once and
writes da and db once) and the plain reversed loop on the CPU.

The kernel chains its S-chunks by a decoupled look-back through scratch
that this module keeps, one zeroed buffer per (card, stream), grown as
shapes need: a ticket counter the kernel puts back to 0 itself, and
look-back words tagged with an epoch that is new on every launch, so
nothing is cleared between launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.device import empty_unfilled
from repro_torch.kernels import build
from repro_torch.kernels.rglru_scan.ref import (lru_scan_bwd_ref,
                                                 rglru_scan_ref)

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
        bwd = lib.rglru_scan_bwd_launch
        bwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 3
                        + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
                           ctypes.c_int, ctypes.c_void_p])
        bwd.restype = ctypes.c_int
        _fns = size, fn, bwd
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
    h = empty_unfilled((B, S, W), torch.float32, a.device)
    h_last = empty_unfilled((B, W), torch.float32, a.device)
    if h.numel() == 0:
        return h, h_last
    with torch.cuda.device(a.device):
        size, fn, _ = _kernel()
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


def lru_scan_bwd(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor | None,
                 g: torch.Tensor, g_last: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The gradient of ``lru_scan`` (see ``ref.py::lru_scan_bwd_ref``):
    a, h (its output) and g (the gradient reaching h) [B, S, W] f32; h0
    and g_last [B, W] f32 or None.  Returns (da, db, dh0)."""
    if a.dim() != 3 or a.shape[1] == 0 or any(
            tuple(t.shape) != tuple(a.shape) for t in (h, g)):
        raise ValueError(f"rglru_scan_bwd: a, h and g must be one [B, S, W] "
                         f"shape with S > 0, got {tuple(a.shape)}, "
                         f"{tuple(h.shape)} and {tuple(g.shape)}")
    B, S, W = a.shape
    rows = [t for t in (h0, g_last) if t is not None]
    if any(tuple(t.shape) != (B, W) for t in rows):
        raise ValueError(f"rglru_scan_bwd: h0 and g_last must be {(B, W)}")
    ins = [a, h, g] + rows
    if any(t.device != a.device for t in ins):
        raise ValueError("rglru_scan_bwd: every input must share one device")
    if a.device.type == "cpu":
        return lru_scan_bwd_ref(a, h, h0, g, g_last)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd: no kernel for device {a.device}")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in ins):
        raise ValueError("rglru_scan_bwd: the kernel takes contiguous "
                         "float32 inputs")
    da = empty_unfilled((B, S, W), torch.float32, a.device)
    db = empty_unfilled((B, S, W), torch.float32, a.device)
    with torch.cuda.device(a.device):
        size, _, fn = _kernel()
        stream = torch.cuda.current_stream().cuda_stream
        scratch, epoch = _scratch_for(size(B, S, W), a.device, stream)
        err = fn(a.data_ptr(), g.data_ptr(),
                 None if g_last is None else g_last.data_ptr(),
                 h.data_ptr(), None if h0 is None else h0.data_ptr(),
                 da.data_ptr(), db.data_ptr(), B, S, W,
                 scratch.data_ptr(), scratch.numel(), epoch,
                 int(torch.are_deterministic_algorithms_enabled()), stream)
    global launches
    launches += 1
    build.check(err, "rglru_scan_bwd")
    return da, db, None if h0 is None else a[:, 0] * db[:, 0]


class _LruScan(torch.autograd.Function):
    """h_t = a_t h_{t-1} + b_t with its gradient: ``lru_scan`` forward,
    ``lru_scan_bwd`` backward (one kernel launch each on the card)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_last = lru_scan(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h, h_last

    @staticmethod
    def backward(ctx, g, g_last):
        a, h, h0 = ctx.saved_tensors
        return lru_scan_bwd(a, h, h0, g.contiguous(),
                            None if g_last is None else g_last.contiguous())


def lru_scan_vjp(a: torch.Tensor, b: torch.Tensor,
                 h0: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``lru_scan`` under autograd (gradients in a, b and h0)."""
    return _LruScan.apply(a, b, h0)

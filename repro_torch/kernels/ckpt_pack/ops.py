"""Dispatching wrapper of the ckpt_pack chunk gather.

A CPU tensor takes the plain version (``ref.py``).  A CUDA tensor launches
the hand-written kernel (``kernel.cu``) or raises; there is no fallback.
``launches`` counts the kernel's launches (callers may reset it to 0).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ckpt_pack.ref import ckpt_pack_ref

#: launches of the CUDA kernel since the count was last reset
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.library("ckpt_pack").ckpt_pack_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _index(idx, n: int) -> torch.Tensor:
    """``idx`` as a 1-D int32 tensor.  Host indices are range-checked here;
    an index tensor already on the card is taken as it is (the kernel
    zero-fills any entry past the source rather than read out of bounds)."""
    if isinstance(idx, torch.Tensor) and idx.device.type != "cpu":
        if idx.dim() != 1:
            raise ValueError(f"ckpt_pack: idx must be 1-D, got {tuple(idx.shape)}")
        return idx.to(torch.int32)
    host = np.asarray(idx.numpy() if isinstance(idx, torch.Tensor) else idx)
    if host.ndim != 1 or not (host.dtype.kind in "iu" or host.size == 0):
        raise ValueError(f"ckpt_pack: idx must be a 1-D integer array, got "
                         f"{host.dtype} of shape {host.shape}")
    if host.size and int(host.max()) >= n:
        raise IndexError(f"ckpt_pack: index {int(host.max())} out of range "
                         f"for {n} source chunks")
    return torch.from_numpy(host.astype(np.int32))


def pack_chunks(src: torch.Tensor, idx, *, out: torch.Tensor | None = None
                ) -> torch.Tensor:
    """out[i] = src[idx[i]] at chunk granularity (idx[i] < 0 => zero chunk).

    ``src`` is chunk-major [N, R, C] of any dtype; ``idx`` is [M] integer
    (numpy or tensor).  ``out``, if given, is a contiguous [M, R, C] tensor
    of ``src``'s dtype and device that receives the chunks.
    """
    if src.dim() != 3:
        raise ValueError(f"ckpt_pack: src must be [N, R, C], got "
                         f"{tuple(src.shape)}")
    n, R, C = src.shape
    index = _index(idx, n)
    m = index.numel()
    if out is not None and (tuple(out.shape) != (m, R, C)
                            or out.dtype != src.dtype
                            or out.device != src.device
                            or not out.is_contiguous()):
        raise ValueError(f"ckpt_pack: out must be a contiguous {(m, R, C)} "
                         f"{src.dtype} tensor on {src.device}")
    if src.device.type == "cpu":
        res = ckpt_pack_ref(src, index)
        return res if out is None else out.copy_(res)
    if src.device.type != "cuda":
        raise ValueError(f"ckpt_pack: no kernel for device {src.device}")
    if not src.is_contiguous():
        raise ValueError("ckpt_pack: the kernel takes a contiguous src")
    if out is None:
        out = torch.empty((m, R, C), dtype=src.dtype, device=src.device)
    index = index.to(src.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(src.device):
        err = _kernel()(src.data_ptr(), index.data_ptr(), out.data_ptr(), n,
                        m, R * C * src.element_size(),
                        torch.cuda.current_stream().cuda_stream)
    global launches
    launches += 1
    build.check(err, "ckpt_pack")
    return out

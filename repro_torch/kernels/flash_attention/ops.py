"""Dispatching wrapper of the flash attention forward.

A CPU tensor takes the plain version (``ref.py``).  A CUDA tensor launches
the hand-written kernel (``kernel.cu``: bf16, head dim 64 or 128) or
raises; there is no fallback.  ``launches`` counts the kernel's launches
(callers may reset it to 0).  The kernel picks its own 64 x 64 tiles, so
unlike the Pallas wrapper this one takes no block sizes.  Forward only: the
backward comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

#: launches of the CUDA kernel since the count was last reset
launches = 0

#: head dims the kernel is compiled for
HEAD_DIMS = (64, 128)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.library("flash_attention").flash_attention_fwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0):
    """q [B, Sq, Hq, hd]; k, v [B, Sk, Hkv, hd] -> [B, Sq, Hq, hd] in q's
    dtype.  Query head h reads kv head h // (Hq // Hkv); ``window`` > 0
    keeps keys with k_pos > q_pos - window; ``softcap`` > 0 caps logits as
    cap * tanh(s / cap); ``q_offset`` is the absolute position of q[:, 0]."""
    B, Sq, Hq, hd = q.shape
    Bk, Sk, Hkv, hdk = k.shape
    if (Bk != B or hdk != hd or tuple(v.shape) != tuple(k.shape)
            or Hkv == 0 or Hq % Hkv):
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: the kernel takes bfloat16 "
                             f"tensors on one card; {name} is {t.dtype} on "
                             f"{t.device}")
        # 16-byte cp.async rows: contiguous head dim, strides of 8 elements
        if (t.stride(-1) != 1 or t.data_ptr() % 16
                or any(s % 8 for s in t.stride()[:-1])):
            raise ValueError(f"flash_attention: {name} needs a contiguous, "
                             f"16-byte aligned head dim (strides "
                             f"{t.stride()})")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel is built for head "
                         f"dims {HEAD_DIMS}, got {hd}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    o = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Sq, Sk, Hq, Hkv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3],
            int(causal), int(window), float(softcap), int(q_offset),
            torch.cuda.current_stream().cuda_stream)
    global launches
    launches += 1
    build.check(err, "flash_attention")
    return o

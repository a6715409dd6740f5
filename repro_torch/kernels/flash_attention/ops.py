"""Dispatching wrappers of the flash attention forward and backward.

A CPU tensor takes the plain versions (``ref.py``).  A CUDA tensor launches
the hand-written Hopper kernels (``kernel.cu``: bf16, head dim 64 or 128;
TMA copies into an mbarrier ring, products on warpgroup MMA) or raises;
there is no fallback.  ``launches`` counts the forward kernel's launches,
``bwd_launches`` the backward's (callers may reset either to 0).  The
kernels pick their own tiles, so unlike the Pallas wrapper these
take no block sizes.  k and v may be strided views (slices of one fused
tensor, say): the kernels' tensor maps take any strides that are multiples
of 8 elements over a contiguous head dim.

``flash_attention_vjp`` makes it differentiable.  On the card its forward
is ``flash_attention_fwd_lse`` (the kernel, which also writes each row's
log-sum-exp) and its backward ``flash_attention_bwd``: two kernel passes,
dq per 128-row q block and dk, dv per 128-key block with a kv head's G
query heads summed in the block, and a short third pass that adds the
partials of a key block the schedule splits over several blocks
(``bwd_plan``); no atomics, so a launch repeats bit for bit.  On the CPU it
is the reference's own ``_fa_bwd``: the plain forward, and autograd
through the port's blocked ``models/layers.py::flash_attention_xla``
recomputed from (q, k, v).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.device import empty_unfilled
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                      attention_lse_ref,
                                                      attention_ref)
from repro_torch.models.layers import flash_attention_xla

#: launches of the forward kernel since the count was last reset
launches = 0
#: launches of the backward kernel (its two passes count once)
bwd_launches = 0

#: head dims the kernel is compiled for
HEAD_DIMS = (64, 128)

#: log2(e): the kernel's log-sum-exp is this times the natural one
LOG2E = 1.4426950408889634

#: what ``bwd_plan`` reports, in the C function's order: the scratch the
#: backward needs; the SMs the plan assumes (an H100 SXM's, whatever the
#: card); per pass its blocks, its items (a block's steps: a 64-key tile
#: for 128 queries in the dq pass, a (query head, 64-row q tile) for 128
#: keys in the dk/dv pass) and its heaviest block; the dk/dv pass's chunk
#: bound, the key blocks it splits, their partial slots a kv head, the sum
#: pass's blocks and the key blocks
PLAN_KEYS = ("scratch_bytes", "sms", "dq_blocks", "dq_items", "dq_heaviest",
             "dkdv_blocks", "dkdv_items", "dkdv_heaviest", "chunk",
             "split_key_blocks", "partial_slots", "sum_blocks", "key_blocks")

_fns: dict[str, ctypes._CFuncPtr] = {}


def _kernel(name: str = "fwd"):
    """The C function of the forward (``fwd``), the backward (``bwd``) or
    the backward's plan (``plan``)."""
    fn = _fns.get(name)
    if fn is None:
        lib = build.library("flash_attention")
        if name == "plan":
            fn = lib.flash_attention_bwd_plan
            fn.argtypes = [ctypes.c_int] * 9 + [
                ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
        elif name == "fwd":
            fn = lib.flash_attention_fwd_launch
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                           + [ctypes.c_longlong] * 12)
        else:
            fn = lib.flash_attention_bwd_launch
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                           + [ctypes.c_longlong] * 24)
        if name != "plan":
            fn.argtypes += [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def bwd_plan(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, hd: int, *,
             causal: bool = True, window: int = 0,
             q_offset: int = 0) -> dict:
    """The backward kernel's schedule for a shape, as ``PLAN_KEYS`` names
    it: the kernel library's own planner, which depends on the shape alone
    (building the library needs ``nvcc``)."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    err = _kernel("plan")(B, Sq, Sk, Hq, Hkv, hd, int(causal), int(window),
                          int(q_offset), out, len(PLAN_KEYS))
    build.check(err, "flash_attention_bwd_plan")
    return dict(zip(PLAN_KEYS, out))


def _tma_ready(t: torch.Tensor) -> bool:
    """TMA's rules: a contiguous head dim, 16-byte base and strides."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and not any(s % 8 for s in t.stride()[:-1]))


def _check_card(where: str, **tensors) -> None:
    """Raise unless every tensor is bf16 on the first one's card and
    obeys TMA's rules."""
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != device or t.dtype != torch.bfloat16:
            raise ValueError(f"{where}: the kernel takes bfloat16 tensors on "
                             f"one card; {name} is {t.dtype} on {t.device}")
        if not _tma_ready(t):
            raise ValueError(f"{where}: {name} needs a contiguous, 16-byte "
                             f"aligned head dim (strides {t.stride()})")


def _shapes(where: str, q, k, v):
    B, Sq, Hq, hd = q.shape
    Bk, Sk, Hkv, hdk = k.shape
    if (Bk != B or hdk != hd or tuple(v.shape) != tuple(k.shape)
            or Hkv == 0 or Hq % Hkv):
        raise ValueError(f"{where}: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    return B, Sq, Sk, Hq, Hkv, hd


def _forward(q, k, v, causal, window, softcap, q_offset, with_lse):
    """The forward kernel on the card: o, and lse [B, Hq, Sq] f32 (log2
    domain) if ``with_lse``, else None."""
    B, Sq, Sk, Hq, Hkv, hd = _shapes("flash_attention", q, k, v)
    _check_card("flash_attention", q=q, k=k, v=v)
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel is built for head "
                         f"dims {HEAD_DIMS}, got {hd}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    o = empty_unfilled((B, Sq, Hq, hd), q.dtype, q.device)
    lse = (empty_unfilled((B, Hq, Sq), torch.float32, q.device) if with_lse
           else None)
    if o.numel() == 0:
        return o, lse
    with torch.cuda.device(q.device):
        err = _kernel("fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Sq, Sk, Hq, Hkv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3],
            int(causal), int(window), float(softcap), int(q_offset),
            torch.cuda.current_stream().cuda_stream)
    global launches
    launches += 1
    build.check(err, "flash_attention")
    return o, lse


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0):
    """q [B, Sq, Hq, hd]; k, v [B, Sk, Hkv, hd] -> [B, Sq, Hq, hd] in q's
    dtype.  Query head h reads kv head h // (Hq // Hkv); ``window`` > 0
    keeps keys with k_pos > q_pos - window; ``softcap`` > 0 caps logits as
    cap * tanh(s / cap); ``q_offset`` is the absolute position of q[:, 0]."""
    _shapes("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _forward(q, k, v, causal, window, softcap, q_offset, False)[0]


def flash_attention_fwd_lse(q, k, v, *, causal: bool = True, window: int = 0,
                            softcap: float = 0.0, q_offset: int = 0):
    """``flash_attention`` and each query row's log-sum-exp, f32
    [B, Hq, Sq], in the kernel's log2 domain: ``LOG2E`` times the natural
    log-sum-exp of the (softcapped, masked) logits."""
    _shapes("flash_attention", q, k, v)
    if q.device.type == "cpu":
        o, lse = attention_lse_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset)
        return o, lse * LOG2E
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _forward(q, k, v, causal, window, softcap, q_offset, True)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        q_offset: int = 0):
    """dq, dk, dv of ``flash_attention`` at (q, k, v) for the upstream
    gradient ``do`` (o's shape), given the forward's output ``o`` and
    log-sum-exp ``lse`` as ``flash_attention_fwd_lse`` returns them.
    Every query row must see at least one key (with a window, the last
    query's position must be below Sk + window - 1)."""
    B, Sq, Sk, Hq, Hkv, hd = _shapes("flash_attention_bwd", q, k, v)
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape) \
            or tuple(lse.shape) != (B, Hq, Sq):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)} and lse {tuple(lse.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if Sk == 0 or (window > 0 and Sq and q_offset + Sq >= Sk + window):
        raise ValueError(f"flash_attention_bwd: a query row sees no key "
                         f"(Sq {Sq}, Sk {Sk}, window {window}, q_offset "
                         f"{q_offset})")
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse / LOG2E, do, causal=causal,
                                 window=window, softcap=softcap,
                                 q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device "
                         f"{q.device}")
    _check_card("flash_attention_bwd", q=q, k=k, v=v, o=o, do=do)
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: the kernel is built for "
                         f"head dims {HEAD_DIMS}, got {hd}")
    if q_offset < 0:
        raise ValueError(f"flash_attention_bwd: q_offset {q_offset} < 0")
    if (lse.device != q.device or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be contiguous "
                         f"float32 on {q.device}, got {lse.dtype} on "
                         f"{lse.device}")
    dq = empty_unfilled(q.shape, q.dtype, q.device)
    dk = empty_unfilled(k.shape, k.dtype, k.device)
    dv = empty_unfilled(v.shape, v.dtype, v.device)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    with torch.cuda.device(q.device):
        # each query row's (lse2, D), then the partials of split key blocks
        nbytes = bwd_plan(B, Sq, Sk, Hq, Hkv, hd, causal=causal,
                          window=window, q_offset=q_offset)["scratch_bytes"]
        dd = empty_unfilled((nbytes // 4,), torch.float32, q.device)
        err = _kernel("bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dd.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, Hq, Hkv, hd,
            *(st for t in (q, k, v, o, do, dq, dk, dv)
              for st in t.stride()[:3]),
            int(causal), int(window), float(softcap), int(q_offset),
            torch.cuda.current_stream().cuda_stream)
    global bwd_launches
    bwd_launches += 1
    build.check(err, "flash_attention_bwd")
    return dq, dk, dv


class _FlashAttentionVjp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, block_q, block_k,
                q_offset):
        ctx.args = dict(causal=causal, window=window, softcap=softcap,
                        q_offset=q_offset)
        ctx.blocks = dict(block_q=block_q, block_k=block_k)
        ctx.kernel = q.device.type != "cpu"
        if not ctx.kernel:
            ctx.save_for_backward(q, k, v)
            return flash_attention(q, k, v, **ctx.args)
        o, lse = flash_attention_fwd_lse(q, k, v, **ctx.args)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        if ctx.kernel:
            q, k, v, o, lse = ctx.saved_tensors
            # the kernel's layout rules; autograd's gradient may be a view
            g = g if _tma_ready(g) else g.contiguous()
            dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, g, **ctx.args)
        else:
            q, k, v = (t.detach().requires_grad_(True)
                       for t in ctx.saved_tensors)
            with torch.enable_grad():
                out = flash_attention_xla(q, k, v, **ctx.args, **ctx.blocks)
                dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_vjp(q, k, v, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, block_q: int = 512,
                        block_k: int = 512, q_offset: int = 0):
    """``flash_attention`` under autograd.  On the card: the forward kernel
    (saving o and the log-sum-exp) and the backward kernel.  On the CPU:
    the plain forward, and the gradient of the blocked
    ``flash_attention_xla`` with ``block_q`` x ``block_k`` tiles,
    recomputed from (q, k, v), as the reference's ``_fa_bwd`` does."""
    return _FlashAttentionVjp.apply(q, k, v, causal, window, softcap,
                                    block_q, block_k, q_offset)

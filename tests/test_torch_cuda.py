"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a card.  This file imports neither JAX nor the JAX package,
so it also runs on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.ckpt_pack import ops as pack_ops
from repro_torch.kernels.ckpt_pack.ref import ckpt_pack_ref
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                      attention_lse_ref,
                                                      attention_ref)
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan.ref import (lru_scan_bwd_ref,
                                                 rglru_scan_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int32,
                                   torch.uint8])
@pytest.mark.parametrize("n,r,c", [(12, 8, 16), (16, 1, 36), (5, 3, 7),
                                   (64, 540, 96)])
def test_ckpt_pack_kernel_exact(cuda, dtype, n, r, c):
    """Bit-exact, including odd chunk sizes (unaligned word paths),
    repeated indices and -1 (zero) chunks; counts one launch."""
    rng = np.random.default_rng(n * r * c)
    src = torch.from_numpy(rng.normal(size=(n, r, c)) * 50).to(dtype).to(cuda)
    idx = np.concatenate([rng.integers(-1, n, size=2 * n), [n - 1, -1, 0, 0]])
    pack_ops.launches = 0
    got = pack_ops.pack_chunks(src, idx)
    torch.cuda.synchronize()
    assert pack_ops.launches == 1
    want = ckpt_pack_ref(src, torch.as_tensor(idx))
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_ckpt_pack_kernel_into_offset_buffer(cuda):
    """``out=`` a slice at an odd byte offset of a staging buffer."""
    src = torch.arange(6 * 5 * 3, dtype=torch.uint8, device=cuda).reshape(6, 5, 3)
    staging = torch.zeros(1 + 4 * 15, dtype=torch.uint8, device=cuda)
    out = staging[1:].view(4, 5, 3)
    pack_ops.pack_chunks(src, np.array([5, -1, 2, 5]), out=out)
    want = ckpt_pack_ref(src, torch.tensor([5, -1, 2, 5]))
    assert torch.equal(out, want) and int(staging[0]) == 0


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,window,cap,qoff,fused", [
    (2, 128, 128, 9, 3, 64, 0, 0.0, 0, False),
    (1, 33, 57, 2, 2, 64, 0, 0.0, 24, False),     # ragged, continuation
    (1, 200, 200, 4, 1, 128, 48, 0.0, 0, False),  # window, hd 128
    (2, 96, 96, 4, 2, 64, 0, 30.0, 0, False),     # softcap
    # one row, one tile, and a row or a tile either side of the 64-row tile
    (1, 1, 1, 3, 3, 64, 0, 0.0, 0, False),        # G 1
    (1, 63, 63, 9, 3, 64, 0, 0.0, 0, False),      # G 3
    (1, 64, 64, 9, 1, 64, 0, 0.0, 0, False),      # G 9
    (2, 65, 65, 3, 1, 64, 0, 0.0, 0, False),
    (1, 127, 127, 9, 3, 64, 0, 0.0, 0, False),
    (1, 129, 129, 9, 3, 64, 0, 0.0, 0, False),
    (1, 129, 129, 4, 2, 128, 0, 0.0, 0, False),   # hd 128: two boxes a tile
    (2, 100, 300, 9, 3, 64, 0, 0.0, 200, False),  # q_offset, Sq % 64 != 0
    (1, 150, 150, 4, 2, 64, 16, 0.0, 0, False),   # window inside one tile
    (1, 200, 200, 4, 2, 64, 40, 30.0, 0, False),  # softcap and window
    (2, 150, 150, 6, 2, 64, 0, 0.0, 0, True),     # k, v slices of one tensor
    (1, 129, 129, 8, 4, 128, 0, 0.0, 0, True),
    # qwen2-vl-7b's heads: an odd group, G 7 (query head h reads kv h // 7)
    (2, 200, 200, 28, 4, 128, 0, 0.0, 0, False),
    (2, 512, 512, 28, 4, 128, 0, 0.0, 0, False),  # vlm_state's prefill
    (1, 65, 65, 14, 2, 128, 0, 0.0, 0, False),
    (1, 100, 300, 7, 1, 128, 0, 0.0, 200, False),
    # kimi-k2's heads: 64 query heads over 8 kv heads (G 8) at hd 128, at
    # its serving prefill and ragged
    (4, 512, 512, 64, 8, 128, 0, 0.0, 0, False),
    (2, 200, 200, 16, 2, 128, 0, 0.0, 0, False),
])
def test_flash_attention_kernel_within_tolerance(cuda, B, Sq, Sk, Hq, Hkv, hd,
                                                 window, cap, qoff, fused):
    """|kernel - plain| <= 2e-2 + 2e-2 |plain|: P is rounded to bf16 for
    the PV tensor-core product and the output to bf16.  ``fused``: k and v
    are the two non-contiguous halves of one [B, Sk, 2 Hkv, hd] tensor."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, Sq, Hq, hd), generator=g, device=cuda).to(torch.bfloat16)
    if fused:
        kv = torch.randn((B, Sk, 2 * Hkv, hd), generator=g,
                         device=cuda).to(torch.bfloat16)
        k, v = kv[:, :, :Hkv], kv[:, :, Hkv:]
        assert not k.is_contiguous() and not v.is_contiguous()
    else:
        k, v = (torch.randn((B, Sk, Hkv, hd), generator=g,
                            device=cuda).to(torch.bfloat16) for _ in range(2))
    attn_ops.launches = 0
    got = attn_ops.flash_attention(q, k, v, window=window, softcap=cap,
                                   q_offset=qoff).float()
    torch.cuda.synchronize()
    assert attn_ops.launches == 1
    want = attention_ref(q, k, v, window=window, softcap=cap,
                         q_offset=qoff).float()
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= 2e-2 + 2e-2 * want.abs()).all())


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError):
        attn_ops.flash_attention(q, q, q)                       # f32
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError):
        attn_ops.flash_attention(qb[..., :32], qb[..., :32], qb[..., :32])
    # TMA needs 16-byte strides: a row stride of 68 elements is refused
    wide = torch.zeros(1, 8, 2, 68, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attn_ops.flash_attention(qb, wide[..., :64], wide[..., :64])


def _scan_inputs(device, B, S, W, with_h0, gates, seed):
    """Gates from the model's range (a = exp(-8 softplus(lam) r)) or from
    the reference test's (a in [0.8, 0.999])."""
    g = torch.Generator(device=device).manual_seed(seed)
    if gates == "model":
        lam = torch.randn(W, generator=g, device=device)
        r = torch.rand((B, S, W), generator=g, device=device)
        a = torch.exp(-8.0 * torch.logaddexp(lam, torch.zeros_like(lam)) * r)
        b = torch.sqrt(1.0 - a * a) * torch.randn((B, S, W), generator=g,
                                                  device=device)
    else:
        a = 0.8 + 0.199 * torch.rand((B, S, W), generator=g, device=device)
        b = torch.randn((B, S, W), generator=g, device=device)
    h0 = torch.randn((B, W), generator=g, device=device) if with_h0 else None
    return a, b, h0


def _assert_scan_close(a, b, h0, h, h_last):
    """|kernel - plain| <= 1e-5 + 1e-5 |plain| (tests/test_kernels.py's f32
    tolerance: the kernel composes chunk aggregates and runs FMA chains,
    the plain version a doubling scan); h_last is h[:, -1] bit for bit."""
    want, want_last = rglru_scan_ref(a, b, h0)
    assert bool(((h - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())
    assert bool(((h_last - want_last).abs()
                 <= 1e-5 + 1e-5 * want_last.abs()).all())
    assert torch.equal(h_last, h[:, -1])


# the kernel's chunk is 64 steps and its W tile 64 columns; W % 4 != 0 or
# an unaligned base stages by cp.async, any other call by TMA
@pytest.mark.parametrize("B,S,W,with_h0,gates,unaligned", [
    (4, 512, 4096, True, "model", False),   # the serving path's prefill
    (1, 2048, 4096, True, "model", False),
    (1, 1000, 4096, False, "test", False),  # ragged S, h0 = None
    (2, 300, 1000, True, "test", False),    # ragged W
    (3, 5, 33, True, "test", False),        # S shorter than a box; cp.async
    (2, 1, 4096, True, "model", False),     # S = 1
    (2, 64, 4096, True, "test", False),     # S = one chunk
    (2, 65, 4096, True, "test", False),     # S = one chunk + 1
    (1, 4096, 4096, True, "test", False),   # 64 chunks chained by look-back
    (2, 130, 100, True, "test", False),     # W not a multiple of 64 (TMA)
    (2, 200, 65, True, "test", False),      # W not a multiple of 64 (cp.async)
    (3, 200, 4096, False, "model", False),  # h0 = None over several chunks
    (2, 300, 4096, True, "model", True),    # bases 4 bytes past 16 (cp.async)
    (70000, 3, 8, True, "test", False),     # a flat grid: B past 65,535
])
def test_rglru_scan_kernel_within_tolerance(cuda, B, S, W, with_h0, gates,
                                            unaligned):
    """Within tolerance of the plain version; one launch.  ``unaligned``
    passes a and b as contiguous views that start 4 bytes past a 16-byte
    boundary, which TMA cannot take."""
    a, b, h0 = _scan_inputs(cuda, B, S, W, with_h0, gates, B * S * W)
    ka, kb = a, b
    if unaligned:
        ka, kb = (torch.empty(t.numel() + 1, device=cuda)[1:].view_as(t)
                  .copy_(t) for t in (a, b))
        assert ka.data_ptr() % 16 and ka.is_contiguous()
    scan_ops.launches = 0
    h, h_last = scan_ops.lru_scan(ka, kb, h0)
    torch.cuda.synchronize()
    assert scan_ops.launches == 1
    _assert_scan_close(a, b, h0, h, h_last)


def test_rglru_scan_kernel_back_to_back_calls(cuda):
    """Calls one after another on one stream, of one shape and of others,
    reuse the look-back scratch: the ticket counter and the look-back words
    must be fresh for each launch."""
    shapes = [(4, 512, 4096), (4, 512, 4096), (1, 2048, 4096), (2, 65, 100),
              (4, 512, 4096)]
    ins = [_scan_inputs(cuda, B, S, W, True, "test", i)
           for i, (B, S, W) in enumerate(shapes)]
    scan_ops.launches = 0
    outs = [scan_ops.lru_scan(a, b, h0) for a, b, h0 in ins]
    torch.cuda.synchronize()
    assert scan_ops.launches == len(shapes)
    for (a, b, h0), (h, h_last) in zip(ins, outs):
        _assert_scan_close(a, b, h0, h, h_last)


def test_rglru_scan_kernel_refuses_what_it_does_not_take(cuda):
    a = torch.zeros(1, 8, 4, device=cuda)
    with pytest.raises(ValueError):
        scan_ops.lru_scan(a.to(torch.bfloat16), a.to(torch.bfloat16))
    with pytest.raises(ValueError):
        scan_ops.lru_scan(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError):
        scan_ops.lru_scan(a, a.cpu())


def _scan_grads(fn, a, b, h0, g, g_last):
    """(h, h_last, da, db, dh0 or None) of ``fn`` on copies of a, b, h0 for
    the upstream gradients g of h and g_last of h_last."""
    ins = [t.clone().requires_grad_(True) for t in (a, b, h0)
           if t is not None]
    h, h_last = fn(ins[0], ins[1], ins[2] if h0 is not None else None)
    grads = torch.autograd.grad((h, h_last), ins, (g, g_last))
    dh0 = grads[2] if h0 is not None else None
    return h.detach(), h_last.detach(), grads[0], grads[1], dh0


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("B,S,W,with_h0", [
    (4, 2048, 4096, True),      # the hybrid train path's shape
    (2, 300, 1000, False),      # ragged S and W, h0 = None
])
def test_rglru_scan_vjp_grads_match_plain_path(cuda, B, S, W, with_h0,
                                               deterministic):
    """The autograd Function (kernel forward, kernel backward: one launch
    each) against autograd through the plain version on the same card
    tensors and upstream gradients: da, db, dh0 within the scan's f32
    tolerance, 1e-5 + 1e-5 |plain|; in deterministic mode (the train
    path's: chained carries) and in default mode (the decoupled
    look-back)."""
    a, b, h0 = _scan_inputs(cuda, B, S, W, with_h0, "model", S + W)
    gen = torch.Generator(device=cuda).manual_seed(W)
    g = torch.randn((B, S, W), generator=gen, device=cuda)
    g_last = torch.randn((B, W), generator=gen, device=cuda)
    scan_ops.launches = 0
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        got = _scan_grads(scan_ops.lru_scan_vjp, a, b, h0, g, g_last)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was)
    assert scan_ops.launches == 2
    want = _scan_grads(rglru_scan_ref, a, b, h0, g, g_last)
    for x, y in zip(got, want):
        if y is None:
            assert x is None
            continue
        assert bool(torch.isfinite(x).all())
        assert bool(((x - y).abs() <= 1e-5 + 1e-5 * y.abs()).all())


def test_rglru_scan_repeats_bit_for_bit_in_deterministic_mode(cuda):
    """Under ``torch.use_deterministic_algorithms`` the kernel chains its
    chunks' carries: ten forward launches at the train path's shape (32
    chunks) and two backward runs of the Function give the same bits."""
    a, b, h0 = _scan_inputs(cuda, 4, 2048, 4096, True, "model", 7)
    gen = torch.Generator(device=cuda).manual_seed(7)
    g = torch.randn(a.shape, generator=gen, device=cuda)
    g_last = torch.randn(h0.shape, generator=gen, device=cuda)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        first = scan_ops.lru_scan(a, b, h0)[0]
        same = [torch.equal(scan_ops.lru_scan(a, b, h0)[0], first)
                for _ in range(9)]
        runs = [_scan_grads(scan_ops.lru_scan_vjp, a, b, h0, g, g_last)
                for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(was)
    assert all(same)
    _assert_scan_close(a, b, h0, first, first[:, -1])
    for x, y in zip(*runs):
        assert torch.equal(x, y)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,window,cap,qoff", [
    (4, 2048, 2048, 9, 3, 64, 0, 0.0, 0),       # smollm's train step
    (4, 1024, 1024, 24, 8, 64, 0, 0.0, 0),      # granite's
    (1, 512, 512, 32, 8, 128, 0, 0.0, 0),       # qwen3-4b's heads, hd 128
    (2, 333, 433, 9, 3, 64, 256, 50.0, 100),    # ragged, all three options
    (1, 512, 512, 9, 3, 64, 0, 0.0, 0),
    (2, 1000, 1000, 9, 3, 64, 0, 0.0, 0),
    (3, 1536, 1536, 6, 2, 64, 0, 0.0, 0),
    (1, 2048, 2048, 4, 2, 128, 0, 0.0, 0),
    (1, 65, 65, 3, 3, 64, 0, 0.0, 0),           # G 1, a row past a tile
    (2, 200, 200, 4, 1, 128, 48, 30.0, 0),      # window and softcap, hd 128
    (1, 100, 300, 7, 1, 128, 0, 0.0, 200),      # q_offset, G 7
    # the 128-row blocks' edges: the second 64-row half holds one row (Sk
    # 65) or 8 of 64 (Sk 200, the second key block)
    (1, 65, 65, 2, 2, 128, 0, 0.0, 0),
    (2, 200, 200, 7, 1, 64, 0, 0.0, 0),         # and G 7
    # a window of 40: q tile 2 visits key block 0 but sees no key of its
    # first half, so that warpgroup has no visible query there; G 1 with a
    # softcap at hd 128
    (1, 256, 256, 3, 1, 64, 40, 0.0, 0),
    (2, 384, 384, 2, 2, 128, 40, 20.0, 0),
    # few blocks: the schedule cuts every key block into runs of at most 5
    # items and sums their partials (hd 64, G 4)
    (1, 1024, 1024, 8, 2, 64, 0, 0.0, 0),
    (4, 1024, 1024, 64, 8, 128, 0, 0.0, 0),     # kimi_train's heads, G 8
])
def test_flash_attention_bwd_kernel_within_tolerance(cuda, B, Sq, Sk, Hq,
                                                     Hkv, hd, window, cap,
                                                     qoff):
    """The backward kernel, from the forward kernel's o and log-sum-exp,
    against ``attention_bwd_ref`` in f32 on the same tensors: each of dq,
    dk, dv within 2e-2 of its array's largest magnitude (P and dS round to
    bf16 for the products, the gradients to bf16); the log-sum-exp (log2
    domain) against ``attention_lse_ref``'s within 1e-3 (1 + |plain|).  One
    forward and one backward launch counted."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Hq)
    q, k, v, do = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
                   for s in [(B, Sq, Hq, hd), (B, Sk, Hkv, hd),
                             (B, Sk, Hkv, hd), (B, Sq, Hq, hd)])
    kw = dict(window=window, softcap=cap, q_offset=qoff)
    attn_ops.launches = attn_ops.bwd_launches = 0
    o, lse = attn_ops.flash_attention_fwd_lse(q, k, v, **kw)
    got = attn_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert attn_ops.launches == 1 and attn_ops.bwd_launches == 1
    lse_nat = lse / attn_ops.LOG2E
    lse_ref = attention_lse_ref(q, k, v, **kw)[1]
    assert bool(((lse_nat - lse_ref).abs()
                 <= 1e-3 * (1 + lse_ref.abs())).all())
    want = attention_bwd_ref(q.float(), k.float(), v.float(), o.float(),
                             lse_nat, do.float(), **kw)
    for x, y in zip(got, want):
        assert x.dtype == torch.bfloat16 and x.shape == y.shape
        assert bool(torch.isfinite(x).all())
        assert float((x.float() - y).abs().max()) <= 2e-2 * float(
            y.abs().max())


@pytest.mark.parametrize("B,S,Hq,Hkv,hd", [
    (4, 2048, 9, 3, 64),        # smollm's train step
    (4, 1024, 24, 8, 64),       # granite's
    (1, 512, 32, 8, 128),       # qwen3-4b's heads: split key blocks summed
    (4, 1024, 64, 8, 128),      # kimi_train's heads, G 8
])
def test_flash_attention_bwd_kernel_repeats_bit_for_bit(cuda, B, S, Hq, Hkv,
                                                        hd):
    """No atomics: two launches give the same bits in dq, dk and dv, at
    the three shapes the path times (the sum pass's fixed order too)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
                   for s in [(B, S, Hq, hd), (B, S, Hkv, hd),
                             (B, S, Hkv, hd), (B, S, Hq, hd)])
    o, lse = attn_ops.flash_attention_fwd_lse(q, k, v)
    first = attn_ops.flash_attention_bwd(q, k, v, o, lse, do)
    second = attn_ops.flash_attention_bwd(q, k, v, o, lse, do)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_flash_attention_bwd_kernel_refuses_what_it_does_not_take(cuda):
    qb = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8, device=cuda)
    q32 = qb.float()
    with pytest.raises(ValueError):                            # f32
        attn_ops.flash_attention_bwd(q32, q32, q32, q32, lse, q32)
    q96 = torch.zeros(1, 8, 2, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                            # hd 96
        attn_ops.flash_attention_bwd(q96, q96, q96, q96, lse, q96)
    # TMA needs 16-byte strides: a row stride of 68 elements is refused
    wide = torch.zeros(1, 8, 2, 68, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attn_ops.flash_attention_bwd(qb, wide[..., :64], wide[..., :64], qb,
                                     lse, qb)
    with pytest.raises(ValueError):                            # dO too
        attn_ops.flash_attention_bwd(qb, qb, qb, qb, lse,
                                     wide.expand(1, 8, 2, 68)[..., 2:66])
    with pytest.raises(ValueError):                            # f32 lse
        attn_ops.flash_attention_bwd(qb, qb, qb, qb, lse.double(), qb)


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("B,S,W,with_h0,unaligned", [
    (4, 2048, 4096, True, False),   # the hybrid train path's shape
    (2, 300, 1000, False, False),   # ragged S and W, h0 = None
    (2, 65, 100, True, False),      # one chunk and a step, W % 64 != 0
    (2, 200, 65, True, False),      # W % 4 != 0: the cp.async route
    (2, 300, 128, True, True),      # an unaligned base: cp.async
    (3, 1, 64, True, False),        # S 1
])
def test_rglru_scan_reverse_mode_matches_plain(cuda, B, S, W, with_h0,
                                               unaligned, deterministic):
    """The kernel's reverse mode (``lru_scan_bwd``, one launch) against
    ``lru_scan_bwd_ref``'s reversed loop on the same card tensors: da, db
    and dh0 within the scan's f32 tolerance, 1e-5 + 1e-5 |plain|, in
    deterministic mode (chained carries) and in default mode."""
    a, b, h0 = _scan_inputs(cuda, B, S, W, with_h0, "model", B + S + W)
    gen = torch.Generator(device=cuda).manual_seed(S)
    g = torch.randn((B, S, W), generator=gen, device=cuda)
    g_last = torch.randn((B, W), generator=gen, device=cuda)
    h = rglru_scan_ref(a, b, h0)[0]
    ins = (a, h, g)
    if unaligned:
        ins = tuple(torch.empty(t.numel() + 1, device=cuda)[1:].view_as(t)
                    .copy_(t) for t in ins)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    scan_ops.launches = 0
    try:
        got = scan_ops.lru_scan_bwd(ins[0], ins[1], h0, ins[2], g_last)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was)
    assert scan_ops.launches == 1
    want = lru_scan_bwd_ref(a, h, h0, g, g_last)
    for x, y in zip(got, want):
        if y is None:
            assert x is None
            continue
        assert bool(torch.isfinite(x).all())
        assert bool(((x - y).abs() <= 1e-5 + 1e-5 * y.abs()).all())


# ------------------------------------------------------------ train path
@pytest.mark.parametrize("B,S", [(1, 512), (2, 1000), (4, 2048)])
def test_flash_attention_vjp_grads_match_plain_path(cuda, B, S):
    """The autograd Function's dq, dk, dv (the forward kernel, then the
    backward kernel from its log-sum-exp) against autograd through the
    plain blocked path on the same upstream gradient, bf16, smollm's heads:
    the same function, held to the kernel's bf16 tolerance (2e-2 + 2e-2
    |plain|)."""
    from repro_torch.models.layers import flash_attention_xla

    g = torch.Generator(device=cuda).manual_seed(S)
    shapes = [(B, S, 9, 64), (B, S, 3, 64), (B, S, 3, 64), (B, S, 9, 64)]
    q, k, v, dout = (torch.randn(s, generator=g, device=cuda)
                     .to(torch.bfloat16) for s in shapes)

    def grads(fn):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(fn(*ts), ts, dout)

    attn_ops.launches = 0
    got = grads(lambda a, b, c: attn_ops.flash_attention_vjp(
        a, b, c, True, 0, 0.0, 512, 1024, 0))
    assert attn_ops.launches == 1
    want = grads(lambda a, b, c: flash_attention_xla(
        a, b, c, causal=True, block_q=512, block_k=1024))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        assert bool(torch.isfinite(a).all())
        assert bool(((a - b).abs() <= 2e-2 + 2e-2 * b.abs()).all())


def test_deterministic_train_step_repeats_bit_for_bit(cuda, monkeypatch):
    """Two runs of 3 train steps from one seeded state, in deterministic
    mode, through the kernel path with remat: every array of the states and
    every loss bit-equal."""
    import dataclasses
    import functools

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.api import build_model
    from repro_torch.train import (AdamW, SyntheticLM, init_train_state,
                                   make_train_step, warmup_cosine)

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = dataclasses.replace(get_smoke_config("smollm_135m"), d_model=256,
                              head_dim=64, attention_impl="pallas",
                              remat=True)
    api = build_model(cfg)
    step = make_train_step(api, AdamW(), functools.partial(
        warmup_cosine, base_lr=3e-3, warmup=1, total=3),
        ShapeConfig("t", 256, 2, "train"))
    data = SyntheticLM(cfg.vocab, 256, 2, seed=0)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for _ in range(2):
            state = init_train_state(
                api, AdamW(), torch.Generator(device=cuda).manual_seed(0))
            losses = []
            for i in range(3):
                batch = {k: torch.from_numpy(v).to(cuda)
                         for k, v in data.batch(i).items()}
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            runs.append((state, losses))
    finally:
        torch.use_deterministic_algorithms(was)
    (s1, l1), (s2, l2) = runs
    assert l1 == l2 and all(np.isfinite(l1))
    for name in s1:
        assert torch.equal(s1[name].reshape(-1).view(torch.uint8),
                           s2[name].reshape(-1).view(torch.uint8)), name


def test_vlm_prefill_on_the_card_matches_the_cpu(cuda):
    """qwen2-vl's smoke backbone widened to the kernel's head dim 128 with
    qwen2-vl-7b's odd group (14 query heads over 2 kv heads, G 7), bf16,
    prefilled from its embeddings batch (M-RoPE positions [B, S, 3]): the
    card's logits and cache (the flash kernel, one launch a layer) against
    the CPU's (its plain version) on the same weights, within bf16's 2e-2
    of each array's scale."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.api import build_model, make_token_batch

    cfg = dataclasses.replace(get_smoke_config("qwen2_vl_7b"), head_dim=128,
                              num_heads=14, num_kv_heads=2,
                              attention_impl="pallas")
    assert cfg.mrope_sections() == (16, 24, 24) and cfg.q_per_kv == 7
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    batch = make_token_batch(cfg, ShapeConfig("p", 200, 2, "prefill"), seed=1)
    cpu = api.prefill(params, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, 208)
    attn_ops.launches = 0
    card = api.prefill({k: v.to(cuda) for k, v in params.items()},
                       {k: torch.from_numpy(v).to(cuda)
                        for k, v in batch.items()}, 208)
    torch.cuda.synchronize()
    assert attn_ops.launches == cfg.num_layers
    (got_logits, got_cache), (want_logits, want_cache) = card, cpu
    for got, want in [(got_logits, want_logits),
                      (got_cache["k"], want_cache["k"]),
                      (got_cache["v"], want_cache["v"])]:
        got, want = got.float().cpu(), want.float()
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= \
            2e-2 * float(want.abs().max())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_whisper_prefill_and_decode_on_the_card_match_the_cpu(cuda, dtype,
                                                              tol):
    """whisper's smoke model over 40 frames (its blocked attention, no
    kernel), prefilled with 24 tokens and decoded 4 steps, on the card and
    on the CPU from the same weights and inputs: the logits of every step
    and the whole cache (k, v, the cross K/V) within ``tol`` of each
    array's scale (f32 1e-5, bf16 2e-2); the CPU's greedy tokens fed to
    both."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.api import build_model, make_token_batch

    cfg = dataclasses.replace(get_smoke_config("whisper_base"), dtype=dtype,
                              encoder_seq=40)
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in make_token_batch(
        cfg, ShapeConfig("p", 24, 2, "prefill"), seed=1).items()}
    on_card = {k: v.to(cuda) for k, v in params.items()}
    runs = {"cpu": api.prefill(params, batch, 28),
            "card": api.prefill(on_card, {k: v.to(cuda)
                                          for k, v in batch.items()}, 28)}

    def same(what):
        (got, got_cache), (want, want_cache) = runs["card"], runs["cpu"]
        for name, a, b in [("logits", got, want)] + [
                (k, got_cache[k], want_cache[k])
                for k in ("k", "v", "xk", "xv")]:
            a, b = a.float().cpu(), b.float()
            assert bool(torch.isfinite(a).all()), (what, name)
            assert float((a - b).abs().max()) <= tol * float(
                b.abs().max()), (what, name)
        assert int(got_cache["length"]) == int(want_cache["length"])

    same("prefill")
    for i in range(4):
        token = torch.argmax(runs["cpu"][0], -1).to(torch.int32)[:, None]
        pos = torch.full((2,), 24 + i, dtype=torch.int32)
        runs = {"cpu": api.decode_step(params, runs["cpu"][1],
                                       {"token": token, "pos": pos}),
                "card": api.decode_step(on_card, runs["card"][1],
                                        {"token": token.to(cuda),
                                         "pos": pos.to(cuda)})}
        same(f"decode step {i}")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_moe_ffn_ep_on_the_card_matches_the_dense_oracle(cuda, dtype, tol):
    """``moe_ffn_ep`` (a model axis of 1) against the dense one-hot oracle
    at capacity factor E on the card, granite's expert count (40 real of
    48) and top-8 at a narrow width: y within ``tol`` of its scale, and the
    EP forward and backward repeat bit for bit in deterministic mode (the
    dispatch and combine gather, never accumulate through atomics)."""
    from repro_torch.models import moe
    from repro_torch.train.step import ONE_DEVICE

    gen = torch.Generator(device=cuda).manual_seed(0)
    B, S, D, E, Fd = 2, 64, 128, 48, 64

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=cuda)
                ).to(dtype)
    args = [rnd(B, S, D), rnd(D, E), rnd(E, D, Fd, scale=0.1),
            rnd(E, D, Fd, scale=0.1), rnd(E, Fd, D, scale=0.1)]
    kw = dict(top_k=8, num_real=40, capacity_factor=float(E))
    y_dn, _ = moe.moe_ffn(*args, **kw)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for _ in range(2):
            ts = [a.clone().requires_grad_(True) for a in args]
            y, aux = moe.moe_ffn_ep(*ts, mesh=ONE_DEVICE, **kw)
            grads = torch.autograd.grad((y.float() ** 2).sum() + aux, ts)
            runs.append([y.detach(), aux.detach(), *grads])
    finally:
        torch.use_deterministic_algorithms(was)
    y = runs[0][0].float()
    assert float((y - y_dn.float()).abs().max()) <= \
        tol * float(y_dn.float().abs().max())
    for a, b in zip(*runs):
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


def test_granite_ep_train_step_repeats_bit_for_bit(cuda, monkeypatch):
    """Granite's smoke EP variant (the one-device step installs a (1, 1)
    context, so every MoE layer runs ``moe_ffn_ep``) at head dim 64 through
    the kernel path: two runs of 3 steps from one seeded state in
    deterministic mode, every array and loss bit-equal, aux positive."""
    import dataclasses
    import functools

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.api import build_model
    from repro_torch.train import (AdamW, SyntheticLM, init_train_state,
                                   make_train_step, warmup_cosine)

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = get_smoke_config("granite_moe_3b_a800m")
    cfg = dataclasses.replace(
        cfg, d_model=256, head_dim=64, attention_impl="pallas", remat=True,
        moe=dataclasses.replace(cfg.moe, impl="ep"))
    api = build_model(cfg)
    step = make_train_step(api, AdamW(), functools.partial(
        warmup_cosine, base_lr=3e-3, warmup=1, total=3),
        ShapeConfig("t", 256, 2, "train"))
    data = SyntheticLM(cfg.vocab, 256, 2, seed=0)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for _ in range(2):
            state = init_train_state(
                api, AdamW(), torch.Generator(device=cuda).manual_seed(0))
            metrics = []
            for i in range(3):
                batch = {k: torch.from_numpy(v).to(cuda)
                         for k, v in data.batch(i).items()}
                state, m = step(state, batch)
                metrics.append((float(m["loss"]), float(m["aux"])))
            runs.append((state, metrics))
    finally:
        torch.use_deterministic_algorithms(was)
    (s1, m1), (s2, m2) = runs
    assert m1 == m2 and all(np.isfinite(l) and a > 0 for l, a in m1)
    for name in s1:
        assert torch.equal(s1[name].reshape(-1).view(torch.uint8),
                           s2[name].reshape(-1).view(torch.uint8)), name


def _fe_functions(N):
    from repro_torch.fem import (Element, FunctionSpace, distribute,
                                 interpolate, tri_mesh)
    plexes, _, _ = distribute(tri_mesh(6, 5, seed=2), N, method="random",
                              seed=3)
    spaces = [FunctionSpace(lp, Element("P", 4, "triangle")) for lp in plexes]
    funcs = [interpolate(sp, lambda p: np.sin(3 * p[:, 0])
                         * (2 + np.cos(5 * p[:, 1])) + p[:, 0] * p[:, 1])
             for sp in spaces]
    return spaces, funcs


@pytest.mark.parametrize("N", [1, 4])
def test_functions_round_trip_through_the_card(cuda, N):
    """DoF vectors to the card and back, float64, bit for bit."""
    from repro_torch.fem.torch_fem import (functions_from_device,
                                           functions_to_device)
    spaces, funcs = _fe_functions(N)
    on_card = functions_to_device(funcs)            # the card by default
    assert all(t.device.type == "cuda" and t.dtype == torch.float64
               for t in on_card)
    for t, f in zip(on_card, funcs):
        assert np.array_equal(t.cpu().numpy(), f.values)
    back = functions_from_device(spaces, on_card)
    for b, f in zip(back, funcs):
        assert np.array_equal(b.values, f.values)


def test_fe_round_trip_n4_to_m1_lands_on_the_card(cuda, tmp_path):
    """A P4 function kept on the card, saved from N = 4 through the async
    facade and loaded on M = 1 onto the card: every DoF equals the field
    at its node, bit for bit."""
    from repro_torch.core.async_io import AsyncCheckpointer
    from repro_torch.core.comm import Comm
    from repro_torch.core.store import DatasetStore
    from repro_torch.fem import FEMCheckpoint, node_points
    from repro_torch.fem.torch_fem import (functions_from_device,
                                           functions_to_device)
    spaces, funcs = _fe_functions(4)
    on_card = functions_to_device(funcs, cuda)
    ac = AsyncCheckpointer(FEMCheckpoint(DatasetStore(str(tmp_path), "w")),
                           Comm(4))
    ac.save_mesh("m", [sp.plex for sp in spaces])
    ac.save_function("m", "f", functions_from_device(spaces, on_card),
                     time_index=0)
    ac.wait()
    ck = FEMCheckpoint(DatasetStore(str(tmp_path), "r"))
    loaded = ck.load_mesh("m", Comm(1))
    lspaces, lfuncs = ck.load_function(loaded, "f", Comm(1), time_index=0)
    (got,) = functions_to_device(lfuncs, cuda)
    assert got.device.type == "cuda"
    p = node_points(lspaces[0])
    want = np.sin(3 * p[:, 0]) * (2 + np.cos(5 * p[:, 1])) + p[:, 0] * p[:, 1]
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.fixture
def one_card_mesh(cuda):
    """A (1, 1) mesh of one NCCL process on the card; the group is gone
    after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_debug_mesh

    init_distributed("cuda", rank=0, world_size=1)
    try:
        yield make_debug_mesh(1, 1, device_type="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["smollm_135m", "whisper_base"])
def test_mesh_decode_at_one_card_is_the_one_device_decode(one_card_mesh,
                                                          arch):
    """The sharded prefill and decode steps on a (1, 1) mesh take the
    one-device path bit for bit (no split: the plain ``decode_attention``),
    f32 smoke config; and the sequence-parallel partial and combine of one
    key range (no group) hold to the one-device attention within 1e-6 of
    the f32 scale on the card."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distrib.context import (DimSplit, MeshContext,
                                             use_mesh_context)
    from repro_torch.distrib.rules import rules_for
    from repro_torch.launch.serve import greedy, shard_params
    from repro_torch.models.api import build_model, make_token_batch
    from repro_torch.models.layers import decode_attention
    from repro_torch.train.step import make_decode_step, make_prefill_step

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    api, rules, B, P, G = build_model(cfg), rules_for(cfg.arch), 2, 8, 4
    params = api.init(torch.Generator().manual_seed(0))
    params = {k: v.cuda() for k, v in params.items()}
    shape = ShapeConfig("p", P, B, "prefill")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in make_token_batch(cfg, shape, seed=0).items()}
    mesh = one_card_mesh
    sharded = shard_params(api, params, mesh, rules)
    logits, cache = make_prefill_step(api, shape, P + G, mesh=mesh,
                                      rules=rules)(sharded, batch)
    want, plain = make_prefill_step(api, shape, P + G)(params, batch)
    assert torch.equal(logits.to_local(), want)
    decode, one = make_decode_step(api, mesh=mesh), make_decode_step(api)
    tok = greedy(want)
    for i in range(G):
        step = {"token": tok, "pos": torch.full((B,), P + i,
                                                dtype=torch.int32,
                                                device="cuda")}
        logits, cache = decode(sharded, cache, step)
        want, plain = one(params, plain, step)
        assert torch.equal(logits.to_local(), want), i
        tok = greedy(want)
    for k, v in plain.items():
        assert torch.equal(cache[k].to_local(), v), k
    q = torch.randn(B, 1, 4, 16, device="cuda")
    kv = torch.randn(2, B, 12, 2, 16, device="cuda")
    lens = torch.tensor([3, 12], dtype=torch.int32, device="cuda")
    want = decode_attention(q, kv[0], kv[1], lens, window=5, softcap=5.0)
    split = {"k": {2: DimSplit(0, 12, 12, None)}}
    with use_mesh_context(MeshContext(mesh=mesh, cache_splits=split)):
        got = decode_attention(q, kv[0], kv[1], lens, window=5, softcap=5.0,
                               entry="k")
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_serve_launcher_mesh_path_on_one_card(cuda):
    """``torchrun --nproc-per-node 1 -m repro_torch.launch.serve``: a world
    of one under NCCL serves through the mesh path and prints the
    reference launcher's keys with the card's name."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "repro_torch.launch.serve",
         "--arch", "smollm-135m", "--gen-len", "4"],
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert {"arch", "batch", "prompt_len", "gen_len", "prefill_seconds",
            "decode_seconds", "decode_tokens_per_s",
            "sample_tokens"} <= set(line)
    assert line["device"] == torch.cuda.get_device_name(0)
    assert len(line["sample_tokens"]) == 5


@pytest.mark.parametrize("m", [2, 3])
def test_tp_step_on_processes_that_share_the_card(cuda, tmp_path,
                                                  monkeypatch, m):
    """smollm-135m at full width, 1 layer, B 2, S 256, on a (1, m) mesh of
    m processes that share the card (gloo, which takes the card's
    tensors), its compute split over the model axis: 2 steps against the
    one-process card steps within tests/test_torch_mesh_train.py's bf16
    tolerances; a second TP run bit-equal; each process launches the flash
    kernels; over the model axis, parameter bytes only where a weight's
    split does not line up with its activation's (m = 2: wq, wk and wv,
    whose 9 and 3 heads do not split 2 ways) and none at m = 3; the saved
    state restored on one process bit-equal to every process's shards."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from helpers.torch_tp_workers import (card_config, card_errors,
                                          card_one_process, card_tp_train,
                                          load_kept)

    from repro_torch.core.store import DatasetStore
    from repro_torch.core.tensor_ckpt import TensorCheckpoint
    from repro_torch.core.torch_io import load_torch
    from repro_torch.launch.spawn import run_processes
    from repro_torch.models.api import build_model

    layers, B, S, steps = 1, 2, 256, 2
    store, kept_dir = tmp_path / "store", tmp_path / "kept"
    kept_dir.mkdir()
    ranks = run_processes(card_tp_train, m, (
        (1, m), layers, B, S, steps, 0, str(store), str(kept_dir)),
        timeout=300, pg_timeout=120)
    api = build_model(card_config(layers))
    D, hd, L = api.cfg.d_model, api.cfg.head_dim_, layers
    # wq [L, D, 9 * hd], wk and wv [L, D, 3 * hd], each process's part
    gathered = 0 if m == 3 else L * D * (9 + 3 + 3) * hd * 2 // m
    for r in ranks:
        assert r["launches"]["flash_attention"] > 0
        assert r["launches"]["flash_attention_bwd"] > 0
        assert r["model_bytes"]["parameter"] == steps * gathered
        assert r["model_bytes"]["activation"] > 0
        assert r["repeat_differs"] == [] and r["repeat_metrics_equal"]
        assert r["metrics"] == ranks[0]["metrics"]
    kept = load_kept(str(kept_dir), m)
    ck = TensorCheckpoint(DatasetStore(str(store), "r"))
    target = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in api.abstract_params().items()}
    target = {f"params/{k}": v for k, v in target.items()}
    restored = load_torch(ck, target, steps, device="cuda")
    for r in kept:
        for k, v in restored.items():
            got = v[r["boxes"][k]].cpu().reshape(-1).view(torch.uint8)
            assert torch.equal(got, r["local"][k].reshape(-1)
                               .view(torch.uint8)), k
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    try:
        one = card_one_process(layers, B, S, steps, 0)
    finally:
        torch.use_deterministic_algorithms(was)
    errors = card_errors(ranks[0]["metrics"], kept, one)
    worst = max(errors.items(), key=lambda kv: kv[1])
    assert worst[1] <= 1.0, worst


def test_adafactor_mesh_on_processes_that_share_the_card(cuda, tmp_path,
                                                         monkeypatch):
    """kimi-k2 at full width, 1 layer, 16 experts (EP), in f32 (its
    attention on the blocked plain path: the flash kernels take bf16, and
    ``chip_smoke.py``'s ``adafactor_mesh`` runs them at a process's
    heads), B 2, S 256, on a (1, 2) mesh of 2 processes that share the
    card (gloo), each with 32 query and 4 kv heads, 8 experts and half the
    vocab (top-8 of 8 experts would choose every expert, which makes the
    aux loss's gradient, the only one a sequence's last token gets, zero
    up to rounding, and Adafactor's row normalisation would turn that
    rounding into a whole step of its embedding row): the sharded Adafactor step, its reductions summed over the
    model axis, 2 steps against the one-process card steps within
    tests/test_torch_mesh_train.py's f32 tolerances and step 1 again
    bit-equal; the decode on local heads, fed the one-process decode's
    tokens, choosing them again with logits within 1e-4 of their scale;
    no parameter bytes over the model axis; the smoke config's sharded
    Adafactor state restored on one process bit-equal to every process's
    shards.  In f32 a step moves each weight by many spacings, so the
    whole update is held (in bf16 most move about one, and the two runs'
    last bits decide which way they round: ``ADA_MIN_CHANGE_ULPS``)."""
    import dataclasses
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from helpers import torch_adafactor_workers as W
    from helpers.torch_tp_workers import card_errors
    from test_torch_mesh_train import RTOL

    from repro_torch.core.store import DatasetStore
    from repro_torch.core.tensor_ckpt import TensorCheckpoint
    from repro_torch.core.torch_io import load_torch
    from repro_torch.launch.spawn import run_processes
    from repro_torch.models.api import build_model
    from repro_torch.train.optim import Adafactor
    from repro_torch.train.step import init_train_state

    cfg = dataclasses.replace(W.card_config(1, 16), dtype="float32",
                              attention_impl="xla_flash")
    B, S, steps, P, G, m = 2, 256, 2, 64, 4, 2
    lr, warmup = 0.005, 2
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    try:
        one_logits, tokens = W.card_one_process(cfg, B, P, G, 0)
        one = W.card_one_train(cfg, B, S, steps, 0, lr, warmup, steps)
    finally:
        torch.use_deterministic_algorithms(was)
    store, kept_dir = tmp_path / "store", tmp_path / "kept"
    kept_dir.mkdir()
    ranks = run_processes(W.card_adafactor_mesh, m, (
        (1, m), cfg, B, S, steps, 1, 0, lr, warmup, steps, tokens, P,
        str(store), str(kept_dir)), timeout=300, pg_timeout=120)
    for r in ranks:
        assert r["launches"]["ckpt_pack"] > 0
        for what in ("model_bytes", "serve_model_bytes"):
            assert r[what]["parameter"] == 0 and r[what]["activation"] > 0
        assert r["repeat_differs"] == [] and r["repeat_metrics_equal"]
        assert r["metrics"] == ranks[0]["metrics"]
    errors = card_errors(ranks[0]["metrics"],
                         W.load_kept(str(kept_dir), m), one,
                         rtol=RTOL["float32"])
    worst = max(errors.items(), key=lambda kv: kv[1])
    assert worst[1] <= 1.0, worst
    agree = W.logit_agreement(ranks[0]["logits"], one_logits, tokens)
    assert agree["logits_err_over_scale"] <= 1e-4, agree
    assert agree["argmax_flips"] == [], agree
    small = build_model(W.config(*W.SAVED))
    target = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in init_train_state(
                  small, Adafactor(), torch.Generator().manual_seed(0)).items()}
    restored = load_torch(TensorCheckpoint(DatasetStore(str(store), "r")),
                          target, 2, device="cuda")
    for r in W.load_kept(str(kept_dir), m, "smoke"):
        for k, t in r["local"].items():
            got = restored[k][r["boxes"][k]].cpu()
            assert torch.equal(got.reshape(-1).view(torch.uint8),
                               t.reshape(-1).view(torch.uint8)), k


def test_tp_families_on_processes_that_share_the_card(cuda, tmp_path,
                                                      monkeypatch):
    """recurrentgemma-9b at full width and 3 layers (each process's RG-LRU
    block on 2,048 of the 4,096 channels, its scan on the card at that
    width), B 1, S 128, whisper-base at full width and 1 + 1 layers, B 2,
    S 64, and xlstm-350m at full width and 2 layers (each process with
    1,024 of the mLSTM's 2,048 inner columns and 2,048 of the sLSTM's
    4,096 gate columns), B 1, S 64, on a (1, 2) mesh of 2 processes that
    share the card (gloo, one spawn for the three), their compute split
    over the model axis (``chip_smoke.py``'s ``tp_train`` legs at a
    smaller size): a bf16 prefill and 4 decode steps on local heads,
    channels and columns within 0.05 (xlstm: 0.08) of one process's logits
    and the same greedy tokens; 2 f32 TP steps within
    tests/test_torch_mesh_train.py's f32 tolerances of the one-process card
    steps and again bit-equal; the scan launched by each process (a
    prefill once per RG-LRU layer, a step three times); no parameter bytes
    over the model axis; each smoke config's sharded state restored on one
    process bit-equal to every process's shards."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from helpers.torch_tp_family_workers import family_legs

    legs = {"recurrentgemma_9b": {"layers": 3, "B": 1, "S": 128, "P": 128},
            "whisper_base": {"layers": 1, "B": 2, "S": 64, "P": 16},
            "xlstm_350m": {"layers": 2, "B": 1, "S": 64, "P": 64}}
    m, steps = 2, 2
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    try:
        records, launches, failed = family_legs(
            (1, m), legs, steps, 0, 3e-3, 4, str(tmp_path),
            {a: 0.08 if a == "xlstm_350m" else 0.05 for a in legs},
            timeout=300)
    finally:
        torch.use_deterministic_algorithms(was)
    assert failed == [], failed
    assert launches["ckpt_pack"] > 0
    # per process: a prefill once per RG-LRU layer (2 of the 3), each step
    # three times a layer (forward, remat's recompute, reverse)
    n_lru = 2
    assert launches["rglru_scan"] == m * (n_lru + 3 * n_lru * steps)
    rg = records[0]
    assert rg["local_shapes"]["params/lru/w_a"] == [2, 2048, 4096]
    assert rg["cache_local_shapes"]["h"] == [2, 1, 2048]
    xl = records[2]
    assert xl["local_shapes"]["params/m/w_up"] == [1, 1024, 1024]
    assert xl["local_shapes"]["params/s/w"] == [1, 1024, 2048]
    assert xl["local_shapes"]["params/s/w_out"] == [1, 512, 1024]
    assert xl["cache_local_shapes"]["m_state"] == [1, 1, 4, 512, 512]

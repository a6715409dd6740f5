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
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

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


# ------------------------------------------------------------ train path
@pytest.mark.parametrize("B,S", [(1, 512), (2, 1000), (4, 2048)])
def test_flash_attention_vjp_grads_match_plain_path(cuda, B, S):
    """The autograd Function's dq, dk, dv (kernel forward, backward through
    the plain blocked path) against autograd through that plain path on
    the same upstream gradient, bf16, smollm's heads: the same computation,
    held to the kernel's bf16 tolerance (2e-2 + 2e-2 |plain|)."""
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

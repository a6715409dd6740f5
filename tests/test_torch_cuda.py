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


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,window,cap,qoff", [
    (2, 128, 128, 9, 3, 64, 0, 0.0, 0),
    (1, 33, 57, 2, 2, 64, 0, 0.0, 24),     # ragged, continuation
    (1, 200, 200, 4, 1, 128, 48, 0.0, 0),   # window, hd 128
    (2, 96, 96, 4, 2, 64, 0, 30.0, 0),      # softcap
])
def test_flash_attention_kernel_within_tolerance(cuda, B, Sq, Sk, Hq, Hkv, hd,
                                                 window, cap, qoff):
    """|kernel - plain| <= 2e-2 + 2e-2 |plain|: P is rounded to bf16 for
    the PV tensor-core product and the output to bf16."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))
    attn_ops.launches = 0
    got = attn_ops.flash_attention(q, k, v, window=window, softcap=cap,
                                   q_offset=qoff).float()
    torch.cuda.synchronize()
    assert attn_ops.launches == 1
    want = attention_ref(q, k, v, window=window, softcap=cap,
                         q_offset=qoff).float()
    assert bool(((got - want).abs() <= 2e-2 + 2e-2 * want.abs()).all())


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError):
        attn_ops.flash_attention(q, q, q)                       # f32
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError):
        attn_ops.flash_attention(qb[..., :32], qb[..., :32], qb[..., :32])

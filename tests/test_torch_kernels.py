"""The port's kernels (plain versions, as CPU tensors take them) and
attention layers against the JAX package's, on the same NumPy inputs.

The JAX Pallas kernels run with ``interpret=True`` as ``test_kernels.py``
runs them.  CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.hypothesis_shim import given, settings, strategies as st

from repro.kernels.ckpt_pack.ops import pack_chunks as jax_pack_chunks
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models import layers as jax_layers
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ckpt_pack import ops as pack_ops
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models import layers

# the cases of tests/test_kernels.py
ATTN_CASES = [
    # B, Sq, Sk, Hq, Hkv, hd, causal, window, softcap, q_offset, bq, bk
    (2, 128, 128, 4, 2, 64, True, 0, 0.0, 0, 64, 64),
    (1, 64, 64, 2, 1, 32, True, 16, 0.0, 0, 32, 32),
    (1, 96, 96, 4, 4, 64, True, 0, 50.0, 0, 32, 48),
    (2, 48, 144, 4, 2, 16, True, 0, 0.0, 96, 24, 48),     # decode-continuation
    (1, 80, 80, 8, 2, 128, False, 0, 0.0, 0, 40, 40),     # bidirectional
    (1, 33, 57, 2, 2, 8, True, 0, 0.0, 0, 16, 16),        # ragged edges
]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """One NumPy array as a JAX array and a torch tensor of ``dtype``, with
    the same values (bf16 rounding happens once, in NumPy f32 -> JAX)."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH_DTYPES[dtype])
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------- ckpt pack
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_ckpt_pack_plain_matches_jax(dtype):
    """Exact: a gather moves values, it does no arithmetic."""
    rng = np.random.default_rng(7)
    a = rng.normal(size=(12, 8, 16)) * 10
    src_j = jnp.asarray(a, dtype)
    src_t = params_from_jax({"src": np.asarray(src_j)}, device="cpu")["src"]
    idx = np.asarray([3, 0, 11, -1, 7, 7, 2], np.int32)
    want = np.asarray(jax_pack_chunks(src_j, jnp.asarray(idx), interpret=True))
    got = pack_ops.pack_chunks(src_t, idx)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@settings(max_examples=25, deadline=None)
@given(
    n=st.integers(1, 20),
    m=st.integers(1, 24),
    r=st.integers(1, 8),
    c=st.integers(1, 16),
    seed=st.integers(0, 2**31 - 1),
)
def test_ckpt_pack_plain_property(n, m, r, c, seed):
    """out[i] == src[idx[i]] for random chunk maps incl. unattached, exact
    against the JAX kernel; the ``out=`` form fills a given buffer."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(n, r, c)).astype(np.float32)
    idx = rng.integers(-1, n, size=(m,)).astype(np.int32)
    want = np.asarray(jax_pack_chunks(jnp.asarray(src), jnp.asarray(idx),
                                      interpret=True))
    got = pack_ops.pack_chunks(torch.from_numpy(src), idx)
    np.testing.assert_array_equal(got.numpy(), want)
    buf = torch.full((m, r, c), 7.0)
    out = pack_ops.pack_chunks(torch.from_numpy(src), torch.from_numpy(idx),
                               out=buf)
    assert out is buf
    np.testing.assert_array_equal(buf.numpy(), want)


def test_ckpt_pack_rejects_bad_input():
    src = torch.zeros(4, 2, 3)
    with pytest.raises(IndexError):
        pack_ops.pack_chunks(src, np.array([0, 4]))
    with pytest.raises(ValueError):
        pack_ops.pack_chunks(src, np.array([[0]]))
    with pytest.raises(ValueError):
        pack_ops.pack_chunks(src, np.array([0]), out=torch.zeros(2, 2, 3))
    with pytest.raises(ValueError):
        pack_ops.pack_chunks(torch.zeros(4, 6), np.array([0]))


def test_cpu_wrappers_never_launch():
    """CPU tensors take the plain versions: no kernel, no launch count."""
    pack_ops.launches = attn_ops.launches = 0
    pack_ops.pack_chunks(torch.zeros(3, 2, 2), np.array([1, -1]))
    q = torch.zeros(1, 8, 2, 64)
    attn_ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    assert pack_ops.launches == 0 and attn_ops.launches == 0


# ---------------------------------------------------------- flash attention
@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(case, dtype):
    """The kernel's plain version vs the Pallas kernel (interpret mode).
    Both compute in f32 and cast the output once: f32 agrees to 2e-5
    (summation order); bf16 to 2e-2, the repo's Pallas-vs-oracle bf16
    tolerance (an output may round to the neighbouring bf16 value)."""
    B, Sq, Sk, Hq, Hkv, hd, causal, window, cap, qoff, bq, bk = case
    rng = np.random.default_rng(11)
    qj, qt = _pair(rng.normal(size=(B, Sq, Hq, hd)), dtype)
    kj, kt = _pair(rng.normal(size=(B, Sk, Hkv, hd)), dtype)
    vj, vt = _pair(rng.normal(size=(B, Sk, Hkv, hd)), dtype)
    want = jax_flash(qj, kj, vj, causal=causal, window=window, softcap=cap,
                     block_q=bq, block_k=bk, q_offset=qoff, interpret=True)
    got = attn_ops.flash_attention(qt, kt, vt, causal=causal, window=window,
                                   softcap=cap, q_offset=qoff)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == qt.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_xla_port_matches_reference(case, dtype):
    """The blocked plain path (``attention_impl="xla_flash"``) vs the JAX
    ``flash_attention_xla`` with the same blocks: same skips, same f32
    accumulation, P cast to v's dtype before PV in both.  f32 to 2e-5;
    bf16 to 2e-2 (P and the output round to bf16 in both, but the f32
    sums before the rounding differ in order)."""
    B, Sq, Sk, Hq, Hkv, hd, causal, window, cap, qoff, bq, bk = case
    rng = np.random.default_rng(12)
    qj, qt = _pair(rng.normal(size=(B, Sq, Hq, hd)), dtype)
    kj, kt = _pair(rng.normal(size=(B, Sk, Hkv, hd)), dtype)
    vj, vt = _pair(rng.normal(size=(B, Sk, Hkv, hd)), dtype)
    want = jax_layers.flash_attention_xla(
        qj, kj, vj, causal=causal, window=window, softcap=cap, block_q=bq,
        block_k=bk, q_offset=qoff)
    got = layers.flash_attention_xla(
        qt, kt, vt, causal=causal, window=window, softcap=cap, block_q=bq,
        block_k=bk, q_offset=qoff)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("window,cap,qoff", [(0, 0.0, 0), (9, 0.0, 0),
                                             (0, 30.0, 0), (0, 0.0, 20)])
def test_naive_attention_matches_reference(window, cap, qoff):
    """f32, summation order only: 2e-5."""
    rng = np.random.default_rng(13)
    qj, qt = _pair(rng.normal(size=(2, 24, 4, 16)), "float32")
    kj, kt = _pair(rng.normal(size=(2, 24 + qoff, 2, 16)), "float32")
    vj, vt = _pair(rng.normal(size=(2, 24 + qoff, 2, 16)), "float32")
    want = jax_layers.naive_attention(qj, kj, vj, window=window, softcap=cap,
                                      q_offset=qoff)
    got = layers.naive_attention(qt, kt, vt, window=window, softcap=cap,
                                 q_offset=qoff)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches_reference(per_slot, window):
    """f32, summation order only: 2e-5; scalar and per-slot lengths."""
    rng = np.random.default_rng(14)
    B, Smax = 3, 20
    qj, qt = _pair(rng.normal(size=(B, 1, 4, 16)), "float32")
    kj, kt = _pair(rng.normal(size=(B, Smax, 2, 16)), "float32")
    vj, vt = _pair(rng.normal(size=(B, Smax, 2, 16)), "float32")
    lens = np.array([4, 11, 20], np.int32) if per_slot else np.int32(13)
    want = jax_layers.decode_attention(qj, kj, vj, jnp.asarray(lens),
                                       window=window)
    got = layers.decode_attention(qt, kt, vt, torch.from_numpy(np.asarray(lens)),
                                  window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_norm_and_rope_match_reference():
    """f32: rms_norm to 1e-6; RoPE to 2e-5 (sin/cos of angles up to ~60
    rad round differently in the two libraries)."""
    rng = np.random.default_rng(15)
    xj, xt = _pair(rng.normal(size=(2, 60, 3, 16)), "float32")
    wj, wt = _pair(rng.normal(size=(16,)) * 0.1, "float32")
    np.testing.assert_allclose(_np(layers.rms_norm(xt, wt)),
                               _np(jax_layers.rms_norm(xj, wj)),
                               rtol=1e-6, atol=1e-6)
    pos = np.broadcast_to(np.arange(60, dtype=np.int32), (2, 60))
    sj, cj = jax_layers.rope_angles(jnp.asarray(pos), 16, 10_000.0)
    stt, ct = layers.rope_angles(torch.from_numpy(pos.copy()), 16, 10_000.0)
    np.testing.assert_allclose(_np(stt), _np(sj), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(layers.apply_rope(xt, stt, ct)),
                               _np(jax_layers.apply_rope(xj, sj, cj)),
                               rtol=2e-5, atol=2e-5)

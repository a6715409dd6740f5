"""The plain versions behind the train path's two backward kernels, on the
CPU, against the JAX package: the attention backward (``attention_bwd_ref``
with the log-sum-exp of ``attention_lse_ref``) against ``jax.vjp`` of the
reference's ``flash_attention_xla``, and the scan's backward
(``lru_scan_bwd_ref``, a reversed loop) against autograd through the
plain scan; the CPU wrappers of both take these plain versions and launch
nothing.

Inputs are seeded NumPy handed to both packages, in f32.  Tolerances:
the attention's gradients, output and log-sum-exp within 1e-5 of each
array's scale (its largest magnitude): the same function in f32, summed
in another order; the scan's gradients within 1e-5 + 1e-5 |plain|
elementwise, the kernel's own f32 tolerance.  The CUDA kernels run on the
card only (``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jax_layers
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                      attention_lse_ref,
                                                      attention_ref)
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan.ref import (lru_scan_bwd_ref,
                                                 rglru_scan_ref)

ATTN_BWD_CASES = [
    # B, Sq, Sk, Hq, Hkv, hd, causal, window, softcap, q_offset
    (2, 37, 37, 3, 3, 16, True, 0, 0.0, 0),       # ragged S 37, G 1
    (1, 37, 37, 6, 2, 16, True, 8, 0.0, 0),       # window 8, G 3
    (1, 40, 40, 6, 2, 16, True, 0, 20.0, 0),      # softcap 20
    (1, 24, 40, 3, 1, 16, True, 0, 0.0, 16),      # q_offset 16, G 3
    (1, 37, 53, 6, 2, 16, True, 8, 20.0, 16),     # all of them at once
    (1, 33, 33, 4, 2, 16, False, 0, 0.0, 0),      # bidirectional
]
ATTN_TOL = 1e-5
SCAN_TOL = 1e-5


def _within_scale(got, want, what: str) -> None:
    """max |got - want| <= ATTN_TOL * max |want|."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= ATTN_TOL * scale, f"{what}: {err} > {ATTN_TOL} * {scale}"


def _attn_inputs(case, seed):
    B, Sq, Sk, Hq, Hkv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            [(B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd),
             (B, Sq, Hq, hd)]]


def _jax_lse(q, k, *, causal, window, softcap, q_offset):
    """The natural log-sum-exp of the reference's logits, as its
    ``flash_attention_xla`` forms them (scale, softcap, mask), [B, Hq, Sq]."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = jnp.asarray(q).reshape(B, Sq, Hkv, G, hd)
    s = jnp.einsum("bqhgd,bkhd->bhgqk", qg, jnp.asarray(k)) / math.sqrt(hd)
    if softcap > 0:
        s = softcap * jnp.tanh(s / softcap)
    qpos = q_offset + jnp.arange(Sq)[:, None]
    kpos = jnp.arange(Sk)[None, :]
    ok = jnp.ones((Sq, Sk), bool)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    s = jnp.where(ok, s, -jnp.inf)
    return jax.nn.logsumexp(s, axis=-1).reshape(B, Hq, Sq)


@pytest.mark.parametrize("case", ATTN_BWD_CASES)
def test_attention_bwd_ref_matches_jax_vjp(case):
    """dq, dk, dv of ``attention_bwd_ref`` (from ``attention_lse_ref``'s
    output and log-sum-exp) against ``jax.vjp`` of the reference's
    blocked ``flash_attention_xla`` (16 x 16 blocks, its skips included);
    the output against the reference's and the log-sum-exp against the
    reference's logits; each within 1e-5 of the array's scale."""
    causal, window, cap, qoff = case[6:]
    q, k, v, do = _attn_inputs(case, sum(case[:6]))
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff)
    out, vjp = jax.vjp(lambda a, b, c: jax_layers.flash_attention_xla(
        a, b, c, block_q=16, block_k=16, **kw), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o, lse = attention_lse_ref(qt, kt, vt, **kw)
    _within_scale(o.numpy(), out, "o")
    _within_scale(lse.numpy(), _jax_lse(q, k, **kw), "lse")
    got = attention_bwd_ref(qt, kt, vt, o, lse, dot, **kw)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == torch.float32 and x.shape == tuple(y.shape)
        _within_scale(x.numpy(), y, name)


@pytest.mark.parametrize("case", ATTN_BWD_CASES[:3])
def test_attention_bwd_ref_matches_autograd_of_attention_ref(case):
    """The explicit backward against autograd through ``attention_ref``
    itself (the same f32 function), within 1e-5 of each array's scale."""
    causal, window, cap, qoff = case[6:]
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff)
    q, k, v, do = map(torch.from_numpy, _attn_inputs(case, 7))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*ins, **kw), ins, do)
    o, lse = attention_lse_ref(q, k, v, **kw)
    for name, x, y in zip(("dq", "dk", "dv"),
                          attention_bwd_ref(q, k, v, o, lse, do, **kw), want):
        _within_scale(x.numpy(), y.numpy(), name)


def test_attention_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors ``flash_attention_fwd_lse`` returns the plain output
    and log2(e) times the natural log-sum-exp (the kernel's domain), and
    ``flash_attention_bwd`` the plain gradients from it: no launch of
    either kernel."""
    case = ATTN_BWD_CASES[4]
    kw = dict(zip(("causal", "window", "softcap", "q_offset"), case[6:]))
    q, k, v, do = map(torch.from_numpy, _attn_inputs(case, 3))
    attn_ops.launches = attn_ops.bwd_launches = 0
    o, lse2 = attn_ops.flash_attention_fwd_lse(q, k, v, **kw)
    o_ref, lse = attention_lse_ref(q, k, v, **kw)
    assert torch.equal(o, o_ref)
    torch.testing.assert_close(lse2, lse * attn_ops.LOG2E, rtol=0, atol=0)
    got = attn_ops.flash_attention_bwd(q, k, v, o, lse2, do, **kw)
    want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for x, y in zip(got, want):
        _within_scale(x.numpy(), y.numpy(), "wrapper")
    assert attn_ops.launches == 0 and attn_ops.bwd_launches == 0


def test_attention_bwd_refuses_a_row_with_no_key():
    """With a window, a query past Sk + window - 1 sees no key: the
    backward refuses it (its log-sum-exp is not defined)."""
    q = torch.zeros(1, 4, 2, 16)
    k = torch.zeros(1, 8, 2, 16)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError):
        attn_ops.flash_attention_bwd(q, k, k, q, lse, q, window=2,
                                     q_offset=7)
    with pytest.raises(ValueError):
        attn_ops.flash_attention_bwd(q, k, k, q, lse[..., :3], q)


def _scan_case(B, S, W, with_h0, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, size=(B, S, W)).astype(np.float32)
    b = rng.normal(size=(B, S, W)).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32) if with_h0 else None
    g = rng.normal(size=(B, S, W)).astype(np.float32)
    g_last = rng.normal(size=(B, W)).astype(np.float32)
    return [None if x is None else torch.from_numpy(x)
            for x in (a, b, h0, g, g_last)]


@pytest.mark.parametrize("S", [1, 37, 300])
@pytest.mark.parametrize("with_h0", [True, False])
def test_lru_scan_bwd_ref_matches_autograd_of_plain_scan(S, with_h0):
    """da, db (and dh0) of the reversed loop against autograd through the
    plain doubling scan, through both h and h_last, within 1e-5 + 1e-5
    |plain|; the CPU wrapper ``lru_scan_bwd`` gives the loop's bits and
    launches nothing."""
    a, b, h0, g, g_last = _scan_case(2, S, 24, with_h0, S)
    ins = [t.clone().requires_grad_(True) for t in (a, b, h0)
           if t is not None]
    h, h_last = rglru_scan_ref(ins[0], ins[1], ins[2] if with_h0 else None)
    # at S 1 without h0 the plain scan never reads a: its gradient is 0
    want = torch.autograd.grad((h, h_last), ins, (g, g_last),
                               allow_unused=True, materialize_grads=True)
    got = lru_scan_bwd_ref(a, h.detach(), h0, g, g_last)
    assert (got[2] is None) == (not with_h0)
    for x, y in zip([t for t in got if t is not None], want):
        assert bool(((x - y).abs() <= SCAN_TOL + SCAN_TOL * y.abs()).all())
    scan_ops.launches = 0
    wrapped = scan_ops.lru_scan_bwd(a, h.detach(), h0, g, g_last)
    for x, y in zip(wrapped, got):
        assert (x is None and y is None) or torch.equal(x, y)
    assert scan_ops.launches == 0


def test_lru_scan_bwd_ref_without_g_last():
    """g_last None is a zero gradient of h_last."""
    a, b, h0, g, _ = _scan_case(1, 9, 4, True, 1)
    h = rglru_scan_ref(a, b, h0)[0]
    got = lru_scan_bwd_ref(a, h, h0, g, None)
    want = lru_scan_bwd_ref(a, h, h0, g, torch.zeros_like(h0))
    for x, y in zip(got, want):
        assert torch.equal(x, y)

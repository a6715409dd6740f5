"""The training half of the port's RecurrentGemma family against the JAX
package: the ``rglru_scan`` gradient (``lru_scan_vjp``, whose backward is
the scan run backwards in time) against ``jax.vjp`` of the reference's
scan and of its ``_lru_scan`` layer, and against autograd through the
port's plain version; the loss and every gradient; three train steps;
the trainer's kill and resume; the train state crossing between the two
packages' checkpoints; the train launcher.

Inputs are seeded NumPy handed to both packages; the parameters are the
reference's ``api.init(key(0))`` brought over by ``params_from_jax``.
Tolerances: f32 1e-5 and bf16 2e-2, each relative to ``1 + max |want|``
of the array (``helpers/torch_recurrent.py``)."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import torch_recurrent as rec

from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_scan_ref
from repro.models import rglru as jax_rglru
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.launch import train as torch_train_launcher
from repro_torch.models import rglru

ARCH = "recurrentgemma_9b"


def _scan_inputs(B, S, W, with_h0, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, size=(B, S, W)).astype(np.float32)
    b = rng.normal(size=(B, S, W)).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32) if with_h0 else None
    g = rng.normal(size=(B, S, W)).astype(np.float32)
    g_last = rng.normal(size=(B, W)).astype(np.float32)
    return a, b, h0, g, g_last


def _torch_grads(fn, arrays, g, g_last):
    """Gradients of <h, g> + <h_last, g_last> in each of ``arrays``
    (the scan's or the layer's inputs, None passed through)."""
    ins = [None if x is None else torch.from_numpy(x).requires_grad_(True)
           for x in arrays]
    h, h_last = fn(*ins)
    live = [t for t in ins if t is not None]
    return torch.autograd.grad((h, h_last), live,
                               (torch.from_numpy(g), torch.from_numpy(g_last)))


def _jax_grads(fn, arrays, g, g_last):
    live = [jnp.asarray(x) for x in arrays if x is not None]

    def f(*xs):
        it = iter(xs)
        return fn(*[None if x is None else next(it) for x in arrays])

    _, vjp = jax.vjp(f, *live)
    return vjp((jnp.asarray(g), jnp.asarray(g_last)))


@pytest.mark.parametrize("S", [37, 300])
@pytest.mark.parametrize("with_h0", [True, False])
def test_scan_vjp_matches_jax_vjp_and_plain_autograd(S, with_h0):
    """da, db (and dh0) of ``lru_scan_vjp`` through both h and h_last:
    against ``jax.vjp`` of the reference's scan oracle within 1e-5 of each
    gradient's scale, and against autograd through the port's plain
    version (the out-of-place doubling scan) within the same; S 37 and 300
    are not multiples of the kernel's 64-step chunk."""
    a, b, h0, g, g_last = _scan_inputs(2, S, 24, with_h0, S)
    got = _torch_grads(scan_ops.lru_scan_vjp, (a, b, h0), g, g_last)
    want = _jax_grads(jax_scan_ref, (a, b, h0), g, g_last)
    plain = _torch_grads(rglru_scan_ref, (a, b, h0), g, g_last)
    assert len(got) == len(want) == len(plain) == (3 if with_h0 else 2)
    for name, x, y, z in zip(("da", "db", "dh0"), got, want, plain):
        assert x.dtype == torch.float32
        rec.close(x, y, 1e-5, f"{name} against jax.vjp")
        rec.close(x, z, 1e-5, f"{name} against the plain autograd")


@pytest.mark.parametrize("S", [37, 300])
@pytest.mark.parametrize("with_h0", [True, False])
def test_lru_scan_layer_grads_match_reference(S, with_h0):
    """The ``_lru_scan`` layer (f32 gates, then the scan's Function)
    against ``jax.vjp`` of the reference's ``_lru_scan`` (its 256-step
    chunked associative scan: S 300 crosses a chunk) through y and h_last:
    dx, d w_a, d w_i, d lam (and dh0) within 1e-5 of each one's scale."""
    B, W = 2, 16
    rng = np.random.default_rng(S + 1)
    x = rng.normal(size=(B, S, W)).astype(np.float32)
    w_a = (rng.normal(size=(W, W)) * 0.2).astype(np.float32)
    w_i = (rng.normal(size=(W, W)) * 0.2).astype(np.float32)
    lam = rng.normal(size=(W,)).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32) if with_h0 else None
    g = rng.normal(size=(B, S, W)).astype(np.float32)
    g_last = rng.normal(size=(B, W)).astype(np.float32)

    def layer(lib):
        def fn(x, w_a, w_i, lam, h0):
            return lib._lru_scan(x, {"w_a": w_a, "w_i": w_i, "lam": lam},
                                 h0)
        return fn

    arrays = (x, w_a, w_i, lam, h0)
    got = _torch_grads(layer(rglru), arrays, g, g_last)
    want = _jax_grads(layer(jax_rglru), arrays, g, g_last)
    assert len(got) == len(want) == (5 if with_h0 else 4)
    for name, a, b in zip(("dx", "dw_a", "dw_i", "dlam", "dh0"), got, want):
        rec.close(a, b, 1e-5, name)


def test_scan_vjp_backward_counts_no_launch_on_cpu():
    """On CPU tensors both passes take the plain version: no launch."""
    scan_ops.launches = 0
    a = torch.full((1, 4, 2), 0.5, requires_grad=True)
    b = torch.ones(1, 4, 2, requires_grad=True)
    h, h_last = scan_ops.lru_scan_vjp(a, b)
    (h.sum() + h_last.sum()).backward()
    # l_4 = 1 + 1 (h and h_last), l_t = 1 + 0.5 l_{t+1}: 2 at every step
    np.testing.assert_array_equal(b.grad[0, :, 0].numpy(), [2.0] * 4)
    np.testing.assert_array_equal(a.grad[0, 1:, 0].numpy(),
                                  2.0 * h[0, :-1, 0].detach().numpy())
    assert scan_ops.launches == 0


@pytest.mark.parametrize("dtype,remat,layers", [
    ("float32", False, 3),
    ("float32", True, 5),       # one (lru, lru, local) group and a tail
    ("bfloat16", True, 3),
])
def test_loss_and_grads_match_reference(dtype, remat, layers):
    """``api.loss`` and every gradient against ``jax.value_and_grad``:
    f32 within 1e-5, bf16 within 2e-2 of each array's scale."""
    rec.check_loss_and_grads(ARCH, dtype, remat=remat, num_layers=layers)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_reference(dtype):
    rec.check_train_steps(ARCH, dtype)


def test_trainer_kill_and_resume_is_bit_exact(tmp_path):
    rec.check_kill_and_resume(ARCH, tmp_path)


def test_train_state_crosses_between_the_packages(tmp_path):
    rec.check_train_state_cross_loads(ARCH, tmp_path)


def test_remat_recompute_runs_under_the_forward_context():
    rec.check_remat_span_context(ARCH, rglru, "_mlp")


def test_train_launcher_cpu(tmp_path, capsys):
    """The launcher's JSON lines (a line every 10 steps, then the
    summary) on the CPU."""
    torch_train_launcher.main(["--arch", ARCH, "--smoke", "--steps", "10",
                               "--batch", "2", "--seq", "16", "--ckpt-dir",
                               str(tmp_path), "--ckpt-every", "5",
                               "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["step"] for ln in lines[:-1]] == [10]
    assert lines[-1]["saved_steps"] == [5, 10]
    assert np.isfinite(lines[-1]["final_loss"])

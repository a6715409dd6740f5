"""The port's xLSTM family (xlstm-350m) against the JAX package: the
config copy, parameter specs, the chunkwise mLSTM and the sequential
sLSTM, the loss and every gradient, prefill and decode, decode after a
prefill against a longer prefill, the O(1) serving state restarted
N-to-M, three train steps, the trainer's kill and resume, the train state
crossing between the packages' checkpoints, and both launchers.

Inputs are seeded NumPy handed to both packages; the parameters are the
reference's ``api.init(key(0))`` brought over by ``params_from_jax``.
Tolerances: f32 1e-5 and bf16 2e-2, each relative to ``1 + max |want|``
of the array (``helpers/torch_recurrent.py``)."""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import torch_recurrent as rec
from helpers.ast_copy import normalised

from repro.configs import get_config, get_smoke_config
from repro.configs import xlstm_350m as ref_config_module
from repro.configs.base import ShapeConfig
from repro.models import xlstm as jax_xlstm
from repro.models.api import build_model, make_token_batch
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.configs import xlstm_350m as config_module
from repro_torch.convert import params_from_jax
from repro_torch.core.comm import Comm
from repro_torch.core.store import DatasetStore
from repro_torch.core.tensor_ckpt import TensorCheckpoint, balanced_chunk_partition
from repro_torch.core.torch_io import layout_from_torch, load_torch, save_torch
from repro_torch.launch import serve as torch_serve
from repro_torch.launch import train as torch_train_launcher
from repro_torch.models import xlstm
from repro_torch.models.api import build_model as torch_build_model

ARCH = "xlstm_350m"


# ------------------------------------------------------- configs and specs
def test_config_module_is_a_copy():
    """The module's tree is the reference's (docstrings and the package
    prefix aside), the arch is ported, and both configs are equal."""
    assert normalised(config_module) == normalised(ref_config_module)
    assert ARCH in ARCHS
    assert dataclasses.asdict(torch_get_config("xlstm-350m")) == \
        dataclasses.asdict(get_config(ARCH))
    assert dataclasses.asdict(torch_smoke_config(ARCH)) == \
        dataclasses.asdict(get_smoke_config(ARCH))


def test_param_and_cache_specs_match_reference():
    """Every name, shape, logical axis, dtype and init of the full-size
    and smoke models, the full model's parameter count, and the serving
    state's shapes and dtypes."""
    for cfg, tcfg in [(get_config(ARCH), torch_get_config(ARCH)),
                      (get_smoke_config(ARCH), torch_smoke_config(ARCH))]:
        api, tapi = build_model(cfg), torch_build_model(tcfg)
        assert sorted(tapi.param_specs) == sorted(api.param_specs)
        for name, spec in api.param_specs.items():
            assert dataclasses.asdict(tapi.param_specs[name]) == \
                dataclasses.asdict(spec), name
        want = api.cache_specs(4, 544)
        got = tapi.cache_specs(4, 544)
        assert sorted(got) == sorted(want)
        for key, spec in got.items():
            assert spec.shape == want[key].shape, key
            assert spec.dtype == str(want[key].dtype), key
    n = sum(int(np.prod(s.shape)) for s in
            torch_build_model(torch_get_config(ARCH)).param_specs.values())
    assert n == 353_772_544


def test_params_from_jax_carries_the_params():
    _, params, _, tparams = rec.apis(ARCH)
    assert sorted(tparams) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(rec.bits(tparams[k]), rec.bits(v),
                                      err_msg=k)


# ------------------------------------------------------------------ mLSTM
def _mlstm_inputs(S, seed):
    B, H, hd = 2, 2, 16
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    log_f = -np.logaddexp(0, -rng.normal(1.0, 1.0, size=(B, S, H))
                          ).astype(np.float32)
    log_i = -np.logaddexp(0, -rng.normal(size=(B, S, H))).astype(np.float32)
    state = (rng.normal(size=(B, H, hd, hd)) * 0.3).astype(np.float32)
    norm = np.abs(rng.normal(size=(B, H, hd))).astype(np.float32)
    outs = (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, H, hd, hd)).astype(np.float32),
            rng.normal(size=(B, H, hd)).astype(np.float32))
    return (q, k, v, log_f, log_i, state, norm), outs


@pytest.mark.parametrize("S", [1, 128, 200])
def test_mlstm_chunk_matches_reference(S):
    """y, the carried matrix state and normaliser, from a nonzero incoming
    state and norm, in chunks of 128 (S 200 pads the last chunk with
    log_i = -30), and every gradient through all three (``jax.vjp`` of
    the reference on the same cotangents), within 1e-5 of each array's
    scale in f32."""
    ins, cot = _mlstm_inputs(S, S)
    tins = [torch.from_numpy(x).requires_grad_(True) for x in ins]
    got = xlstm._mlstm_chunk(*tins, chunk=128)
    want, vjp = jax.vjp(lambda *xs: jax_xlstm._mlstm_chunk(*xs, chunk=128),
                        *(jnp.asarray(x) for x in ins))
    for name, a, b in zip(("y", "state", "norm"), got, want):
        assert a.dtype == torch.float32
        rec.close(a, b, 1e-5, name)
    tgrads = torch.autograd.grad(got, tins,
                                 [torch.from_numpy(c) for c in cot])
    jgrads = vjp(tuple(jnp.asarray(c) for c in cot))
    for name, a, b in zip(("q", "k", "v", "log_f", "log_i", "state",
                           "norm"), tgrads, jgrads):
        assert np.isfinite(rec.np_(a)).all(), name
        rec.close(a, b, 1e-5, f"d{name}")


# ------------------------------------------------------------------ sLSTM
@pytest.mark.parametrize("given_state", [False, True])
def test_slstm_block_matches_reference(given_state):
    """The block's output and its carried (c, n, h, m), from the default
    state and from a given one, and the gradients in x and the block's
    parameters, in f32 within 1e-5 of each array's scale."""
    B, S, D, H = 2, 9, 32, 2
    rng = np.random.default_rng(int(given_state))
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    lp = {"ln": (rng.normal(size=(D,)) * 0.1).astype(np.float32),
          "w": (rng.normal(size=(D, 4 * D)) * 0.2).astype(np.float32),
          "r": (rng.normal(size=(H, D // H, 4 * D // H)) * 0.2
                ).astype(np.float32),
          "b": (rng.normal(size=(4 * D,)) * 0.1).astype(np.float32),
          "w_out": (rng.normal(size=(D, D)) * 0.2).astype(np.float32)}
    state = None
    if given_state:
        state = (rng.normal(size=(B, D)).astype(np.float32),
                 np.abs(rng.normal(size=(B, D))).astype(np.float32) + 1.0,
                 rng.normal(size=(B, D)).astype(np.float32),
                 rng.normal(size=(B, D)).astype(np.float32))
    cot = rng.normal(size=(B, S, D)).astype(np.float32)
    names = sorted(lp)

    def run(lib, to, x_, *ws):
        return lib._slstm_block(x_, dict(zip(names, ws)), state=None
                                if state is None else tuple(map(to, state)))

    tx = torch.from_numpy(x).requires_grad_(True)
    tws = [torch.from_numpy(lp[n]).requires_grad_(True) for n in names]
    y, carry = run(xlstm, torch.from_numpy, tx, *tws)
    (want_y, want_carry), vjp = jax.vjp(
        lambda *a: run(jax_xlstm, jnp.asarray, *a), jnp.asarray(x),
        *(jnp.asarray(lp[n]) for n in names))
    rec.close(y, want_y, 1e-5, "y")
    for name, a, b in zip("cnhm", carry, want_carry):
        assert a.dtype == torch.float32
        rec.close(a, b, 1e-5, name)
    got = torch.autograd.grad(y, [tx] + tws, torch.from_numpy(cot))
    want = vjp((jnp.asarray(cot), tuple(jnp.zeros_like(c)
                                        for c in want_carry)))
    for name, a, b in zip(["x"] + names, got, want):
        rec.close(a, b, 1e-5, f"d{name}")


# ----------------------------------------------------- model loss + grads
@pytest.mark.parametrize("dtype,remat,S", [
    ("float32", False, 20),
    ("float32", True, 200),      # two mLSTM chunks, the last padded
    ("bfloat16", True, 200),
])
def test_loss_and_grads_match_reference(dtype, remat, S):
    """``api.loss`` and every gradient against ``jax.value_and_grad``:
    f32 within 1e-5, bf16 within 2e-2 of each array's scale."""
    rec.check_loss_and_grads(ARCH, dtype, S=S, remat=remat)


# ----------------------------------------------------------------- serving
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill logits and the whole state, then four decode steps (logits
    and state) against ``api.prefill`` / ``api.decode_step``."""
    api, params, tapi, tparams = rec.apis(ARCH, dtype=dtype)
    tol = rec.TOL[dtype]
    batch = make_token_batch(api.cfg, ShapeConfig("p", 12, 2, "prefill"),
                             seed=1)
    logits, cache = jax.jit(api.prefill)(params, batch)
    tlogits, tcache = tapi.prefill(
        tparams, {"tokens": torch.from_numpy(batch["tokens"])})

    def same(where):
        rec.close(tlogits, logits, tol, f"{where}: logits")
        assert sorted(tcache) == sorted(cache)
        for key in cache:
            assert str(tcache[key].dtype) == f"torch.{cache[key].dtype}", key
            rec.close(tcache[key], cache[key], tol, f"{where}: {key}")

    same("prefill")
    step = jax.jit(api.decode_step)
    for i in range(4):
        tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
        pos = np.full((2,), 12 + i, np.int32)
        logits, cache = step(params, cache, {"token": tok, "pos": pos})
        tlogits, tcache = tapi.decode_step(
            tparams, tcache, {"token": torch.from_numpy(tok),
                              "pos": torch.from_numpy(pos)})
        same(f"decode step {i}")
    assert int(tcache["length"]) == 16 and tcache["length"].dim() == 0


def test_bf16_distance_from_f32_stays_within_twice_the_reference():
    """Each package's bf16 prefill logits against its own f32 prefill for
    the same weights (the reference's bf16 ``key(0)`` parameters, cast),
    smoke config, B 2, S 128.  The f32 runs agree within 1e-5 of the
    logits' scale.  The port's bf16 distance is larger than the
    reference's (1.27x here, 0.0463 against 0.0402 at full size, B 1, S
    128, ``tools/xlstm_bf16_distance.py``).  That 1.27x is XLA's excess
    precision (``--xla_allow_excess_precision``, on by default): XLA drops
    bf16 round trips inside its fusions, where the port rounds at every
    op the reference's program names.  With the flag off the two
    packages' bf16 logits agree (the test below); this pins the gap
    under the default flag below 2x."""
    cfg = get_smoke_config(ARCH)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 128),
                                               dtype=np.int32)
    host = {k: np.asarray(v)
            for k, v in build_model(cfg).init(jax.random.key(0)).items()}
    out = {}
    for dt in ("bfloat16", "float32"):
        api = build_model(dataclasses.replace(cfg, dtype=dt))
        tapi = torch_build_model(dataclasses.replace(
            torch_smoke_config(ARCH), dtype=dt))
        jp = {k: jnp.asarray(v, dt) for k, v in host.items()}
        tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                 device="cpu")
        ref, _ = jax.jit(api.prefill)(jp, {"tokens": tokens})
        with torch.no_grad():
            got, _ = tapi.prefill(tp, {"tokens": torch.from_numpy(tokens)})
        out[dt] = (rec.np_(ref), rec.np_(got))
    (r16, t16), (r32, t32) = out["bfloat16"], out["float32"]
    scale = float(np.abs(r32).max())
    assert float(np.abs(t32 - r32).max()) <= 1e-5 * scale
    ref_dist = float(np.abs(r16 - r32).max()) / scale
    port_dist = float(np.abs(t16 - t32).max()) / scale
    assert 0 < ref_dist and port_dist <= 2 * ref_dist, (port_dist, ref_dist)


# The reference's smoke prefill in bf16 and f32 under the flags the test
# passes; writes the tokens, the f32 parameters and both logits to argv[1]
_REF_PREFILL = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.models.api import build_model

cfg = get_smoke_config("xlstm_350m")
tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 128),
                                           dtype=np.int32)
host = {k: np.asarray(jnp.asarray(v, jnp.float32))
        for k, v in build_model(cfg).init(jax.random.key(0)).items()}
logits = {}
for dt in ("bfloat16", "float32"):
    api = build_model(dataclasses.replace(cfg, dtype=dt))
    out, _ = jax.jit(api.prefill)({k: jnp.asarray(v, dt)
                                   for k, v in host.items()},
                                  {"tokens": tokens})
    logits[dt] = np.asarray(jnp.asarray(out, jnp.float32))
np.savez(sys.argv[1], tokens=tokens, r16=logits["bfloat16"],
         r32=logits["float32"], **{"param/" + k: v for k, v in host.items()})
print("OK")
"""


def test_bf16_prefill_matches_the_reference_without_excess_precision(
        tmp_path):
    """The gap above is the reference's, not the port's: with XLA's
    excess precision off (``XLA_FLAGS=--xla_allow_excess_precision=false``,
    read once when the backend starts, so the reference runs in a fresh
    process), the reference rounds bf16 where its program says, and the
    port's bf16 prefill logits (smoke config, B 2, S 128, the same
    parameters) match it within 1e-6 of the f32 logits' scale (reading:
    8.0e-8; 9.4e-4 under the default flag)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    out = tmp_path / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(repo / "src"),
               XLA_FLAGS="--xla_allow_excess_precision=false")
    res = subprocess.run([sys.executable, "-c", _REF_PREFILL, str(out)],
                         env=env, cwd=repo, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), \
        res.stderr[-4000:]
    with np.load(out) as z:
        tokens, r16, r32 = z["tokens"], z["r16"], z["r32"]
        host = {k[len("param/"):]: z[k] for k in z.files
                if k.startswith("param/")}
    tapi = torch_build_model(dataclasses.replace(torch_smoke_config(ARCH),
                                                 dtype="bfloat16"))
    tp = params_from_jax({k: np.asarray(jnp.asarray(v, "bfloat16"))
                          for k, v in host.items()}, device="cpu")
    with torch.no_grad():
        t16, _ = tapi.prefill(tp, {"tokens": torch.from_numpy(tokens)})
    scale = float(np.abs(r32).max())
    gap = float(np.abs(rec.np_(t16) - r16).max()) / scale
    assert gap <= 1e-6, gap


@pytest.mark.parametrize("P", [7, 130])
def test_decode_after_prefill_matches_a_longer_prefill(P):
    """Decoding token P after a prefill of P (one chunk-1 mLSTM step, one
    sLSTM step) against one prefill of P + 1 tokens (chunked: P 130 spans
    two chunks), in f32: within 1e-5 of the logits' scale in the port, and
    the difference is the reference's within 1e-5."""
    api, params, tapi, tparams = rec.apis(ARCH, dtype="float32")
    tokens = np.random.default_rng(P).integers(
        0, api.cfg.vocab, size=(2, P + 1)).astype(np.int32)
    step = {"token": tokens[:, P:], "pos": np.full((2,), P, np.int32)}
    _, cache = api.prefill(params, {"tokens": tokens[:, :P]})
    want = np.asarray(api.decode_step(params, cache, step)[0]) - \
        np.asarray(api.prefill(params, {"tokens": tokens})[0])
    _, tcache = tapi.prefill(tparams, {"tokens": torch.from_numpy(
        tokens[:, :P])})
    longer, _ = tapi.prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    dec, _ = tapi.decode_step(tparams, tcache,
                              {k: torch.from_numpy(v) for k, v in
                               step.items()})
    rec.close(dec, longer, 1e-5, "decode against prefill")
    rec.close(rec.np_(dec) - rec.np_(longer), want, 1e-5,
              "difference against the reference's")


def test_serving_state_saves_as_4_ranks_and_restores_on_1(tmp_path):
    """The state after a prefill (12 f32 arrays per pair and a 0-d
    length) saved as 4 ranks and restored on one: bit-exact, verified, and
    the decode steps continued from it give the served tokens."""
    tapi = torch_build_model(torch_smoke_config(ARCH))
    tparams = tapi.init(torch.Generator().manual_seed(0))
    B, P, G = 3, 10, 6
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, tapi.cfg.vocab, size=(B, P)).astype(np.int32))
    saved = {}
    out, _ = torch_serve.serve_batch(
        tapi, tparams, {"tokens": tokens}, G, torch.device("cpu"),
        on_prefill=lambda logits, cache: saved.update(
            logits=logits.clone(),
            cache={k: v.clone() for k, v in cache.items()}))
    cache = saved["cache"]
    assert cache["length"].dim() == 0 and int(cache["length"]) == P
    ck = TensorCheckpoint(DatasetStore(str(tmp_path), "w"))
    layout = layout_from_torch(cache)
    ck.save_layout(layout)
    ownership = balanced_chunk_partition(layout, 4)
    assert all(ownership)
    save_torch(ck, cache, step=0, ownership=ownership)
    ck_r = TensorCheckpoint(DatasetStore(str(tmp_path), "r"))
    restored = load_torch(ck_r, tapi.abstract_cache(B, P + G), step=0,
                          device="cpu")
    assert ck_r.verify_step(Comm(1), 0)
    for key, t in cache.items():
        assert restored[key].dtype == t.dtype, key
        np.testing.assert_array_equal(rec.bits(restored[key]), rec.bits(t),
                                      err_msg=key)
    first = torch.argmax(saved["logits"], -1).to(torch.int32)[:, None]
    with torch.inference_mode():
        toks = torch_serve.decode_steps(tapi, tparams, restored, first, P, G,
                                        torch.device("cpu"))
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(), out)


# ------------------------------------------------------------------- train
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_reference(dtype):
    rec.check_train_steps(ARCH, dtype)


def test_trainer_kill_and_resume_is_bit_exact(tmp_path):
    rec.check_kill_and_resume(ARCH, tmp_path)


def test_train_state_crosses_between_the_packages(tmp_path):
    rec.check_train_state_cross_loads(ARCH, tmp_path)


def test_remat_recompute_runs_under_the_forward_context():
    rec.check_remat_span_context(ARCH, xlstm, "_slstm_block")


# ------------------------------------------------------------- launchers
def test_serve_launcher_cpu(capsys):
    torch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12", "--gen-len", "3"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["arch"] == "xlstm-350m-smoke" and line["device"] == "cpu"
    assert line["gen_len"] == 3 and len(line["sample_tokens"]) == 4


def test_train_launcher_cpu(tmp_path, capsys):
    """The launcher's JSON lines (a line every 10 steps, then the
    summary) on the CPU."""
    torch_train_launcher.main(["--arch", "xlstm-350m", "--smoke", "--steps",
                               "10", "--batch", "2", "--seq", "16",
                               "--ckpt-dir", str(tmp_path), "--ckpt-every",
                               "5", "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["step"] for ln in lines[:-1]] == [10]
    assert lines[-1]["saved_steps"] == [5, 10]
    assert np.isfinite(lines[-1]["final_loss"])

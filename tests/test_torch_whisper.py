"""The port's encoder-decoder family (whisper-base) against the JAX
package: the config copy, parameter and cache specs, the encoder, the loss
and every gradient, prefill with tokens and BOS-primed, decode steps,
decode after a prefill against a longer prefill, the serving cache
restarted N-to-M, three train steps, the trainer's kill and resume, the
train state crossing between the packages' checkpoints, and both
launchers.

Inputs are seeded NumPy handed to both packages (``enc_frames`` drawn as
``make_token_batch`` draws them); the parameters are the reference's
``api.init(key(0))`` brought over by ``params_from_jax``.  Tolerances: f32
1e-5 and bf16 2e-2, each relative to ``1 + max |want|`` of the array
(``helpers/torch_recurrent.py``).  The reference's blocked attention pads
a ragged last block and masks it, the port's slices it: the cases with
blocks of 8 over 20 frames hold the two within the same tolerances."""

from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from helpers import torch_recurrent as rec
from helpers.ast_copy import normalised

from repro.configs import get_config, get_smoke_config
from repro.configs import whisper_base as ref_config_module
from repro.configs.base import ShapeConfig
from repro.models import whisper as jax_whisper
from repro.models.api import build_model, make_token_batch
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.configs import whisper_base as config_module
from repro_torch.core.comm import Comm
from repro_torch.core.store import DatasetStore
from repro_torch.core.tensor_ckpt import TensorCheckpoint, balanced_chunk_partition
from repro_torch.core.torch_io import layout_from_torch, load_torch, save_torch
from repro_torch.launch import serve as torch_serve
from repro_torch.launch import train as torch_train_launcher
from repro_torch.models import whisper
from repro_torch.models.api import build_model as torch_build_model

ARCH = "whisper_base"
# blocks of 8 over 20 frames and 12 tokens: every attention of the family
# ends in a ragged block (the reference pads it, the port slices it)
RAGGED = dict(encoder_seq=20, attn_block_q=8, attn_block_k=8)


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------- configs and specs
def test_config_module_is_a_copy():
    """The module's tree is the reference's (docstrings and the package
    prefix aside), the arch is ported, and both configs are equal."""
    assert normalised(config_module) == normalised(ref_config_module)
    assert ARCH in ARCHS
    for name in (ARCH, "whisper-base"):
        assert dataclasses.asdict(torch_get_config(name)) == \
            dataclasses.asdict(get_config(name))
    assert dataclasses.asdict(torch_smoke_config(ARCH)) == \
        dataclasses.asdict(get_smoke_config(ARCH))


def test_param_and_cache_specs_match_reference():
    """Every name, shape, logical axis, dtype and init of the full and
    smoke models, the serving cache's shapes and dtypes (the cross K/V at
    the encoder's Se, unpadded), and the full model's parameter count: the
    reference's, inside its band (0.05-0.11 G,
    ``tests/test_arch_smoke.py::PARAM_BANDS``)."""
    for cfg, tcfg in [(get_config(ARCH), torch_get_config(ARCH)),
                      (get_smoke_config(ARCH), torch_smoke_config(ARCH))]:
        api, tapi = build_model(cfg), torch_build_model(tcfg)
        assert sorted(tapi.param_specs) == sorted(api.param_specs)
        for name, spec in api.param_specs.items():
            assert dataclasses.asdict(tapi.param_specs[name]) == \
                dataclasses.asdict(spec), name
        want, got = api.cache_specs(4, 40), tapi.cache_specs(4, 40)
        assert sorted(got) == sorted(want)
        for key, spec in got.items():
            assert spec.shape == want[key].shape, key
            assert spec.dtype == str(want[key].dtype), key
        assert got["xk"].shape[2] == cfg.encoder_seq
    n = sum(int(np.prod(s.shape)) for s in
            torch_build_model(torch_get_config(ARCH)).param_specs.values())
    assert n == sum(int(np.prod(s.shape)) for s in
                    build_model(get_config(ARCH)).param_specs.values())
    assert n == 83_194_368 and 0.05e9 <= n <= 0.11e9


def test_params_from_jax_carries_the_params():
    _, params, _, tparams = rec.apis(ARCH)
    assert sorted(tparams) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(rec.bits(tparams[k]), rec.bits(v),
                                      err_msg=k)


# ----------------------------------------------------------------- encoder
@pytest.mark.parametrize("dtype,kw", [
    ("float32", {}), ("bfloat16", {}), ("float32", RAGGED),
    ("bfloat16", RAGGED)], ids=["f32", "bf16", "f32-ragged", "bf16-ragged"])
def test_encode_matches_reference(dtype, kw):
    """The encoder states of seeded frames (bidirectional attention, RoPE
    at 0..Se-1, the frames cast to the model's dtype)."""
    api, params, tapi, tparams = rec.apis(ARCH, dtype=dtype, **kw)
    frames = rec.with_frames(api.cfg, {"tokens": np.zeros((2, 1))},
                             seed=3)["enc_frames"]
    want = jax.jit(lambda p, f: jax_whisper.encode(p, api.cfg, f))(
        params, frames)
    got = whisper.encode(tparams, tapi.cfg, torch.from_numpy(frames))
    assert got.dtype == getattr(torch, dtype)
    rec.close(got, want, rec.TOL[dtype], "encoder states")


# ----------------------------------------------------- model loss + grads
@pytest.mark.parametrize("dtype,remat,kw", [
    ("float32", False, {}),
    ("float32", True, RAGGED),
    ("bfloat16", True, {}),
], ids=["f32", "f32-remat-ragged", "bf16-remat"])
def test_loss_and_grads_match_reference(dtype, remat, kw):
    """``api.loss`` (the decoder's xent through a bf16 copy of the tied
    table, chunks of 8 over S 20, the last padded) and every gradient
    against ``jax.value_and_grad``; the table's own gradient, rounded to
    bf16 in both packages, within one bf16 ulp more (f32 reads 1.2e-4 of
    a 1.24 scale with the ragged blocks: an element a last bit apart
    before the rounding)."""
    rec.check_loss_and_grads(ARCH, dtype, S=20, remat=remat,
                             loose=("embed",), **kw)


# ----------------------------------------------------------------- serving
def _ref_prefill(api, params, batch, Smax):
    return jax.jit(lambda p, b: api.prefill(p, b, Smax))(params, batch)


def _same_state(tlogits, tcache, logits, cache, tol, where):
    rec.close(tlogits, logits, tol, f"{where}: logits")
    assert sorted(tcache) == sorted(cache)
    for key in cache:
        assert str(tcache[key].dtype) == f"torch.{cache[key].dtype}", key
        rec.close(tcache[key], cache[key], tol, f"{where}: {key}")


@pytest.mark.parametrize("dtype,kw", [("float32", {}), ("bfloat16", {}),
                                      ("float32", RAGGED)],
                         ids=["f32", "bf16", "f32-ragged"])
def test_prefill_and_decode_match_reference(dtype, kw):
    """Prefill logits and the whole cache (k, v padded to P + 4, the cross
    K/V, length), then four decode steps (logits and cache; the cross K/V
    are not written) against ``api.prefill`` / ``api.decode_step``."""
    api, params, tapi, tparams = rec.apis(ARCH, dtype=dtype, **kw)
    tol = rec.TOL[dtype]
    B, P, G = 2, 12, 4
    batch = make_token_batch(api.cfg, ShapeConfig("p", P, B, "prefill"),
                             seed=1)
    assert sorted(batch) == ["enc_frames", "tokens"]
    logits, cache = _ref_prefill(api, params, batch, P + G)
    tlogits, tcache = tapi.prefill(tparams, _t(batch), P + G)
    _same_state(tlogits, tcache, logits, cache, tol, "prefill")
    assert tcache["length"].dim() == 0 and int(tcache["length"]) == P
    xk = tcache["xk"].clone()
    step = jax.jit(api.decode_step)
    for i in range(G):
        tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
        pos = np.full((B,), P + i, np.int32)
        logits, cache = step(params, cache, {"token": tok, "pos": pos})
        tlogits, tcache = tapi.decode_step(
            tparams, tcache, {"token": torch.from_numpy(tok),
                              "pos": torch.from_numpy(pos)})
        _same_state(tlogits, tcache, logits, cache, tol, f"decode step {i}")
    assert int(tcache["length"]) == P + G
    assert torch.equal(tcache["xk"], xk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bos_primed_prefill_matches_reference(dtype):
    """A batch with frames and no tokens primes the decoder with a zero
    BOS column [B, 1]: logits and a cache of length 1."""
    api, params, tapi, tparams = rec.apis(ARCH, dtype=dtype)
    frames = {"enc_frames": rec.with_frames(
        api.cfg, {"tokens": np.zeros((3, 1))}, seed=5)["enc_frames"]}
    logits, cache = _ref_prefill(api, params, frames, 6)
    tlogits, tcache = tapi.prefill(tparams, _t(frames), 6)
    _same_state(tlogits, tcache, logits, cache, rec.TOL[dtype], "BOS")
    assert int(tcache["length"]) == 1 and tcache["k"].shape[2] == 6


@pytest.mark.parametrize("P", [7, 12])
def test_decode_after_prefill_matches_a_longer_prefill(P):
    """Decoding token P after a prefill of P against one prefill of P + 1
    tokens over the same frames, in f32: within 1e-5 of the logits' scale
    in the port, and the difference is the reference's within 1e-5."""
    api, params, tapi, tparams = rec.apis(ARCH, dtype="float32")
    rng = np.random.default_rng(P)
    tokens = rng.integers(0, api.cfg.vocab, size=(2, P + 1)).astype(np.int32)
    frames = rec.with_frames(api.cfg, {"tokens": tokens},
                             seed=P)["enc_frames"]
    short = {"tokens": tokens[:, :P], "enc_frames": frames}
    longer = {"tokens": tokens, "enc_frames": frames}
    step = {"token": tokens[:, P:], "pos": np.full((2,), P, np.int32)}
    _, cache = _ref_prefill(api, params, short, P + 1)
    want = np.asarray(jax.jit(api.decode_step)(params, cache, step)[0]) - \
        np.asarray(jax.jit(api.prefill)(params, longer)[0])
    _, tcache = tapi.prefill(tparams, _t(short), P + 1)
    tlonger, _ = tapi.prefill(tparams, _t(longer))
    dec, _ = tapi.decode_step(tparams, tcache, _t(step))
    rec.close(dec, tlonger, 1e-5, "decode against prefill")
    rec.close(rec.np_(dec) - rec.np_(tlonger), want, 1e-5,
              "difference against the reference's")


def test_serving_cache_saves_as_4_ranks_and_restores_on_1(tmp_path):
    """The cache after a prefill (k, v, the cross K/V xk, xv and a 0-d
    length) saved as 4 ranks and restored on one: bit-exact, verified, and
    the decode steps continued from it give the served tokens."""
    tapi = torch_build_model(torch_smoke_config(ARCH))
    tparams = tapi.init(torch.Generator().manual_seed(0))
    B, P, G = 3, 10, 6
    batch = torch_serve.prompt_batch(tapi.cfg, B, P, torch.device("cpu"),
                                     seed=4)
    saved = {}
    out, _ = torch_serve.serve_batch(
        tapi, tparams, batch, G, torch.device("cpu"),
        on_prefill=lambda logits, cache: saved.update(
            logits=logits.clone(),
            cache={k: v.clone() for k, v in cache.items()}))
    cache = saved["cache"]
    assert sorted(cache) == ["k", "length", "v", "xk", "xv"]
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
    """Three AdamW steps on seeded frames, as ``rec.check_train_steps``
    (the tied table's first moment, whose gradient comes through a bf16
    copy of the table, reads 2.4e-6 of 1 + its largest value in f32)."""
    rec.check_train_steps(ARCH, dtype)


def test_trainer_kill_and_resume_is_bit_exact(tmp_path):
    rec.check_kill_and_resume(ARCH, tmp_path)


def test_train_state_crosses_between_the_packages(tmp_path):
    rec.check_train_state_cross_loads(ARCH, tmp_path)


# ------------------------------------------------------------- launchers
def test_serve_launcher_cpu(capsys):
    """The serving launcher on whisper's smoke config: the prompt batch
    carries ``tokens`` and ``enc_frames``, (B, P) read from the tokens."""
    torch_serve.main(["--arch", "whisper-base", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12", "--gen-len", "3"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["arch"] == "whisper-base-smoke" and line["device"] == "cpu"
    assert line["batch"] == 2 and line["prompt_len"] == 12
    assert line["gen_len"] == 3 and len(line["sample_tokens"]) == 4


def test_train_launcher_cpu(tmp_path, capsys):
    """The train launcher on whisper's smoke config (the trainer feeds
    zero frames, as the reference's does)."""
    torch_train_launcher.main(["--arch", "whisper-base", "--smoke", "--steps",
                               "10", "--batch", "2", "--seq", "16",
                               "--ckpt-dir", str(tmp_path), "--ckpt-every",
                               "5", "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["step"] for ln in lines[:-1]] == [10]
    assert lines[-1]["saved_steps"] == [5, 10]
    assert np.isfinite(lines[-1]["final_loss"])

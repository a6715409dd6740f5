"""The port's dense transformer, serving engine and launcher against the
JAX package's, on the reference's own parameters (``api.init(key(0))``
brought over by ``params_from_jax``)."""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.models.api import build_model, make_token_batch
from repro.serve import ServeEngine
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as torch_serve
from repro_torch.models.api import build_model as torch_build_model
from repro_torch.models.api import make_token_batch as torch_token_batch
from repro_torch.serve import TorchServeEngine

# f32: the two libraries sum in different orders (2 layers, smoke widths);
# bf16: activations round to bf16 at different places (silu, einsum
# outputs), a few bf16 ulps of the logits' scale
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _apis(impl: str, dtype: str):
    cfg = dataclasses.replace(get_smoke_config("smollm_135m"),
                              attention_impl=impl, dtype=dtype)
    tcfg = dataclasses.replace(torch_smoke_config("smollm_135m"),
                               attention_impl=impl, dtype=dtype)
    api, tapi = build_model(cfg), torch_build_model(tcfg)
    params = api.init(jax.random.key(0))
    tparams = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    return api, params, tapi, tparams


def test_configs_are_copies():
    assert (dataclasses.asdict(torch_smoke_config("smollm_135m"))
            == dataclasses.asdict(get_smoke_config("smollm_135m")))
    from repro.configs import get_config
    from repro_torch.configs import get_config as torch_get_config
    assert (dataclasses.asdict(torch_get_config("smollm-135m"))
            == dataclasses.asdict(get_config("smollm_135m")))
    with pytest.raises(ValueError):
        torch_get_config("gemma2_2b")


def test_param_specs_match_reference():
    api, _, tapi, tparams = _apis("naive", "bfloat16")
    assert sorted(tapi.param_specs) == sorted(api.param_specs)
    for name, spec in api.param_specs.items():
        assert dataclasses.asdict(tapi.param_specs[name]) == \
            dataclasses.asdict(spec), name
        assert tuple(tparams[name].shape) == spec.shape
        assert str(tparams[name].dtype) == f"torch.{spec.dtype}"


def test_init_follows_specs_on_generator_device():
    tapi = torch_build_model(torch_smoke_config("smollm_135m"))
    a = tapi.init(torch.Generator().manual_seed(3))
    b = tapi.init(torch.Generator().manual_seed(3))
    for name, spec in tapi.param_specs.items():
        assert tuple(a[name].shape) == spec.shape
        assert torch.equal(a[name], b[name])
        if spec.init == "zeros":
            assert not a[name].any()
        else:
            assert 0.01 < float(a[name].float().std()) < 0.03


@pytest.mark.parametrize("kind,seq,batch", [("train", 16, 2),
                                            ("prefill", 24, 3),
                                            ("decode", 40, 4)])
def test_make_token_batch_bit_identical(kind, seq, batch):
    cfg = get_smoke_config("smollm_135m")
    shape = ShapeConfig("s", seq, batch, kind)
    want = make_token_batch(cfg, shape, seed=5)
    got = torch_token_batch(torch_smoke_config("smollm_135m"), shape, seed=5)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_prefill_and_decode_logits_match_reference(impl, dtype):
    """Prefill logits and three decode steps (scalar length) against
    ``api.prefill`` / ``api.decode_step``; tolerance per dtype above."""
    api, params, tapi, tparams = _apis(impl, dtype)
    tol = LOGIT_TOL[dtype]
    batch = make_token_batch(api.cfg, ShapeConfig("p", 12, 2, "prefill"),
                             seed=1)
    Smax = 16
    logits, cache = jax.jit(lambda p, b: api.prefill(p, b, Smax))(params,
                                                                  batch)
    tlogits, tcache = tapi.prefill(
        tparams, {"tokens": torch.from_numpy(batch["tokens"])}, Smax)
    np.testing.assert_allclose(_np(tlogits), _np(logits), rtol=tol, atol=tol)
    assert tuple(tcache["k"].shape) == cache["k"].shape
    np.testing.assert_allclose(_np(tcache["k"]), _np(cache["k"]), rtol=tol,
                               atol=tol)
    step = jax.jit(api.decode_step)
    tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
    for i in range(3):
        pos = np.full((2,), 12 + i, np.int32)
        logits, cache = step(params, cache, {"token": jnp.asarray(tok),
                                             "pos": jnp.asarray(pos)})
        tlogits, tcache = tapi.decode_step(
            tparams, tcache, {"token": torch.from_numpy(tok),
                              "pos": torch.from_numpy(pos)})
        np.testing.assert_allclose(_np(tlogits), _np(logits), rtol=tol,
                                   atol=tol, err_msg=f"decode step {i}")
        assert int(tcache["length"]) == int(cache["length"])
        tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]


def test_decode_per_slot_lengths_match_reference():
    """Per-slot [B] lengths (the engine's cache), f32."""
    api, params, tapi, tparams = _apis("naive", "float32")
    B, Smax = 3, 20
    rng = np.random.default_rng(2)
    k = rng.normal(size=api.cache_specs(B, Smax)["k"].shape) * 0.5
    v = rng.normal(size=k.shape) * 0.5
    lens = np.array([3, 9, 14], np.int32)
    tok = rng.integers(0, api.cfg.vocab, size=(B, 1)).astype(np.int32)
    cache = {"k": jnp.asarray(k, jnp.float32), "v": jnp.asarray(v, jnp.float32),
             "length": jnp.asarray(lens)}
    tcache = {"k": torch.from_numpy(k.astype(np.float32)),
              "v": torch.from_numpy(v.astype(np.float32)),
              "length": torch.from_numpy(lens.copy())}
    batch = {"token": tok, "pos": lens}
    logits, cache = jax.jit(api.decode_step)(
        params, cache, {k_: jnp.asarray(a) for k_, a in batch.items()})
    tlogits, tcache = tapi.decode_step(
        tparams, tcache, {k_: torch.from_numpy(a.copy()) for k_, a in batch.items()})
    np.testing.assert_allclose(_np(tlogits), _np(logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tcache["k"]), _np(cache["k"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(cache["length"]))


def _requests(vocab, rng):
    return [
        (0, rng.integers(0, vocab, size=7).astype(np.int32), 6),
        (1, rng.integers(0, vocab, size=12).astype(np.int32), 3),
        (2, rng.integers(0, vocab, size=4).astype(np.int32), 8),
        (3, rng.integers(0, vocab, size=9).astype(np.int32), 5),
    ]


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_engine_matches_reference_engine(impl):
    """TorchServeEngine vs the JAX ServeEngine on the same f32 weights:
    token for token (staggered prompts, slots=2 forces queuing and
    mid-flight admission)."""
    api, params, tapi, tparams = _apis(impl, "float32")
    reqs = _requests(api.cfg.vocab, np.random.default_rng(0))
    ref = ServeEngine(api, params, slots=2, max_seq=48)
    eng = TorchServeEngine(tapi, tparams, slots=2, max_seq=48)
    for rid, prompt, max_new in reqs:
        ref.submit(rid, prompt, max_new)
        eng.submit(rid, prompt, max_new)
    want, got = ref.run(), eng.run()
    assert got == want
    assert set(got) == {0, 1, 2, 3}


def _sequential_greedy(tapi, tparams, prompt, max_new, max_seq):
    logits, cache = tapi.prefill(
        tparams, {"tokens": torch.from_numpy(prompt[None, :])}, max_seq)
    out = [int(torch.argmax(logits[0]))]
    pos = len(prompt)
    for _ in range(max_new - 1):
        logits, cache = tapi.decode_step(
            tparams, cache, {"token": torch.tensor([[out[-1]]], dtype=torch.int32),
                             "pos": torch.tensor([pos], dtype=torch.int32)})
        out.append(int(torch.argmax(logits[0])))
        pos += 1
    return out


def test_engine_matches_sequential_greedy():
    """The engine contract of tests/test_serve_engine.py, on the port."""
    _, _, tapi, tparams = _apis("pallas", "float32")
    reqs = _requests(tapi.cfg.vocab, np.random.default_rng(1))
    eng = TorchServeEngine(tapi, tparams, slots=2, max_seq=48)
    for rid, prompt, max_new in reqs:
        eng.submit(rid, prompt, max_new)
    results = eng.run()
    for rid, prompt, max_new in reqs:
        assert results[rid] == _sequential_greedy(tapi, tparams, prompt,
                                                  max_new, 48), rid


def test_engine_frees_slots_early():
    """A short request retires, its slot serves a queued request, and the
    freed slot's length is reset so its idle writes stay in the cache."""
    tapi = torch_build_model(torch_smoke_config("smollm_135m"))
    tparams = tapi.init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    eng = TorchServeEngine(tapi, tparams, slots=2, max_seq=12)
    eng.submit(0, rng.integers(0, 256, size=5), 2)
    eng.submit(1, rng.integers(0, 256, size=5), 2)
    eng.submit(2, rng.integers(0, 256, size=3), 20)      # runs to max_seq
    results = eng.run()
    assert len(results[0]) == 2 and len(results[1]) == 2
    assert 0 < len(results[2]) < 20
    assert eng.cache["length"].tolist() == [0, 0]


def test_serve_launcher_cpu(capsys):
    torch_serve.main(["--arch", "smollm_135m", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen-len", "3"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["gen_len"] == 3
    assert len(line["sample_tokens"]) == 4
    with pytest.raises(SystemExit):
        torch_serve.main(["--arch", "smollm_135m", "--smoke", "--device",
                          "cpu", "--data-mesh", "2"])

"""The port's RecurrentGemma family and its ``rglru_scan`` plain version
against the JAX package's, on the same NumPy inputs and on the reference's
own parameters (``api.init(key(0))`` brought over by ``params_from_jax``).

The JAX Pallas kernel runs with ``interpret=True`` as ``test_kernels.py``
runs it; the CUDA kernel runs only on the card (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config
from repro.configs.base import ShapeConfig
from repro.kernels.rglru_scan.ops import lru_scan as jax_lru_scan
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_scan_ref
from repro.models import rglru as jax_rglru
from repro.models.api import build_model, make_token_batch
from repro_torch.configs import base as torch_base
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.comm import Comm
from repro_torch.core.store import DatasetStore
from repro_torch.core.tensor_ckpt import TensorCheckpoint, balanced_chunk_partition
from repro_torch.core.torch_io import layout_from_torch, load_torch, save_torch
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.launch import serve as torch_serve
from repro_torch.models import rglru
from repro_torch.models.api import build_model as torch_build_model
from repro_torch.serve import TorchServeEngine

ARCH = "recurrentgemma_9b"
# f32: the two libraries sum the products and the scan in different orders
# (3 layers, smoke widths; the largest difference seen is ~4e-7 against
# logits of ~1.2); bf16: activations round to bf16 at different places, the
# repo's bf16 tolerance
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _apis(dtype: str):
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(torch_smoke_config(ARCH), dtype=dtype)
    api, tapi = build_model(cfg), torch_build_model(tcfg)
    params = api.init(jax.random.key(0))
    tparams = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    return api, params, tapi, tparams


# ------------------------------------------------------------- configs
def test_configs_are_copies():
    for ref, port in ((get_config(ARCH), torch_get_config("recurrentgemma-9b")),
                      (get_smoke_config(ARCH), torch_smoke_config(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_param_specs_and_count_match_reference():
    """Every name, shape, dtype and init of the full-size model, and its
    parameter count (no memory behind either)."""
    cfg = get_config(ARCH)
    api = build_model(cfg)
    tapi = torch_build_model(torch_get_config(ARCH))
    assert sorted(tapi.param_specs) == sorted(api.param_specs)
    for name, spec in api.param_specs.items():
        assert dataclasses.asdict(tapi.param_specs[name]) == \
            dataclasses.asdict(spec), name
    n = sum(int(np.prod(s.shape)) for s in tapi.param_specs.values())
    assert n == 9_396_088_832
    for key, spec in tapi.cache_specs(4, 544).items():
        ref = api.cache_specs(4, 544)[key]
        assert spec.shape == ref.shape and spec.dtype == str(ref.dtype), key


# ------------------------------------------------------------ rglru_scan
# the cases of tests/test_kernels.py (block sizes are the Pallas kernel's)
SCAN_CASES = [
    (2, 64, 32, 16, 32, True),
    (1, 100, 48, 32, 16, True),     # ragged both dims
    (3, 33, 128, 33, 128, True),
    (1, 256, 16, 64, 16, True),
    (2, 40, 24, 8, 24, False),      # h0 = None
]


@pytest.mark.parametrize("B,S,W,bs,bw,with_h0", SCAN_CASES)
def test_rglru_scan_plain_matches_pallas(B, S, W, bs, bw, with_h0):
    """The kernel's plain version vs the Pallas kernel (interpret mode) and
    the JAX oracle, at test_kernels.py's f32 tolerance (rtol = atol = 1e-5:
    the three sum in different orders)."""
    rng = np.random.default_rng(B * S * W)
    a = rng.uniform(0.8, 0.999, size=(B, S, W)).astype(np.float32)
    b = (rng.normal(size=(B, S, W)) * 0.1).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32) if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    want, want_last = jax_lru_scan(jnp.asarray(a), jnp.asarray(b), jh0,
                                   block_s=bs, block_w=bw, interpret=True)
    oracle, _ = jax_scan_ref(jnp.asarray(a), jnp.asarray(b), jh0)
    got, got_last = scan_ops.lru_scan(
        torch.from_numpy(a), torch.from_numpy(b),
        None if h0 is None else torch.from_numpy(h0))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, W)
    for ref in (want, oracle):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got_last), _np(want_last), rtol=1e-5,
                               atol=1e-5)


def test_rglru_scan_wrapper_checks_and_never_launches_on_cpu():
    scan_ops.launches = 0
    a = torch.full((1, 5, 3), 0.5)
    h, h_last = scan_ops.lru_scan(a, torch.ones(1, 5, 3), torch.zeros(1, 3))
    # h_t = 0.5 h_{t-1} + 1 from 0: 1, 1.5, 1.75, ...
    np.testing.assert_allclose(h[0, :, 0].numpy(),
                               [1.0, 1.5, 1.75, 1.875, 1.9375])
    assert torch.equal(h_last, h[:, -1]) and scan_ops.launches == 0
    with pytest.raises(ValueError):
        scan_ops.lru_scan(a, torch.ones(1, 4, 3))
    with pytest.raises(ValueError):
        scan_ops.lru_scan(a, a, torch.zeros(3))
    with pytest.raises(ValueError):
        scan_ops.lru_scan(a[:, :0], a[:, :0])


def test_rglru_scan_scratch_gets_a_new_epoch_per_launch(monkeypatch):
    """The kernel's look-back scratch: one zeroed buffer per (card, stream),
    grown when a shape needs more, and a new epoch on every launch; when
    the epochs run out the buffer is zeroed anew and they restart at 1."""
    monkeypatch.setattr(scan_ops, "_scratch", {})
    cpu = torch.device("cpu")
    s1, e1 = scan_ops._scratch_for(64, cpu, 7)
    s2, e2 = scan_ops._scratch_for(32, cpu, 7)
    assert s2 is s1 and (e1, e2) == (1, 2) and not s1.any()
    other, e = scan_ops._scratch_for(32, cpu, 8)    # another stream
    assert other is not s1 and e == 1
    big, e3 = scan_ops._scratch_for(128, cpu, 7)     # grown, zeroed anew
    assert big.numel() == 128 and e3 == 1
    scan_ops._scratch[(None, 7)][1] = scan_ops.EPOCHS - 2
    _, last = scan_ops._scratch_for(8, cpu, 7)
    assert last == scan_ops.EPOCHS - 1
    fresh, e4 = scan_ops._scratch_for(8, cpu, 7)
    assert e4 == 1 and fresh is not big and not fresh.any()


@pytest.mark.parametrize("S", [300, 40])
@pytest.mark.parametrize("with_h0", [True, False])
def test_lru_scan_layer_matches_reference(S, with_h0):
    """``_lru_scan`` (gates + scan) vs the reference's chunked
    associative scan: S 300 spans two 256-step chunks, S 40 is one.  f32
    gate products sum in another order: rtol = atol = 1e-5."""
    B, W = 2, 32
    rng = np.random.default_rng(S)
    x = rng.normal(size=(B, S, W)).astype(np.float32)
    lp = {"w_a": (rng.normal(size=(W, W)) * 0.2).astype(np.float32),
          "w_i": (rng.normal(size=(W, W)) * 0.2).astype(np.float32),
          "lam": rng.normal(size=(W,)).astype(np.float32)}
    h0 = rng.normal(size=(B, W)).astype(np.float32) if with_h0 else None
    want, want_last = jax_rglru._lru_scan(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp.items()},
        None if h0 is None else jnp.asarray(h0))
    got, got_last = rglru._lru_scan(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in lp.items()},
        None if h0 is None else torch.from_numpy(h0))
    assert got_last.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got_last), _np(want_last), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------- prefill, decode
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill logits and the full cache, then four decode steps (logits
    and cache), against ``api.prefill`` / ``api.decode_step``; tolerance per
    dtype above."""
    api, params, tapi, tparams = _apis(dtype)
    tol = TOL[dtype]
    batch = make_token_batch(api.cfg, ShapeConfig("p", 12, 2, "prefill"),
                             seed=1)
    Smax = 20
    logits, cache = jax.jit(lambda p, b: api.prefill(p, b, Smax))(params,
                                                                  batch)
    tlogits, tcache = tapi.prefill(
        tparams, {"tokens": torch.from_numpy(batch["tokens"])}, Smax)
    np.testing.assert_allclose(_np(tlogits), _np(logits), rtol=tol, atol=tol)

    def same_cache(where):
        assert sorted(tcache) == sorted(cache)
        for key in cache:
            assert tuple(tcache[key].shape) == cache[key].shape, key
            assert str(tcache[key].dtype) == f"torch.{cache[key].dtype}", key
            np.testing.assert_allclose(_np(tcache[key]), _np(cache[key]),
                                       rtol=tol, atol=tol,
                                       err_msg=f"{where}: {key}")

    same_cache("prefill")
    step = jax.jit(api.decode_step)
    tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
    for i in range(4):
        pos = np.full((2,), 12 + i, np.int32)
        logits, cache = step(params, cache, {"token": jnp.asarray(tok),
                                             "pos": jnp.asarray(pos)})
        tlogits, tcache = tapi.decode_step(
            tparams, tcache, {"token": torch.from_numpy(tok),
                              "pos": torch.from_numpy(pos)})
        np.testing.assert_allclose(_np(tlogits), _np(logits), rtol=tol,
                                   atol=tol, err_msg=f"decode step {i}")
        same_cache(f"decode step {i}")
        tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]


def _decode_minus_prefill(prefill, decode_step, tokens, S):
    """Logits of decoding token S after a prefill of S tokens, minus those
    of one prefill of S + 1 tokens."""
    _, cache = prefill(tokens[:, :S], S + 4)
    longer, _ = prefill(tokens[:, :S + 1], None)
    dec, _ = decode_step(cache, tokens[:, S:S + 1],
                         np.full((tokens.shape[0],), S, np.int32))
    return _np(dec) - _np(longer)


@pytest.mark.parametrize("S,faulty", [(6, False), (11, True), (16, False)])
def test_ring_buffer_caveat_pinned(S, faulty):
    """The reference's ring layout (kept by the port): a prefill longer
    than the window keeps its last ``win`` keys in slots 0..win-1, and
    decode overwrites slot ``length % win``, which holds the oldest key only
    when S % win == 0.  With window 8, S 11 evicts a key still in the
    window, so decode-after-prefill differs from a longer prefill (by ~0.02
    here), equally in both packages; S 6 and 16 agree to f32 rounding."""
    api, params, tapi, tparams = _apis("float32")
    assert api.cfg.local_window == 8
    tokens = np.random.default_rng(3).integers(
        0, api.cfg.vocab, size=(2, 17)).astype(np.int32)
    prefill = jax.jit(api.prefill, static_argnums=2)
    step = jax.jit(api.decode_step)
    want = _decode_minus_prefill(
        lambda t, Smax: prefill(params, {"tokens": jnp.asarray(t)}, Smax),
        lambda c, t, p: step(params, c, {"token": jnp.asarray(t),
                                         "pos": jnp.asarray(p)}),
        tokens, S)
    got = _decode_minus_prefill(
        lambda t, Smax: tapi.prefill(tparams, {"tokens": torch.from_numpy(t)},
                                     Smax),
        lambda c, t, p: tapi.decode_step(tparams, c,
                                         {"token": torch.from_numpy(t),
                                          "pos": torch.from_numpy(p)}),
        tokens, S)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if faulty:
        assert np.abs(want).max() > 1e-3
    else:
        assert np.abs(want).max() < 1e-5 and np.abs(got).max() < 1e-5


# ----------------------------------------------------- serving state N-to-M
def test_cache_saves_as_4_ranks_and_restores_on_1(tmp_path):
    """The cache after a prefill (f32 h, bf16 conv and ring k/v, 0-d
    length) saved as 4 ranks and restored on one: bit-exact, verified, and
    the decode steps continued from it give the same tokens."""
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
    assert cache["length"].dim() == 0 and cache["h"].dtype == torch.float32

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
        assert restored[key].dtype == t.dtype
        assert torch.equal(restored[key].reshape(-1).view(torch.uint8),
                           t.reshape(-1).view(torch.uint8)), key
    first = torch.argmax(saved["logits"], -1).to(torch.int32)[:, None]
    with torch.inference_mode():
        toks = torch_serve.decode_steps(tapi, tparams, restored, first, P, G,
                                        torch.device("cpu"))
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(), out)


# ----------------------------------------------------------- entry points
def test_serve_launcher_recurrentgemma_cpu(capsys):
    torch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12", "--gen-len", "3"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["arch"] == "recurrentgemma-9b-smoke"
    assert line["device"] == "cpu" and line["gen_len"] == 3
    assert len(line["sample_tokens"]) == 4


def test_engine_refuses_caches_it_cannot_splice():
    """The engine splices k and v only: a recurrent cache is refused at
    construction instead of being served with zero h and conv states."""
    tapi = torch_build_model(torch_smoke_config(ARCH))
    tparams = tapi.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="conv"):
        TorchServeEngine(tapi, tparams, slots=2, max_seq=16)


@pytest.mark.parametrize("arch", ["whisper_base"])
def test_build_model_refuses_unported_families(arch):
    """No family is refused any more: the one this test pinned as refused,
    the encoder-decoder, builds from the reference's smoke config (made
    into the port's schema field by field) with the reference's specs."""
    ref = dataclasses.asdict(get_smoke_config(arch))
    tapi = torch_build_model(torch_base.ModelConfig(**ref))
    want = build_model(get_smoke_config(arch)).param_specs
    assert sorted(tapi.param_specs) == sorted(want)
    for name, spec in want.items():
        assert dataclasses.asdict(tapi.param_specs[name]) == \
            dataclasses.asdict(spec), name

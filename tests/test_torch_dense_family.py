"""The rest of the dense decoder family in the port against the JAX
package, in one process: qwen3-4b (qk-norm, head dim 128 at full size),
gemma2-2b (softcaps, alternating local/global layers with a sliding
window) and qwen2-vl-7b's backbone (embeddings input, M-RoPE, untied
embeddings), each on its smoke config: the config copies, parameter specs,
synthetic batches, ``mrope_angles``, the loss and its gradients, prefill
and decode under both attention paths, the serving launcher and the port
of ``examples/serve_batched.py``.

Inputs are made with seeded NumPy and handed to both packages; the
parameters are the reference's ``api.init(key(0))`` brought over by
``params_from_jax``.  The reference's step builders run on an Auto-axis
(1, 1) mesh (the installed jax's ``make_debug_mesh`` gives Explicit axes:
ROADMAP.md, Reference caveats).  Tolerances, unless a test says otherwise:
f32 1e-5 and bf16 2e-2, each relative to the array's own largest value.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.ast_copy import normalised
from jax.sharding import AxisType

from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.distrib.rules import rules_for as ref_rules_for
from repro.models.api import build_model, make_token_batch
from repro.models.layers import mrope_angles as ref_mrope_angles
from repro.models.layers import rope_angles as ref_rope_angles
from repro.train.step import make_decode_step as ref_make_decode_step
from repro.train.step import make_prefill_step as ref_make_prefill_step
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.examples import serve_batched
from repro_torch.launch import serve as torch_serve
from repro_torch.models.api import build_model as torch_build_model
from repro_torch.models.api import make_token_batch as torch_token_batch
from repro_torch.models.layers import mrope_angles, rope_angles
from repro_torch.train.step import make_decode_step, make_prefill_step

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3_4b", "gemma2_2b", "qwen2_vl_7b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _close(got, want, tol, what=""):
    """max |got - want| <= tol * max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} * {scale}"


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _apis(arch: str, dtype: str = "bfloat16", **kw):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw)
    tcfg = dataclasses.replace(torch_smoke_config(arch), dtype=dtype, **kw)
    api, tapi = build_model(cfg), torch_build_model(tcfg)
    params = api.init(jax.random.key(0))
    tparams = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    return api, params, tapi, tparams


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------- configs and specs
@pytest.mark.parametrize("arch", ARCHS)
def test_config_module_is_a_copy(arch):
    """The module's tree is the reference's (docstrings and the package
    prefix aside), and it builds through the port's ``build_model``."""
    ours = importlib.import_module(f"repro_torch.configs.{arch}")
    ref = importlib.import_module(f"repro.configs.{arch}")
    assert normalised(ours) == normalised(ref)
    torch_build_model(ours.config())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    """Names, shapes, logical axes, dtypes and inits, for the full config
    (qwen2-vl's untied ``unembed`` included) and the smoke one."""
    from repro.configs import get_config
    from repro_torch.configs import get_config as torch_get_config
    for ref_cfg, cfg in [(get_smoke_config(arch), torch_smoke_config(arch)),
                         (get_config(arch), torch_get_config(arch))]:
        want = build_model(ref_cfg).param_specs
        got = torch_build_model(cfg).param_specs
        assert sorted(got) == sorted(want)
        assert ("unembed" in got) == (not cfg.tie_embeddings)
        for name, spec in want.items():
            assert dataclasses.asdict(got[name]) == dataclasses.asdict(spec), \
                name


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_the_params(arch):
    """The reference's smoke init, bit for bit (qwen2-vl's ``unembed``
    included)."""
    _, params, _, tparams = _apis(arch)
    assert sorted(tparams) == sorted(params)
    for k, v in params.items():
        v = np.asarray(v)
        assert tuple(tparams[k].shape) == v.shape, k
        assert str(tparams[k].dtype) == f"torch.{v.dtype}", k
        assert tparams[k].reshape(-1).view(torch.uint8).numpy().tobytes() \
            == np.ascontiguousarray(v).tobytes(), k


@pytest.mark.parametrize("kind,seq,batch", [("train", 16, 2),
                                            ("prefill", 24, 3),
                                            ("decode", 40, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_token_batch_bit_identical(arch, kind, seq, batch):
    """Same keys in the same order, dtypes and values; qwen2-vl's
    embeddings input (f32 ``embeds``, M-RoPE ``positions`` [B, S, 3] drawn
    in [0, 64)) included."""
    shape = ShapeConfig("s", seq, batch, kind)
    want = make_token_batch(get_smoke_config(arch), shape, seed=5)
    got = torch_token_batch(torch_smoke_config(arch), shape, seed=5)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    if arch == "qwen2_vl_7b" and kind != "decode":
        assert got["positions"].shape == (batch, seq, 3)
        assert 0 <= got["positions"].min() and got["positions"].max() < 64


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_embeds_cast_is_bit_identical(kind):
    """The f32 ``embeds`` of the smoke batch as the port's embeddings
    input takes them (``Tensor.to``) and as the reference's ``astype``
    rounds them to bf16 (round to nearest even): the same bits, unscaled,
    with the positions passed through."""
    from repro_torch.models.transformer import _embed_in
    cfg = get_smoke_config("qwen2_vl_7b")
    batch = make_token_batch(cfg, ShapeConfig("s", 24, 3, kind), seed=7)
    want = np.asarray(jnp.asarray(batch["embeds"]).astype(cfg.dtype))
    got, positions = _embed_in({}, torch_smoke_config("qwen2_vl_7b"),
                               _torch_batch(batch))
    assert got.dtype == torch.bfloat16
    assert got.view(torch.int16).numpy().tobytes() == want.tobytes()
    np.testing.assert_array_equal(positions.numpy(), batch["positions"])


# ----------------------------------------------------------------- M-RoPE
# |port - reference| <= 2^-23 (one f32 ulp at 1.0, the largest a sine or
# cosine takes): both take the same f32 frequencies (XLA's f32 pow, which
# the port reproduces bit for bit) and the same f32 products, so only the
# two libraries' sin and cos differ, by 1 ulp where they differ at all
ANGLE_ATOL = 2.0 ** -23


@pytest.mark.parametrize("head_dim,sections", [(128, (16, 24, 24)),
                                               (16, (2, 3, 3))],
                         ids=["qwen2-vl-7b", "smoke"])
def test_mrope_angles_match_reference(head_dim, sections):
    """At every position 0..32,768 on each stream, and at random (t, h, w)
    triples in that range; the config's own split for both widths."""
    cfg = dataclasses.replace(get_smoke_config("qwen2_vl_7b"),
                              head_dim=head_dim)
    assert cfg.mrope_sections() == sections
    rng = np.random.default_rng(0)
    ramp = np.arange(32_769, dtype=np.int32)
    pos = np.concatenate([np.stack([ramp] * 3, -1),
                          rng.integers(0, 32_769, (4096, 3))]).astype(np.int32)
    want = ref_mrope_angles(jnp.asarray(pos), head_dim, cfg.rope_theta,
                            sections)
    got = mrope_angles(torch.from_numpy(pos), head_dim, cfg.rope_theta,
                       sections)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ANGLE_ATOL)
    # each stream feeds its own lanes, in (t, h, w) order
    one = np.zeros((1, 3), np.int32)
    one[0, 1] = 1000
    sin, _ = mrope_angles(torch.from_numpy(one), head_dim, cfg.rope_theta,
                          sections)
    t, h, _ = sections
    lanes = np.nonzero(sin[0].numpy())[0]
    assert lanes.min() == t and lanes.max() == t + h - 1
    with pytest.raises(ValueError, match="sections"):
        mrope_angles(torch.from_numpy(one), head_dim, cfg.rope_theta,
                     (1, 1, 1))


@pytest.mark.parametrize("head_dim,theta", [(64, 10_000.0), (128, 1e6),
                                            (256, 10_000.0)])
def test_rope_angles_match_reference(head_dim, theta):
    """Plain RoPE shares the frequencies: the same bound at positions up
    to 32,768 (smollm's hd 64, qwen3's 128, gemma2's 256)."""
    pos = np.arange(32_769, dtype=np.int32)
    want = ref_rope_angles(jnp.asarray(pos), head_dim, theta)
    got = rope_angles(torch.from_numpy(pos), head_dim, theta)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ANGLE_ATOL)


# -------------------------------------------------------- loss, gradients
# f32: the unembedding table's gradient (``embed`` when tied, ``unembed``
# when not) passes through the reference's bf16 copy of the table
# (``_unembed``), so its cotangent is rounded to bf16 and a value that
# lands on a rounding boundary moves by a bf16 ulp: measured at up to
# 3.3e-5 of the array's scale (gemma2 smoke; every other array under 1e-6)
UNEMBED_F32_TOL = 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, dtype):
    """``api.loss`` and its metrics and gradients against
    ``jax.value_and_grad(api.loss)`` on the train batch (qwen2-vl: the
    embeddings input with [B, S, 3] positions, so its ``embed`` table gets
    no gradient in either package)."""
    api, params, tapi, tparams = _apis(arch, dtype, vocab_chunk=8)
    batch = make_token_batch(api.cfg, ShapeConfig("t", 20, 2, "train"),
                             seed=1)
    (want, wm), wg = jax.jit(jax.value_and_grad(api.loss, has_aux=True))(
        params, batch)
    leaves = {n: p.requires_grad_(True) for n, p in tparams.items()}
    loss, metrics = tapi.loss(leaves, _torch_batch(batch))
    names = sorted(leaves)
    grads = dict(zip(names, torch.autograd.grad(
        loss, [leaves[n] for n in names], allow_unused=True)))
    tol = TOL[dtype]
    _close(loss, want, tol, "loss")
    assert sorted(metrics) == sorted(wm)
    for k in wm:
        _close(metrics[k], wm[k], tol, k)
    for n in names:
        if grads[n] is None:                 # not on the loss's path
            assert arch == "qwen2_vl_7b" and n == "embed"
            assert not np.asarray(wg[n], np.float32).any()
            continue
        assert grads[n].dtype == leaves[n].dtype
        table = dtype == "float32" and n in ("embed", "unembed")
        _close(grads[n], wg[n], UNEMBED_F32_TOL if table else tol,
               f"grad {n}")


# ------------------------------------------------------- prefill, decode
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["naive", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, impl, dtype):
    """Prefill logits and cache, then 4 decode steps (each package fed the
    reference's greedy tokens), through both packages' step builders.  The
    prompt (12) is longer than gemma2 smoke's window (8), so its local
    layers drop keys in prefill and in decode; qwen2-vl prefills from its
    embeddings batch and decodes tokens."""
    api, params, tapi, tparams = _apis(arch, dtype, attention_impl=impl)
    B, P, G = 3, 12, 4
    if arch == "gemma2_2b":
        assert P > api.cfg.local_window
    shape = ShapeConfig("p", P, B, "prefill")
    batch = make_token_batch(api.cfg, shape, seed=1)
    rules = ref_rules_for(api.cfg.arch)
    prefill = ref_make_prefill_step(api, _auto_mesh(), rules, shape,
                                    cache_len=P + G)
    decode = ref_make_decode_step(api, _auto_mesh(), rules,
                                  ShapeConfig("d", P + G, B, "decode"))
    tol = TOL[dtype]
    logits, cache = prefill(params, batch)
    tlogits, tcache = make_prefill_step(tapi, shape, cache_len=P + G)(
        tparams, _torch_batch(batch))
    _close(tlogits, logits, tol, "prefill logits")
    for k in ("k", "v"):
        _close(tcache[k], cache[k], tol, f"cache {k}")
    tdecode = make_decode_step(tapi)
    tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
    for i in range(G):
        pos = np.full((B,), P + i, np.int32)
        logits, cache = decode(params, cache, {"token": jnp.asarray(tok),
                                               "pos": jnp.asarray(pos)})
        tlogits, tcache = tdecode(tparams, tcache,
                                  {"token": torch.from_numpy(tok),
                                   "pos": torch.from_numpy(pos)})
        _close(tlogits, logits, tol, f"decode step {i}")
        assert int(tcache["length"]) == int(cache["length"])
        tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]


def _random_cache(api, B, Smax, lens, seed):
    rng = np.random.default_rng(seed)
    k = (rng.normal(size=api.cache_specs(B, Smax)["k"].shape) * 0.5
         ).astype(np.float32)
    v = (rng.normal(size=k.shape) * 0.5).astype(np.float32)
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v),
             "length": jnp.asarray(lens)},
            {"k": torch.from_numpy(k), "v": torch.from_numpy(v),
             "length": torch.from_numpy(lens.copy())})


@pytest.mark.parametrize("arch", ["qwen2_vl_7b", "gemma2_2b"])
def test_decode_per_slot_lengths_match_reference(arch):
    """Per-slot [B] lengths (the engine's cache), f32: qwen2-vl's token
    positions stacked onto its three M-RoPE streams, gemma2's window
    measured from each slot's own length (slot lengths on both sides of
    it)."""
    api, params, tapi, tparams = _apis(arch, "float32")
    B, Smax = 3, 20
    lens = np.array([3, 9, 14], np.int32)
    cache, tcache = _random_cache(api, B, Smax, lens, seed=2)
    tok = np.random.default_rng(3).integers(
        0, api.cfg.vocab, size=(B, 1)).astype(np.int32)
    batch = {"token": tok, "pos": lens}
    logits, cache = jax.jit(api.decode_step)(
        params, cache, {k: jnp.asarray(a) for k, a in batch.items()})
    tlogits, tcache = tapi.decode_step(tparams, tcache, _torch_batch(batch))
    _close(tlogits, logits, TOL["float32"], "logits")
    _close(tcache["k"], cache["k"], TOL["float32"], "cache k")
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(cache["length"]))


def test_decode_from_embeds_matches_reference():
    """qwen2-vl's decode step fed an embedding and its [B, 1, 3] M-RoPE
    positions (the reference's embeds branch: unscaled, positions as
    given), f32, against a random cache."""
    api, params, tapi, tparams = _apis("qwen2_vl_7b", "float32")
    B, Smax = 2, 16
    lens = np.array(5, np.int32)
    cache, tcache = _random_cache(api, B, Smax, lens, seed=4)
    rng = np.random.default_rng(5)
    batch = {"token": np.zeros((B, 1), np.int32),
             "pos": np.full((B,), 5, np.int32),
             "embeds": rng.normal(size=(B, 1, api.cfg.d_model),
                                  scale=0.5).astype(np.float32),
             "positions": rng.integers(0, 64, (B, 1, 3)).astype(np.int32)}
    logits, cache = jax.jit(api.decode_step)(
        params, cache, {k: jnp.asarray(a) for k, a in batch.items()})
    tlogits, tcache = tapi.decode_step(tparams, tcache, _torch_batch(batch))
    _close(tlogits, logits, TOL["float32"], "logits")
    _close(tcache["k"], cache["k"], TOL["float32"], "cache k")
    # the token path (scaled embedding of token 0) gives other logits
    tok_logits, _ = tapi.decode_step(
        tparams, _random_cache(api, B, Smax, lens, seed=4)[1],
        _torch_batch({k: batch[k] for k in ("token", "pos")}))
    assert not torch.allclose(tok_logits, tlogits)


# ------------------------------------------------------------ entry points
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_cpu(arch, capsys):
    """``--smoke --device cpu`` for each arch (kernel attention selected,
    its plain version on the CPU); qwen2-vl prefills its embeddings batch.
    The tokens are those of ``serve_batch`` on the same seeded weights and
    batch."""
    torch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "10", "--gen-len",
                      "3"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = dataclasses.replace(torch_smoke_config(arch),
                              attention_impl="pallas")
    assert line["arch"] == cfg.arch and line["device"] == "cpu"
    assert line["gen_len"] == 3 and len(line["sample_tokens"]) == 4
    tapi = torch_build_model(cfg)
    batch = torch_token_batch(cfg, ShapeConfig("serve", 10, 2, "prefill"),
                              seed=0)
    assert ("embeds" in batch) == (arch == "qwen2_vl_7b")
    out, _ = torch_serve.serve_batch(
        tapi, tapi.init(torch.Generator().manual_seed(0)),
        _torch_batch(batch), 3, torch.device("cpu"))
    assert out[0].tolist() == line["sample_tokens"]


def _reference_example_output() -> str:
    """The reference's ``examples/serve_batched.py`` run as it is, with its
    (1, 1) debug mesh made with Auto axes (the jax caveat)."""
    spec = importlib.util.spec_from_file_location(
        "ref_serve_batched", ROOT / "examples" / "serve_batched.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.make_debug_mesh = lambda d, m: jax.make_mesh(
        (d, m), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue()


def _seq_lines(text: str) -> list[str]:
    return [ln.strip() for ln in text.splitlines()
            if ln.strip().startswith("seq ")]


def test_serve_batched_example_matches_reference_tokens(capsys):
    """The port's example on the reference's gemma2 smoke weights
    (``api.init(key(0))``, bf16) prints the reference example's tokens,
    sequence by sequence, and its three kinds of line."""
    ref_text = _reference_example_output()
    api = build_model(get_smoke_config(serve_batched.ARCH))
    params = api.init(jax.random.key(0))
    tparams = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    tapi = torch_build_model(torch_smoke_config(serve_batched.ARCH))
    out = serve_batched.serve(tapi, tparams, torch.device("cpu"))
    text = capsys.readouterr().out
    assert out.shape == (serve_batched.B, serve_batched.G + 1)
    assert _seq_lines(text) == _seq_lines(ref_text)
    assert len(_seq_lines(text)) == serve_batched.B
    for start in ("prefill: 4 prompts x 24 tokens", "decode: 12 steps x 4"):
        assert any(ln.startswith(start) for ln in text.splitlines())
    assert "cache length=24" in text


def test_serve_batched_example_main_cpu(capsys):
    """``--device cpu`` runs the example on its own seeded weights."""
    out = serve_batched.main(["--device", "cpu"])
    assert out.shape == (4, 13)
    assert ((out >= 0) & (out < 256)).all()
    assert len(_seq_lines(capsys.readouterr().out)) == 4

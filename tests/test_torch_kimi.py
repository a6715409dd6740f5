"""kimi-k2 and Adafactor in the port against the JAX package: the config
copy, parameter specs and the full config's count, the smoke model
(qk-norm, an untied unembedding, 8 experts top-2) dense and in its EP
variant through the loss, its gradients, prefill and decode, decode after
a prefill against a longer prefill, the serving cache restarted N-to-M;
``Adafactor``'s slots and updates parameter by parameter, its decay's
bits; the one-device train step under Adafactor, the trainer's kill and
resume and the Adafactor train state crossing between the packages; and
both launchers.

Inputs are seeded NumPy handed to both packages; the parameters are the
reference's ``api.init(key(0))`` brought over by ``params_from_jax``.  The
reference's EP variant and its step builders run on an Auto-axis (1, 1)
mesh (the installed jax's ``make_debug_mesh`` gives Explicit axes:
ROADMAP.md, Reference caveats).  Tolerances: f32 1e-5 and bf16 2e-2 of an
array's scale, as each test says."""

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
from jax.sharding import AxisType

from repro.configs import get_config, get_smoke_config
from repro.configs import kimi_k2_1t_a32b as ref_config_module
from repro.configs.base import ShapeConfig
from repro.distrib.context import MeshContext as RefMeshContext
from repro.distrib.context import use_mesh_context as ref_use_mesh_context
from repro.distrib.rules import rules_for as ref_rules_for
from repro.models.api import ParamSpec as RefParamSpec
from repro.models.api import build_model, make_token_batch
from repro.train.data import SyntheticLM
from repro.train.optim import Adafactor as RefAdafactor
from repro.train.step import make_decode_step as ref_make_decode_step
from repro.train.step import make_prefill_step as ref_make_prefill_step
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.configs import kimi_k2_1t_a32b as config_module
from repro_torch.convert import params_from_jax
from repro_torch.core.comm import Comm
from repro_torch.core.store import DatasetStore
from repro_torch.core.tensor_ckpt import TensorCheckpoint, balanced_chunk_partition
from repro_torch.core.torch_io import layout_from_torch, load_torch, save_torch
from repro_torch.distrib import use_mesh_context
from repro_torch.distrib.rules import rules_for
from repro_torch.launch import serve as torch_serve
from repro_torch.launch import train as torch_train_launcher
from repro_torch.models.api import ParamSpec
from repro_torch.models.api import build_model as torch_build_model
from repro_torch.train.optim import Adafactor, make_optimizer
from repro_torch.train.step import (ONE_DEVICE, make_decode_step,
                                    make_prefill_step, mesh_context_for,
                                    train_state_specs)

ARCH = "kimi_k2_1t_a32b"
TOL = rec.TOL


def _variant(cfg, impl: str, capacity: float | None = None, **kw):
    moe = dataclasses.replace(cfg.moe, impl=impl)
    if capacity is not None:
        moe = dataclasses.replace(moe, capacity_factor=capacity)
    return dataclasses.replace(cfg, moe=moe, **kw)


def _apis(impl: str, dtype: str, capacity: float | None = None, **kw):
    cfg = _variant(get_smoke_config(ARCH), impl, capacity, dtype=dtype,
                   **kw)
    tcfg = _variant(torch_smoke_config(ARCH), impl, capacity, dtype=dtype,
                    **kw)
    api, tapi = build_model(cfg), torch_build_model(tcfg)
    params = api.init(jax.random.key(0))
    tparams = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    return api, params, tapi, tparams


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _contexts(arch: str):
    """Both packages' (1, 1) contexts, as their step builders install
    them (the EP variant's layers need one)."""
    rules = ref_rules_for(arch)
    ref = RefMeshContext(mesh=_auto_mesh(), dp_axes=rules.batch_axes,
                         ep_axis="model", fsdp_axis=rules.table["embed"],
                         rules=rules)
    return ref, mesh_context_for(ONE_DEVICE, rules_for(arch))


def _scale_close(got, want, tol, what=""):
    """max |got - want| <= tol * max |want| (the array's own scale)."""
    got, want = rec.np_(got), rec.np_(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} * {scale}"


# ------------------------------------------------------- configs and specs
def test_config_module_is_a_copy():
    """The module's tree is the reference's (docstrings and the package
    prefix aside), the arch is ported, and both configs are equal."""
    assert normalised(config_module) == normalised(ref_config_module)
    assert ARCH in ARCHS
    for name in (ARCH, "kimi-k2-1t-a32b"):
        assert dataclasses.asdict(torch_get_config(name)) == \
            dataclasses.asdict(get_config(name))
    assert dataclasses.asdict(torch_smoke_config(ARCH)) == \
        dataclasses.asdict(get_smoke_config(ARCH))
    assert torch_get_config(ARCH).optimizer == "adafactor"


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_param_specs_and_count_match_reference(impl):
    """Every name, shape, logical axis, dtype and init of the full and
    smoke models (the EP variant pads the smoke's 8 experts to 16), the
    serving cache's shapes, and the full model's parameter count: the
    reference's, inside its band (0.8-1.2 T,
    ``tests/test_arch_smoke.py::PARAM_BANDS``)."""
    for cfg, tcfg in [(get_config(ARCH), torch_get_config(ARCH)),
                      (get_smoke_config(ARCH), torch_smoke_config(ARCH))]:
        api = build_model(_variant(cfg, impl))
        tapi = torch_build_model(_variant(tcfg, impl))
        assert sorted(tapi.param_specs) == sorted(api.param_specs)
        for name, spec in api.param_specs.items():
            assert dataclasses.asdict(tapi.param_specs[name]) == \
                dataclasses.asdict(spec), name
        want, got = api.cache_specs(4, 40), tapi.cache_specs(4, 40)
        assert {k: (s.shape, s.dtype) for k, s in got.items()} == \
            {k: (w.shape, str(w.dtype)) for k, w in want.items()}
    specs = torch_build_model(torch_get_config(ARCH)).param_specs
    n = sum(int(np.prod(s.shape)) for s in specs.values())
    assert n == sum(int(np.prod(s.shape)) for s in
                    build_model(get_config(ARCH)).param_specs.values())
    assert 0.8e12 <= n <= 1.2e12 and "unembed" in specs
    assert specs["we_gate"].shape == (61, 384, 7168, 2048)


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_params_from_jax_carries_the_params(impl):
    _, params, _, tparams = _apis(impl, "bfloat16")
    assert sorted(tparams) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(rec.bits(tparams[k]), rec.bits(v),
                                      err_msg=k)


# ----------------------------------------------------- model loss + grads
# The arrays whose gradient flows only through the MoE layers' routing and
# experts.  In bf16 a routing choice near a tie can flip between the two
# packages (their activations round at different places), which moves a
# whole token's contribution between two experts; these arrays are then
# held in the 2-norm, ||got - want|| <= 0.25 ||want|| (granite's bound,
# tests/test_torch_moe.py), every other array within bf16's 2e-2.
MOE_PATH = ("ln2", "router", "we_gate", "we_up", "we_down")
MOE_PATH_BF16_L2 = 0.25


@pytest.mark.parametrize("impl,dtype", [("dense", "float32"),
                                        ("dense", "bfloat16"),
                                        ("ep", "float32")])
def test_loss_and_grads_match_reference(impl, dtype):
    """``api.loss`` (xent + 0.01 aux, through qk-norm and the untied
    unembedding) and its metrics and gradients against
    ``jax.value_and_grad(api.loss)``, each package under its (1, 1)
    context.  f32 within 1e-5 of each array's scale, the unembedding's
    gradient (rounded to bf16 in both: the logits come through a bf16 copy
    of the table) within one bf16 ulp more; bf16 as ``MOE_PATH`` says."""
    api, params, tapi, tparams = _apis(impl, dtype, vocab_chunk=8)
    batch = SyntheticLM(api.cfg.vocab, 20, 2, seed=1).batch(0)
    ref_ctx, ctx = _contexts(api.cfg.arch)
    with ref_use_mesh_context(ref_ctx):
        (want, wm), wg = jax.jit(jax.value_and_grad(
            api.loss, has_aux=True))(params, batch)
    leaves = {n: p.requires_grad_(True) for n, p in tparams.items()}
    with use_mesh_context(ctx):
        loss, metrics = tapi.loss(leaves, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
        names = sorted(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[n] for n in names])))
    tol = TOL[dtype]
    assert sorted(metrics) == sorted(wm) == ["aux", "xent"]
    _scale_close(loss, want, tol, "loss")
    for k in wm:
        _scale_close(metrics[k], wm[k], tol, k)
    for n in names:
        assert grads[n].dtype == leaves[n].dtype, n
        if dtype == "bfloat16" and n in MOE_PATH:
            got, ref = rec.np_(grads[n]), rec.np_(wg[n])
            assert np.linalg.norm(got - ref) <= \
                MOE_PATH_BF16_L2 * np.linalg.norm(ref), n
        else:
            _scale_close(grads[n], wg[n],
                         tol + (rec.BF16_ULP if n == "unembed" else 0),
                         f"grad {n}")


# ----------------------------------------------------------------- serving
@pytest.mark.parametrize("impl,dtype,attn", [
    ("dense", "float32", "naive"), ("dense", "bfloat16", "naive"),
    ("ep", "float32", "naive"), ("dense", "float32", "pallas")])
def test_prefill_and_decode_match_reference(impl, dtype, attn):
    """Prefill logits and cache, then 4 decode steps, through both
    packages' step builders on a (1, 1) mesh (B 4: the EP variant's decode
    capacity is ceil(4*2/16*2.0) = 1, so choices drop in both); the
    ``pallas`` case runs kimi's full-size dispatch (the flash kernel's
    plain version on the CPU, the reference's Pallas kernel in interpret
    mode)."""
    api, params, tapi, tparams = _apis(impl, dtype, attention_impl=attn)
    B, P, G = 4, 12, 4
    shape = ShapeConfig("p", P, B, "prefill")
    batch = make_token_batch(api.cfg, shape, seed=1)
    rules = ref_rules_for(api.cfg.arch)
    prefill = ref_make_prefill_step(api, _auto_mesh(), rules, shape,
                                    cache_len=P + G)
    decode = ref_make_decode_step(api, _auto_mesh(), rules,
                                  ShapeConfig("d", P + G, B, "decode"))
    tprefill = make_prefill_step(tapi, shape, cache_len=P + G)
    tdecode = make_decode_step(tapi)
    tol = TOL[dtype]
    logits, cache = prefill(params, batch)
    tlogits, tcache = tprefill(tparams,
                               {"tokens": torch.from_numpy(batch["tokens"])})
    _scale_close(tlogits, logits, tol, "prefill logits")
    for k in ("k", "v"):
        _scale_close(tcache[k], cache[k], tol, f"cache {k}")
    tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
    for i in range(G):
        pos = np.full((B,), P + i, np.int32)
        logits, cache = decode(params, cache, {"token": jnp.asarray(tok),
                                               "pos": jnp.asarray(pos)})
        tlogits, tcache = tdecode(tparams, tcache,
                                  {"token": torch.from_numpy(tok),
                                   "pos": torch.from_numpy(pos)})
        _scale_close(tlogits, logits, tol, f"decode step {i}")
        tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]


def test_decode_after_prefill_matches_a_longer_prefill():
    """Decoding token P after a prefill of P against one prefill of P + 1,
    dense in f32 at capacity factor E (8: at the smoke's 2.0 the two
    token counts drop different choices, 7.3e-5 apart): within 1e-5 of
    the logits' scale in the port, and the difference is the reference's
    within 1e-5."""
    api, params, tapi, tparams = _apis("dense", "float32", capacity=8.0)
    P = 9
    tokens = np.random.default_rng(P).integers(
        0, api.cfg.vocab, size=(2, P + 1)).astype(np.int32)
    step = {"token": tokens[:, P:], "pos": np.full((2,), P, np.int32)}
    _, cache = jax.jit(lambda p, b: api.prefill(p, b, P + 1))(
        params, {"tokens": tokens[:, :P]})
    want = np.asarray(jax.jit(api.decode_step)(params, cache, step)[0]) - \
        np.asarray(jax.jit(api.prefill)(params, {"tokens": tokens})[0])
    _, tcache = tapi.prefill(tparams, {"tokens": torch.from_numpy(
        tokens[:, :P])}, P + 1)
    longer, _ = tapi.prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    dec, _ = tapi.decode_step(tparams, tcache,
                              {k: torch.from_numpy(v) for k, v in
                               step.items()})
    rec.close(dec, longer, 1e-5, "decode against prefill")
    rec.close(rec.np_(dec) - rec.np_(longer), want, 1e-5,
              "difference against the reference's")


def test_serving_cache_saves_as_4_ranks_and_restores_on_1(tmp_path):
    """The KV cache after a prefill saved as 4 ranks and restored on one:
    bit-exact, verified, and the decode steps continued from it give the
    served tokens."""
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
    ck = TensorCheckpoint(DatasetStore(str(tmp_path), "w"))
    layout = layout_from_torch(cache)
    ck.save_layout(layout)
    save_torch(ck, cache, step=0,
               ownership=balanced_chunk_partition(layout, 4))
    ck_r = TensorCheckpoint(DatasetStore(str(tmp_path), "r"))
    restored = load_torch(ck_r, tapi.abstract_cache(B, P + G), step=0,
                          device="cpu")
    assert ck_r.verify_step(Comm(1), 0)
    for key, t in cache.items():
        np.testing.assert_array_equal(rec.bits(restored[key]), rec.bits(t),
                                      err_msg=key)
    first = torch.argmax(saved["logits"], -1).to(torch.int32)[:, None]
    with torch.inference_mode():
        toks = torch_serve.decode_steps(tapi, tparams, restored, first, P, G,
                                        torch.device("cpu"))
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(), out)


# --------------------------------------------------------------- Adafactor
def test_make_optimizer_returns_adafactor():
    opt = make_optimizer("adafactor")
    assert isinstance(opt, Adafactor) and opt.name == "adafactor"
    assert not opt.elementwise and make_optimizer("adamw").elementwise
    assert dataclasses.asdict(opt) == dataclasses.asdict(RefAdafactor())


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_adafactor_state_specs_match_reference(which):
    """The train state's specs under Adafactor: ``vr/`` (the last dim
    dropped) and ``vc/`` (the second last dropped) for every factored
    parameter, ``v/`` for the rest, with the reference's shapes, axes,
    dtypes and order."""
    from repro.train.step import train_state_specs as ref_specs

    get, tget = ((get_config, torch_get_config) if which == "full"
                 else (get_smoke_config, torch_smoke_config))
    want = ref_specs(build_model(get(ARCH)), RefAdafactor())
    got = train_state_specs(torch_build_model(tget(ARCH)), Adafactor())
    assert list(got) == list(want)
    for n, s in want.items():
        assert dataclasses.asdict(got[n]) == dataclasses.asdict(s), n
    assert "opt/vr/we_gate" in got and "opt/v/final_norm" in got
    if which == "full":
        assert got["opt/vc/we_gate"].shape == (61, 384, 2048)


# one parameter of each branch of ``Adafactor.update``: a vector (v/), a
# matrix, a layer stack of one (the whole-array branch), a layer stack of
# three (updated one leading slice at a time), expert stacks of one and of
# two layers, and a matrix with a dim of 1 (not factored)
ADAFACTOR_SHAPES = {"norm": (24,), "matrix": (24, 40), "stack1": (1, 16, 24),
                    "stack3": (3, 16, 24), "experts1": (1, 4, 16, 8),
                    "experts2": (2, 4, 16, 8), "column": (24, 1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adafactor_update_matches_reference(dtype):
    """Three ``update`` calls (steps 0, 1, 2; lr 1e-2) from the same
    parameters, gradients and zero slots: every slot within 1e-5 of its
    scale, every f32 parameter within 1e-5 of its scale, every bf16
    parameter within one bf16 ulp of the reference's element (the two
    round an f32 value that may differ in its last bits)."""
    rng = np.random.default_rng(0)
    specs = {n: ParamSpec(s, ("layers",) * len(s), dtype)
             for n, s in ADAFACTOR_SHAPES.items()}
    ref_specs = {n: RefParamSpec(s.shape, s.axes, s.dtype)
                 for n, s in specs.items()}
    host = {n: (rng.normal(size=s) * 0.05).astype(np.float32)
            for n, s in ADAFACTOR_SHAPES.items()}
    grads = [{n: rng.normal(size=s).astype(np.float32)
              for n, s in ADAFACTOR_SHAPES.items()} for _ in range(3)]
    ref, opt = RefAdafactor(), Adafactor()
    jp = {n: jnp.asarray(v, dtype) for n, v in host.items()}
    tp = params_from_jax({n: np.asarray(v) for n, v in jp.items()},
                         device="cpu")
    js, ts = ref.init(ref_specs), opt.init(specs)
    assert sorted(ts) == sorted(js)
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape, k
    update = jax.jit(ref.update)
    for step in range(3):
        jg = {n: jnp.asarray(g, dtype) for n, g in grads[step].items()}
        tg = params_from_jax({n: np.asarray(v) for n, v in jg.items()},
                             device="cpu")
        jp, js = update(jp, jg, js, jnp.float32(1e-2), jnp.int32(step))
        tp, ts = opt.update(tp, tg, ts, torch.tensor(1e-2),
                            torch.tensor(step, dtype=torch.int32))
        assert sorted(ts) == sorted(js)
        for k, v in js.items():
            assert ts[k].dtype == torch.float32, k
            _scale_close(ts[k], v, 1e-5, f"step {step} slot {k}")
        for n, v in jp.items():
            assert tp[n].dtype == getattr(torch, dtype), n
            if dtype == "float32":
                _scale_close(tp[n], v, 1e-5, f"step {step} param {n}")
            else:
                got, want = rec.np_(tp[n]), rec.np_(v)
                assert (np.abs(got - want) <= 2 ** -7 * np.abs(want)).all(), \
                    (step, n)
    assert all(float(np.abs(rec.np_(tp[n]) - rec.np_(jnp.asarray(
        host[n], dtype))).max()) > 0 for n in host), "a parameter never moved"


def test_sharded_step_refuses_adafactor_where_the_state_is_sharded():
    """No longer refused: the sharded step sums each of Adafactor's
    reductions over the groups that split the parameter's dims
    (``tests/test_torch_adafactor_mesh.py`` holds its values to the
    reference's).  On a (2, 2) mesh (a fake process group of 4, which
    builds the groups and moves nothing) the step builds, its state
    shardings are the rule table's, ``we_gate`` is split over both axes,
    and each factored slot lies as its parameter with the reduced dim
    dropped; a (1, 1) mapping builds as before."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs.base import ShapeConfig as TorchShapeConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train.step import make_train_step

    tapi = torch_build_model(torch_smoke_config(ARCH))
    shape = TorchShapeConfig("t", 16, 4, "train")
    rules = rules_for(torch_get_config(ARCH).arch)
    specs = train_state_specs(tapi, Adafactor())
    dist.init_process_group("fake", rank=0, world_size=4, store=FakeStore())
    try:
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        step = make_train_step(tapi, Adafactor(), lambda s: 1e-3, shape,
                               mesh=mesh, rules=rules)
        assert step.state_shardings == {
            n: rules.sharding_for(mesh, s.axes, s.shape)
            for n, s in specs.items()}
    finally:
        dist.destroy_process_group()
    sh = step.state_shardings
    assert sh["params/we_gate"] == [Shard(2), Shard(1)]
    assert sh["opt/vr/we_gate"] == [Shard(2), Shard(1)]
    assert sh["opt/vc/we_gate"] == [Replicate(), Shard(1)]
    assert sh["opt/vr/unembed"] == [Replicate(), Shard(0)]
    step = make_train_step(tapi, Adafactor(), lambda s: 1e-3, shape,
                           mesh={"data": 1, "model": 1})
    assert step.state_shardings["params/we_gate"] is not None


def test_adafactor_decay_bits_match_reference():
    """The decay ``1 - (step + 1) ** -0.8`` in f32, bit for bit with the
    reference's over steps 0-99 (``torch.pow`` with the exponent in f64 is
    an ulp off at 5 of them)."""
    steps = np.arange(100, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: 1.0 - (s + 1).astype(jnp.float32)
                               ** (-RefAdafactor().decay_pow))(steps))
    got = torch.stack([Adafactor().decay(torch.tensor(int(s),
                                                      dtype=torch.int32))
                       for s in steps]).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ------------------------------------------------------------------- train
def test_train_step_matches_reference():
    """Three one-device steps under Adafactor (f32), as
    ``rec.check_train_steps``: each parameter's change within 1e-5 of the
    reference's largest change plus one f32 spacing of the parameter
    (reads at most 4.6e-5 of the change, which is about 1e-4)."""
    rec.check_train_steps(ARCH, "float32")


def test_trainer_kill_and_resume_is_bit_exact(tmp_path):
    """Runs A, B and C of the trainer on an Adafactor state."""
    rec.check_kill_and_resume(ARCH, tmp_path)


def test_adafactor_train_state_crosses_between_the_packages(tmp_path):
    rec.check_train_state_cross_loads(ARCH, tmp_path)


# ------------------------------------------------------------- launchers
def test_serve_launcher_cpu(capsys):
    torch_serve.main(["--arch", "kimi-k2-1t-a32b", "--smoke", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "12",
                      "--gen-len", "3"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["arch"] == "kimi-k2-smoke" and line["device"] == "cpu"
    assert line["gen_len"] == 3 and len(line["sample_tokens"]) == 4


def test_train_launcher_cpu(tmp_path, capsys):
    """The train launcher builds the config's optimizer: Adafactor."""
    torch_train_launcher.main(["--arch", "kimi-k2-1t-a32b", "--smoke",
                               "--steps", "10", "--batch", "2", "--seq", "16",
                               "--ckpt-dir", str(tmp_path), "--ckpt-every",
                               "5", "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[-1]["saved_steps"] == [5, 10]
    assert np.isfinite(lines[-1]["final_loss"])

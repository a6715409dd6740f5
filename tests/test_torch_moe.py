"""The port's MoE family against the JAX package's, in one process: the
granite-moe-3b-a800m config copy, the dense one-hot ``moe_ffn`` and the
expert-parallel ``moe_ffn_ep`` on a mesh of one process, the granite smoke
model (dense, and its EP variant with 8 phantom experts) through the loss,
its gradients, prefill and decode, the one-device train step, the serving
step builders and the launchers.

Inputs are made with seeded NumPy and handed to both packages.  The
reference's EP variant runs through its step builders on an Auto-axis (1,
1) mesh (the installed jax's ``make_debug_mesh`` gives Explicit axes:
ROADMAP.md, Reference caveats).  Tolerances, unless a test says otherwise:
f32 1e-5 and bf16 2e-2, each relative to the array's own largest value.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.ast_copy import normalised
from jax.sharding import AxisType

import repro.configs.granite_moe_3b_a800m as ref_granite
from repro.configs import get_config, get_smoke_config
from repro.configs.base import ShapeConfig
from repro.distrib import sharding as ref_sharding
from repro.distrib.context import MeshContext as RefMeshContext
from repro.distrib.context import use_mesh_context as ref_use_mesh_context
from repro.distrib.rules import rules_for as ref_rules_for
from repro.models import moe as ref_moe
from repro.models.api import build_model, make_token_batch
from repro.train import schedule as ref_schedule
from repro.train.data import SyntheticLM
from repro.train.optim import AdamW as RefAdamW
from repro.train.step import init_train_state as ref_init_train_state
from repro.train.step import make_decode_step as ref_make_decode_step
from repro.train.step import make_prefill_step as ref_make_prefill_step
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.configs import granite_moe_3b_a800m
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.torch_io import layout_from_torch
from repro_torch.distrib import mesh_context
from repro_torch.distrib.rules import placements_for, rules_for
from repro_torch.launch import serve as torch_serve
from repro_torch.launch import train as torch_train_launcher
from repro_torch.models import moe
from repro_torch.models.api import build_model as torch_build_model
from repro_torch.train import schedule
from repro_torch.train.optim import AdamW
from repro_torch.train.step import (ONE_DEVICE, make_decode_step,
                                    make_prefill_step, make_train_step)

ARCH = "granite_moe_3b_a800m"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


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


def _ref_ctx(arch: str):
    """The context the reference's step builders install on a (1, 1)
    Auto mesh."""
    rules = ref_rules_for(arch)
    return RefMeshContext(mesh=_auto_mesh(), dp_axes=rules.batch_axes,
                          ep_axis="model", fsdp_axis=rules.table["embed"],
                          rules=rules)


def _variant(cfg, impl: str, **kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            impl=impl), **kw)


def _apis(impl: str, dtype: str, **kw):
    cfg = _variant(get_smoke_config(ARCH), impl, dtype=dtype, **kw)
    tcfg = _variant(torch_smoke_config(ARCH), impl, dtype=dtype, **kw)
    api, tapi = build_model(cfg), torch_build_model(tcfg)
    params = api.init(jax.random.key(0))
    tparams = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    return api, params, tapi, tparams


# ------------------------------------------------------------- the config
def test_granite_config_is_a_copy_of_the_reference():
    """The module's tree is the reference's; both configs are equal, and
    the full one pads 40 experts to 48 for EP."""
    assert normalised(granite_moe_3b_a800m) == normalised(ref_granite)
    assert (dataclasses.asdict(torch_get_config("granite-moe-3b-a800m"))
            == dataclasses.asdict(get_config(ARCH)))
    assert (dataclasses.asdict(torch_smoke_config(ARCH))
            == dataclasses.asdict(get_smoke_config(ARCH)))
    full = torch_get_config(ARCH)
    assert full.moe.impl == "ep" and full.moe.num_experts_padded == 48
    assert _variant(torch_smoke_config(ARCH), "ep").moe.num_experts_padded \
        == 16


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_param_specs_match_reference(impl):
    api, params, tapi, tparams = _apis(impl, "bfloat16")
    assert sorted(tapi.param_specs) == sorted(api.param_specs)
    for name, spec in api.param_specs.items():
        assert dataclasses.asdict(tapi.param_specs[name]) == \
            dataclasses.asdict(spec), name


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_params_from_jax_carries_granite_params(impl):
    """The reference's granite smoke init, dense and EP-padded (its 8
    phantom experts' router columns and weights included), bit for bit."""
    _, params, _, tparams = _apis(impl, "bfloat16")
    assert sorted(tparams) == sorted(params)
    for k, v in params.items():
        v = np.asarray(v)
        assert tuple(tparams[k].shape) == v.shape, k
        assert tparams[k].reshape(-1).view(torch.uint8).numpy().tobytes() \
            == np.ascontiguousarray(v).tobytes(), k


def test_full_granite_placements_cut_the_reference_boxes():
    """Granite's full parameters (48 experts, D 1536) on 2x2, 4x2, 2x4 and
    16x16 meshes: each spec is the reference's, and its DTensor placements'
    local box is ``sharding.device_box`` at every coordinate; the expert
    arrays chunk 16-wide over the experts (3 experts a chunk)."""
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset)
    specs = torch_build_model(torch_get_config(ARCH)).param_specs
    rules, ref = rules_for(get_config(ARCH).arch), \
        ref_rules_for(get_config(ARCH).arch)
    for mesh in [(2, 2), (4, 2), (2, 4), (16, 16)]:
        sizes = {"data": mesh[0], "model": mesh[1]}
        meta = type("Mesh", (), {"shape": sizes})()   # what spec_for reads
        for name in ("router", "we_gate", "we_up", "we_down", "wq", "embed"):
            s = specs[name]
            spec = rules.spec_for(s.axes, s.shape, meta)
            assert spec == tuple(ref.spec_for(s.axes, s.shape, meta)), name
            pl = placements_for(spec, sizes)
            for c in [(d, m) for d in range(mesh[0]) for m in range(mesh[1])]:
                box = ref_sharding.device_box(s.shape, sizes, spec,
                                              dict(zip(sizes, c)))
                shape, off = _compute_local_shape_and_global_offset(
                    s.shape, list(mesh), list(c), pl)
                assert (tuple(off), tuple(o + n for o, n in zip(off, shape))) \
                    == (box.start, box.stop), (name, mesh, c)
    layout = layout_from_torch(torch_build_model(
        dataclasses.replace(torch_get_config(ARCH), num_layers=2))
        .abstract_params())
    we = {a.name: a for a in layout.arrays}["we_gate"]
    assert we.shape == (2, 48, 1536, 512) and we.chunk_shape[1] == 3


# ----------------------------------------------------------- moe_ffn parity
def _moe_inputs(B, S, D, E, Fd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, D)).astype(np.float32),
            rng.normal(size=(D, E)).astype(np.float32),
            (rng.normal(size=(E, D, Fd)) * 0.1).astype(np.float32),
            (rng.normal(size=(E, D, Fd)) * 0.1).astype(np.float32),
            (rng.normal(size=(E, Fd, D)) * 0.1).astype(np.float32)]


def _ref_grads(fn, inputs, dtype):
    """(y, aux) and the gradients of sum(y^2) + aux for every input, by
    ``jax.value_and_grad``."""
    def loss(*a):
        y, aux = fn(*a)
        return (y.astype(jnp.float32) ** 2).sum() + aux, (y, aux)
    args = [jnp.asarray(a, JDT[dtype]) for a in inputs]
    (_, (y, aux)), g = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(5)), has_aux=True))(*args)
    return y, aux, g


def _port_grads(fn, inputs, dtype):
    t = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(True)
         for a in inputs]
    y, aux = fn(*t)
    g = torch.autograd.grad((y.float() ** 2).sum() + aux, t)
    return y, aux, g


NAMES = ["x", "router", "w_gate", "w_up", "w_down"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_real", [8, 6], ids=["real", "phantoms"])
def test_moe_ffn_matches_reference(num_real, dtype):
    """The dense oracle at the default capacity (choices drop: the output
    differs from that at capacity E), with and without phantom experts:
    y, aux and the gradients of x, the router and the three expert
    arrays."""
    inputs = _moe_inputs(2, 16, 32, 8, 16)
    kw = dict(top_k=2, capacity_factor=1.25, num_real=num_real)
    y, aux, g = _ref_grads(lambda *a: ref_moe.moe_ffn(*a, **kw), inputs,
                           dtype)
    ty, taux, tg = _port_grads(lambda *a: moe.moe_ffn(*a, **kw), inputs,
                               dtype)
    tol = TOL[dtype]
    _close(ty, y, tol, "y")
    _close(taux, aux, tol, "aux")
    for n, a, b in zip(NAMES, tg, g):
        assert a.dtype == getattr(torch, dtype)
        _close(a, b, tol, f"grad {n}")
    full, _ = moe.moe_ffn(*[torch.from_numpy(a) for a in inputs],
                          **dict(kw, capacity_factor=8.0))
    assert not torch.allclose(full, ty.float().detach()), "nothing dropped"


# the reference's EP at its default capacity on a (1, 1) mesh, and the
# port's: (B, S, D, E padded, F, top_k, num_real); the last is granite's
# decode at B 4 (T 4): capacity ceil(4*8/48*1.25) = 1, most choices drop
EP_CASES = [(2, 16, 32, 12, 16, 2, 8), (4, 1, 32, 48, 8, 8, 40)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", EP_CASES, ids=["prefill", "decode_c1"])
def test_moe_ffn_ep_matches_reference_ep_on_one_process(case, dtype):
    """The port's ``moe_ffn_ep`` with a model axis of 1 (no collective)
    against the reference's ``moe_ffn_ep`` on a (1, 1) mesh, at the default
    capacity 1.25 with phantom experts: y, aux, every gradient.  bf16: the
    port sums a token's top_k outputs at once, the reference adds them one
    by one, each rounded to bf16."""
    B, S, D, E, Fd, K, num_real = case
    inputs = _moe_inputs(B, S, D, E, Fd, seed=1)
    kw = dict(top_k=K, capacity_factor=1.25, num_real=num_real)
    cap = max(1, math.ceil(B * S * K / E * 1.25))
    if case == EP_CASES[1]:
        assert cap == 1
    mesh = _auto_mesh()
    y, aux, g = _ref_grads(lambda *a: ref_moe.moe_ffn_ep(*a, mesh=mesh, **kw),
                           inputs, dtype)
    ty, taux, tg = _port_grads(
        lambda *a: moe.moe_ffn_ep(*a, mesh=ONE_DEVICE, **kw), inputs, dtype)
    tol = TOL[dtype]
    _close(ty, y, tol, "y")
    _close(taux, aux, tol, "aux")
    for n, a, b in zip(NAMES, tg, g):
        _close(a, b, tol, f"grad {n}")


def test_moe_ffn_ep_matches_dense_oracle_when_nothing_drops():
    """At capacity factor E nothing drops on either path: the port's EP
    (one process) equals the port's dense oracle in f32, y, aux and every
    gradient, the router's included."""
    inputs = _moe_inputs(4, 16, 32, 8, 16, seed=2)
    kw = dict(top_k=2, capacity_factor=8.0, num_real=8)
    ey, eaux, eg = _port_grads(
        lambda *a: moe.moe_ffn_ep(*a, mesh=ONE_DEVICE, **kw), inputs,
        "float32")
    dy, daux, dg = _port_grads(lambda *a: moe.moe_ffn(*a, **kw), inputs,
                               "float32")
    _close(ey, dy, 1e-5, "y")
    _close(eaux, daux, 1e-5, "aux")
    for n, a, b in zip(NAMES, eg, dg):
        _close(a, b, 1e-5, f"grad {n}")


def test_reference_aux_differs_between_its_paths_with_phantoms():
    """Pinned reference behaviour (ROADMAP.md, Reference caveats): with
    phantom experts the dense oracle scales its aux loss by the padded
    count E, the EP path by the real count, so at capacity E (nothing
    dropped) the two aux values differ by E / num_real while y and the
    router's gradient through y agree.  The port keeps both formulas."""
    E, num_real = 12, 8
    inputs = [jnp.asarray(a) for a in _moe_inputs(2, 16, 32, E, 16)]
    kw = dict(top_k=2, capacity_factor=float(E), num_real=num_real)
    y_d, aux_d = ref_moe.moe_ffn(*inputs, **kw)
    y_e, aux_e = jax.jit(lambda *a: ref_moe.moe_ffn_ep(
        *a, mesh=_auto_mesh(), **kw))(*inputs)
    _close(y_e, y_d, 1e-5, "y")
    np.testing.assert_allclose(float(aux_d) / float(aux_e), E / num_real,
                               rtol=1e-5)

    def router_grad(fn):
        return jax.grad(lambda r: (fn(inputs[0], r, *inputs[2:], **kw)[0]
                                   ** 2).sum())(inputs[1])
    ep = functools.partial(ref_moe.moe_ffn_ep, mesh=_auto_mesh())
    _close(jax.jit(lambda: router_grad(ep))(), router_grad(ref_moe.moe_ffn),
           1e-5, "router grad through y")
    t = [torch.from_numpy(np.asarray(a)) for a in inputs]
    _, taux_d = moe.moe_ffn(*t, **kw)
    _, taux_e = moe.moe_ffn_ep(*t, mesh=ONE_DEVICE, **kw)
    _close(taux_d, aux_d, 1e-5, "port dense aux")
    _close(taux_e, aux_e, 1e-5, "port EP aux")


def test_moe_ffn_ep_refuses_what_the_reference_refuses():
    """E not divisible by the model axis raises, as the reference asserts;
    so do expert arrays that are not this process's share."""
    x, r, wg, wu, wd = [torch.from_numpy(a)
                        for a in _moe_inputs(1, 4, 8, 6, 4)]
    with pytest.raises(ValueError, match="not divisible by model=4"):
        moe.moe_ffn_ep(x, r, wg, wu, wd, top_k=2, capacity_factor=1.25,
                       num_real=6, mesh={"data": 1, "model": 4})
    with pytest.raises(ValueError, match="expected this process's 3 of 6"):
        moe.moe_ffn_ep(x, r, wg, wu, wd, top_k=2, capacity_factor=1.25,
                       num_real=6, mesh={"data": 1, "model": 2})


# ------------------------------------------------------------ granite smoke
# The arrays whose gradient flows only through the MoE layers' routing and
# experts.  In bf16 a routing choice near a tie can flip between the two
# packages (their activations round at different places): with this test's
# inputs one of the first layer's 80 choices flips (none in f32), and a
# flipped choice moves a whole token's contribution between two experts.
# These arrays are then held in the 2-norm, ||got - want|| <= 0.25 ||want||
# (measured on the CPU: 0.114 at most, dense and EP); every other array,
# the loss and the metrics keep bf16's 2e-2.
MOE_PATH = ("ln2", "router", "we_gate", "we_up", "we_down")
MOE_PATH_BF16_L2 = 0.25


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_granite_loss_and_grads_match_reference(impl, dtype):
    """``api.loss`` (xent + 0.01 aux) and its metrics and gradients against
    ``jax.value_and_grad(api.loss)``; the EP variant under each package's
    (1, 1) mesh context (the port's one-device step installs the same).
    f32 1e-5 for every array; bf16 as ``MOE_PATH`` says."""
    api, params, tapi, tparams = _apis(impl, dtype, vocab_chunk=8)
    batch = SyntheticLM(api.cfg.vocab, 20, 2, seed=1).batch(0)
    fn = jax.jit(jax.value_and_grad(api.loss, has_aux=True))
    with ref_use_mesh_context(_ref_ctx(api.cfg.arch)):
        (want, wm), wg = fn(params, batch)
    leaves = {n: p.requires_grad_(True) for n, p in tparams.items()}
    from repro_torch.distrib import use_mesh_context
    from repro_torch.train.step import mesh_context_for
    with use_mesh_context(mesh_context_for(ONE_DEVICE,
                                           rules_for(tapi.cfg.arch))):
        loss, metrics = tapi.loss(leaves, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
        names = sorted(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[n] for n in names])))
    tol = TOL[dtype]
    assert sorted(metrics) == sorted(wm) == ["aux", "xent"]
    assert float(metrics["aux"]) > 0
    _close(loss, want, tol, "loss")
    for k in wm:
        _close(metrics[k], wm[k], tol, k)
    for n in names:
        assert grads[n].dtype == leaves[n].dtype
        if dtype == "bfloat16" and n in MOE_PATH:
            got, want = _np(grads[n]), _np(wg[n])
            assert np.linalg.norm(got - want) <= \
                MOE_PATH_BF16_L2 * np.linalg.norm(want), n
        else:
            _close(grads[n], wg[n], tol, f"grad {n}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_granite_prefill_and_decode_match_reference(impl, dtype):
    """Prefill logits and cache, then 4 decode steps, through both
    packages' step builders on a (1, 1) mesh (B 4: the EP variant's decode
    capacity is ceil(4*2/16*2.0) = 1, so choices drop in both)."""
    api, params, tapi, tparams = _apis(impl, dtype)
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
    _close(tlogits, logits, tol, "prefill logits")
    for k in ("k", "v"):
        _close(tcache[k], cache[k], tol, f"cache {k}")
    tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
    for i in range(G):
        pos = np.full((B,), P + i, np.int32)
        logits, cache = decode(params, cache, {"token": jnp.asarray(tok),
                                               "pos": jnp.asarray(pos)})
        tlogits, tcache = tdecode(tparams, tcache,
                                  {"token": torch.from_numpy(tok),
                                   "pos": torch.from_numpy(pos)})
        _close(tlogits, logits, tol, f"decode step {i}")
        tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]


def test_serve_step_builders_install_the_context():
    """The builders run their function under a (1, 1) context and refuse
    larger meshes, naming the ROADMAP item."""
    tapi = torch_build_model(_variant(torch_smoke_config(ARCH), "ep"))
    seen = []
    step = make_prefill_step(dataclasses.replace(
        tapi, prefill=lambda p, b, Smax: seen.append(
            (mesh_context(), Smax))), ShapeConfig("p", 8, 2, "prefill"),
        cache_len=12)
    step({}, {})
    ctx, Smax = seen[0]
    assert Smax == 12 and ctx.mesh == ONE_DEVICE and ctx.ep_axis == "model"
    assert ctx.dp_axes == ("data",)
    assert mesh_context() is None
    for build in (lambda m: make_prefill_step(
            tapi, ShapeConfig("p", 8, 2, "prefill"), mesh=m),
            lambda m: make_decode_step(tapi, mesh=m)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
            build({"data": 2, "model": 1})


def test_build_model_admits_moe_and_refuses_the_rest():
    """granite builds, and ``enc_dec`` now dispatches to the whisper
    family, as the reference's ``build_model`` does, whatever the
    config's family says (nothing is refused any more)."""
    from repro_torch.models import whisper

    torch_build_model(torch_get_config(ARCH))
    cfg = dataclasses.replace(torch_smoke_config("smollm_135m"),
                              family="audio", enc_dec=True)
    api = torch_build_model(cfg)
    assert sorted(api.param_specs) == sorted(whisper.param_specs(cfg))
    assert "dec/xk" in api.param_specs
    assert sorted(api.cache_specs(2, 8)) == ["k", "length", "v", "xk",
                                             "xv"]


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_one_device_train_step_matches_reference(impl):
    """Three steps of the port's one-device step (which installs a (1, 1)
    context, so the EP variant runs ``moe_ffn_ep``) against the
    reference's ``make_train_step`` on a (1, 1) Auto mesh, f32: metrics
    (``xent`` and ``aux`` among them) and slots within 1e-5 of their scale,
    the embedding's within 1e-4 (both packages unembed through a bf16
    copy, so its logit gradient is rounded to bf16: 2.3e-5 measured);
    parameters within that plus 2 lr-sized AdamW steps (a gradient near 0
    may take either sign)."""
    cfg = _variant(get_smoke_config(ARCH), impl, dtype="float32")
    tcfg = _variant(torch_smoke_config(ARCH), impl, dtype="float32")
    api, tapi = build_model(cfg), torch_build_model(tcfg)
    shape = ShapeConfig("t", 16, 4, "train")
    kw = dict(base_lr=1e-3, warmup=2, total=100)
    ref_step = ref_make_train_step(
        api, RefAdamW(), lambda s: ref_schedule.warmup_cosine(s, **kw),
        _auto_mesh(), ref_rules_for(cfg.arch), shape, donate=False)
    step = make_train_step(tapi, AdamW(),
                           lambda s: schedule.warmup_cosine(s, **kw), shape)
    jstate = ref_init_train_state(api, RefAdamW(), jax.random.key(0))
    tstate = params_from_jax({k: np.asarray(v) for k, v in jstate.items()},
                             device="cpu")
    data = SyntheticLM(cfg.vocab, 16, 4, seed=0)
    for i in range(3):
        batch = data.batch(i)
        jstate, jm = ref_step(jstate, batch)
        tstate, tm = step(tstate, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
        assert sorted(tm) == sorted(jm) == ["aux", "grad_norm", "loss", "lr",
                                            "xent"]
        for k in jm:
            _close(tm[k], jm[k], 1e-5, f"step {i} metric {k}")
    for k, v in jstate.items():
        tol = 1e-4 if k.endswith("/embed") else 1e-5
        if k.startswith("params/"):
            tol += 2e-3 / float(np.abs(np.asarray(v, np.float32)).max())
        _close(tstate[k], v, tol, k)


# ----------------------------------------------------------------- launchers
def test_serve_launcher_granite_cpu(capsys):
    """The serving launcher on granite's smoke config through the step
    builders; the EP variant's ``serve_batch`` runs ``moe_ffn_ep`` in every
    layer of the prefill and of each decode step, and gives the tokens of
    a direct ``api.prefill`` / ``decode_step`` loop under the same
    context."""
    torch_serve.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                      "--device", "cpu", "--prompt-len", "8", "--gen-len",
                      "4"])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["arch"] == "granite-moe-smoke" and line["gen_len"] == 4
    tapi = torch_build_model(_variant(torch_smoke_config(ARCH), "ep"))
    params = tapi.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, tapi.cfg.vocab, (4, 8)).astype(np.int32))
    moe.calls = 0
    out, _ = torch_serve.serve_batch(tapi, params, {"tokens": tokens}, 4,
                                     torch.device("cpu"))
    assert moe.calls == tapi.cfg.num_layers * (1 + 4)
    prefill = make_prefill_step(tapi, ShapeConfig("p", 8, 4, "prefill"),
                                cache_len=12)
    decode = make_decode_step(tapi)
    with torch.inference_mode():
        logits, cache = prefill(params, {"tokens": tokens})
        toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
        for i in range(4):
            logits, cache = decode(params, cache, {
                "token": toks[-1], "pos": torch.full((4,), 8 + i,
                                                     dtype=torch.int32)})
            toks.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
    np.testing.assert_array_equal(out, torch.cat(toks, 1).numpy())


def test_train_launcher_granite_cpu(tmp_path, capsys):
    """The train launcher takes ``--arch granite_moe_3b_a800m`` (its smoke
    config) and reports a finite loss."""
    torch_train_launcher.main(["--arch", "granite_moe_3b_a800m", "--smoke",
                               "--steps", "10", "--batch", "2", "--seq", "16",
                               "--ckpt-dir", str(tmp_path), "--ckpt-every",
                               "5", "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["saved_steps"] == [5, 10] and np.isfinite(last["final_loss"])


def test_remat_recompute_runs_under_the_forward_context():
    """A checkpointed span is recomputed in the backward pass on whatever
    thread runs it (on a card, the autograd engine's own), where the
    thread-local ``MeshContext`` is not installed: the span must install
    the context its forward ran under, or the recompute would take the
    dense path and refuse the saved tensors.  Here the backward runs on a
    second thread; its gradients equal those of a backward on this one."""
    import threading

    from repro_torch.distrib import use_mesh_context
    from repro_torch.train.step import mesh_context_for

    tcfg = _variant(torch_smoke_config(ARCH), "ep", dtype="float32",
                    remat=True)
    tapi = torch_build_model(tcfg)
    params = tapi.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        tcfg.vocab, 16, 2, seed=0).batch(0).items()}
    ctx = mesh_context_for(ONE_DEVICE, rules_for(tcfg.arch))

    def grads(elsewhere: bool):
        leaves = {n: p.clone().requires_grad_(True)
                  for n, p in params.items()}
        with use_mesh_context(ctx):
            loss, _ = tapi.loss(leaves, batch)
        out = {}

        def backward():
            out["g"] = torch.autograd.grad(loss, list(leaves.values()))
        if elsewhere:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        else:
            with use_mesh_context(ctx):
                backward()
        return out["g"]

    for a, b in zip(grads(True), grads(False)):
        assert torch.equal(a, b)

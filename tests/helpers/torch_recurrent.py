"""Checks shared by the port tests of the recurrent families, whisper and
kimi-k2 (``test_torch_rglru_train.py``, ``test_torch_xlstm.py``,
``test_torch_whisper.py``, ``test_torch_kimi.py``): each family's smoke
config in both packages on the reference's own parameters, the loss and
its gradients, three train steps under the config's optimizer, the
trainer's kill and resume, and the train state crossing between the
packages' checkpoints.  An encoder-decoder's batches carry seeded
``enc_frames`` (``with_frames``).

Tolerances: f32 1e-5 and bf16 2e-2, each relative to ``1 + max |want|``
of the array (the repo's tolerances)."""

from __future__ import annotations

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.core.jax_io import layout_from_jax, load_jax, save_jax
from repro.core.store import DatasetStore
from repro.core.tensor_ckpt import TensorCheckpoint
from repro.distrib.rules import rules_for
from repro.models.api import build_model
from repro.train import schedule as ref_schedule
from repro.train.data import SyntheticLM as RefSyntheticLM
from repro.train.optim import make_optimizer as ref_make_optimizer
from repro.train.step import init_train_state as ref_init_train_state
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.store import DatasetStore as TorchStore
from repro_torch.core.tensor_ckpt import TensorCheckpoint as TorchCheckpoint
from repro_torch.core.torch_io import layout_from_torch, load_torch, save_torch
from repro_torch.distrib.context import mesh_context, use_mesh_context
from repro_torch.distrib.rules import rules_for as torch_rules_for
from repro_torch.models.api import build_model as torch_build_model
from repro_torch.train import schedule
from repro_torch.train.data import SyntheticLM
from repro_torch.train.loop import (SimulatedPreemption, TorchTrainer,
                                    TrainerConfig)
from repro_torch.train.optim import make_optimizer
from repro_torch.train.step import (ONE_DEVICE, init_train_state,
                                    make_train_step, mesh_context_for,
                                    train_state_specs)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# one bf16 ulp, relative: the extra room of an array whose gradient is
# rounded to bf16 in both packages (a table unembedded through a bf16
# copy), where a last-bit difference before the rounding moves an element
# by a whole ulp
BF16_ULP = 2.0 ** -8
SHAPE = ShapeConfig("t", 32, 4, "train")


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def close(got, want, tol, what="", ulp=0.0):
    """|got - want| <= tol * (1 + max |want|) + ulp * max |want|
    elementwise."""
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    top = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    bound = tol * (1.0 + top) + ulp * top
    assert err <= bound, f"{what}: max |diff| {err} > {bound}"


def bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(t)).reshape(-1).view(np.uint8)


def with_frames(cfg, batch: dict, seed: int = 7) -> dict:
    """``batch`` plus, for an encoder-decoder, ``enc_frames`` [B, Se, D]
    drawn from ``seed`` (normal, scale 0.5, f32: ``make_token_batch``'s
    draw); ``SyntheticLM`` makes tokens only."""
    if not cfg.enc_dec:
        return batch
    B = batch["tokens"].shape[0]
    frames = np.random.default_rng(seed).normal(
        size=(B, cfg.encoder_seq, cfg.d_model), scale=0.5).astype("float32")
    return {**batch, "enc_frames": frames}


def apis(arch: str, **kw):
    """(reference api, its params from key(0), port api, the same params
    as port tensors) on the smoke config with ``kw`` replaced in both."""
    cfg = dataclasses.replace(get_smoke_config(arch), **kw)
    tcfg = dataclasses.replace(torch_smoke_config(arch), **kw)
    api, tapi = build_model(cfg), torch_build_model(tcfg)
    params = api.init(jax.random.key(0))
    tparams = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    return api, params, tapi, tparams


def check_loss_and_grads(arch: str, dtype: str, S: int = 20, loose=(),
                         **kw):
    """``api.loss`` and every gradient against ``jax.value_and_grad`` (S
    over vocab chunks of 8, so the last chunk pads), at ``TOL[dtype]``;
    the gradients of the parameters named in ``loose`` at one
    ``BF16_ULP`` of their own scale more."""
    api, params, tapi, tparams = apis(arch, dtype=dtype, vocab_chunk=8,
                                      **kw)
    batch = with_frames(api.cfg,
                        RefSyntheticLM(api.cfg.vocab, S, 2, seed=1).batch(0))
    (want, wmetrics), wgrads = jax.jit(jax.value_and_grad(
        api.loss, has_aux=True))(params, batch)
    leaves = {n: p.requires_grad_(True) for n, p in tparams.items()}
    loss, metrics = tapi.loss(leaves, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    names = sorted(leaves)
    grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n]
                                                        for n in names])))
    assert sorted(metrics) == sorted(wmetrics)
    close(loss, want, TOL[dtype], "loss")
    for n in names:
        assert grads[n].dtype == leaves[n].dtype, n
        assert np.isfinite(np_(grads[n])).all(), n
        close(grads[n], wgrads[n], TOL[dtype], f"grad {n}",
              ulp=BF16_ULP if n in loose else 0.0)


def _sched(base_lr=1e-3):
    return (functools.partial(ref_schedule.warmup_cosine, base_lr=base_lr,
                              warmup=2, total=100),
            functools.partial(schedule.warmup_cosine, base_lr=base_lr,
                              warmup=2, total=100))


def check_train_steps(arch: str, dtype: str):
    """Three steps of ``make_train_step`` under the config's optimizer
    against the reference's, built on an Auto-axis (1, 1) mesh (the
    installed jax's ``make_debug_mesh`` gives Explicit axes: ROADMAP.md,
    Reference caveats).  Metrics and f32 slots within ``TOL[dtype]``.
    Under AdamW the parameters within it plus 2 lr-sized steps (an update
    is about lr whatever the gradient, so a gradient near 0 may take
    either sign in the two libraries).  Under Adafactor, whose steps are
    some lr * RMS(p) (about 1e-4 here) and come from the factored second
    moment, not from one element's sign, each parameter's change over the
    three steps matches the reference's within ``TOL[dtype]`` of the
    largest change, plus one spacing of the parameter's dtype at its
    largest value (the rounding of the stored parameter)."""
    api, _, tapi, _ = apis(arch, dtype=dtype)
    jsched, tsched = _sched()
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ref_opt = ref_make_optimizer(api.cfg.optimizer)
    opt = make_optimizer(tapi.cfg.optimizer)
    assert opt.name == ref_opt.name
    ref_step = ref_make_train_step(api, ref_opt, jsched, mesh,
                                   rules_for(api.cfg.arch), SHAPE,
                                   donate=False)
    step = make_train_step(tapi, opt, tsched, SHAPE)
    jstate = ref_init_train_state(api, ref_opt, jax.random.key(0))
    # on the step's own shardings, so that its first call and the next
    # share one trace
    jstate = jax.device_put(jstate, ref_step.state_shardings)
    start = {k: np_(v) for k, v in jstate.items() if k.startswith("params/")}
    tstate = params_from_jax({k: np.asarray(v) for k, v in jstate.items()},
                             device="cpu")
    data = SyntheticLM(api.cfg.vocab, SHAPE.seq_len, SHAPE.global_batch,
                       seed=0)
    tol = TOL[dtype]
    for i in range(3):
        batch = with_frames(api.cfg, data.batch(i), seed=i)
        jstate, jm = ref_step(jstate, batch)
        tstate, tm = step(tstate, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
        assert sorted(tm) == sorted(jm), i
        for k in jm:
            close(tm[k], jm[k], tol, f"step {i} metric {k}")
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    for k, v in jstate.items():
        if not k.startswith("params/"):
            close(tstate[k], v, tol, k)
        elif opt.name != "adafactor":
            close(tstate[k], v, tol + 2e-3, k)
        else:
            got, want = np_(tstate[k]) - start[k], np_(v) - start[k]
            top = float(np.abs(np_(v)).max())
            spacing = torch.finfo(tstate[k].dtype).eps * 2.0 ** np.floor(
                np.log2(top))
            err = float(np.abs(got - want).max())
            bound = tol * float(np.abs(want).max()) + spacing
            assert err <= bound, f"{k}: change off by {err} > {bound}"


def _trainer(arch: str, path, ckpt_every: int, S: int = 16, B: int = 2):
    cfg = torch_smoke_config(arch)
    api = torch_build_model(cfg)
    opt = make_optimizer(cfg.optimizer)
    step = make_train_step(api, opt, _sched(3e-3)[1],
                           ShapeConfig("t", S, B, "train"))
    return TorchTrainer(step, SyntheticLM(cfg.vocab, S, B, seed=0),
                        TrainerConfig(ckpt_dir=str(path),
                                      ckpt_every=ckpt_every, log_every=1),
                        device="cpu",
                        init_state_fn=lambda: init_train_state(
                            api, opt, torch.Generator().manual_seed(0)))


def check_kill_and_resume(arch: str, path):
    """Run A: 6 steps straight.  Run B: a save every 2 steps through the
    async checkpointer, preempted at step 5.  Run C, a fresh trainer:
    restores step 4 and runs to 6.  C ends in A's state and losses, bit
    for bit."""
    ta = _trainer(arch, path / "a", 0)
    ra = ta.run(6)
    tb = _trainer(arch, path / "b", 2)
    with pytest.raises(SimulatedPreemption):
        tb.run(6, fail_at=5)
    tc = _trainer(arch, path / "b", 2)
    state, start = tc.restore_latest()
    assert start == 4
    rc = tc.run(6, start_state=state, start_step=start)
    assert [h["step"] for h in tc.history] == [5, 6]
    assert [h["loss"] for h in tc.history] == \
        [h["loss"] for h in ta.history][4:]
    assert sorted(ra["state"]) == sorted(rc["state"])
    for k, v in ra["state"].items():
        assert v.dtype == rc["state"][k].dtype, k
        assert torch.equal(v, rc["state"][k]), k


def check_train_state_cross_loads(arch: str, path):
    """A reference train state (bf16 parameters, the config's optimizer's
    f32 slots, a 0-d step) saved by ``save_jax`` restores through
    ``load_torch`` bit for bit; saved back by ``save_torch`` it restores
    through ``load_jax`` bit for bit."""
    api = build_model(get_smoke_config(arch))
    state = ref_init_train_state(api, ref_make_optimizer(api.cfg.optimizer),
                                 jax.random.key(1))
    state = {k: (v + 1 if k.startswith("opt/") else v)
             for k, v in state.items()}
    state["step"] = jnp.int32(12)
    ck = TensorCheckpoint(DatasetStore(str(path / "jax"), "w"))
    ck.save_layout(layout_from_jax(state))
    save_jax(ck, state, step=12)
    tcfg = torch_smoke_config(arch)
    specs = train_state_specs(torch_build_model(tcfg),
                              make_optimizer(tcfg.optimizer))
    assert sorted(specs) == sorted(state)
    target = {k: torch.empty(s.shape, dtype=getattr(torch, s.dtype),
                             device="meta") for k, s in specs.items()}
    got = load_torch(TorchCheckpoint(TorchStore(str(path / "jax"), "r")),
                     target, step=12, device="cpu")
    for k, v in state.items():
        assert str(got[k].dtype) == f"torch.{np.asarray(v).dtype.name}", k
        np.testing.assert_array_equal(bits(got[k]), bits(v), err_msg=k)
    tck = TorchCheckpoint(TorchStore(str(path / "torch"), "w"))
    tck.save_layout(layout_from_torch(got))
    save_torch(tck, got, step=12)
    back = load_jax(TensorCheckpoint(DatasetStore(str(path / "torch"), "r")),
                    jax.tree.map(lambda a: jax.ShapeDtypeStruct(
                        a.shape, a.dtype, sharding=a.sharding), state),
                    step=12)
    for k, v in state.items():
        np.testing.assert_array_equal(bits(back[k]), bits(v), err_msg=k)


def check_remat_span_context(arch: str, module, hook: str):
    """Under remat the backward pass recomputes each checkpointed span on
    whatever thread runs it (on a card, the autograd engine's own): every
    call of ``module.<hook>`` inside a span, forward and recompute, must
    see the ``MeshContext`` the forward ran under, also when the backward
    runs on a second thread."""
    tcfg = dataclasses.replace(torch_smoke_config(arch), remat=True,
                               dtype="float32")
    tapi = torch_build_model(tcfg)
    params = {n: p.requires_grad_(True) for n, p in
              tapi.init(torch.Generator().manual_seed(0)).items()}
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        tcfg.vocab, 16, 2, seed=0).batch(0).items()}
    ctx = mesh_context_for(ONE_DEVICE, torch_rules_for(tcfg.arch))
    inner, seen = getattr(module, hook), []

    def spy(*args, **kw):
        seen.append(mesh_context())
        return inner(*args, **kw)

    setattr(module, hook, spy)
    try:
        with use_mesh_context(ctx):
            loss, _ = tapi.loss(params, batch)
        forward = len(seen)
        t = threading.Thread(target=lambda: torch.autograd.grad(
            loss, list(params.values())))
        t.start()
        t.join()
    finally:
        setattr(module, hook, inner)
    assert forward > 0 and len(seen) == 2 * forward
    assert all(c is ctx for c in seen)

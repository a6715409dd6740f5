"""The port's training slice against the JAX package's: the data pipeline,
schedule, chunked loss, attention gradients, model loss and gradients,
AdamW, the train step, the async checkpointer copy, and the trainer
(restart bit for bit, preemption, crash mid-save, and restarts across the
two frameworks in both directions).

The reference train step is built on an Auto-axis mesh: the installed
jax's ``make_debug_mesh`` gives Explicit axes, on which the reference step
fails (ROADMAP.md, Reference caveats).  Inputs are made with seeded NumPy
and handed to both packages.  Each comparison states its tolerance per
dtype beside it.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.ast_copy import normalised
from jax.sharding import AxisType

from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.core import async_io as ref_async_io
from repro.distrib.rules import rules_for
from repro.kernels.flash_attention.ops import (
    flash_attention_vjp as ref_flash_attention_vjp,
)
from repro.models.api import build_model
from repro.models.layers import chunked_softmax_xent as ref_xent
from repro.models.layers import flash_attention_xla as ref_flash_xla
from repro.train import schedule as ref_schedule
from repro.train.data import SyntheticLM as RefSyntheticLM
from repro.train.loop import Trainer, TrainerConfig as RefTrainerConfig
from repro.train.optim import AdamW as RefAdamW
from repro.train.step import init_train_state as ref_init_train_state
from repro.train.step import make_train_step as ref_make_train_step
from repro.train.step import train_state_specs as ref_train_state_specs
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import async_io
from repro_torch.core.store import DatasetStore as TorchStore
from repro_torch.kernels.flash_attention.ops import flash_attention_vjp
from repro_torch.launch import train as torch_train_launcher
from repro_torch.models.api import ParamSpec as TorchParamSpec
from repro_torch.models.api import build_model as torch_build_model
from repro_torch.models.layers import chunked_softmax_xent, flash_attention_xla
from repro_torch.train import schedule
from repro_torch.train.data import SyntheticLM
from repro_torch.train.loop import (SimulatedPreemption, TorchTrainer,
                                    TrainerConfig)
from repro_torch.train.optim import Adafactor, AdamW, make_optimizer
from repro_torch.train.step import (init_train_state, make_train_step,
                                    train_state_specs)

ARCH = "smollm_135m"
SHAPE = ShapeConfig("t", 32, 4, "train")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(**kw):
    """The smoke config of both packages with the same replacements."""
    return (dataclasses.replace(get_smoke_config(ARCH), **kw),
            dataclasses.replace(torch_smoke_config(ARCH), **kw))


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _close(got, want, tol, what=""):
    """|got - want| <= tol * (1 + max |want|) elementwise: ``tol`` relative
    to the array's own scale."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = 1.0 + float(np.abs(want).max()) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} * {scale}"


# ------------------------------------------------------------ data pipeline
@pytest.mark.parametrize("vocab,S,B,seed,step", [(256, 32, 4, 0, 0),
                                                 (256, 33, 3, 7, 11),
                                                 (49152, 64, 2, 0, 5)])
def test_synthetic_lm_batches_bit_identical(vocab, S, B, seed, step):
    ref, port = RefSyntheticLM(vocab, S, B, seed), SyntheticLM(vocab, S, B,
                                                               seed)
    want, got = ref.batch(step), port.batch(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in ref.shard_rows(step, 1, B).items():
        np.testing.assert_array_equal(port.shard_rows(step, 1, B)[k], v)
    assert port.state(step + 1) == ref.state(step + 1)
    assert SyntheticLM.restore_step(port.state(9)) == \
        RefSyntheticLM.restore_step(ref.state(9)) == 9


# ------------------------------------------------------------------ schedule
@pytest.mark.parametrize("kw", [dict(base_lr=1e-3, warmup=10, total=100),
                                dict(base_lr=3e-3, warmup=2, total=6),
                                dict(base_lr=3e-4, warmup=0, total=50,
                                     min_frac=0.0)])
def test_warmup_cosine_matches_reference(kw):
    """Steps 0-120 (warmup, cosine, and the clipped tail), both in f32 on a
    0-d step: within 2 f32 ulps of ``base_lr`` (the two libraries' cos may
    differ in its last bit, which ``base_lr * cos`` scales)."""
    for s in range(121):
        want = np.float32(ref_schedule.warmup_cosine(jnp.int32(s), **kw))
        got = schedule.warmup_cosine(torch.tensor(s, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=0,
                                   atol=kw["base_lr"] * 2 ** -22,
                                   err_msg=f"step {s}")
    assert float(schedule.constant(torch.tensor(3), base_lr=0.25)) == \
        float(ref_schedule.constant(jnp.int32(3), base_lr=0.25))


# ------------------------------------------------------- chunked xent loss
@pytest.mark.parametrize("chunk,softcap", [(0, 0.0), (8, 0.0), (8, 30.0),
                                           (64, 0.0)])
def test_chunked_softmax_xent_matches_reference(chunk, softcap):
    """Value and gradients (hidden, table) in f32, S = 20: chunk 8 pads the
    last chunk; within 2e-6 of each array's scale (sums in other orders)."""
    rng = np.random.default_rng(chunk)
    B, S, D, V = 2, 20, 16, 50
    h = rng.normal(size=(B, S, D)).astype(np.float32)
    e = rng.normal(size=(D, V)).astype(np.float32)
    t = rng.integers(0, V, size=(B, S)).astype(np.int32)
    m = (rng.random((B, S)) < 0.8).astype(np.float32)

    def ref(h_, e_):
        return ref_xent(h_, e_, t, m, chunk=chunk, softcap=softcap)[0]

    (want_total, (want_dh, want_de)) = jax.jit(jax.value_and_grad(
        ref, argnums=(0, 1)))(h, e)
    th = torch.from_numpy(h).requires_grad_(True)
    te = torch.from_numpy(e).requires_grad_(True)
    total, count = chunked_softmax_xent(th, te, torch.from_numpy(t),
                                        torch.from_numpy(m), chunk=chunk,
                                        softcap=softcap)
    dh, de = torch.autograd.grad(total, (th, te))
    assert float(count) == float(m.sum())
    _close(total, want_total, 2e-6, "total")
    _close(dh, want_dh, 2e-6, "d hidden")
    _close(de, want_de, 2e-6, "d table")


# ------------------------------------------------------- attention grads
def _qkvg(B, Sq, Sk, Hq, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32)
    g = rng.normal(size=(B, Sq, Hq, hd)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("window,softcap,q_offset,dtype", [
    (0, 0.0, 0, "float32"),
    (8, 0.0, 0, "float32"),
    (0, 20.0, 0, "float32"),
    (6, 0.0, 16, "float32"),
    (0, 0.0, 0, "bfloat16"),
])
def test_flash_attention_xla_grads_match_jax_vjp(window, softcap, q_offset,
                                                 dtype):
    """The port's blocked attention under autograd against ``jax.vjp`` of
    the reference's, causal, blocks 16 x 8 over ragged S = 37 (keys 53 with
    a q_offset).  f32: within 1e-5 of each array's scale; bf16: 2e-2 (both
    round P to bf16 before the PV product, in other orders)."""
    Sq, Sk = 37, 37 + q_offset
    q, k, v, g = _qkvg(2, Sq, Sk, 4, 2, 16, seed=window + q_offset)
    kw = dict(causal=True, window=window, softcap=softcap, block_q=16,
              block_k=8, q_offset=q_offset)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    @jax.jit
    def ref(a, b, c, g_):
        out, vjp = jax.vjp(lambda a, b, c: ref_flash_xla(a, b, c, **kw),
                           a, b, c)
        return out, vjp(g_)

    out, want = ref(*(jnp.asarray(x, jdt) for x in (q, k, v, g)))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_(True)
                  for x in (q, k, v))
    tout = flash_attention_xla(tq, tk, tv, **kw)
    got = torch.autograd.grad(tout, (tq, tk, tv),
                              torch.from_numpy(g).to(tdt))
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    _close(tout, out, tol, "out")
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == tdt
        assert np.isfinite(_np(a)).all()
        _close(a, b, tol, f"d{name}")


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (0, 20.0), (8, 0.0)])
def test_flash_attention_vjp_grads(window, softcap):
    """The autograd Function on CPU tensors: the forward is the kernel's
    plain version, the gradients equal autograd through the plain blocked
    path bit for bit (they are that), and match the reference
    ``flash_attention_vjp`` (the Pallas kernel in interpret mode, its
    backward through the reference's blocked path) within 1e-5 of each
    array's scale in f32."""
    q, k, v, g = _qkvg(2, 40, 40, 4, 2, 16, seed=3)
    blocks = dict(block_q=16, block_k=16)

    @jax.jit
    def ref(a, b, c, g_):
        out, vjp = jax.vjp(
            lambda a, b, c: ref_flash_attention_vjp(a, b, c, True, window,
                                                    softcap, 16, 16, 0, True),
            a, b, c)
        return out, vjp(g_)

    out, want = ref(*(jnp.asarray(x) for x in (q, k, v, g)))

    def grads(fn):
        ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        o = fn(*ts)
        return o, torch.autograd.grad(o, ts, torch.from_numpy(g))

    tout, got = grads(lambda a, b, c: flash_attention_vjp(
        a, b, c, True, window, softcap, 16, 16, 0))
    _, plain = grads(lambda a, b, c: flash_attention_xla(
        a, b, c, causal=True, window=window, softcap=softcap, **blocks))
    _close(tout, out, 1e-5, "out")
    for name, a, b, c in zip("qkv", got, plain, want):
        assert torch.equal(a, b), f"d{name} differs from the plain path"
        _close(a, c, 1e-5, f"d{name}")


# ----------------------------------------------------- model loss + grads
def _loss_apis(**kw):
    cfg, tcfg = _cfgs(vocab_chunk=8, **kw)
    api, tapi = build_model(cfg), torch_build_model(tcfg)
    params = api.init(jax.random.key(0))
    tparams = params_from_jax({n: np.asarray(p) for n, p in params.items()},
                              device="cpu")
    batch = RefSyntheticLM(cfg.vocab, 20, 2, seed=1).batch(0)
    return api, params, tapi, tparams, batch


def _check_loss_and_grads(tol, **kw):
    api, params, tapi, tparams, batch = _loss_apis(**kw)
    (want, wmetrics), wgrads = jax.jit(jax.value_and_grad(
        api.loss, has_aux=True))(params, batch)
    leaves = {n: p.requires_grad_(True) for n, p in tparams.items()}
    loss, metrics = tapi.loss(leaves, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    names = sorted(leaves)
    grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n]
                                                        for n in names])))
    assert sorted(metrics) == sorted(wmetrics) == ["aux", "xent"]
    assert float(metrics["aux"]) == float(wmetrics["aux"]) == 0.0
    _close(loss, want, tol, "loss")
    for n in names:
        assert grads[n].dtype == leaves[n].dtype
        _close(grads[n], wgrads[n], tol, f"grad {n}")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["naive", "xla_flash", "pallas"])
def test_loss_and_grads_match_reference(impl, remat):
    """``api.loss`` and its gradients against ``jax.value_and_grad`` in f32
    (S 20 over vocab chunks of 8, so the last chunk pads): within 1e-5 of
    each array's scale."""
    _check_loss_and_grads(1e-5, attention_impl=impl, remat=remat,
                          dtype="float32")


def test_loss_and_grads_remat_groups():
    """``remat_group`` 2 on 3 layers: one group of two, then a one-layer
    tail, through the kernel path in f32 within 1e-5 of each array's
    scale."""
    _check_loss_and_grads(1e-5, attention_impl="pallas", remat=True,
                          remat_group=2, num_layers=3, dtype="float32")


def test_loss_and_grads_bf16():
    """The real dtype (bf16 parameters and activations), through the kernel
    path with remat: activations round at other places, so within 2e-2 of
    each array's scale."""
    _check_loss_and_grads(2e-2, attention_impl="pallas", remat=True)


# ----------------------------------------------------------------- AdamW
def test_adamw_matches_reference():
    """One AdamW step against a hand-rolled reference (the reference's own
    test), and three steps against the reference's ``AdamW.update`` on bf16
    parameters with f32 slots: f32 slots within 1e-6 relative; bf16
    parameters within one bf16 ulp (2^-8 relative; lr * bias-correction
    rounds differently in the last f32 bit)."""
    opt = AdamW(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    rng = np.random.default_rng(0)
    p = rng.normal(size=(4, 3)).astype(np.float32)
    g = rng.normal(size=(4, 3)).astype(np.float32)
    specs = {"w": TorchParamSpec((4, 3), (None, None), "float32")}
    state = opt.init(specs)
    new_p, _ = opt.update({"w": torch.from_numpy(p)},
                          {"w": torch.from_numpy(g)}, state,
                          torch.tensor(1e-2), torch.tensor(0, dtype=torch.int32))
    m, v = 0.1 * g, 0.05 * g ** 2
    want = p - 1e-2 * ((m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.95)) + 1e-8)
                       + 0.1 * p)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5)

    ref = RefAdamW()
    shapes = {"a": (8, 5), "b": (7,)}
    ps = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    jp = {n: jnp.asarray(x, jnp.bfloat16) for n, x in ps.items()}
    tp = params_from_jax({n: np.asarray(x) for n, x in jp.items()},
                         device="cpu")
    js = {f"{s}/{n}": jnp.zeros(shapes[n], jnp.float32)
          for s in "mv" for n in shapes}
    ts = {k: torch.zeros(tuple(x.shape)) for k, x in js.items()}
    for step in range(3):
        gs = {n: rng.normal(size=s).astype(np.float32)
              for n, s in shapes.items()}
        jp, js = ref.update(jp, {n: jnp.asarray(x, jnp.bfloat16)
                                 for n, x in gs.items()}, js,
                            jnp.float32(3e-3), jnp.int32(step))
        tp, ts = opt.update(tp, {n: torch.from_numpy(x).to(torch.bfloat16)
                                 for n, x in gs.items()}, ts,
                            torch.tensor(3e-3),
                            torch.tensor(step, dtype=torch.int32))
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-6, atol=1e-12, err_msg=k)
    for n in jp:
        assert tp[n].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(tp[n]), _np(jp[n]), rtol=2 ** -8,
                                   err_msg=n)


def test_make_optimizer_and_state_specs():
    assert isinstance(make_optimizer("adamw"), AdamW)
    assert isinstance(make_optimizer("adafactor"), Adafactor)
    with pytest.raises(ValueError):
        make_optimizer("sgd")
    cfg, tcfg = _cfgs()
    want = ref_train_state_specs(build_model(cfg), RefAdamW())
    got = train_state_specs(torch_build_model(tcfg), AdamW())
    assert list(got) == list(want)
    for n, s in want.items():
        assert dataclasses.asdict(got[n]) == dataclasses.asdict(s), n


# ------------------------------------------------------------ train step
def _sched(base_lr=1e-3):
    return (functools.partial(ref_schedule.warmup_cosine, base_lr=base_lr,
                              warmup=2, total=100),
            functools.partial(schedule.warmup_cosine, base_lr=base_lr,
                              warmup=2, total=100))


def _state_to_torch(state) -> dict[str, torch.Tensor]:
    return params_from_jax({k: np.asarray(v) for k, v in state.items()},
                           device="cpu")


@pytest.mark.parametrize("microbatches,dtype,tol", [
    (1, "float32", 1e-5),
    (2, "bfloat16", 2e-2),
])
def test_train_step_matches_reference(microbatches, dtype, tol):
    """Three steps of ``make_train_step`` (value and grad, schedule, AdamW,
    step + 1; with 2 microbatches the gradients accumulate in the grad
    dtype) against the reference's.  Metrics and f32 slots within ``tol``
    of each array's scale (f32 1e-5; bf16 2e-2: activations round at other
    places); parameters within ``tol`` plus 2 lr-sized AdamW steps (an
    update is lr * m/sqrt(v), about lr in size whatever the gradient, so a
    gradient near 0 may take either sign in the two libraries)."""
    cfg, tcfg = _cfgs(dtype=dtype)
    api, tapi = build_model(cfg), torch_build_model(tcfg)
    jsched, tsched = _sched()
    ref_step = ref_make_train_step(api, RefAdamW(), jsched, _auto_mesh(),
                                   rules_for(cfg.arch), SHAPE, donate=False,
                                   microbatches=microbatches)
    step = make_train_step(tapi, AdamW(), tsched, SHAPE,
                           microbatches=microbatches)
    jstate = ref_init_train_state(api, RefAdamW(), jax.random.key(0))
    tstate = _state_to_torch(jstate)
    data = SyntheticLM(cfg.vocab, SHAPE.seq_len, SHAPE.global_batch, seed=0)
    for i in range(3):
        batch = data.batch(i)
        jstate, jm = ref_step(jstate, batch)
        tstate, tm = step(tstate, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
        assert sorted(tm) == sorted(jm), i
        for k in jm:
            _close(tm[k], jm[k], tol, f"step {i} metric {k}")
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    assert tstate["step"].dtype == torch.int32
    for k, v in jstate.items():
        if k.startswith("params/"):
            _close(tstate[k], v, tol + 2e-3, k)
        else:
            _close(tstate[k], v, tol, k)


# ------------------------------------------------------------ async_io copy
def test_async_io_is_a_copy_of_the_reference():
    """The port's ``async_io`` is the whole reference module, its FEM facade
    (``fem``, ``save_mesh``, ``save_function`` and the ``FEMCheckpoint``
    branch) included, with the ``@hot_path`` markers removed, docstrings
    and the package prefix aside."""
    assert normalised(async_io) == normalised(ref_async_io)
    assert {"fem", "save_mesh", "save_function"} <= set(
        vars(async_io.AsyncCheckpointer))


# ------------------------------------------------------------------ trainer
def _torch_trainer(path, ckpt_every=5, async_ckpt=True, store_factory=None,
                   log_every=1, seed=0):
    cfg = torch_smoke_config(ARCH)
    api = torch_build_model(cfg)
    opt = make_optimizer(cfg.optimizer)
    step = make_train_step(api, opt, _sched()[1], SHAPE)
    data = SyntheticLM(cfg.vocab, SHAPE.seq_len, SHAPE.global_batch, seed)
    tcfg = TrainerConfig(ckpt_dir=str(path), ckpt_every=ckpt_every,
                         async_ckpt=async_ckpt, log_every=log_every,
                         store_factory=store_factory)
    return TorchTrainer(step, data, tcfg, device="cpu",
                        init_state_fn=lambda: init_train_state(
                            api, opt, torch.Generator().manual_seed(seed)))


def _assert_states_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


def test_trainer_defaults_to_the_card(tmp_path):
    cfg = torch_smoke_config(ARCH)
    api = torch_build_model(cfg)
    step = make_train_step(api, AdamW(), _sched()[1], SHAPE)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchTrainer(step, SyntheticLM(cfg.vocab, 32, 4),
                     TrainerConfig(str(tmp_path)), lambda: {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_train_launcher.main(["--arch", ARCH, "--smoke", "--steps", "1"])


def test_restart_is_bitwise_deterministic(tmp_path):
    """10 straight steps (no checkpoint) == 5 steps + preemption at 7 +
    restart + 5 steps, bit for bit (losses and every array of the state)."""
    t1 = _torch_trainer(tmp_path / "a", ckpt_every=0)
    r1 = t1.run(10)
    t2 = _torch_trainer(tmp_path / "b")
    with pytest.raises(SimulatedPreemption):
        t2.run(10, fail_at=7)          # dies after committing step 5
    t3 = _torch_trainer(tmp_path / "b", ckpt_every=0)
    r3 = t3.run(10)
    assert [h["step"] for h in t3.history] == list(range(6, 11))
    assert [h["loss"] for h in t3.history] == \
        [h["loss"] for h in t1.history][5:]
    _assert_states_equal(r1["state"], r3["state"])


def test_preemption_before_first_checkpoint(tmp_path):
    t = _torch_trainer(tmp_path, ckpt_every=50)
    with pytest.raises(SimulatedPreemption):
        t.run(10, fail_at=3)
    state, start = _torch_trainer(tmp_path, ckpt_every=50).restore_latest()
    assert start == 0                     # cold start: nothing committed
    assert int(state["step"]) == 0


def test_async_checkpointing_restart(tmp_path):
    """Async (double-buffered) writes restart to the same state as sync
    ones, and the async saves record their snapshot time."""
    t1 = _torch_trainer(tmp_path / "sync", async_ckpt=False)
    t1.run(5)
    t2 = _torch_trainer(tmp_path / "async", async_ckpt=True)
    t2.run(5)
    assert [s["step"] for s in t2.save_log] == [5]
    assert all(s["async"] and s["snapshot_seconds"] >= 0
               for s in t2.save_log)
    s1, st1 = _torch_trainer(tmp_path / "sync").restore_latest()
    s2, st2 = _torch_trainer(tmp_path / "async").restore_latest()
    assert st1 == st2 == 5
    _assert_states_equal(s1, s2)


class _Crash(BaseException):
    """The simulated process death (a BaseException, as the reference's
    fault store raises, so no ``except Exception`` swallows it)."""


def _fault_factory(kill_after: int | None):
    """A store constructor over the port's ``DatasetStore`` that dies at the
    ``kill_after``-th mutating operation counted over every store it opens
    (the trainer opens one per save); ``seen`` counts the completed ones."""
    seen = [0]

    class FaultStore(TorchStore):
        def _op(self):
            if kill_after is not None and seen[0] >= kill_after:
                raise _Crash(f"simulated death at mutating op {seen[0]}")
            seen[0] += 1

    for name in ("create", "write_rows", "write_plan", "write_rows_at",
                 "set_attrs", "commit_step"):
        def wrapped(self, *a, _name=name, **kw):
            self._op()
            return getattr(TorchStore, _name)(self, *a, **kw)
        setattr(FaultStore, name, wrapped)
    return FaultStore, seen


@pytest.fixture(scope="module")
def save_op_counts(tmp_path_factory):
    """Per writer mode: the mutating store ops completed after the first
    save (step 5) and after the second (step 10) of a run that counts them,
    and that run's directory."""
    out = {}
    for async_ckpt in (False, True):
        path = tmp_path_factory.mktemp(f"count_async{async_ckpt}")
        store, seen = _fault_factory(None)
        t = _torch_trainer(path, async_ckpt=async_ckpt, store_factory=store)
        t.run(5)
        first = seen[0]
        t.run(10)                               # resumes at 5
        out[async_ckpt] = first, seen[0], path
    return out


@pytest.mark.parametrize("where,async_ckpt", [("first", False),
                                              ("middle", True),
                                              ("commit", False),
                                              ("commit", True)])
def test_crash_mid_save_falls_back_to_last_committed(tmp_path,
                                                     save_op_counts, where,
                                                     async_ckpt):
    """A process death at a mutating store op of the step-10 save (its
    first, one in the middle, or the commit itself) leaves step 5 as the
    restart point, bit for bit."""
    first, second, counted = save_op_counts[async_ckpt]
    kill = {"first": first, "middle": (first + second) // 2,
            "commit": second - 1}[where]
    store, _ = _fault_factory(kill)
    t = _torch_trainer(tmp_path, async_ckpt=async_ckpt, store_factory=store)
    with pytest.raises((_Crash, RuntimeError)):
        t.run(10)
    state, start = _torch_trainer(tmp_path).restore_latest()
    assert start == 5
    want, _ = _torch_trainer(counted).restore_from(5)
    _assert_states_equal(state, want)


# ----------------------------------------------- restarts across frameworks
@functools.lru_cache(maxsize=None)
def _ref_train_step():
    cfg = get_smoke_config(ARCH)
    api = build_model(cfg)
    return api, ref_make_train_step(api, RefAdamW(), _sched()[0],
                                    _auto_mesh(), rules_for(cfg.arch), SHAPE)


def _ref_trainer(path, ckpt_every=5, seed=0):
    api, step = _ref_train_step()
    data = RefSyntheticLM(api.cfg.vocab, SHAPE.seq_len, SHAPE.global_batch,
                          seed=seed)
    tcfg = RefTrainerConfig(ckpt_dir=str(path), ckpt_every=ckpt_every,
                            log_every=1)
    return Trainer(step, data, tcfg,
                   init_state_fn=lambda: ref_init_train_state(
                       api, RefAdamW(), jax.random.key(seed)))


# continuing 3 steps in each framework from one restored bf16 state: losses
# within 2e-2 (bf16 activations round at other places); parameters within 2e-2
# of their scale plus 3 lr-sized AdamW steps (a near-0 gradient may take
# either sign in the two libraries)
CONT_TOL = 2e-2
CONT_PARAM_TOL = CONT_TOL + 3 * 2 * 1e-3


def _check_continuations(jax_run, torch_run, jax_hist, torch_hist):
    assert [h["step"] for h in jax_hist] == [h["step"] for h in torch_hist] \
        == [6, 7, 8]
    for a, b in zip(torch_hist, jax_hist):
        _close(np.float32(a["loss"]), np.float32(b["loss"]), CONT_TOL,
               f"loss at step {b['step']}")
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
    for k, v in jax_run["state"].items():
        tol = CONT_PARAM_TOL if k.startswith("params/") else CONT_TOL
        _close(torch_run["state"][k], v, tol, k)


def test_reference_save_restores_into_torch_trainer(tmp_path):
    """A step saved by the reference ``Trainer`` (async writer) restores
    into ``TorchTrainer`` bit for bit; both then run 3 more steps from
    it."""
    ref = _ref_trainer(tmp_path)
    saved = ref.run(5)["state"]
    t = _torch_trainer(tmp_path)
    state, start = t.restore_latest()
    assert start == 5
    _assert_states_equal(state, _state_to_torch(saved))
    torch_run = t.run(8, start_state=state, start_step=start)
    ref2 = _ref_trainer(tmp_path)
    jax_run = ref2.run(8)
    _check_continuations(jax_run, torch_run, ref2.history, t.history)


def test_torch_save_restores_into_reference_trainer(tmp_path):
    """A step saved by ``TorchTrainer`` (async writer) restores into the
    reference ``Trainer`` bit for bit; both then run 3 more steps from
    it."""
    t = _torch_trainer(tmp_path)
    saved = t.run(5)["state"]
    ref = _ref_trainer(tmp_path)
    state, start = ref.restore_latest()
    assert start == 5
    _assert_states_equal(_state_to_torch(state), saved)
    jax_run = ref.run(8, start_state=state, start_step=start)
    t2 = _torch_trainer(tmp_path)
    torch_run = t2.run(8)
    _check_continuations(jax_run, torch_run, ref.history, t2.history)


def test_params_from_jax_carries_a_train_state():
    """A whole reference train state — ``params/*`` in bf16, ``opt/*`` in
    f32 and the 0-d int32 ``step`` — arrives bit for bit."""
    cfg = get_smoke_config(ARCH)
    api = build_model(cfg)
    state = ref_init_train_state(api, RefAdamW(), jax.random.key(1))
    state = {k: (v + 1 if k.startswith("opt/") else v)
             for k, v in state.items()}
    state["step"] = jnp.int32(12)
    got = _state_to_torch(state)
    assert sorted(got) == sorted(state)
    for k, v in state.items():
        v = np.asarray(v)
        want_dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                      "int32": torch.int32}[v.dtype.name]
        assert got[k].dtype == want_dtype and tuple(got[k].shape) == v.shape
        assert got[k].reshape(-1).view(torch.uint8).numpy().tobytes() == \
            np.ascontiguousarray(v).tobytes(), k
    assert got["step"].dim() == 0 and int(got["step"]) == 12


# -------------------------------------------------------- launcher, example
def test_train_launcher_cpu(tmp_path, capsys):
    """The launcher's JSON lines, the reference's format, on the CPU; a
    restart from its directory resumes at the last save."""
    args = ["--arch", "smollm-135m", "--smoke", "--steps", "20", "--batch",
            "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "10", "--device", "cpu"]
    torch_train_launcher.main(args)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["step"] for ln in lines[:-1]] == [10, 20]
    assert all(set(ln) == {"step", "loss", "lr"} for ln in lines[:-1])
    assert set(lines[-1]) == {"final_loss", "saved_steps", "seconds"}
    assert lines[-1]["saved_steps"] == [10, 20]
    assert np.isfinite(lines[-1]["final_loss"])
    with pytest.raises(SystemExit):
        torch_train_launcher.main(args + ["--data-mesh", "2"])


def test_train_example_cpu(tmp_path):
    """The kill-and-resume example on the CPU: preempted at 3/5 of the run,
    resumed from the last committed step to the end."""
    from repro_torch.examples import train_smollm

    out = train_smollm.main(["--steps", "50", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path / "ck")])
    assert [h["step"] for h in out["resumed_history"]] == [50]
    assert np.isfinite(out["last_loss"])

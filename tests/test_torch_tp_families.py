"""Tensor-parallel compute over the model axis for the recurrentgemma,
whisper and xLSTM families: their sharded train and prefill steps on 4
``torch.distributed`` processes (gloo on the CPU) against the JAX
package's GSPMD steps on 4 host devices.

* recurrentgemma-9b (RG-LRU blocks on this process's channels, the MQA
  attention on its query heads), whisper-base (encoder, decoder and
  cross-attention on its heads and kv heads) and xlstm-350m (the mLSTM's
  inner width and the sLSTM's gate columns on this process's part, each
  cell whole on every process), smoke configs, on (2, 2)
  and (1, 4): 3 sharded steps against the reference's sharded
  ``make_train_step`` on an Auto-axis (2, 2) ``jax.make_mesh`` (values
  differ between meshes by the rounding of the sharded sums only), within
  ``tests/test_torch_mesh_train.py``'s ``RTOL`` for f32 and bf16; every
  process ends with the same metrics;
* the sharded prefill's logits and cache against the reference's within
  1e-5 of their scale in f32;
* each family's aligned parameters (``lru/w_a`` and ``lru/w_i`` among
  them) are this process's part of the step, and no parameter is gathered
  over the model axis;
* each process's forward scans run at width ``W / n``;
* a planted fault (the gates' partial products never summed; whisper's
  and xLSTM's copy-in boundaries dropped) fails the parity check;
* on a (1, 1) mesh the sharded step is the one-device step bit for bit.

The reference runs in a subprocess per arch with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (ROADMAP.md,
Reference caveats; xLSTM's with ``--xla_allow_excess_precision=false``
too, as its bf16 steps round at every op the program names only so) and
writes ``.npz`` files; the port's 4 processes run every case in one
spawn.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from helpers import torch_tp_family_workers as W
from test_torch_mesh_train import _close, _close_update, _rtol
from test_torch_tp import PREFILL_TOL, _dump, _load_npz, _tag

from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch.spawn import run_processes
from repro_torch.models.api import build_model

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300
PG_TIMEOUT = 60
#: the reference's mesh every port run is held to
REF_MESH = (2, 2)
#: the XLA flags of each arch's reference subprocess beside the host
#: device count: XLA's excess precision keeps the reference's bf16 xLSTM
#: closer to f32 than its program text (ROADMAP.md, Reference caveats)
_XLA_EXTRA = {"xlstm_350m": " --xla_allow_excess_precision=false"}
#: the archs whose reference also runs on one device, (1, 1): the spread
#: between its own meshes bounds the arrays ``SPREAD_BOUND`` names
SELF_SPREAD = {"xlstm_350m": (1, 1)}

_JAX = r"""
import dataclasses, functools, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config, get_smoke_config
from repro.configs.base import ShapeConfig
from repro.distrib.rules import rules_for
from repro.models.api import build_model, make_token_batch
from repro.train import schedule
from repro.train.data import SyntheticLM
from repro.train.optim import AdamW
from repro.train.step import make_prefill_step, make_train_step

out, arch, shape = sys.argv[1], sys.argv[2], tuple(map(int, sys.argv[3:5]))
tag = f"{arch}_{shape[0]}x{shape[1]}"
BATCH, SEQ, P, PB, CACHE, STEPS = %(sizes)r
sched = functools.partial(schedule.warmup_cosine, base_lr=1e-3, warmup=2,
                          total=100)
mesh = jax.make_mesh(shape, ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
rules = rules_for(get_config(arch).arch)


def config(dtype):
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype)


def with_frames(cfg, batch, step):
    if not cfg.enc_dec:
        return batch
    B = batch["tokens"].shape[0]
    frames = np.random.default_rng(7 + step).normal(
        size=(B, cfg.encoder_seq, cfg.d_model), scale=0.5).astype("float32")
    return {**batch, "enc_frames": frames}


def load(path):
    dtypes = json.load(open(path + ".json"))
    with np.load(path) as z:
        return {k: jnp.asarray(z[k].view(jnp.bfloat16)
                               if dtypes[k] == "bfloat16" else z[k])
                for k in z.files}


def dump(path, tree):
    arrays = {k: np.asarray(v) for k, v in tree.items()}
    dtypes = {k: a.dtype.name for k, a in arrays.items()}
    np.savez(path, **{k: a.view(np.uint16) if a.dtype.name == "bfloat16"
                      else a for k, a in arrays.items()})
    json.dump(dtypes, open(path + ".json", "w"))


for dtype in %(dtypes)r:
    api = build_model(config(dtype))
    step = make_train_step(api, AdamW(), sched, mesh, rules,
                           ShapeConfig("t", SEQ, BATCH, "train"),
                           donate=False)
    state = load(f"{out}/init_{arch}_{dtype}.npz")
    data = SyntheticLM(api.cfg.vocab, SEQ, BATCH, 0)
    metrics = []
    for i in range(STEPS):
        state, m = step(state, with_frames(api.cfg, data.batch(i), i))
        metrics.append({k: float(v) for k, v in m.items()})
    dump(f"{out}/final_{tag}_{dtype}.npz", state)
    json.dump(metrics, open(f"{out}/metrics_{tag}_{dtype}.json", "w"))
cfg = config("float32")
pshape = ShapeConfig("p", P, PB, "prefill")
logits, cache = make_prefill_step(build_model(cfg), mesh, rules, pshape,
                                  cache_len=CACHE)(
    load(f"{out}/params_{arch}.npz"), make_token_batch(cfg, pshape, 0))
dump(f"{out}/prefill_{tag}.npz", {"logits": logits, **cache})
print("OK")
""" % {"sizes": (W.BATCH, W.SEQ, W.P, W.PB, W.CACHE, W.STEPS),
       "dtypes": W.DTYPES}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Seeded initial states (train, per arch and dtype) and f32 parameters
    (prefill, per arch) written for both packages; the reference's steps,
    one subprocess per arch, run beside the port's 4 processes."""
    ref = tmp_path_factory.mktemp("tp_families")
    inits, params = {}, {}
    for arch in W.ARCHS:
        for dtype in W.DTYPES:
            inits[(arch, dtype)] = W.initial_state(arch, dtype)
            _dump(ref / f"init_{arch}_{dtype}.npz", inits[(arch, dtype)])
        params[arch] = W.initial_params(arch)
        _dump(ref / f"params_{arch}.npz", params[arch])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    cells = [(arch, REF_MESH) for arch in W.ARCHS] + list(SELF_SPREAD.items())
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, str(ref), arch,
                               *map(str, shape)],
                              env=dict(env, XLA_FLAGS=(
                                  "--xla_force_host_platform_device_count=4"
                                  + _XLA_EXTRA.get(arch, ""))),
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for arch, shape in cells]
    try:
        four = run_processes(W.family_cases, 4, (inits, params),
                             timeout=TIMEOUT, pg_timeout=PG_TIMEOUT,
                             threads=1)
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0 and out.strip().endswith("OK"), \
                err[-4000:]
    finally:
        for p in procs:
            p.kill()
    return {"ref": ref, "inits": inits, "four": four}


#: bf16 parameters whose 3-step update is mostly last-bit roundings: the
#: RG-LRU gates' matrices, whose gradients reach them through
#: a = exp(-8 softplus(lam) r) and move most elements by under one bf16
#: spacing.  The reference's own (1, 1) and (1, 4) runs differ from its
#: (2, 2) run by 13.0 % and 12.6 % of ``lru/w_a``'s update (``lru/w_i``:
#: 5.8 % and 4.7 %), past RTOL's 5e-2, and by 1.7 % over the elements
#: (2, 2) moved at least one spacing (ROADMAP.md, Reference caveats).
#: Their updates are held over those elements.
ROUNDING_BOUND = {"params/lru/w_a", "params/lru/w_i"}


def _close_update_moved(got, want, init, rtol, what=""):
    """``_close_update`` over the elements whose reference update is at
    least one spacing of the dtype at the reference's value."""
    w = want.double()
    spacing = torch.finfo(want.dtype).eps * torch.exp2(torch.floor(
        torch.log2(w.abs().clamp_min(torch.finfo(want.dtype).tiny))))
    moved = (w - init.double()).abs() >= spacing
    assert int(moved.sum()) > 0, f"{what}: no element moved a spacing"
    _close_update(got.double()[moved], w[moved], init.double()[moved], rtol,
                  what)


#: xLSTM's sLSTM gate bias (ROADMAP.md, Reference caveats).  The gradient
#: of its input gate's columns (the first D of 4D) is about 0: below
#: AdamW's eps in f32, rounding noise in bf16, which AdamW turns into
#: updates of either sign; the reference's own (1, 1) and (2, 2) steps
#: differ by 1.76e-3 (f32) and 53 % (bf16) of the update with them and by
#: 3.4e-7 and 1.2 % without.  Its update is held over the other columns.
INPUT_GATE_NOISE = {"params/s/b"}
#: bf16 slots that are a sum over the batch's positions of bf16 cotangents
#: that cancel (the z gate's bias): the reference's own (1, 1) and (2, 2)
#: steps differ by 7.8 % (v) and 3.9 % (m) of their scale, past RTOL's
#: 3e-2, and its bf16 from its f32 by 3.6 %.  Each is held within RTOL or
#: within that spread of the reference, whichever is larger.
SPREAD_BOUND = {"opt/m/s/b", "opt/v/s/b"}


def _check_steps(ref: Path, arch: str, dtype: str, init: dict,
                 got: dict) -> None:
    """``got``'s metrics per step, optimizer slots and parameter updates
    within ``_rtol`` of their scale against the reference's sharded steps
    on ``REF_MESH`` (raises AssertionError otherwise); xLSTM's gate bias
    as ``INPUT_GATE_NOISE`` and ``SPREAD_BOUND`` say."""
    tag = f"{arch}_{_tag(REF_MESH)}"
    want_m = json.loads((ref / f"metrics_{tag}_{dtype}.json").read_text())
    want = _load_npz(ref / f"final_{tag}_{dtype}.npz")
    for i, (gm, wm) in enumerate(zip(got["metrics"], want_m)):
        assert sorted(gm) == sorted(wm), i
        for k in wm:
            _close(gm[k], wm[k], _rtol(dtype, k), f"step {i} metric {k}")
    assert sorted(got["state"]) == sorted(want)
    for k, v in want.items():
        assert got["state"][k].dtype == v.dtype, k
        if k.startswith("params/") and torch.equal(v, init[k]):
            # a step too small for the dtype's spacing (bf16 lam at 1.0):
            # the port must leave it as the reference does, bit for bit
            assert torch.equal(got["state"][k], v), k
        elif k.startswith("params/") and dtype == "bfloat16" \
                and k in ROUNDING_BOUND:
            _close_update_moved(got["state"][k], v, init[k],
                                _rtol(dtype, k), k)
        elif k in INPUT_GATE_NOISE:
            D = v.shape[-1] // 4
            _close_update(got["state"][k][..., D:], v[..., D:],
                          init[k][..., D:], _rtol(dtype, k), k)
        elif k.startswith("params/"):
            _close_update(got["state"][k], v, init[k], _rtol(dtype, k), k)
        elif dtype == "bfloat16" and k in SPREAD_BOUND:
            other = _load_npz(ref / f"final_{arch}_{_tag(SELF_SPREAD[arch])}"
                                    f"_{dtype}.npz")[k]
            spread = float((other.double() - v.double()).abs().max()
                           / v.double().abs().max())
            _close(got["state"][k], v, max(_rtol(dtype, k), spread), k)
        elif k != "step":
            _close(got["state"][k], v, _rtol(dtype, k), k)


# ------------------------------------------------------------ train steps
@pytest.mark.parametrize("dtype", W.DTYPES)
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("shape", W.MESHES, ids=_tag)
def test_tp_family_step_matches_reference_sharded_step(runs, shape, arch,
                                                       dtype):
    """Three sharded steps on 4 processes: loss, lr and grad_norm per step,
    every optimizer slot and every parameter's update within ``_rtol`` of
    its scale against the reference's sharded step; every process ends
    with the same metrics."""
    per_rank = [r[("train", shape, arch, dtype)] for r in runs["four"]]
    for r in per_rank[1:]:
        assert r["metrics"] == per_rank[0]["metrics"]
    _check_steps(runs["ref"], arch, dtype, runs["inits"][(arch, dtype)],
                 per_rank[0])


@pytest.mark.parametrize("arch", W.ARCHS)
def test_planted_fault_fails_the_parity_check(runs, arch):
    """The same steps with a fault planted in the split (recurrentgemma:
    the gates' partial products sliced to this process's channels, never
    summed; whisper and xLSTM: the copy-in boundaries dropped, so the
    gradients of the whole values the split work reads, the encoder states
    and the blocks' normed inputs among them, are never summed) fall
    outside the tolerances the true steps meet."""
    got = runs["four"][0][("fault", arch)]
    with pytest.raises(AssertionError):
        _check_steps(runs["ref"], arch, W.FAULT_DTYPE,
                     runs["inits"][(arch, W.FAULT_DTYPE)], got)


# ---------------------------------------------------------------- prefill
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("shape", W.MESHES, ids=_tag)
def test_tp_family_prefill_matches_reference(runs, shape, arch):
    """The sharded prefill's last-position logits and its cache (the ring
    buffer and the recurrent and conv states; whisper's self and cross
    K/V) against the reference's sharded prefill, f32, within 1e-5 of
    their scale."""
    want = _load_npz(runs["ref"] / f"prefill_{arch}_{_tag(REF_MESH)}.npz")
    got = runs["four"][0][("prefill", shape, arch)]
    pairs = {"logits": got["logits"], **got["cache"]}
    assert sorted(pairs) == sorted(want)
    for k, w in want.items():
        g = pairs[k]
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == w.dtype, k
        scale = float(w.double().abs().max()) if w.numel() else 0.0
        err = float((g.double() - w.double()).abs().max()) if w.numel() \
            else 0.0
        assert err <= PREFILL_TOL * max(scale, 1.0), (k, err, scale)


# ------------------------------------------------ what stays on a process
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("shape", W.MESHES, ids=_tag)
def test_aligned_parameters_are_never_gathered_over_model(runs, shape, arch):
    """Each family's parameters whose split matches their activation's
    (``ALIGNED``: ``lru/w_a`` and ``lru/w_i``, stored row-split beside
    the channels they contract, among them) are this process's part of the
    step, and the step gathers no parameter over the model axis (the
    others are whole on it); activations do cross it."""
    for r in runs["four"]:
        got = r[("train", shape, arch, "float32")]
        assert set(got["local_params"]) == W.ALIGNED[arch]
        assert got["sent"]["parameter"] == 0
        assert got["sent"]["activation"] > 0
    assert {"lru/w_a", "lru/w_i"} <= W.ALIGNED["recurrentgemma_9b"]


@pytest.mark.parametrize("shape", W.MESHES, ids=_tag)
def test_each_process_scans_its_channels(runs, shape):
    """Under the model axis of m processes each forward ``rglru_scan``
    (its plain version on the CPU, the kernel on a card) runs on the
    process's W / m channels, in the planted-fault-free steps."""
    W_ = W.config("recurrentgemma_9b", "float32").lru_width
    for r in runs["four"]:
        for dtype in W.DTYPES:
            got = r[("train", shape, "recurrentgemma_9b", dtype)]
            assert got["scan_widths"] == [W_ // shape[1]]


# ------------------------------------------------------------- (1, 1)
@pytest.fixture
def world_of_one():
    launch_mesh.init_distributed("cpu", rank=0, world_size=1,
                                 init_method=f"tcp://localhost:"
                                             f"{launch_mesh.free_port()}",
                                 timeout=30)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("arch", W.ARCHS)
def test_one_process_mesh_is_the_plain_step_bit_for_bit(world_of_one, arch):
    """On a (1, 1) mesh the model axis splits nothing: two sharded steps
    give the one-device step's metrics and state bit for bit."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optim import AdamW
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        shard_state)

    from helpers.torch_tp_workers import _sched, rules

    cfg = W.config(arch, "float32")
    api = build_model(cfg)
    shape = ShapeConfig("t", 16, 4, "train")
    plain = make_train_step(api, AdamW(), _sched(), shape)
    mesh = launch_mesh.make_debug_mesh(1, 1, device_type="cpu")
    sharded = make_train_step(api, AdamW(), _sched(), shape, mesh=mesh,
                              rules=rules(arch))
    a = init_train_state(api, AdamW(), torch.Generator().manual_seed(0))
    b = shard_state(a, mesh, sharded.state_shardings)
    data = SyntheticLM(cfg.vocab, 16, 4, seed=0)
    for i in range(2):
        batch = {k: torch.from_numpy(v)
                 for k, v in W.with_frames(cfg, data.batch(i), i).items()}
        a, ma = plain(a, batch)
        b, mb = sharded(b, batch)
        assert {k: float(v) for k, v in ma.items()} == \
            {k: float(v) for k, v in mb.items()}
    for k in a:
        assert torch.equal(a[k].view(-1).view(torch.uint8),
                           b[k].to_local().view(-1).view(torch.uint8)), k

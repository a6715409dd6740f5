"""The port's sharded training across ``torch.distributed`` processes (gloo
on the CPU) against the JAX package's sharded training, and the paper's
restart on another process count.

* The sharded step (DTensor state on a (2, 2) mesh, 4 processes) against
  the reference's sharded ``make_train_step`` on a (2, 2) Auto-axis mesh
  of 4 host devices, from the same seeded state and batches.
* A step saved by the JAX ``Trainer`` on a (2, 2) mesh restores into the
  port on 2 processes, mesh (1, 2), bit for bit; a step saved by the
  port's ``TorchTrainer`` on 4 processes restores into the JAX ``Trainer``
  on a (1, 4) mesh, bit for bit.
* Kill and resume on one mesh, 2 processes, bit-exact with a straight run.
* The fault store kills rank 0's writer mid-save: every process raises at
  once, the committed step is the earlier one, and 2 processes restart
  from it bit for bit.

The reference runs in subprocesses with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, its meshes built by
``jax.make_mesh(..., axis_types=(AxisType.Auto,) * 2)`` (the installed
jax's ``make_debug_mesh`` gives Explicit axes, on which the reference step
fails: ROADMAP.md, Reference caveats).  Each set of the port's processes
runs several cases, and the tests read what they returned.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from helpers import torch_mesh_workers as W

from repro_torch.core.store import DatasetStore
from repro_torch.core.tensor_ckpt import TensorCheckpoint
from repro_torch.core.torch_io import to_torch
from repro_torch.launch.spawn import run_processes

REPO = Path(__file__).resolve().parents[1]
# each set of processes runs well under this; a hang fails the test here
TIMEOUT = 300
# a collective waits this long for a peer before it raises
PG_TIMEOUT = 60
STEPS = 3           # sharded steps held against the reference's

_JAX = r"""
import dataclasses, functools, json, sys
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.distrib.rules import rules_for
from repro.models.api import build_model
from repro.train import schedule
from repro.train.data import SyntheticLM
from repro.train.loop import Trainer, TrainerConfig
from repro.train.optim import AdamW
from repro.train.step import init_train_state, make_train_step

out, mode, ckpt = sys.argv[1], sys.argv[2], sys.argv[3]
SHAPE = ShapeConfig("t", %(seq)d, %(batch)d, "train")
sched = functools.partial(schedule.warmup_cosine, base_lr=1e-3, warmup=2,
                          total=100)


def mesh(d, m):
    return jax.make_mesh((d, m), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def dump(path, tree):
    arrays = {k: np.asarray(v) for k, v in tree.items()}
    dtypes = {k: a.dtype.name for k, a in arrays.items()}
    np.savez(path, **{k: a.view(np.uint16) if a.dtype.name == "bfloat16"
                      else a for k, a in arrays.items()})
    json.dump(dtypes, open(path + ".json", "w"))


def trainer(m, ckpt_every):
    cfg = get_smoke_config("%(arch)s")
    api = build_model(cfg)
    step = make_train_step(api, AdamW(), sched, m, rules_for(cfg.arch),
                           SHAPE)
    data = SyntheticLM(cfg.vocab, SHAPE.seq_len, SHAPE.global_batch, seed=0)
    return Trainer(step, data, TrainerConfig(ckpt_dir=ckpt,
                                             ckpt_every=ckpt_every,
                                             log_every=1),
                   init_state_fn=lambda: init_train_state(
                       api, AdamW(), jax.random.key(0)))


if mode == "step_and_save":
    # the sharded step on (2, 2), from init_train_state(key(0)), per dtype
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_smoke_config("%(arch)s"), dtype=dtype)
        api = build_model(cfg)
        step = make_train_step(api, AdamW(), sched, mesh(2, 2),
                               rules_for(cfg.arch), SHAPE, donate=False)
        state = init_train_state(api, AdamW(), jax.random.key(0))
        dump(f"{out}/init_{dtype}.npz", state)
        data = SyntheticLM(cfg.vocab, SHAPE.seq_len, SHAPE.global_batch, 0)
        metrics = []
        for i in range(%(steps)d):
            state, m = step(state, data.batch(i))
            metrics.append({k: float(v) for k, v in m.items()})
        dump(f"{out}/final_{dtype}.npz", state)
        json.dump(metrics, open(f"{out}/metrics_{dtype}.json", "w"))
    # the Trainer on (2, 2) saves steps 2 and 4
    res = trainer(mesh(2, 2), 2).run(4)
    dump(f"{out}/trainer_4.npz", res["state"])
elif mode == "restore":
    state, start = trainer(mesh(1, 4), 0).restore_latest()
    assert start == 4, start
    dump(f"{out}/restored_4.npz", state)
print("OK")
""" % {"seq": W.TRAIN_SEQ, "batch": W.TRAIN_BATCH, "arch": W.TRAIN_ARCH,
       "steps": STEPS}


def _jax(out: Path, mode: str, ckpt: Path) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", _JAX, str(out), mode,
                          str(ckpt)], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), \
        res.stderr[-4000:]


def _load_npz(path: Path) -> dict[str, torch.Tensor]:
    dtypes = json.loads(Path(str(path) + ".json").read_text())
    with np.load(path) as z:
        return {k: to_torch(z[k], dtypes[k]) for k in z.files}


def _close(got, want, tol, what=""):
    """|got - want| <= tol * (1 + max |want|) elementwise (the helper of
    tests/test_torch_train.py)."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want.float() if isinstance(want, torch.Tensor)
                      else want, np.float64)
    assert got.shape == want.shape, what
    scale = 1.0 + float(np.abs(want).max()) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} * {scale}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs and the port's, in the order their inputs need:
    the reference's sharded steps and (2, 2) trainer; 4 port processes
    (sharded steps, a trainer that saves, the injected crash); the
    reference restoring the port's save on (1, 4); 2 port processes
    (restoring the reference's save on (1, 2), kill and resume, the restart
    after the crash)."""
    root = tmp_path_factory.mktemp("mesh_train")
    ref, jck, pck, fck = (root / "ref", root / "jax_ckpt", root / "port_ckpt",
                          root / "fault_ckpt")
    ref.mkdir()
    _jax(ref, "step_and_save", jck)
    inits = {d: _load_npz(ref / f"init_{d}.npz")
             for d in ("float32", "bfloat16")}
    kept = str(root / "fault_step2.pt")
    four = run_processes(W.four_processes, 4,
                         (inits, STEPS, str(pck), str(fck), kept),
                         timeout=TIMEOUT, pg_timeout=PG_TIMEOUT, threads=1)
    _jax(ref, "restore", pck)
    two = run_processes(W.two_processes, 2,
                        (str(jck), str(root / "resume"), str(fck), kept),
                        timeout=TIMEOUT, pg_timeout=PG_TIMEOUT, threads=1)
    return {"ref": ref, "inits": inits, "four": four, "two": two,
            "fault_ckpt": fck, "kept": kept}


# ------------------------------------------------------------ sharded step
# Every value is held relative to its own scale: max |got - want| <= rtol *
# max |want| for the metrics and the optimizer slots, and, for a parameter,
# its update (final - init; three steps at lr <= 1e-3 move a parameter by
# under 2e-3, far below its own scale) in the 2-norm: ||du_got - du_want||
# <= rtol * ||du_want||, since a few elements of near-0 gradient may take
# either sign in AdamW's first steps.
#
# f32: both packages' ``_unembed`` casts the tied embedding to bf16, so the
# embedding's gradient from the logits is rounded to bf16 on each data rank
# before the mean (the mean of two rounded halves against the rounding of
# the whole: one bf16 ulp, 2.4e-4 of 0.099, measured in both packages), and
# the differing embedding update reaches every other gradient from the
# next step on.  Measured on the CPU with this test's inputs: the
# embedding's slots 1.6e-3 and its update 2.0e-3; every other slot and
# update 4.1e-4 at most; grad_norm 1.2e-4; the loss 8.6e-8.  bf16: the
# gradients and parameters themselves are bf16 (one ulp 2^-8 relative):
# slots 1.4e-2, updates 2.2e-2, metrics 6.2e-4 measured.  Each tolerance
# is about 5x its measured error (2x for bf16's slots and updates, which
# sit at two bf16 ulps).
RTOL = {"float32": {"metric": 1e-5, "grad_norm": 1e-3, "slot": 2e-3,
                    "update": 1e-3, "embed_slot": 1e-2,
                    "embed_update": 1e-2},
        "bfloat16": {"metric": 5e-3, "grad_norm": 5e-3, "slot": 3e-2,
                     "update": 5e-2, "embed_slot": 3e-2,
                     "embed_update": 5e-2}}


def _f64(x) -> np.ndarray:
    return np.asarray(x.double() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def _close(got, want, rtol, what=""):
    """max |got - want| <= rtol * max |want| (exact where want is 0)."""
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if want.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= rtol * scale, \
        f"{what}: max |diff| {err} > {rtol} * max |want| {scale}"


def _close_update(got, want, init, rtol, what=""):
    """||(got - init) - (want - init)|| <= rtol * ||want - init||."""
    du_got, du_want = _f64(got) - _f64(init), _f64(want) - _f64(init)
    err = float(np.linalg.norm(du_got - du_want))
    scale = float(np.linalg.norm(du_want))
    assert scale > 0, f"{what}: the reference did not update it"
    assert err <= rtol * scale, \
        f"{what}: ||diff of updates|| {err} > {rtol} * ||update|| {scale}"


def _rtol(dtype: str, name: str) -> float:
    tols = RTOL[dtype]
    if name == "grad_norm":
        return tols["grad_norm"]
    if "/" not in name:
        return tols["metric"]
    kind = "update" if name.startswith("params/") else "slot"
    return tols[f"embed_{kind}" if name.endswith("/embed") else kind]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_step_matches_reference_sharded_step(runs, dtype):
    """Three sharded steps on 4 processes, mesh (2, 2): loss, lr and the
    global grad_norm per step, every optimizer slot and every parameter's
    update, each within ``_rtol`` of its own scale against the reference's
    sharded step on a (2, 2) mesh of 4 devices; every process ends with the
    same values."""
    want_m = json.loads((runs["ref"] / f"metrics_{dtype}.json").read_text())
    want = _load_npz(runs["ref"] / f"final_{dtype}.npz")
    init = runs["inits"][dtype]
    per_rank = [r["steps"][dtype] for r in runs["four"]]
    for r in per_rank[1:]:
        assert r["metrics"] == per_rank[0]["metrics"]
        assert not W._same_bits(r["state"], per_rank[0]["state"])
    got = per_rank[0]
    for i, (gm, wm) in enumerate(zip(got["metrics"], want_m)):
        assert sorted(gm) == sorted(wm), i
        for k in wm:
            _close(gm[k], wm[k], _rtol(dtype, k), f"step {i} metric {k}")
    assert int(got["state"]["step"]) == STEPS
    assert sorted(got["state"]) == sorted(want)
    for k, v in want.items():
        assert got["state"][k].dtype == v.dtype, k
        if k.startswith("params/"):
            _close_update(got["state"][k], v, init[k], _rtol(dtype, k), k)
        elif k != "step":
            _close(got["state"][k], v, _rtol(dtype, k), k)


# ------------------------------------------------------ across the packages
def test_reference_save_restores_on_two_port_processes(runs):
    """A step the JAX Trainer saved on a (2, 2) mesh of 4 devices restores
    on 2 port processes, mesh (1, 2), bit for bit in every array, and each
    process's shard is its box of it."""
    want = _load_npz(runs["ref"] / "trainer_4.npz")
    for start, full, local_ok in (r["restored"] for r in runs["two"]):
        assert start == 4 and local_ok
        assert not W._same_bits(full, want)


def test_port_save_on_four_processes_restores_into_reference(runs):
    """A step the port's TorchTrainer saved from 4 processes, mesh (2, 2),
    restores into the JAX Trainer on a (1, 4) mesh, bit for bit."""
    got = _load_npz(runs["ref"] / "restored_4.npz")
    saved = runs["four"][0]["saved"]
    assert not W._same_bits(got, saved)


# --------------------------------------------------------- kill and resume
def test_kill_and_resume_on_one_mesh_is_bit_exact(runs):
    """Run A straight to 4; run B saving every 2 preempted at 3; run C
    restoring step 2 and running to 4 ends in A's state bit for bit, on
    every process's shards and in the whole arrays, with A's losses."""
    for r in (x["resume"] for x in runs["two"]):
        assert r["preempted"] and r["restored"] == 2
        assert [s["step"] for s in r["saved_by_b"]] == [2]
        assert r["local_differ"] == [] and r["whole_differ"] == []
        a, c = r["losses"]
        assert sorted(c) == [3, 4]
        assert all(c[s] == a[s] for s in c)


# ------------------------------------------------------------ the crash
def test_writer_crash_raises_on_every_process(runs):
    """The fault store kills rank 0's async writer 4 ops into the step-4
    save: every process raises (rank 0 the writer's error, the others the
    broadcast failure) well inside the group's timeout, and the committed
    steps are the earlier one."""
    for rank, r in enumerate(x["crashed"] for x in runs["four"]):
        assert r["start"] == 2
        assert "simulated process death" in r["crash"], (rank, r["crash"])
        if rank:
            assert r["crash"].startswith("PeerFailed"), r["crash"]
            assert "async checkpoint write failed" in r["crash"]
        assert r["run_seconds"] < PG_TIMEOUT / 2
        assert [h["step"] for h in r["history"]] == [3, 4]
    store = DatasetStore(str(runs["fault_ckpt"]), "r")
    assert TensorCheckpoint(store).steps() == [2]


def test_restart_after_crash_on_another_process_count(runs):
    """2 processes, mesh (1, 2), restart the crashed 4-process run from its
    committed step 2, every array of every shard bit-equal to the state
    the 4 processes saved there."""
    for r in (x["after_crash"] for x in runs["two"]):
        assert r["start"] == 2 and r["world"] == 2
        assert r["bit_equal_arrays"] == len(torch.load(runs["kept"]))

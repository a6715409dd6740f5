"""Adafactor on a sharded mesh: kimi-k2's smoke config trained by the
sharded step on 4 ``torch.distributed`` processes (gloo on the CPU)
against the JAX package's GSPMD step on 4 host devices.

* The smoke config as it is (dense experts) and its EP variant, at 2
  layers (layer-stacked parameters updated one leading slice at a time)
  and 1 (the whole-array branch; ``ln1`` [1, D] unfactored), f32 and bf16,
  on (2, 2) and (1, 4): 3 sharded steps against the reference's sharded
  ``make_train_step`` (on (2, 2) for the dense experts, whose values differ
  between meshes by the rounding of the sharded sums only; on the same
  mesh for EP, whose capacity follows each data rank's tokens), at
  ``tests/test_torch_kimi.py``'s tolerances where a mesh does not move
  the values further: metrics and slots within ``TOL[dtype]`` of
  ``1 + max |want|``; each parameter's change over the three steps within
  a tolerance of the reference's largest change plus one spacing of the
  parameter's dtype at its largest value, and in bf16 the MoE path's
  arrays in the 2-norm (``MOE_PATH``, as the kimi tests hold their
  gradients).  The tolerance of a change, and of ``grad_norm``, is the
  larger of kimi's and ``tests/test_torch_mesh_train.py``'s ``RTOL``: a
  mesh that splits the batch rounds the unembedding's gradient (taken
  through a bf16 copy of the table) to bf16 on each data rank before the
  mean, which that file measured.  Adafactor's update follows the
  gradient element by element (its normalisation is by row and column),
  so in f32 ``unembed``'s change carries that rounding: 4.4e-3 of its
  largest change in the max norm and 1.9e-3 in the 2-norm, where it is
  held as that file holds its tied table's update (``embed_update``,
  1e-2); ``grad_norm`` reads 6.5e-5 and every other parameter 1.9e-4 at
  most.  In bf16 a change is a few ulps of the stored parameter, which
  the spacing allowance covers; ``ln2`` (on the MoE path) reads 4.7e-2 in
  the max norm.
* Every process of a replica group holds the same bits of every array;
  the steps repeat bit for bit.
* The (2, 2) state restores on 1 process and on 2 ranks of a (1, 2) mesh
  bit for bit.
* On a (1, 1) mesh the sharded step is the one-device step bit for bit.

The reference runs in subprocesses with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` on Auto-axis meshes
(ROADMAP.md, Reference caveats), beside the port's one spawn of 4
processes, which runs both meshes.
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
from helpers import torch_adafactor_workers as W
from helpers.torch_recurrent import TOL, close
from test_torch_kimi import MOE_PATH, MOE_PATH_BF16_L2
from test_torch_mesh_train import RTOL as MESH_RTOL
from test_torch_mesh_train import _close as _close_rel
from test_torch_mesh_train import _close_update
from test_torch_mesh_train import _rtol as _mesh_rtol
from test_torch_tp import _dump, _load_npz

from repro_torch.configs.base import ShapeConfig
from repro_torch.core.comm import Comm
from repro_torch.core.store import DatasetStore
from repro_torch.core.tensor_ckpt import TensorCheckpoint
from repro_torch.core.torch_io import load_torch, to_torch
from repro_torch.distrib import sharding
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch.spawn import run_processes
from repro_torch.models.api import build_model
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optim import Adafactor
from repro_torch.train.step import (init_train_state, make_train_step,
                                    shard_state)

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300
PG_TIMEOUT = 60

_JAX = r"""
import dataclasses, functools, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config, get_smoke_config
from repro.configs.base import ShapeConfig
from repro.distrib.rules import rules_for
from repro.models.api import build_model
from repro.train import schedule
from repro.train.data import SyntheticLM
from repro.train.optim import Adafactor
from repro.train.step import make_train_step

out, impl, shape = sys.argv[1], sys.argv[2], tuple(map(int, sys.argv[3:5]))
ARCH, SEQ, BATCH, STEPS, DEPTHS, DTYPES = %(consts)r
tag = f"{impl}_{shape[0]}x{shape[1]}"
sched = functools.partial(schedule.warmup_cosine, base_lr=1e-3, warmup=2,
                          total=100)
mesh = jax.make_mesh(shape, ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
rules = rules_for(get_config(ARCH).arch)


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


for layers in DEPTHS:
    for dtype in DTYPES:
        cfg = get_smoke_config(ARCH)
        cfg = dataclasses.replace(cfg, num_layers=layers, dtype=dtype,
                                  moe=dataclasses.replace(cfg.moe,
                                                          impl=impl))
        api = build_model(cfg)
        step = make_train_step(api, Adafactor(), sched, mesh, rules,
                               ShapeConfig("t", SEQ, BATCH, "train"),
                               donate=False)
        state = load(f"{out}/init_{impl}_{layers}_{dtype}.npz")
        data = SyntheticLM(cfg.vocab, SEQ, BATCH, 0)
        metrics = []
        for i in range(STEPS):
            state, m = step(state, data.batch(i))
            metrics.append({k: float(v) for k, v in m.items()})
        dump(f"{out}/final_{tag}_{layers}_{dtype}.npz", state)
        json.dump(metrics, open(f"{out}/metrics_{tag}_{layers}_{dtype}.json",
                                "w"))
print("OK")
""" % {"consts": (W.ARCH, W.SEQ, W.BATCH, W.STEPS, W.DEPTHS, W.DTYPES)}

CASES = [(s, i, n, d) for s in W.MESHES for i in W.IMPLS for n in W.DEPTHS
         for d in W.DTYPES]


def _tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def _case_id(case) -> str:
    shape, impl, layers, dtype = case
    return f"{_tag(shape)}-{impl}-L{layers}-{dtype}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Seeded initial states written for both packages; the reference's
    steps, one subprocess per impl and reference mesh, beside the port's
    4 processes, which also save the ``SAVED`` case's (2, 2) state."""
    ref = tmp_path_factory.mktemp("adafactor")
    store = tmp_path_factory.mktemp("adafactor_store")
    inits = {}
    for impl in W.IMPLS:
        for layers in W.DEPTHS:
            for dtype in W.DTYPES:
                inits[(impl, layers, dtype)] = W.initial_state(impl, layers,
                                                               dtype)
                _dump(ref / f"init_{impl}_{layers}_{dtype}.npz",
                      inits[(impl, layers, dtype)])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cells = sorted({(i, W.ref_mesh(i, s)) for i in W.IMPLS
                    for s in W.MESHES})
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, str(ref), impl,
                               *map(str, shape)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for impl, shape in cells]
    try:
        four = run_processes(W.cases, 4, (inits, str(store)),
                             timeout=TIMEOUT, pg_timeout=PG_TIMEOUT,
                             threads=1)
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0 and out.strip().endswith("OK"), \
                err[-4000:]
    finally:
        for p in procs:
            p.kill()
    return {"ref": ref, "store": store, "inits": inits, "four": four}


# ------------------------------------------------------------ the steps
def _change_close(got, want, init, tol: float, what: str) -> None:
    """``tests/test_torch_kimi.py``'s rule for an Adafactor parameter: its
    change within ``tol`` of the reference's largest change plus one
    spacing of its dtype at its largest value."""
    du, dw = got.double() - init.double(), want.double() - init.double()
    top = float(want.double().abs().max())
    spacing = torch.finfo(got.dtype).eps * 2.0 ** np.floor(np.log2(top))
    err = float((du - dw).abs().max())
    bound = tol * float(dw.abs().max()) + spacing
    assert float(dw.abs().max()) > 0, f"{what}: the reference did not move"
    assert err <= bound, f"{what}: change off by {err} > {bound}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_adafactor_step_matches_reference_sharded_step(runs, case):
    """Three sharded Adafactor steps on 4 processes against the
    reference's sharded step on ``ref_mesh``: every metric and slot within
    ``TOL[dtype]``, every parameter by the change rule; every process
    ends with the same metrics."""
    shape, impl, layers, dtype = case
    tag = f"{impl}_{_tag(W.ref_mesh(impl, shape))}_{layers}_{dtype}"
    want_m = json.loads((runs["ref"] / f"metrics_{tag}.json").read_text())
    want = _load_npz(runs["ref"] / f"final_{tag}.npz")
    init = runs["inits"][(impl, layers, dtype)]
    per_rank = [r[case] for r in runs["four"]]
    for r in per_rank[1:]:
        assert r["metrics"] == per_rank[0]["metrics"]
    got, tol = per_rank[0], TOL[dtype]
    for i, (gm, wm) in enumerate(zip(got["metrics"], want_m)):
        assert sorted(gm) == sorted(wm), i
        for k in wm:
            if k == "grad_norm":
                _close_rel(gm[k], wm[k], MESH_RTOL[dtype][k],
                           f"step {i} {k}")
            else:
                close(gm[k], wm[k], tol, f"step {i} metric {k}")
    assert sorted(got["state"]) == sorted(want)
    for k, w in want.items():
        g = got["state"][k]
        assert g.dtype == w.dtype, k
        name = k[len("params/"):]
        if dtype == "bfloat16" and name in MOE_PATH:
            _close_update(g, w, init[k], MOE_PATH_BF16_L2, k)
        elif dtype == "float32" and name == "unembed":
            _close_update(g, w, init[k], MESH_RTOL[dtype]["embed_update"], k)
        elif k.startswith("params/"):
            _change_close(g, w, init[k], max(tol, _mesh_rtol(dtype, k)), k)
        elif k != "step":
            close(g, w, tol, k)
    assert int(got["state"]["step"]) == W.STEPS


@pytest.mark.parametrize("shape", W.MESHES, ids=_tag)
def test_replica_groups_hold_the_same_bits(runs, shape):
    """In every case, the processes whose shard of an array is the same box
    (a replica group: ``vr/`` of a weight split over ``model`` and
    ``embed``, say, is replicated over ``data``) hold the same bits, and
    the shards tile the whole array rank 0 gathered."""
    for case in CASES:
        if case[0] != shape:
            continue
        whole = runs["four"][0][case]["state"]
        for k, w in whole.items():
            by_box = {}
            for r in runs["four"]:
                t, (start, stop) = r[case]["local"][k]
                bits = t.reshape(-1).view(torch.uint8)
                box = tuple(slice(a, b) for a, b in zip(start, stop))
                assert torch.equal(bits, w[box].reshape(-1).view(
                    torch.uint8)), (case, k, start)
                by_box.setdefault((start, stop), []).append(bits)
            for copies in by_box.values():
                assert all(torch.equal(c, copies[0]) for c in copies), \
                    (case, k)


@pytest.mark.parametrize("shape", W.MESHES, ids=_tag)
def test_repeated_steps_are_bit_equal(runs, shape):
    """``SAVED``'s three steps run again on the same mesh: every process's
    shards and metrics bit for bit."""
    for r in runs["four"]:
        again = r[("repeat", shape)]
        assert again["metrics_equal"] and again["differ"] == []


# --------------------------------------------------------------- restart
def _restored_on(store: Path, ranks: int) -> list[dict]:
    """The saved state loaded by the N-to-M engine for each rank of a
    (1, ``ranks``) mesh, each its box of every array by the rule table."""
    ck = TensorCheckpoint(DatasetStore(str(store), "r"))
    assert ck.verify_step(Comm(1), W.STEPS)
    api = build_model(W.config(*W.SAVED))
    from repro_torch.train.step import train_state_specs

    specs = train_state_specs(api, Adafactor())
    rules = W.rules()
    mesh = {"data": 1, "model": ranks}
    plans = [{n: [sharding.device_box(
        s.shape, mesh, rules.spec_for(s.axes, s.shape, mesh),
        {"data": 0, "model": r})] for n, s in specs.items()}
        for r in range(ranks)]
    layout = ck.layout()
    host = ck.load_state(plans, Comm(ranks), W.STEPS)
    return [{n: (plans[r][n][0], to_torch(host[r][n][0],
                                          layout.spec(n).dtype))
             for n in specs} for r in range(ranks)]


@pytest.mark.parametrize("ranks", [1, 2])
def test_sharded_state_restores_bit_equal(runs, ranks):
    """The 4 processes' (2, 2) save of ``SAVED`` at step 3 restores on one
    process (``load_torch``, every array whole) and on the 2 ranks of a
    (1, 2) mesh (each its box, the engine's N-to-M plan for 2), bit for
    bit."""
    want = runs["four"][0][((2, 2), *W.SAVED)]["state"]
    if ranks == 1:
        target = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in want.items()}
        got = load_torch(TensorCheckpoint(DatasetStore(
            str(runs["store"]), "r")), target, W.STEPS, device="cpu")
        parts = [{k: (None, v) for k, v in got.items()}]
    else:
        parts = _restored_on(runs["store"], ranks)
    for part in parts:
        assert sorted(part) == sorted(want)
        for k, (box, t) in part.items():
            w = want[k] if box is None else want[k][box.slices()]
            assert t.dtype == w.dtype and tuple(t.shape) == tuple(w.shape)
            assert torch.equal(t.reshape(-1).view(torch.uint8),
                               w.reshape(-1).view(torch.uint8)), k


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


@pytest.mark.parametrize("impl", W.IMPLS)
def test_one_process_mesh_is_the_one_device_step_bit_for_bit(world_of_one,
                                                              impl):
    """On a (1, 1) mesh no group splits a dim: two sharded Adafactor steps
    (2 layers, bf16) give the one-device step's metrics and state bit for
    bit."""
    cfg = W.config(impl, 2, "bfloat16")
    api = build_model(cfg)
    shape = ShapeConfig("t", W.SEQ, 4, "train")
    plain = make_train_step(api, Adafactor(), W.schedule(), shape)
    mesh = launch_mesh.make_debug_mesh(1, 1, device_type="cpu")
    sharded = make_train_step(api, Adafactor(), W.schedule(), shape,
                              mesh=mesh, rules=W.rules())
    a = init_train_state(api, Adafactor(), torch.Generator().manual_seed(0))
    b = shard_state(a, mesh, sharded.state_shardings)
    data = SyntheticLM(cfg.vocab, W.SEQ, 4, seed=0)
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
        a, ma = plain(a, batch)
        b, mb = sharded(b, batch)
        assert {k: float(v) for k, v in ma.items()} == \
            {k: float(v) for k, v in mb.items()}
    for k in a:
        assert torch.equal(a[k].reshape(-1).view(torch.uint8),
                           b[k].to_local().reshape(-1).view(torch.uint8)), k

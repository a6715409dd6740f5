"""The port's expert-parallel MoE across ``torch.distributed`` processes
(gloo on the CPU) against the JAX package's ``shard_map`` path on simulated
devices.

* ``moe_ffn_ep`` on 4 processes, mesh (2, 2), against the reference's
  ``moe_ffn_ep`` on a (2, 2) mesh of 4 host devices, at the default
  capacity (the same choices drop in both): y, aux and the gradient of
  every input, the router's included; a planted fault in the router's
  gradient sum or in the aux mean's backward fails the same comparison.
* The granite smoke EP variant's sharded train step on (2, 2) against the
  reference's sharded ``make_train_step``, held as
  ``tests/test_torch_mesh_train.py`` holds smollm's.

The reference runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` on Auto-axis meshes
(ROADMAP.md, Reference caveats) and writes ``.npz`` files; the port's 4
processes run every case in one spawn.
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
from helpers import torch_moe_workers as W
from helpers.torch_mesh_workers import _same_bits

from repro_torch.core.torch_io import to_torch
from repro_torch.launch.spawn import run_processes

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300
PG_TIMEOUT = 60
STEPS = 3

_JAX = r"""
import dataclasses, functools, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.distrib.rules import rules_for
from repro.models.api import build_model
from repro.models.moe import moe_ffn_ep
from repro.train import schedule
from repro.train.data import SyntheticLM
from repro.train.optim import AdamW
from repro.train.step import init_train_state, make_train_step

out = sys.argv[1]
B, S, D, E, F, K, NUM_REAL, CF = %(ep_shape)r
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)


def dump(path, tree):
    arrays = {k: np.asarray(v) for k, v in tree.items()}
    dtypes = {k: a.dtype.name for k, a in arrays.items()}
    np.savez(path, **{k: a.view(np.uint16) if a.dtype.name == "bfloat16"
                      else a for k, a in arrays.items()})
    json.dump(dtypes, open(path + ".json", "w"))


# ---- the EP layer: the inputs of torch_moe_workers.ep_inputs
rng = np.random.default_rng(0)
ins = [rng.normal(size=(B, S, D)).astype(np.float32),
       rng.normal(size=(D, E)).astype(np.float32),
       (rng.normal(size=(E, D, F)) * 0.1).astype(np.float32),
       (rng.normal(size=(E, D, F)) * 0.1).astype(np.float32),
       (rng.normal(size=(E, F, D)) * 0.1).astype(np.float32)]


def layer(cf):
    def loss(*a):
        y, aux = moe_ffn_ep(*a, top_k=K, capacity_factor=cf,
                            num_real=NUM_REAL, mesh=mesh)
        return (y ** 2).sum() + aux, (y, aux)
    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                      has_aux=True))(*ins)


(_, (y, aux)), g = layer(CF)
(_, (y_all, _)), _ = layer(float(E))
np.savez(out + "/layer.npz", y=np.asarray(y), aux=np.asarray(aux),
         y_nothing_dropped=np.asarray(y_all),
         **{f"g{i}": np.asarray(v) for i, v in enumerate(g)})

# ---- the sharded step of granite's smoke EP variant, per dtype
sched = functools.partial(schedule.warmup_cosine, base_lr=1e-3, warmup=2,
                          total=100)
SHAPE = ShapeConfig("t", %(seq)d, %(batch)d, "train")
for dtype in ("float32", "bfloat16"):
    cfg = get_smoke_config("%(arch)s")
    cfg = dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(
        cfg.moe, impl="ep"))
    api = build_model(cfg)
    step = make_train_step(api, AdamW(), sched, mesh, rules_for(cfg.arch),
                           SHAPE, donate=False)
    state = init_train_state(api, AdamW(), jax.random.key(0))
    dump(f"{out}/init_{dtype}.npz", state)
    data = SyntheticLM(cfg.vocab, SHAPE.seq_len, SHAPE.global_batch, 0)
    metrics = []
    for i in range(%(steps)d):
        state, m = step(state, data.batch(i))
        metrics.append({k: float(v) for k, v in m.items()})
    dump(f"{out}/final_{dtype}.npz", state)
    json.dump(metrics, open(f"{out}/metrics_{dtype}.json", "w"))
print("OK")
""" % {"ep_shape": W.EP_SHAPE, "seq": W.SEQ, "batch": W.BATCH,
       "arch": W.ARCH, "steps": STEPS}


def _load_npz(path: Path) -> dict[str, torch.Tensor]:
    dtypes = json.loads(Path(str(path) + ".json").read_text())
    with np.load(path) as z:
        return {k: to_torch(z[k], dtypes[k]) for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref = tmp_path_factory.mktemp("moe_mesh")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", _JAX, str(ref)], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), \
        res.stderr[-4000:]
    inits = {d: _load_npz(ref / f"init_{d}.npz")
             for d in ("float32", "bfloat16")}
    four = run_processes(W.mesh_case, 4, (inits, STEPS), timeout=TIMEOUT,
                         pg_timeout=PG_TIMEOUT, threads=1)
    return {"ref": ref, "inits": inits, "four": four}


# ------------------------------------------------------------ the EP layer
def _f64(x) -> np.ndarray:
    return np.asarray(x.double() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _layer_errors(four, want, fault=None) -> dict[str, float]:
    """Each output's error against the reference, relative to its scale:
    y, x's gradient and the router's assembled over the data axis (the
    router's summed over it), each weight's gradient summed over the data
    axis per model rank against the reference's box of it (that rank's
    experts); every model process's copy of y, aux, x's and the router's
    gradient must agree as written."""
    by = {r["layer"]["coord"]: r["layer"][fault] for r in four}
    dp, ep = W.EP_MESH
    for d in range(dp if fault is None else 0):
        for m in range(1, ep):
            a, b = by[(d, 0)], by[(d, m)]
            assert np.array_equal(a["y"], b["y"]) and a["aux"] == b["aux"]
            for i in (0, 1):
                assert np.array_equal(a["grads"][i], b["grads"][i])
    err = {"y": _rel(np.concatenate([by[(d, 0)]["y"] for d in range(dp)]),
                     want["y"]),
           "aux": max(_rel(r["aux"], want["aux"]) for r in by.values()),
           "grad x": _rel(np.concatenate([by[(d, 0)]["grads"][0]
                                          for d in range(dp)]), want["g0"]),
           "grad router": _rel(sum(by[(d, 0)]["grads"][1]
                                   for d in range(dp)), want["g1"])}
    for i, name in ((2, "w_gate"), (3, "w_up"), (4, "w_down")):
        err[f"grad {name}"] = max(
            _rel(sum(by[(d, m)]["grads"][i] for d in range(dp)),
                 want[f"g{i}"][W.ep_boxes(W.EP_MESH, (0, m))[i]])
            for m in range(ep))
    return err


# f32: the two packages sum the same products in other orders (the
# port's combine sums a token's top_k outputs at once; the model-axis and
# data-axis sums run in f32 over gloo)
LAYER_TOL = 1e-5


def test_ep_layer_matches_reference_on_four_processes(runs):
    """4 processes, mesh (2, 2), against the reference's ``shard_map`` on 4
    devices at the default capacity: choices drop (the output differs from
    the one at capacity E), the same ones in both, and y, aux and every
    gradient agree within 1e-5 of their scale."""
    with np.load(runs["ref"] / "layer.npz") as z:
        want = dict(z)
    assert _rel(want["y_nothing_dropped"], want["y"]) > 1e-3
    for what, e in _layer_errors(runs["four"], want).items():
        assert e <= LAYER_TOL, f"{what}: {e}"


@pytest.mark.parametrize("fault,fails", [
    ("router_not_reduced", "grad router"),
    ("aux_mean_scaled", "grad router")])
def test_planted_fault_fails_the_layer_gate(runs, fault, fails):
    """The gate of the test above catches a missing model-axis sum of the
    gates' gradient (the router's gradient then holds one model shard's
    experts only) and an aux mean whose backward takes 1/n of the
    cotangent (the factor of the batch axes that ``pmean`` hides)."""
    with np.load(runs["ref"] / "layer.npz") as z:
        want = dict(z)
    err = _layer_errors(runs["four"], want, fault)
    assert err[fails] > 100 * LAYER_TOL, err
    assert err["y"] <= LAYER_TOL and err["aux"] <= LAYER_TOL


# ------------------------------------------------------------ sharded step
# Held as tests/test_torch_mesh_train.py holds smollm's sharded step (see
# its comment for the f32 embedding's bf16 unembed): every value relative
# to its own scale, a parameter by its update (final - init) in the 2-norm,
# with smollm's tolerances.
RTOL = {"float32": {"metric": 1e-5, "grad_norm": 1e-3, "slot": 2e-3,
                    "update": 1e-3, "embed_slot": 1e-2,
                    "embed_update": 1e-2},
        "bfloat16": {"metric": 5e-3, "grad_norm": 5e-3, "slot": 3e-2,
                     "update": 5e-2, "embed_slot": 3e-2,
                     "embed_update": 5e-2}}


def _close(got, want, rtol, what=""):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if want.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= rtol * scale, \
        f"{what}: max |diff| {err} > {rtol} * max |want| {scale}"


def _close_l2(got, want, rtol, what=""):
    got, want = _f64(got), _f64(want)
    err, scale = np.linalg.norm(got - want), np.linalg.norm(want)
    assert scale > 0 and err <= rtol * scale, \
        f"{what}: ||diff|| {err} > {rtol} * ||want|| {scale}"


def _rtol(dtype: str, name: str) -> float:
    tols = RTOL[dtype]
    if name == "grad_norm":
        return tols["grad_norm"]
    if "/" not in name:
        return tols["metric"]
    kind = "update" if name.startswith("params/") else "slot"
    return tols[f"embed_{kind}" if name.endswith("/embed") else kind]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ep_sharded_step_matches_reference_sharded_step(runs, dtype):
    """Three sharded steps of granite's smoke EP variant on 4 processes,
    mesh (2, 2) (each process runs 8 of the 16 experts, gathered over the
    data axis only), against the reference's sharded step on a (2, 2)
    mesh of 4 devices: loss, xent, aux, lr and grad_norm per step, every
    slot and every parameter's update; every process ends with the same
    values, and each local shard is its ``device_box``."""
    want_m = json.loads((runs["ref"] / f"metrics_{dtype}.json").read_text())
    want = _load_npz(runs["ref"] / f"final_{dtype}.npz")
    init = runs["inits"][dtype]
    per_rank = [r["steps"][dtype] for r in runs["four"]]
    for r in per_rank:
        assert r["boxes_match"] and r["expert_local"] == (2, 8, 32, 32)
    for r in per_rank[1:]:
        assert r["metrics"] == per_rank[0]["metrics"]
        assert not _same_bits(r["state"], per_rank[0]["state"])
    got = per_rank[0]
    for i, (gm, wm) in enumerate(zip(got["metrics"], want_m)):
        assert sorted(gm) == sorted(wm) == ["aux", "grad_norm", "loss", "lr",
                                            "xent"]
        for k in wm:
            _close(gm[k], wm[k], _rtol(dtype, k), f"step {i} metric {k}")
    assert int(got["state"]["step"]) == STEPS
    assert sorted(got["state"]) == sorted(want)
    for k, v in want.items():
        assert got["state"][k].dtype == v.dtype, k
        if k == "step":
            continue
        g = got["state"][k]
        if k.startswith("params/"):
            g, v = g.double() - init[k].double(), v.double() - init[k].double()
        if k.startswith("params/"):
            _close_l2(g, v, _rtol(dtype, k), k)
        else:
            _close(g, v, _rtol(dtype, k), k)

"""The port's dry run (``repro_torch/launch/dryrun.py``) and its H100
roofline (``repro_torch/launch/roofline.py``) against the JAX package's
dry run:

* for every (arch, shape, mesh) cell: ``params``, ``active_params``,
  ``model_flops`` and the skip reasons equal the reference's, computed in
  one subprocess (importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to
  512 devices, so it stays out of this process), and ``params`` lies in
  ``tests/test_arch_smoke.py``'s bands;
* the state bytes per device equal the sum of one device's boxes by the
  reference's ``rules_for(...).spec_for`` on the same axis sizes
  (``distrib/sharding.py::device_box``);
* on smollm's smoke config the counted FLOPs of a train step lie between
  6 N tokens and 3 x that, and a decode step's count grows with the cache;
* the roofline's table names the H100's peaks and each cell's binding
  term;
* a train step of a model fed embeddings (qwen2-vl, whose token table
  the loss never reads) against the reference's.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from test_arch_smoke import PARAM_BANDS

from repro.configs import ARCHS, get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import SHAPES
from repro.distrib.rules import rules_for as ref_rules_for
from repro.distrib.sharding import device_box
from repro.models.api import build_model as ref_build_model
from repro.models.api import make_token_batch
from repro.train import schedule as ref_schedule
from repro.train.optim import AdamW as RefAdamW
from repro.train.optim import make_optimizer as ref_make_optimizer
from repro.train.step import init_train_state as ref_init_train_state
from repro.train.step import make_train_step as ref_make_train_step
from repro.train.step import train_state_specs as ref_train_state_specs
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.distrib.rules import rules_for
from repro_torch.launch import dryrun, roofline
from repro_torch.models.api import build_model
from repro_torch.train import schedule
from repro_torch.train.optim import AdamW
from repro_torch.train.step import make_train_step

REPO = Path(__file__).resolve().parents[1]
MESHES = ("single", "multi")

_JAX = r"""
import json
from repro.configs import ARCHS, get_config
from repro.configs.base import SHAPES, cell_is_applicable
from repro.launch.dryrun import CELL_ORDER, model_flops
out = {"order": CELL_ORDER, "cells": {}}
for arch in ARCHS:
    cfg = get_config(arch)
    for name, shape in SHAPES.items():
        ok, why = cell_is_applicable(cfg.arch, name)
        out["cells"][f"{arch}/{name}"] = {
            "arch": cfg.arch, "kind": shape.kind,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "model_flops": model_flops(cfg, shape),
            "skip": None if ok else why}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", _JAX], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh", MESHES)
def test_static_records_match_the_reference(reference, mesh):
    assert dryrun.CELL_ORDER == reference["order"]
    for arch in ARCHS:
        for name in SHAPES:
            want = reference["cells"][f"{arch}/{name}"]
            got = dryrun.static_record(arch, name, mesh)
            for key in ("arch", "kind", "params", "active_params",
                        "model_flops"):
                assert got[key] == want[key], (arch, name, key)
            assert got.get("reason") == want["skip"], (arch, name)
            assert (got.get("status") == "skip") == (want["skip"] is not None)
            lo, hi = PARAM_BANDS[arch]
            assert lo <= got["params"] <= hi


def _ref_state_bytes(arch: str, name: str, mesh: str) -> tuple[int, int]:
    """(bytes, rows) of the device at coordinate 0 by the reference's rule
    table and ``device_box``."""
    sizes = dryrun.MESHES[mesh]
    shape = SHAPES[name]
    api = ref_build_model(get_config(arch))
    rules = ref_rules_for(api.cfg.arch, multi_pod=mesh == "multi",
                          shape_name=name)
    if shape.kind == "train":
        specs = ref_train_state_specs(
            api, ref_make_optimizer(api.cfg.optimizer))
        arrays = [(s.shape, s.axes, np.dtype(s.dtype)) for s in specs.values()]
    else:
        arrays = [(s.shape, s.axes, np.dtype(s.dtype))
                  for s in api.param_specs.values()]
        for k, s in api.cache_specs(shape.global_batch,
                                    shape.seq_len).items():
            arrays.append((s.shape, api.cache_axes()[k], np.dtype(s.dtype)))

    class Mesh:           # what spec_for reads of a mesh
        pass
    m = Mesh()
    m.shape = sizes
    origin = {a: 0 for a in sizes}

    def box(shape_, axes):
        spec = rules.spec_for(tuple(axes), tuple(shape_), m)
        return device_box(tuple(shape_), sizes, tuple(spec), origin)
    total = sum(math.prod(box(s, a).shape) * d.itemsize for s, a, d in arrays)
    return total, box((shape.global_batch,), ("batch",)).shape[0]


@pytest.mark.parametrize("mesh", MESHES)
def test_state_bytes_match_the_reference_rules(mesh):
    """Every applicable cell's state bytes per device (and per-device batch)
    against the reference's specs boxed by its own rule table."""
    for arch in ARCHS:
        for name in SHAPES:
            if dryrun.static_record(arch, name, mesh).get("status") == "skip":
                continue
            got = dryrun.cell_state(arch, name, mesh)
            want, rows = _ref_state_bytes(arch, name, mesh)
            assert got["state_bytes_per_device"] == want, (arch, name)
            assert got["device_batch"] == rows, (arch, name)
            assert got["fits_80GB"] == (want <= 80e9)


def test_counted_flops_of_a_train_step_are_sane():
    """smollm's smoke config, B 2 S 64, one process of a (1, 1) mesh: the
    counted FLOPs of the step (the forward, remat's recompute, the
    backward) lie between 6 N tokens and 3 x that; the traffic is
    positive.  A decode step counts more at a longer cache."""
    cfg = get_smoke_config("smollm_135m")
    rules, sizes = rules_for(cfg.arch), {"data": 1, "model": 1}
    shape = ShapeConfig("t", 64, 2, "train")
    got = dryrun.count_step(cfg, shape, rules, sizes, {}, 2)
    six_nt = 6.0 * cfg.param_count() * 2 * 64
    assert six_nt <= got["flops"] <= 3 * six_nt, got["flops"] / six_nt
    assert got["bytes"] > 0
    short, long_ = (dryrun.count_step(cfg, ShapeConfig("d", n, 2, "decode"),
                                      rules, sizes, {}, 2)
                    for n in (64, 128))
    assert long_["flops"] > short["flops"] and long_["bytes"] > short["bytes"]


#: whisper's parameters stored split over a 16-wide model axis (their
#: 512 columns divide 16) whose activation's 8 heads do not: each step
#: gathers them
_WHISPER_GATHERED_AT_16 = ([f"{p}/{k}" for p in ("enc", "dec")
                            for k in ("wq", "wk", "wv")]
                           + ["dec/xq", "dec/xk", "dec/xv"])


@pytest.mark.parametrize("arch,name,compute", [
    ("recurrentgemma_9b", "train_4k", "batch over model"),
    ("recurrentgemma_9b", "prefill_32k", "split over model"),
    ("recurrentgemma_9b", "decode_32k", "split over model"),
    ("whisper_base", "train_4k", "split over model"),
    ("whisper_base", "prefill_32k", "split over model"),
    ("whisper_base", "decode_32k", "split over model"),
    ("xlstm_350m", "train_4k", "split over model"),
])
def test_cells_split_their_compute_over_model(arch, name, compute):
    """A cell's step as ``run_cell`` counts it on the production (16, 16)
    mesh (the cell's config, rule table and knobs), its depth cut (one
    (lru, lru, local) group, 1 + 1 whisper layers, 2 xlstm layers) and its
    sequence to 64 (the split follows the rule table and the widths):
    recurrentgemma's prefill and decode, whisper's three cells and xlstm's
    train cell split their compute over the model axis.  recurrentgemma's
    and xlstm's parameters are all this process's part there (xlstm's
    inner width of 2,048, gate columns of 4,096 and ``w_out``'s 1,024
    rows divide 16); whisper's 8 heads stay whole on a 16-wide axis, so
    the step gathers the q, k and v projections (stored split by their
    512 columns) and splits ``wo``, ``xo`` and the MLP.  recurrentgemma's
    train cell puts its batch on the model axis (``configs/perf.py``:
    ``batch`` over data and model)."""
    shape = dryrun.SHAPES[name]
    cfg, knobs = dryrun._cfg_for(arch, shape, "single")
    layers = {"recurrentgemma_9b": 3, "whisper_base": 1, "xlstm_350m": 2}
    cfg = dataclasses.replace(cfg, num_layers=layers[arch],
                              encoder_layers=1 if cfg.enc_dec else 0)
    rules = rules_for(cfg.arch, shape_name=name)
    sizes = dryrun.MESHES["single"]
    got = dryrun.count_step(cfg, ShapeConfig(name, 64, 1, shape.kind), rules,
                            sizes, knobs, 1)
    assert got["compute"] == compute
    assert got["flops"] > 0 and got["bytes"] > 0
    if compute == "split over model":
        specs, m = build_model(cfg).param_specs, sizes["model"]
        want = sum(math.prod(specs[n].shape) * 2 // m * (m - 1)
                   for n in _WHISPER_GATHERED_AT_16) if cfg.enc_dec else 0
        assert got["comm_bytes_model"]["parameter"] == want
        assert got["comm_bytes_model"]["activation"] > 0


def test_roofline_names_the_h100_peaks_and_the_binding_term(tmp_path):
    """Records of a counted cell and a skipped one: the table states the
    card and its peaks, the skip, and the counted cell's bound as the
    larger of its two terms."""
    for arch, name in (("smollm_135m", "decode_32k"),
                       ("smollm_135m", "long_500k")):
        dryrun.run_cell(arch, name, "single", out_dir=tmp_path)
    rows, md = roofline.table("single", tmp_path)
    assert "H100" in md and "989 TFLOP/s" in md and "3.35 TB/s" in md
    assert "700 W" in md and "skip" in md
    (row,) = rows
    assert row["binding"] in md
    assert row["bound_s"] == max(row["flops"] / 989e12, row["bytes"] / 3.35e12)
    assert row["binding"] == ("compute" if row["flops"] / 989e12
                              >= row["bytes"] / 3.35e12 else "memory")


def test_train_step_of_an_embeddings_model_matches_the_reference():
    """qwen2-vl's backbone fed embeddings never reads its token table, so
    the table's gradient is zero, as under ``jax.grad`` (the dry run
    counts this step): one f32 train step of the smoke config against the
    reference's, the metrics and every array within 1e-5 of its scale
    (parameters plus an lr-sized AdamW step)."""
    arch, shape = "qwen2_vl_7b", ShapeConfig("t", 16, 2, "train")
    cfg = dataclasses.replace(ref_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    api = ref_build_model(cfg)
    kw = dict(base_lr=1e-3, warmup=2, total=100)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ref_step = ref_make_train_step(
        api, RefAdamW(), functools.partial(ref_schedule.warmup_cosine, **kw),
        mesh, ref_rules_for(cfg.arch), shape, donate=False)
    step = make_train_step(build_model(tcfg), AdamW(),
                           functools.partial(schedule.warmup_cosine, **kw),
                           shape)
    jstate = ref_init_train_state(api, RefAdamW(), jax.random.key(0))
    tstate = params_from_jax({k: np.asarray(v) for k, v in jstate.items()},
                             device="cpu")
    batch = make_token_batch(cfg, shape, seed=0)
    jstate, jm = ref_step(jstate, batch)
    tstate, tm = step(tstate, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    for k, v in list(jm.items()) + list(jstate.items()):
        want = np.asarray(v, np.float64)
        got = (tm[k] if k in tm else tstate[k]).double().numpy()
        tol = 1e-5 * (1 + np.abs(want).max()) + (
            2e-3 if k.startswith("params/") else 0.0)
        assert np.abs(got - want).max() <= tol, k

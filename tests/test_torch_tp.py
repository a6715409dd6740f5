"""Tensor-parallel compute over the model axis: the transformer family's
sharded train and prefill steps on 4 ``torch.distributed`` processes (gloo
on the CPU) against the JAX package's GSPMD steps on 4 host devices.

* smollm-135m, qwen3-1.7b (qk-norm), gemma2-2b (softcap and window on the
  blocked path) and granite-moe (its attention split beside the EP
  experts), smoke configs, on (2, 2) and (1, 4): 3 sharded steps against
  the reference's sharded ``make_train_step`` (an Auto-axis
  ``jax.make_mesh``; on (2, 2) for the dense configs, whose values differ
  between meshes by the rounding of the sharded sums only, and on the
  same mesh for granite, whose expert capacity follows each data rank's
  tokens: ``torch_tp_workers.ref_mesh``), within
  ``tests/test_torch_mesh_train.py``'s ``RTOL`` for f32 and bf16; every
  process ends with the same metrics.  A (4, 1) mesh splits nothing over
  the model axis: ``tests/test_torch_mesh_train.py`` and
  ``test_torch_moe_mesh.py`` hold it;
* the sharded prefill's logits and cache against the reference's within
  1e-5 of their scale in f32;
* what the step moves over the model axis: every parameter whose split
  matches its activation's is this process's part (never gathered over
  ``model``), the others' gathers are the only parameter bytes, and a
  step's activation bytes do not grow with d_ff;
* ``collectives.all_sum`` (the reduce-scatter and all-gather every sum
  over a group runs) gives the rank-order f32 sum's bits on every
  process, and sends ``2 (n - 1) / n`` of the tensor;
* on a (1, 1) mesh every family's sharded step is the one-device step bit
  for bit.

The reference runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` on Auto-axis meshes
(ROADMAP.md, Reference caveats) and writes ``.npz`` files; the port's 4
processes run every case in one spawn.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from helpers import torch_tp_workers as W
from test_torch_mesh_train import _close, _close_update, _rtol

from repro_torch.core.torch_io import to_torch
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch.spawn import run_processes
from repro_torch.models.api import build_model

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300
PG_TIMEOUT = 60
# f32 prefill: the packages sum the same products in other orders
PREFILL_TOL = 1e-5

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
SEQ = int(sys.argv[5])
tag = f"{arch}_{shape[0]}x{shape[1]}"
BATCH, P, PB, CACHE, STEPS = %(sizes)r
sched = functools.partial(schedule.warmup_cosine, base_lr=1e-3, warmup=2,
                          total=100)
mesh = jax.make_mesh(shape, ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
rules = rules_for(get_config(arch).arch)


def config(dtype):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    if arch == "gemma2_2b":
        cfg = dataclasses.replace(cfg, attention_impl="xla_flash",
                                  attn_block_q=8, attn_block_k=8)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="ep"))
    return cfg


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
        state, m = step(state, data.batch(i))
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
""" % {"sizes": (W.BATCH, W.P, W.PB, W.CACHE, W.STEPS),
       "dtypes": W.DTYPES}


def _load_npz(path: Path) -> dict[str, torch.Tensor]:
    dtypes = json.loads(Path(str(path) + ".json").read_text())
    with np.load(path) as z:
        return {k: to_torch(z[k], dtypes[k]) for k in z.files}


def _dump(path: Path, tree: dict[str, torch.Tensor]) -> None:
    arrays = {k: v.view(torch.int16).numpy().view(np.uint16)
              if v.dtype == torch.bfloat16
              else v.numpy() for k, v in tree.items()}
    np.savez(path, **arrays)
    path.with_name(path.name + ".json").write_text(json.dumps(
        {k: str(v.dtype).removeprefix("torch.") for k, v in tree.items()}))


def _tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def _ref_tag(arch: str, shape) -> str:
    """The reference run a port run on ``shape`` is held to."""
    return f"{arch}_{_tag(W.ref_mesh(arch, shape))}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Seeded initial states (train, per arch and dtype) and f32 parameters
    (prefill, per arch) written for both packages; the reference's steps
    (``ref_mesh``), one subprocess per arch and mesh, run beside the
    port's 4 processes."""
    ref = tmp_path_factory.mktemp("tp")
    inits, params = {}, {}
    for arch in W.ARCHS:
        for dtype in W.DTYPES:
            inits[(arch, dtype)] = W.initial_state(arch, dtype)
            _dump(ref / f"init_{arch}_{dtype}.npz", inits[(arch, dtype)])
        params[arch] = W.initial_params(arch)
        _dump(ref / f"params_{arch}.npz", params[arch])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cells = sorted({(a, W.ref_mesh(a, s)) for a in W.ARCHS for s in W.MESHES})
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, str(ref), arch,
                               *map(str, shape), str(W.seq(arch))],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for arch, shape in cells]
    try:
        four = run_processes(W.tp_cases, 4, (inits, params), timeout=TIMEOUT,
                             pg_timeout=PG_TIMEOUT, threads=1)
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0 and out.strip().endswith("OK"), \
                err[-4000:]
    finally:
        for p in procs:
            p.kill()
    return {"ref": ref, "inits": inits, "four": four}


# ------------------------------------------------------------ train steps
@pytest.mark.parametrize("dtype", W.DTYPES)
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("shape", W.MESHES, ids=_tag)
def test_tp_step_matches_reference_sharded_step(runs, shape, arch, dtype):
    """Three sharded steps on 4 processes: loss, lr and grad_norm per step,
    every optimizer slot and every parameter's update within ``_rtol`` of
    its scale against the reference's sharded step on ``ref_mesh``; every
    process ends with the same metrics."""
    ref, tag = runs["ref"], _ref_tag(arch, shape)
    want_m = json.loads((ref / f"metrics_{tag}_{dtype}.json").read_text())
    want = _load_npz(ref / f"final_{tag}_{dtype}.npz")
    init = runs["inits"][(arch, dtype)]
    per_rank = [r[("train", shape, arch, dtype)] for r in runs["four"]]
    for r in per_rank[1:]:
        assert r["metrics"] == per_rank[0]["metrics"]
    got = per_rank[0]
    for i, (gm, wm) in enumerate(zip(got["metrics"], want_m)):
        assert sorted(gm) == sorted(wm), i
        for k in wm:
            _close(gm[k], wm[k], _rtol(dtype, k), f"step {i} metric {k}")
    assert sorted(got["state"]) == sorted(want)
    for k, v in want.items():
        assert got["state"][k].dtype == v.dtype, k
        if k.startswith("params/"):
            _close_update(got["state"][k], v, init[k], _rtol(dtype, k), k)
        elif k != "step":
            _close(got["state"][k], v, _rtol(dtype, k), k)


# ---------------------------------------------------------------- prefill
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("shape", W.MESHES, ids=_tag)
def test_tp_prefill_matches_reference(runs, shape, arch):
    """The sharded prefill's last-position logits and its cache (k, v,
    length) against the reference's sharded prefill on ``ref_mesh``, f32,
    within 1e-5 of their scale."""
    want = _load_npz(runs["ref"] / f"prefill_{_ref_tag(arch, shape)}.npz")
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


# ------------------------------------------------ the model axis's traffic
#: each model-split parameter's activation (by its name within its
#: stack): its logical axis and size; whisper's cross-attention's as its
#: self-attention's, the RG-LRU block's its width
_ACTIVATION = {"wq": ("heads", "num_heads"), "wk": ("kv_heads", "num_kv_heads"),
               "wv": ("kv_heads", "num_kv_heads"),
               "wo": ("heads", "num_heads"), "w_gate": ("mlp", "d_ff"),
               "w_up": ("mlp", "d_ff"), "w_down": ("mlp", "d_ff"),
               "embed": ("vocab", "vocab"), "unembed": ("vocab", "vocab"),
               "xq": ("heads", "num_heads"), "xk": ("kv_heads", "num_kv_heads"),
               "xv": ("kv_heads", "num_kv_heads"),
               "xo": ("heads", "num_heads"),
               **{k: ("mlp", "lru_width") for k in (
                   "w_y", "w_x", "conv", "lam", "w_a", "w_i", "w_out")}}
#: xLSTM's split parameters by name (their base names recur with other
#: activations): the mLSTM's inner width 2 D, the sLSTM's gate columns
#: 4 D and ``w_out``'s rows D, each of which a model axis that divides
#: d_model divides
_XLSTM_ACTIVATION = {
    **{f"m/{k}": ("mlp", "d_model") for k in (
        "w_up", "w_gate", "wq", "wk", "wv", "w_if", "w_down")},
    **{f"s/{k}": ("mlp", "d_model") for k in ("w", "b", "w_out")}}


def _expected(arch: str, shape) -> tuple[set[str], int]:
    """The parameters stored split over ``model`` whose activation the rule
    splits too (each process keeps its part), and the bytes a step's
    gathers of the others send (this process's part of each, to each of
    the ``m - 1`` others)."""
    m = shape[1]
    cfg = W.config(arch, "float32")
    api, rules = build_model(cfg), W.rules(arch)
    sizes = {"data": shape[0], "model": m}
    aligned, gathered = set(), 0
    for name, spec in api.param_specs.items():
        pspec = rules.spec_for(spec.axes, spec.shape, sizes)
        on_model = [d for d, e in enumerate(pspec) if e == "model"]
        if m == 1 or not on_model or "experts" in spec.axes:
            continue
        base = name.rsplit("/", 1)[-1]
        axis, size = (_XLSTM_ACTIVATION[name] if cfg.recurrent == "xlstm"
                      and name in _XLSTM_ACTIVATION
                      else _ACTIVATION.get(base, (None, None)))
        n = getattr(cfg, size) * (cfg.head_dim_ if base in ("wo", "xo")
                                  else 1) if size else 0
        if (axis is not None and spec.axes[on_model[0]] == axis
                and n % m == 0):
            aligned.add(name)
        else:
            gathered += math.prod(spec.shape) * 4 // m * (m - 1)
    return aligned, gathered


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("shape", W.MESHES, ids=_tag)
def test_aligned_parameters_are_never_gathered_over_model(runs, shape, arch):
    """Every parameter stored split over ``model`` whose activation the rule
    splits as well is this process's part of the step (``local_params``,
    the experts beside them), and the only parameter bytes on the model
    group are the gathers of the others, once a step."""
    aligned, gathered = _expected(arch, shape)
    for r in runs["four"]:
        got = r[("train", shape, arch, "float32")]
        experts = {n for n in got["local_params"]
                   if n.startswith("we_")}
        assert set(got["local_params"]) - experts == aligned
        assert got["sent"]["parameter"] == W.STEPS * gathered
    if shape == (1, 4) and arch == "smollm_135m":
        # Hkv 2 does not split 4 ways: the attention runs whole and k, v
        # come from wk, wv gathered; q is computed on this process's head
        assert aligned == {"wq", "wo", "w_gate", "w_up", "w_down", "embed"}
        assert gathered > 0
    if shape == (2, 2):
        assert gathered == 0


@pytest.mark.parametrize("shape", [s for s in W.MESHES if s[1] > 1],
                         ids=_tag)
def test_model_axis_bytes_do_not_grow_with_d_ff(runs, shape):
    """smollm's step at d_ff 128 and 256 sends the same activation bytes
    over the model axis (the MLP's hidden never leaves its process), and
    they are more than none."""
    for r in runs["four"]:
        narrow = r[("train", shape, "smollm_135m", "float32")]["sent"]
        wide = r[("wide", shape)]["sent"]
        assert narrow["activation"] > 0
        assert narrow["activation"] == W.STEPS * wide["activation"]
        assert narrow["parameter"] == W.STEPS * wide["parameter"]


# ------------------------------------------------------------ the sums
@pytest.mark.parametrize("name", sorted(W.SUMS))
@pytest.mark.parametrize("axis", ("model", "world"))
@pytest.mark.parametrize("shape", W.MESHES, ids=_tag)
def test_all_sum_is_the_rank_order_sum_on_every_process(runs, shape, axis,
                                                         name):
    """``all_sum`` over the model axis's group and over all 4 processes:
    on every process the bits of the addends added in f32 in rank order
    and cast back, in the addend's shape and dtype; each process sends
    its chunks to the others and its sum to them, ``2 (n - 1)`` chunks of
    ``ceil(numel / n)`` elements, as a ring all-reduce does."""
    for r in runs["four"]:
        case = r[("sums", shape)][(axis, name)]
        got, want, n = case["got"], case["want"], case["n"]
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8))
        chunk = -(-want.numel() // n)
        assert case["sent"] == 2 * (n - 1) * chunk * want.element_size()


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
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optim import AdamW
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        shard_state)
    from repro_torch.configs.base import ShapeConfig

    cfg = W.config(arch, "float32")
    api = build_model(cfg)
    shape = ShapeConfig("t", 16, 4, "train")
    plain = make_train_step(api, AdamW(), W._sched(), shape)
    mesh = launch_mesh.make_debug_mesh(1, 1, device_type="cpu")
    sharded = make_train_step(api, AdamW(), W._sched(), shape, mesh=mesh,
                              rules=W.rules(arch))
    a = init_train_state(api, AdamW(), torch.Generator().manual_seed(0))
    b = shard_state(a, mesh, sharded.state_shardings)
    data = SyntheticLM(cfg.vocab, 16, 4, seed=0)
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
        a, ma = plain(a, batch)
        b, mb = sharded(b, batch)
        assert {k: float(v) for k, v in ma.items()} == \
            {k: float(v) for k, v in mb.items()}
    for k in a:
        assert torch.equal(a[k].view(-1).view(torch.uint8),
                           b[k].to_local().view(-1).view(torch.uint8)), k

"""Dry run of the port, the counterpart of the JAX package's
``launch/dryrun.py``: for every (architecture x input shape x production
mesh) cell, what one process of the port would hold and compute, found
without a card, a process group or any memory for the arrays.

Per cell it records, into ``build/dryrun/<mesh>/<arch>__<shape>.json``,
with one summary line on stdout:

* ``params``, ``active_params`` and ``model_flops`` (the useful-compute
  yardstick: 6 N_active tokens for a train step, 2 N_active tokens for a
  prefill, 2 N_active per new token for a decode step), from the config;
  ``status: "skip"`` and the reason where the cell does not apply;
* ``state_bytes_per_device``: the bytes of one device's box of the state
  (train: the parameters, the optimizer's slots and the step; prefill and
  decode: the parameters and the serving cache) by the arch's rule table
  on the production mesh's axis sizes (16 x 16, or 2 x 16 x 16); every box
  is even (the rule table replicates a dim its axes do not divide), so
  every device holds as much, and ``fits_80GB`` says whether that fits
  one H100;
* ``flops`` and ``bytes`` per device: ``FlopCounterMode`` and a dispatch
  mode that sums each aten op's input and output bytes (eager PyTorch's
  traffic; views and allocations move nothing), over the port's own
  one-device step on ``meta`` tensors at the per-device batch (the global
  batch over the batch axes' extent), with the config's remat and the
  shape's step knobs.  This is what the port's sharded steps run on each
  process today: the compute repeats over the model axis
  (``"compute": "repeated over model"``), but for an expert-parallel MoE
  layer, which runs this process's experts only (its collectives move no
  bytes of the count: they are communication).  The ``rglru_scan``
  kernel cannot run on ``meta``: its stand-in counts the kernel's own
  traffic (its inputs read once, its outputs written once) and no FLOPs,
  as the counter counts no elementwise work anywhere.  A cell whose step
  cannot be counted records ``null`` and the reason.

``launch/roofline.py`` turns the records into the H100 roofline.  Runs on
the CPU; imports neither JAX nor the JAX package.

    python -m repro_torch.launch.dryrun --mesh single
    python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import pathlib
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeConfig, cell_is_applicable
from repro_torch.configs.perf import step_knobs
from repro_torch.distrib.context import MeshContext, use_mesh_context
from repro_torch.distrib.rules import rules_for
from repro_torch.models.api import BatchSpec, build_model
from repro_torch.train.optim import make_optimizer
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.step import (make_decode_step, make_prefill_step,
                                    make_train_step, train_state_specs)

RESULTS = pathlib.Path(__file__).resolve().parents[2] / "build" / "dryrun"

# cheap archs first so a long run yields cells early
CELL_ORDER = [
    "whisper_base", "smollm_135m", "xlstm_350m", "qwen3_1_7b", "gemma2_2b",
    "granite_moe_3b_a800m", "qwen3_4b", "recurrentgemma_9b", "qwen2_vl_7b",
    "kimi_k2_1t_a32b",
]
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
#: one H100's memory (bytes)
DEVICE_BYTES = 80e9


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS (the 'useful compute' yardstick):
    train: 6 N_active tokens; prefill: 2 N_active tokens;
    decode: 2 N_active per new token (B tokens per step)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


# ------------------------------------------------------------ state bytes
def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def device_shape(rules, sizes: dict, shape, axes) -> tuple[int, ...]:
    """One device's box of an array of ``shape`` (every device's is as
    large: ``spec_for`` shards a dim only over axes that divide it)."""
    spec = rules.spec_for(tuple(axes), tuple(shape), sizes)
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        out.append(n // math.prod(sizes[a] for a in names))
    return tuple(out)


def state_bytes(rules, sizes: dict, arrays) -> int:
    """The bytes of one device's boxes of ``arrays``: (shape, axes, dtype)
    triples."""
    return sum(math.prod(device_shape(rules, sizes, s, a)) * _itemsize(t)
               for s, a, t in arrays)


def _cfg_for(arch: str, shape, mesh_tag: str):
    """The cell's config (its remat group from the step knobs) and the
    step's other knobs."""
    cfg = get_config(arch)
    knobs = dict(step_knobs(cfg.arch, shape.name, mesh_tag)
                 if shape.kind == "train" else {})
    if "remat_group" in knobs:
        cfg = dataclasses.replace(cfg, remat_group=knobs.pop("remat_group"))
    return cfg, knobs


def cell_state(arch: str, shape_name: str, mesh_tag: str) -> dict:
    """The record's state part: the per-device batch and the bytes of one
    device's box of the step's state."""
    shape = SHAPES[shape_name]
    cfg, _ = _cfg_for(arch, shape, mesh_tag)
    api, sizes = build_model(cfg), MESHES[mesh_tag]
    rules = rules_for(cfg.arch, multi_pod=mesh_tag == "multi",
                      shape_name=shape_name)
    if shape.kind == "train":
        specs = train_state_specs(api, make_optimizer(cfg.optimizer))
        arrays = [(s.shape, s.axes, s.dtype) for s in specs.values()]
    else:
        c_specs = api.cache_specs(shape.global_batch, shape.seq_len)
        arrays = ([(s.shape, s.axes, s.dtype)
                   for s in api.param_specs.values()]
                  + [(s.shape, api.cache_axes()[k], s.dtype)
                     for k, s in c_specs.items()])
    nbytes = state_bytes(rules, sizes, arrays)
    (rows,) = device_shape(rules, sizes, (shape.global_batch,), ("batch",))
    return {"mesh_shape": dict(sizes), "chips": math.prod(sizes.values()),
            "device_batch": rows, "state_bytes_per_device": nbytes,
            "fits_80GB": nbytes <= DEVICE_BYTES}


# ------------------------------------------------------- counting on meta
_MOVES_NOTHING = {torch.ops.aten.empty.memory_format,
                  torch.ops.aten.empty_strided.default,
                  torch.ops.aten.empty_like.default,
                  torch.ops.aten.detach.default}


class Traffic(TorchDispatchMode):
    """The bytes each aten op reads and writes: its tensor inputs and
    outputs, once each (views and allocations move nothing)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def add(self, *tensors) -> None:
        self.bytes += sum(t.numel() * t.element_size() for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func in _MOVES_NOTHING):
            self.add(*(t for t in tree_flatten((args, kwargs, out))[0]
                       if isinstance(t, torch.Tensor)))
        return out


class _CountingMesh:
    """The production mesh's extents for the model code, with no
    processes behind it: an expert-parallel layer sizes its experts and
    capacity by them and runs as the process at coordinate 0, its
    collectives (groups of None) the identity."""

    def __init__(self, sizes: dict):
        self.shape = dict(sizes)

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


@contextlib.contextmanager
def _scan_stand_in(traffic: Traffic):
    """``rglru_scan`` on ``meta``: outputs of the kernel's shapes, and the
    kernel's own traffic (inputs read once, outputs written once)."""
    from repro_torch.kernels.rglru_scan import ops

    saved = ops.lru_scan, ops.lru_scan_bwd

    def scan(a, b, h0=None):
        h = torch.empty_like(a)
        last = torch.empty_like(a[:, 0])
        traffic.add(a, b, h, last, *(() if h0 is None else (h0,)))
        return h, last

    def scan_bwd(a, h, h0, g, g_last):
        da, db = torch.empty_like(a), torch.empty_like(a)
        traffic.add(a, h, g, da, db,
                    *(t for t in (h0, g_last) if t is not None))
        return da, db, None if h0 is None else torch.empty_like(h0)

    ops.lru_scan, ops.lru_scan_bwd = scan, scan_bwd
    try:
        yield
    finally:
        ops.lru_scan, ops.lru_scan_bwd = saved


def _meta(specs) -> dict[str, torch.Tensor]:
    return {n: torch.empty(s.shape, dtype=getattr(torch, s.dtype),
                           device="meta") for n, s in specs.items()}


def _per_process(specs: dict, ep: int) -> dict:
    """``specs`` with every expert dim cut to one process's experts."""
    out = {}
    for n, s in specs.items():
        if "experts" in s.axes and ep > 1:
            d = s.axes.index("experts")
            s = dataclasses.replace(s, shape=s.shape[:d] + (s.shape[d] // ep,)
                                    + s.shape[d + 1:])
        out[n] = s
    return out


def count_step(cfg, shape: ShapeConfig, rules, sizes: dict, knobs: dict,
               rows: int) -> dict:
    """FLOPs and bytes of one process's step at ``rows`` rows, on meta."""
    api = build_model(cfg)
    ctx = MeshContext(mesh=_CountingMesh(sizes), dp_axes=rules.batch_axes,
                      ep_axis="model", rules=rules)

    def within(fn):
        def run(*args):
            with use_mesh_context(ctx):
                return fn(*args)
        return run
    ep = (sizes["model"] if cfg.moe is not None and cfg.moe.impl == "ep"
          and cfg.moe.num_experts_padded % sizes["model"] == 0 else 1)
    api = dataclasses.replace(
        api, param_specs=_per_process(api.param_specs, ep),
        loss=within(api.loss), prefill=within(api.prefill),
        decode_step=within(api.decode_step))
    local = ShapeConfig(shape.name, shape.seq_len, rows, shape.kind)
    params = _meta(api.param_specs)
    traffic = Traffic()
    with _scan_stand_in(traffic), FlopCounterMode(display=False) as fc, \
            traffic:
        if shape.kind == "train":
            opt = make_optimizer(cfg.optimizer)
            step = make_train_step(
                api, opt, functools.partial(warmup_cosine, base_lr=3e-4,
                                            warmup=2000, total=100_000),
                local, **knobs)
            step(_meta(train_state_specs(api, opt)),
                 _meta(api.input_specs(local)))
        elif shape.kind == "prefill":
            make_prefill_step(api, local)(params,
                                          _meta(api.input_specs(local)))
        else:
            cache = _meta(api.cache_specs(rows, shape.seq_len))
            batch = _meta({"token": BatchSpec((rows, 1), "int32"),
                           "pos": BatchSpec((rows,), "int32")})
            with torch.inference_mode():
                make_decode_step(api)(params, cache, batch)
    return {"flops": float(fc.get_total_flops()), "bytes": float(traffic.bytes),
            "experts_per_process": (cfg.moe.num_experts_padded // ep
                                    if cfg.moe is not None else None)}


def static_record(arch: str, shape_name: str, mesh_tag: str) -> dict:
    """The record's part the config alone gives: the counts, the useful
    FLOPs and, where the cell does not apply, ``status: "skip"`` and why."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    record: dict = {
        "arch": cfg.arch, "shape": shape_name, "mesh": mesh_tag,
        "kind": shape.kind,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "model_flops": model_flops(cfg, shape),
    }
    ok, why = cell_is_applicable(cfg.arch, shape_name)
    if not ok:
        record.update(status="skip", reason=why)
    return record


def run_cell(arch: str, shape_name: str, mesh_tag: str, force: bool = False,
             out_dir: pathlib.Path | None = None) -> dict:
    out_dir = (out_dir or RESULTS) / mesh_tag
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}__{shape_name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    record = static_record(arch, shape_name, mesh_tag)
    if record.get("status") == "skip":
        out_path.write_text(json.dumps(record, indent=1))
        return record

    t0 = time.time()
    shape = SHAPES[shape_name]
    record.update(cell_state(arch, shape_name, mesh_tag))
    record["compute"] = "repeated over model"
    cfg, knobs = _cfg_for(arch, shape, mesh_tag)
    rules = rules_for(cfg.arch, multi_pod=mesh_tag == "multi",
                      shape_name=shape_name)
    try:
        record.update(count_step(cfg, shape, rules, MESHES[mesh_tag], knobs,
                                 record["device_batch"]))
        record["status"] = "ok"
    except Exception as e:                               # noqa: BLE001
        record.update(flops=None, bytes=None, status="ok",
                      null_reason=f"{type(e).__name__}: {e}")
    record["total_seconds"] = round(time.time() - t0, 1)
    out_path.write_text(json.dumps(record, indent=1))
    return record


def iter_cells(archs, shapes):
    for arch in archs:
        for shape_name in shapes:
            yield arch, shape_name


def summary(rec: dict) -> str:
    """The cell's stdout line."""
    extra = ""
    if rec["status"] == "skip":
        extra = rec["reason"][:60]
    elif rec.get("flops") is None:
        extra = f"null: {rec.get('null_reason', '')[:80]}"
    else:
        extra = (f"state={rec['state_bytes_per_device'] / 1e9:.2f}GB "
                 f"fits={rec['fits_80GB']} flops={rec['flops']:.3e} "
                 f"bytes={rec['bytes']:.3e} "
                 f"{rec.get('total_seconds', 0):.0f}s")
    return (f"[{rec['mesh']}] {rec['arch']:24s} {rec['shape']:12s} "
            f"{rec['status']:5s} {extra}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="the port's dry run")
    ap.add_argument("--arch", default=None, help="single arch id")
    ap.add_argument("--shape", default=None, help="single shape name")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch.replace("-", "_")] if args.arch else CELL_ORDER
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]

    if args.list:
        for arch, shape in iter_cells(archs, shapes):
            for m in meshes:
                p = RESULTS / m / f"{arch}__{shape}.json"
                status = "-"
                if p.exists():
                    status = json.loads(p.read_text()).get("status", "?")
                print(f"{m:7s} {arch:24s} {shape:12s} {status}")
        return

    n_ok = n_skip = n_null = 0
    for mesh_tag in meshes:
        for arch, shape in iter_cells(archs, shapes):
            rec = run_cell(arch, shape, mesh_tag, force=args.force)
            n_ok += rec["status"] == "ok"
            n_skip += rec["status"] == "skip"
            n_null += rec["status"] == "ok" and rec.get("flops") is None
            print(summary(rec), flush=True)
    print(f"done: {n_ok} ok ({n_null} with null counts), {n_skip} skip")


if __name__ == "__main__":
    main()

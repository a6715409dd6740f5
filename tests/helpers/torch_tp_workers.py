"""What tests/test_torch_tp.py runs on every process of a 4-process mesh
(``repro_torch.launch.spawn.run_processes``): the transformer family's
sharded train and prefill steps with their compute split over the model
axis; and what ``chip_smoke.py``'s ``tp_train`` phase and the card tests
run on each process of a mesh that shares one card (``card_tp_train``).
Imports torch and the port only.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distrib import collectives
from repro_torch.distrib.rules import local_box, mesh_shape, rules_for
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.api import build_model, make_token_batch
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optim import AdamW
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.step import (init_train_state, make_prefill_step,
                                    make_train_step, shard_state)

#: the smoke configs: GQA, qk-norm, softcap and window on the blocked path
#: (8-wide blocks, so key blocks are skipped), TP attention beside EP
ARCHS = ("smollm_135m", "qwen3_1_7b", "gemma2_2b", "granite_moe_3b_a800m")
#: the meshes whose model axis splits: a (4, 1) mesh runs the one-device
#: ops, which tests/test_torch_mesh_train.py and test_torch_moe_mesh.py hold
MESHES = ((2, 2), (1, 4))


def seq(arch: str) -> int:
    """The train steps' sequence length: granite's is
    tests/test_torch_moe_mesh.py's 16; at 32 its bf16 expert slots drift
    from the reference's past that file's tolerance on every mesh, (4, 1)
    too, where nothing is split over the model axis (top-k choices that
    flip in bf16)."""
    return 16 if get_smoke_config(arch).moe is not None else 32


def ref_mesh(arch: str, shape) -> tuple[int, int]:
    """The reference's mesh a port run on ``shape`` is held to: the same
    for an MoE config (the experts' capacity follows each data rank's
    tokens), else (2, 2), whose values differ from the other meshes' by
    the rounding of the sharded sums only, well inside the tolerances."""
    return tuple(shape) if get_smoke_config(arch).moe is not None else (2, 2)


DTYPES = ("float32", "bfloat16")
BATCH = 8                   # train: every data rank of 4 takes whole rows
P, PB, CACHE = 16, 4, 24    # prefill: prompt, batch, cache positions
STEPS = 3


def config(arch: str, dtype: str, d_ff: int | None = None):
    """The arch's smoke config as the tests run it (the reference's
    ``test_torch_tp._JAX`` makes the same one)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    if arch == "gemma2_2b":
        cfg = dataclasses.replace(cfg, attention_impl="xla_flash",
                                  attn_block_q=8, attn_block_k=8)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="ep"))
    if d_ff is not None:
        cfg = dataclasses.replace(cfg, d_ff=d_ff)
    return cfg


def initial_state(arch: str, dtype: str) -> dict[str, torch.Tensor]:
    """The seeded train state both packages start from."""
    api = build_model(config(arch, dtype))
    return init_train_state(api, AdamW(), torch.Generator().manual_seed(0))


def initial_params(arch: str) -> dict[str, torch.Tensor]:
    """The seeded f32 parameters both packages prefill from."""
    return build_model(config(arch, "float32")).init(
        torch.Generator().manual_seed(1))


def rules(arch: str):
    """The full model's rule table (the smoke arch has no overrides)."""
    return rules_for(get_config(arch).arch)


def _sched():
    return functools.partial(warmup_cosine, base_lr=1e-3, warmup=2,
                             total=100)


def _rows(batch: dict, mesh, shardings) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v[local_box(
        v.shape, mesh, shardings[k]).slices()])) for k, v in batch.items()}


def _model_bytes(mesh) -> dict[str, int]:
    group = mesh.get_group("model") if mesh_shape(mesh)["model"] > 1 \
        else None
    if group is None:
        return {"activation": 0, "parameter": 0}
    return {k: collectives.traffic.of(group, k)
            for k in ("activation", "parameter")}


def train_steps(mesh, cfg, rule_table, init, steps: int, S: int) -> dict:
    """``steps`` sharded steps from ``init`` (whole arrays) on the batches
    of ``SyntheticLM(seed=0)``: the metrics per step, the whole final
    state, the step's local parameters and the bytes sent over the model
    axis."""
    api = build_model(cfg)
    step = make_train_step(api, AdamW(), _sched(),
                           ShapeConfig("t", S, BATCH, "train"), mesh=mesh,
                           rules=rule_table)
    state = shard_state(init, mesh, step.state_shardings)
    data = SyntheticLM(cfg.vocab, S, BATCH, seed=0)
    metrics = []
    collectives.traffic.reset()
    for i in range(steps):
        state, m = step(state, _rows(data.batch(i), mesh,
                                     step.batch_shardings))
        metrics.append({k: float(v) for k, v in m.items()})
    sent = _model_bytes(mesh)
    return {"metrics": metrics, "sent": sent,
            "local_params": sorted(step.local_params),
            "state": {k: t.full_tensor() for k, t in state.items()}}


def prefill(mesh, cfg, rule_table, params) -> dict:
    """The sharded prefill of ``make_token_batch(seed=0)``'s prompts from
    ``params`` (whole arrays): the whole logits and cache."""
    api = build_model(cfg)
    shape = ShapeConfig("p", P, PB, "prefill")
    step = make_prefill_step(api, shape, CACHE, mesh=mesh, rules=rule_table)
    sharded = shard_state(params, mesh, {
        n: rule_table.sharding_for(mesh, s.axes, s.shape)
        for n, s in api.param_specs.items()})
    batch = make_token_batch(cfg, shape, seed=0)
    with torch.no_grad():
        logits, cache = step(sharded, _rows(batch, mesh,
                                            step.batch_shardings))
    return {"logits": logits.full_tensor(),
            "cache": {k: t.full_tensor() for k, t in cache.items()}}


#: all_sum's cases: a ragged f32 tensor (its numel no multiple of the
#: group's size), bf16, a 0-d f32 and an even f32 one
SUMS = {"f32_ragged": ((5, 7), "float32"), "bf16": ((3, 4, 5), "bfloat16"),
        "scalar": ((), "float32"), "f32_even": ((8, 4), "float32")}


def _addend(rank: int, shape, dtype: str) -> torch.Tensor:
    gen = torch.Generator().manual_seed(100 + rank)
    return (torch.randn(shape, generator=gen) * (rank + 1)).to(
        getattr(torch, dtype))


def sums(mesh) -> dict:
    """``collectives.all_sum`` over the model axis and over every process
    of each of ``SUMS``'s seeded addends: what this process got, the
    group's addends added in f32 in rank order here, and the bytes it
    sent."""
    out = {}
    groups = {"model": mesh.get_group("model"),
              "world": torch.distributed.group.WORLD}
    rank = torch.distributed.get_rank()
    for axis, group in groups.items():
        ranks = torch.distributed.get_process_group_ranks(group)
        for name, (shape, dtype) in SUMS.items():
            want = _addend(ranks[0], shape, dtype).float()
            for r in ranks[1:]:
                want = want + _addend(r, shape, dtype).float()
            collectives.traffic.reset()
            got = collectives.all_sum(_addend(rank, shape, dtype), group)
            out[(axis, name)] = {"got": got,
                                 "want": want.to(getattr(torch, dtype)),
                                 "sent": collectives.traffic.of(group),
                                 "n": len(ranks)}
    return out


def tp_cases(inits: dict, params: dict) -> dict:
    """Every case on this process: per mesh, arch and dtype the sharded
    steps from ``inits[(arch, dtype)]``; per mesh and arch the f32 prefill
    from ``params[arch]``; per mesh one step of smollm at twice its d_ff
    from a seeded init, and the sums of ``sums``."""
    out = {}
    for shape in MESHES:
        mesh = make_debug_mesh(*shape, device_type="cpu")
        out[("sums", shape)] = sums(mesh)
        for arch in ARCHS:
            for dtype in DTYPES:
                out[("train", shape, arch, dtype)] = train_steps(
                    mesh, config(arch, dtype), rules(arch),
                    inits[(arch, dtype)], STEPS, seq(arch))
            out[("prefill", shape, arch)] = prefill(
                mesh, config(arch, "float32"), rules(arch), params[arch])
        cfg = config("smollm_135m", "float32", d_ff=256)
        init = init_train_state(build_model(cfg), AdamW(),
                                torch.Generator().manual_seed(0))
        out[("wide", shape)] = train_steps(mesh, cfg, rules("smollm_135m"),
                                           init, 1, seq("smollm_135m"))
    return out


# ------------------------------------------------------------- on the card
def card_config(layers: int):
    """smollm-135m at full width (9 heads, 3 kv heads, hd 64, d_ff 1,536,
    vocab 49,152), ``layers`` of its 30 layers, bf16, remat, its attention
    on the flash kernels."""
    return dataclasses.replace(get_config("smollm_135m"), num_layers=layers,
                               attention_impl="pallas", remat=True)


def load_kept(kept_dir: str, n: int, prefix: str = "rank") -> list[dict]:
    """What ``n`` processes kept under ``kept_dir/<prefix><r>.pt``
    (``card_tp_train``'s, or ``torch_adafactor_workers``'s): each one's
    shards and their boxes (as slices)."""
    out = []
    for r in range(n):
        kept = torch.load(f"{kept_dir}/{prefix}{r}.pt")
        kept["boxes"] = {k: tuple(slice(a, b) for a, b in zip(*v))
                         for k, v in kept["boxes"].items()}
        out.append(kept)
    return out


def card_schedule(lr: float):
    """The card runs' schedule: warmup_cosine(lr, warmup 2, total 100)."""
    return functools.partial(warmup_cosine, base_lr=lr, warmup=2, total=100)


class _TimedBackend(collectives.Backend):
    """The default calls, each with the card synchronised before and after
    it: ``seconds`` sums the wall time of the exchanges, card work
    queued before them excluded."""

    def __init__(self):
        self.seconds = 0.0

    def _timed(self, call, *args) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(*args)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0

    def all_gather(self, parts, t, group) -> None:
        self._timed(super().all_gather, parts, t, group)

    def all_to_all(self, out, t, group) -> None:
        self._timed(super().all_to_all, out, t, group)


def card_tp_train(shape, layers: int, B: int, S: int, steps: int, seed: int,
                  store_dir: str, kept_dir: str, lr: float = 1e-3) -> dict:
    """One process of a mesh of processes that share one card (gloo, which
    takes the card's tensors), in deterministic mode: run A, ``steps``
    sharded steps of ``card_config(layers)`` from the seeded state with the
    launch counts and the model axis's bytes at 0 just before and read
    just after; A's state saved to ``store_dir`` through ckpt_pack (rank 0
    writes) and this process's shards of it written to
    ``kept_dir/rank<r>.pt`` with their boxes; run B, the same steps again,
    bit-equal to A on this process's shards and in every metric, with
    the time in the collectives' exchanges measured (``_TimedBackend``)."""
    from repro_torch.core.store import DatasetStore
    from repro_torch.core.tensor_ckpt import TensorCheckpoint
    from repro_torch.core.torch_io import layout_from_torch, save_torch
    from repro_torch.device import use_deterministic_algorithms
    from repro_torch.kernels.ckpt_pack import ops as pack_ops
    from repro_torch.kernels.flash_attention import ops as attn_ops

    use_deterministic_algorithms()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_debug_mesh(*shape, device_type="cuda")
    cfg = card_config(layers)
    api = build_model(cfg)
    step = make_train_step(api, AdamW(), card_schedule(lr),
                           ShapeConfig("t", S, B, "train"), mesh=mesh,
                           rules=rules(cfg.arch))
    data = SyntheticLM(cfg.vocab, S, B, seed=seed)
    rank = torch.distributed.get_rank()

    def run():
        state = shard_state(init_train_state(
            api, AdamW(), torch.Generator(device="cuda").manual_seed(seed)),
            mesh, step.state_shardings)
        metrics, seconds = [], []
        for i in range(steps):
            batch = {k: v.cuda() for k, v in _rows(
                data.batch(i), mesh, step.batch_shardings).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
        return state, metrics, seconds

    attn_ops.launches = attn_ops.bwd_launches = pack_ops.launches = 0
    collectives.traffic.reset()
    state, metrics, seconds = run()
    launches = {"flash_attention": attn_ops.launches,
                "flash_attention_bwd": attn_ops.bwd_launches}
    sent = _model_bytes(mesh)
    t0 = time.perf_counter()
    ck = (TensorCheckpoint(DatasetStore(store_dir, "w")) if rank == 0
          else None)
    if ck is not None:
        ck.save_layout(layout_from_torch(state))
    save_torch(ck, state, steps)
    if ck is not None:
        ck.store.close()
    save_seconds = time.perf_counter() - t0
    launches["ckpt_pack"] = pack_ops.launches
    local = {k: t.to_local().cpu() for k, t in state.items()}
    boxes = {k: (lambda b: (list(b.start), list(b.stop)))(
        local_box(t.shape, mesh, t.placements)) for k, t in state.items()}
    torch.save({"local": local, "boxes": boxes},
               f"{kept_dir}/rank{rank}.pt")
    with collectives.using(_TimedBackend()) as timed:
        again, again_metrics, again_seconds = run()
    differ = sorted(k for k, t in again.items()
                    if not torch.equal(t.to_local().cpu().view(-1).view(
                        torch.uint8), local[k].view(-1).view(torch.uint8)))
    return {"rank": rank, "metrics": metrics, "step_seconds": seconds,
            "timed_step_seconds": again_seconds,
            "exchange_seconds": timed.seconds,
            "launches": launches, "model_bytes": sent,
            "save_seconds": save_seconds,
            "repeat_differs": differ,
            "repeat_metrics_equal": again_metrics == metrics,
            "local_params": sorted(step.local_params),
            "local_shapes": {k: list(local[k].shape) for k in (
                "params/wq", "params/wk", "params/w_gate", "params/embed")}}


#: tests/test_torch_mesh_train.py's RTOL, its bf16 row: what the card's TP
#: steps are held to against the one-process steps
CARD_RTOL = {"metric": 5e-3, "grad_norm": 5e-3, "slot": 3e-2, "update": 5e-2,
             "embed_slot": 3e-2, "embed_update": 5e-2}


#: its f32 row: what a TP leg trained in f32 is held to
CARD_RTOL_F32 = {"metric": 1e-5, "grad_norm": 1e-3, "slot": 2e-3,
                 "update": 1e-3, "embed_slot": 1e-2, "embed_update": 1e-2}


def card_one_process(layers: int, B: int, S: int, steps: int, seed: int,
                     lr: float = 1e-3):
    """The one-process steps ``card_tp_train`` is held to, in deterministic
    mode: (initial state, final state, metrics per step, ms per step)."""
    from repro_torch.device import use_deterministic_algorithms

    use_deterministic_algorithms()
    api = build_model(card_config(layers))
    step = make_train_step(api, AdamW(), card_schedule(lr),
                           ShapeConfig("t", S, B, "train"))
    init = init_train_state(
        api, AdamW(), torch.Generator(device="cuda").manual_seed(seed))
    data = SyntheticLM(api.cfg.vocab, S, B, seed=seed)
    state, history, ms = init, [], []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in data.batch(i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in m.items()})
    return init, state, history, ms


def _rtol(name: str, table: dict = CARD_RTOL) -> float:
    if name == "grad_norm":
        return table["grad_norm"]
    if "/" not in name:
        return table["metric"]
    kind = "update" if name.startswith("params/") else "slot"
    return table[f"embed_{kind}" if name.endswith("/embed") else kind]


def _ratio(got, want, rtol: float) -> float:
    """max |got - want| / (rtol * max |want|)."""
    got, want = got.double(), want.double()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return err / (rtol * scale) if scale else (0.0 if err == 0 else np.inf)


def card_errors(metrics: list, kept: list, one, device: str = "cpu",
                min_change_ulps: float = 0.0,
                rtol: dict = CARD_RTOL,
                noise_cols: dict | None = None) -> dict[str, float]:
    """Each value's error over its tolerance in ``rtol`` (at most 1 within
    it; ``CARD_RTOL``, bf16's, by default): the TP run's ``metrics`` per
    step and every process's ``kept`` shards (``load_kept``) against the
    one-process run ``one`` (``card_one_process``'s value); a parameter by
    its update in the 2-norm, every other value by its max, computed on
    ``device``.

    ``min_change_ulps`` > 0 holds a parameter's update over the elements
    whose one-process change is at least that many spacings of the
    parameter's dtype at the element's value: where a step moves a stored
    bf16 value by about one spacing, the two runs' last-bit differences
    decide which way it rounds, and the update's 2-norm measures those
    roundings rather than the step.

    ``noise_cols`` ({state name: n}) holds an array, a parameter's update
    or a slot, over its columns (last dim) from ``n`` on: the first ``n``
    get a gradient of about 0, whose rounding noise AdamW turns into steps
    of either sign and which sets a process's own scale where it holds
    those columns alone (xLSTM's ``s/b``: ROADMAP.md, Reference caveats);
    a process that holds none of the others is skipped for it."""
    init, final, history, _ = one
    noise_cols = noise_cols or {}
    out = {}
    for i, (g, w) in enumerate(zip(metrics, history)):
        for k in w:
            out[f"step {i + 1} {k}"] = _ratio(torch.tensor(g[k]),
                                              torch.tensor(w[k]),
                                              _rtol(k, rtol))
    for r in kept:
        for k, t in r["local"].items():
            if k == "step":
                continue
            t = t.to(device)
            want = final[k][r["boxes"][k]].to(device)
            past = None
            if k in noise_cols:
                cols = r["boxes"][k][-1]
                past = torch.arange(cols.start, cols.stop,
                                    device=device) >= noise_cols[k]
                if not bool(past.any()):
                    continue
            if k.startswith("params/"):
                start = init[k][r["boxes"][k]].to(device).double()
                du, dw = t.double() - start, want.double() - start
                if min_change_ulps:
                    spacing = torch.finfo(want.dtype).eps * torch.exp2(
                        torch.floor(torch.log2(want.double().abs().clamp_min(
                            torch.finfo(want.dtype).tiny))))
                    moved = dw.abs() >= min_change_ulps * spacing
                    du, dw = du[moved], dw[moved]
                if past is not None:
                    du, dw = du[..., past], dw[..., past]
                e = float(torch.linalg.norm(du - dw)
                          / (_rtol(k, rtol) * torch.linalg.norm(dw)))
            elif past is not None:
                e = _ratio(t[..., past], want[..., past], _rtol(k, rtol))
            else:
                e = _ratio(t, want, _rtol(k, rtol))
            out[k] = max(out.get(k, 0.0), e)
    return out

"""What tests/test_torch_tp_families.py runs on every process of a
4-process mesh (``repro_torch.launch.spawn.run_processes``): the
recurrentgemma, whisper and xLSTM families' sharded train and prefill
steps with their compute split over the model axis; and what
``chip_smoke.py``'s ``tp_train`` phase and the card tests run on each
process of a mesh that shares one card for these families
(``card_tp_families``, driven by ``family_legs``).  Imports torch and the
port only.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distrib import collectives
from repro_torch.distrib.rules import local_box
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import rglru, whisper, xlstm
from repro_torch.models.api import build_model, make_token_batch
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optim import AdamW
from repro_torch.train.step import (init_train_state, make_prefill_step,
                                    make_train_step, shard_state)

from helpers.torch_tp_workers import (BATCH, CACHE, DTYPES, MESHES, PB, STEPS,
                                      P, _model_bytes, _rows, _sched, rules)

ARCHS = ("recurrentgemma_9b", "whisper_base", "xlstm_350m")
SEQ = 32
#: the planted faults: the RG-LRU gates' partial products never summed
#: (each process slices its channels of its own partial); whisper's and
#: xLSTM's copy-in boundaries dropped (the split work's gradients of the
#: whole values it reads, the encoder states and the blocks' normed inputs
#: among them, never summed)
FAULTS = {"recurrentgemma_9b": "gates_unsummed",
          "whisper_base": "no_copy_in", "xlstm_350m": "no_copy_in"}
#: the module each planted fault drops its copy-in boundaries from
_COPY_IN = {"whisper_base": whisper, "xlstm_350m": xlstm}
FAULT_MESH, FAULT_DTYPE = (2, 2), "float32"

#: the parameters each family takes as this process's part on a model
#: axis of 2 or 4 (smoke configs): their activation's split is theirs
_FFN = ("w_gate", "w_up", "w_down")
ALIGNED = {
    "recurrentgemma_9b": frozenset(
        {"attn/wq", "attn/wo", "embed"}
        | {f"{p}/{k}" for p in ("lru", "attn") for k in _FFN}
        | {f"lru/{k}" for k in ("w_y", "w_x", "conv", "lam", "w_a", "w_i",
                                "w_out")}),
    "whisper_base": frozenset(
        {f"{p}/{k}" for p in ("enc", "dec")
         for k in ("wq", "wk", "wv", "wo") + _FFN}
        | {f"dec/{k}" for k in ("xq", "xk", "xv", "xo")}),
    "xlstm_350m": frozenset(
        {f"m/{k}" for k in ("w_up", "w_gate", "wq", "wk", "wv", "w_if",
                            "w_down")}
        | {f"s/{k}" for k in ("w", "b", "w_out")} | {"embed"}),
}


def noise_cols(cfg) -> dict[str, int]:
    """The state arrays whose first columns are rounding noise, by the
    count of those columns (``card_errors``' ``noise_cols``): xLSTM's
    sLSTM gate bias and its slots, whose input gate (the first D of its
    4 D columns) gets a gradient of about 0 (ROADMAP.md, Reference
    caveats)."""
    if cfg.recurrent != "xlstm":
        return {}
    return {f"{k}/s/b": cfg.d_model for k in ("params", "opt/m", "opt/v")}


def config(arch: str, dtype: str, **kw):
    """The arch's smoke config as the tests run it (the reference's
    ``test_torch_tp_families._JAX`` makes the same one)."""
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw)


def with_frames(cfg, batch: dict, step: int) -> dict:
    """``batch`` plus, for an encoder-decoder, ``enc_frames`` [B, Se, D]
    drawn from ``7 + step`` (normal, scale 0.5, f32; the reference's
    script draws the same)."""
    if not cfg.enc_dec:
        return batch
    B = batch["tokens"].shape[0]
    frames = np.random.default_rng(7 + step).normal(
        size=(B, cfg.encoder_seq, cfg.d_model), scale=0.5).astype("float32")
    return {**batch, "enc_frames": frames}


def initial_state(arch: str, dtype: str) -> dict[str, torch.Tensor]:
    """The seeded train state both packages start from."""
    api = build_model(config(arch, dtype))
    return init_train_state(api, AdamW(), torch.Generator().manual_seed(0))


def initial_params(arch: str) -> dict[str, torch.Tensor]:
    """The seeded f32 parameters both packages prefill from."""
    return build_model(config(arch, "float32")).init(
        torch.Generator().manual_seed(1))


class _ScanWidths:
    """Records the width of every forward ``rglru_scan`` call (the kernel
    on a card, its plain version here) while on."""

    def __init__(self):
        self.widths: list[int] = []

    def __enter__(self):
        self._scan = scan_ops.lru_scan

        def scan(a, b, h0=None):
            self.widths.append(int(a.shape[-1]))
            return self._scan(a, b, h0)
        scan_ops.lru_scan = scan
        return self

    def __exit__(self, *exc):
        scan_ops.lru_scan = self._scan


def _faulty(fault: str | None, arch: str | None = None):
    """A context that plants ``fault`` in ``arch``'s model code (or
    none)."""
    import contextlib

    from repro_torch.distrib.tensor_parallel import split_to_group

    @contextlib.contextmanager
    def planted():
        if fault == "gates_unsummed":
            saved = rglru.sum_scatter_to_group
            rglru.sum_scatter_to_group = split_to_group
        elif fault == "no_copy_in":
            saved = _COPY_IN[arch].copy_to_group
            _COPY_IN[arch].copy_to_group = lambda x, group: x
        try:
            yield
        finally:
            if fault == "gates_unsummed":
                rglru.sum_scatter_to_group = saved
            elif fault == "no_copy_in":
                _COPY_IN[arch].copy_to_group = saved
    return planted()


def train_steps(mesh, arch: str, cfg, init, steps: int, S: int = SEQ,
                fault: str | None = None) -> dict:
    """``steps`` sharded steps from ``init`` (whole arrays) on the batches
    of ``SyntheticLM(seed=0)`` (with ``with_frames``): the metrics per
    step, the whole final state, the step's local parameters, the bytes
    sent over the model axis and the widths the scans ran at."""
    api = build_model(cfg)
    step = make_train_step(api, AdamW(), _sched(),
                           ShapeConfig("t", S, BATCH, "train"), mesh=mesh,
                           rules=rules(arch))
    state = shard_state(init, mesh, step.state_shardings)
    data = SyntheticLM(cfg.vocab, S, BATCH, seed=0)
    metrics = []
    collectives.traffic.reset()
    with _ScanWidths() as scans, _faulty(fault, arch):
        for i in range(steps):
            batch = with_frames(cfg, data.batch(i), i)
            state, m = step(state, _rows(batch, mesh, step.batch_shardings))
            metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "sent": _model_bytes(mesh),
            "local_params": sorted(step.local_params),
            "scan_widths": sorted(set(scans.widths)),
            "state": {k: t.full_tensor() for k, t in state.items()}}


def prefill(mesh, cfg, rule_table, params) -> dict:
    """The sharded prefill of ``make_token_batch(seed=0)``'s prompts (and
    frames) from ``params`` (whole arrays): the whole logits and cache."""
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


def family_cases(inits: dict, params: dict) -> dict:
    """Every case on this process: per mesh, arch and dtype the sharded
    steps from ``inits[(arch, dtype)]``; per mesh and arch the f32 prefill
    from ``params[arch]``; on ``FAULT_MESH`` each arch's planted fault."""
    out = {}
    for shape in MESHES:
        mesh = make_debug_mesh(*shape, device_type="cpu")
        for arch in ARCHS:
            for dtype in DTYPES:
                out[("train", shape, arch, dtype)] = train_steps(
                    mesh, arch, config(arch, dtype), inits[(arch, dtype)],
                    STEPS)
            out[("prefill", shape, arch)] = prefill(
                mesh, config(arch, "float32"), rules(arch), params[arch])
            if shape == FAULT_MESH:
                out[("fault", arch)] = train_steps(
                    mesh, arch, config(arch, FAULT_DTYPE),
                    inits[(arch, FAULT_DTYPE)], STEPS, fault=FAULTS[arch])
    return out


# ------------------------------------------------------------- on the card
def card_config(arch: str, layers: int, dtype: str | None = None):
    """The family at full width on the card, remat, in ``dtype`` (default
    the config's, bf16): recurrentgemma-9b at ``layers`` layers (3: one
    (lru, lru, local) group), whisper-base at ``layers`` encoder and
    decoder layers, xlstm-350m at ``layers`` (2: one mLSTM/sLSTM
    pair)."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers, remat=True)
    if cfg.enc_dec:
        cfg = dataclasses.replace(cfg, encoder_layers=layers)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


#: what a leg trains in: f32.  In bf16 the TP and one-process runs' own
#: roundings reach the bf16 tolerances (CARD_RTOL) at full width: lam's
#: update (one bf16 spacing at 1.0) 2.78 of its limit, the v slots of
#: lru/w_a and dec/w_gate 1.03 and 1.04 (measured on one H100)
CARD_TRAIN_DTYPE = "float32"


def card_batch(cfg, data, step: int, mesh, shardings) -> dict:
    """This process's rows of step ``step``'s batch (with seeded frames
    for an encoder-decoder), on the card."""
    return {k: v.cuda() for k, v in _rows(with_frames(cfg, data.batch(step),
                                                      step),
                                          mesh, shardings).items()}


def card_prompts(cfg, B: int, P_: int, seed: int) -> dict:
    """The seeded prompts (and frames) a prefill serves, on the card."""
    return {k: torch.from_numpy(v).cuda() for k, v in make_token_batch(
        cfg, ShapeConfig("p", P_, B, "prefill"), seed=seed).items()}


def _boxes(state, mesh) -> dict:
    return {k: (list(b.start), list(b.stop)) for k, b in (
        (k, local_box(t.shape, mesh, t.placements))
        for k, t in state.items())}


def seeded_params(api, seed: int, mesh, table) -> dict:
    """This process's shards of ``api.init``'s parameters from a card
    generator seeded with ``seed``, drawn one at a time and cut to this
    process's box at once, as DTensors on ``table``'s placements."""
    from repro_torch.distrib.rules import from_local

    out = {}
    for name, t in api.init_each(torch.Generator(device="cuda")
                                 .manual_seed(seed)):
        spec = api.param_specs[name]
        place = table.sharding_for(mesh, spec.axes, spec.shape)
        box = local_box(t.shape, mesh, place)
        out[name] = from_local(t[box.slices()].clone(), mesh, place, t.shape)
        del t
    return out


def card_tp_families(shape, legs: dict, steps: int, seed: int, lr: float,
                     tokens: dict, store_dir: str, kept_dir: str) -> dict:
    """One process of a mesh of processes that share one card (gloo, which
    takes the card's tensors), in deterministic mode; for each ``arch`` of
    ``legs`` ({arch: {"layers", "B", "S", "P"}}) at full width
    (``card_config``):

    * serving, bf16: a prefill of B prompts of P tokens from the seeded
      parameters and ``tokens[arch].shape[1]`` decode steps fed
      ``tokens[arch]`` (the one-process run's greedy tokens), on this
      process's heads, channels and MLP part; the logits on rank 0;
    * training, in ``CARD_TRAIN_DTYPE``: run A, ``steps`` sharded steps
      from the seeded state, each process's box drawn one parameter at a
      time; run B, the same steps again, bit-equal to A on this process's
      shards and in every metric, with the exchanges' time measured;
    * the smoke config's sharded bf16 train state after 2 steps, saved to
      ``store_dir/<arch>`` through ckpt_pack (rank 0 writes), its shards
      and A's kept under ``kept_dir`` (``<arch>_smoke<r>.pt``,
      ``<arch>_rank<r>.pt``) with their boxes.

    The ``rglru_scan`` launches (forward and reverse), the ckpt_pack
    launches and the model axis's bytes are set to 0 just before each
    part and read just after.  Returns {arch: what it measured}."""
    from repro_torch.core.store import DatasetStore
    from repro_torch.core.tensor_ckpt import TensorCheckpoint
    from repro_torch.core.torch_io import layout_from_torch, save_torch
    from repro_torch.device import use_deterministic_algorithms
    from repro_torch.kernels.ckpt_pack import ops as pack_ops
    from repro_torch.train.step import make_decode_step

    from helpers.torch_adafactor_workers import _bits, seeded_shards
    from helpers.torch_tp_workers import _TimedBackend, card_schedule

    t_start = time.perf_counter()
    use_deterministic_algorithms()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_debug_mesh(*shape, device_type="cuda")
    rank = torch.distributed.get_rank()
    opt = AdamW()

    def sync():
        torch.cuda.synchronize()

    results = {}
    for arch, leg in legs.items():
        B, S, P_, table = leg["B"], leg["S"], leg["P"], rules(arch)
        out = results[arch] = {"rank": rank, "marks": []}

        def mark(what):
            out["marks"].append((what, time.perf_counter() - t_start))
        mark("start")

        # ---- serving on local heads and channels, bf16, seeded
        api = build_model(card_config(arch, leg["layers"]))
        cfg = api.cfg
        t0 = time.perf_counter()
        params = seeded_params(api, seed, mesh, table)
        out["init_seconds"] = time.perf_counter() - t0
        G = tokens[arch].shape[1]
        prefill = make_prefill_step(api, ShapeConfig("p", P_, B, "prefill"),
                                    cache_len=P_ + G, mesh=mesh, rules=table)
        decode = make_decode_step(api, mesh=mesh, rules=table)
        rows = local_box((B,), mesh,
                         prefill.batch_shardings["tokens"]).slices()
        prompts = {k: v[rows]
                   for k, v in card_prompts(cfg, B, P_, seed).items()}
        mine = tokens[arch][rows]
        scan_ops.launches = 0
        collectives.traffic.reset()
        with torch.inference_mode():
            sync()
            t1 = time.perf_counter()
            logits, cache = prefill(params, prompts)
            sync()
            out["prefill_ms"] = (time.perf_counter() - t1) * 1e3
            out["prefill_scan_launches"] = scan_ops.launches
            out["prefill_model_bytes"] = _model_bytes(mesh)
            collectives.traffic.reset()
            seen, decode_ms = [logits.full_tensor().float().cpu()], []
            for i in range(G):
                feed = {"token": mine[:, i:i + 1].cuda(),
                        "pos": torch.full((len(mine),), P_ + i,
                                          dtype=torch.int32, device="cuda")}
                sync()
                t1 = time.perf_counter()
                logits, cache = decode(params, cache, feed)
                sync()
                decode_ms.append((time.perf_counter() - t1) * 1e3)
                seen.append(logits.full_tensor().float().cpu())
        out["decode_model_bytes"] = _model_bytes(mesh)
        out["decode_ms"] = decode_ms
        out["cache_local_shapes"] = {k: list(v.to_local().shape)
                                     for k, v in cache.items()}
        out["logits"] = torch.stack(seen) if rank == 0 else None
        del params, cache, logits, prefill, decode
        torch.cuda.empty_cache()
        mark("served")

        # ---- training: run A, then the same steps again
        api = build_model(card_config(arch, leg["layers"], CARD_TRAIN_DTYPE))
        step = make_train_step(api, opt, card_schedule(lr),
                               ShapeConfig("t", S, B, "train"), mesh=mesh,
                               rules=table)
        out["local_params"] = sorted(step.local_params)
        data = SyntheticLM(cfg.vocab, S, B, seed=seed)

        def run(state):
            metrics, seconds = [], []
            for i in range(steps):
                batch = card_batch(cfg, data, i, mesh, step.batch_shardings)
                sync()
                t1 = time.perf_counter()
                state, m = step(state, batch)
                sync()
                seconds.append(time.perf_counter() - t1)
                metrics.append({k: float(v) for k, v in m.items()})
            return state, metrics, seconds

        init = seeded_shards(api, opt, seed, mesh, step.state_shardings)
        out["local_shapes"] = {k: list(t.to_local().shape)
                               for k, t in init.items()
                               if k.startswith("params/")}
        scan_ops.launches = 0
        collectives.traffic.reset()
        torch.cuda.reset_peak_memory_stats()
        mark("seeded")
        state, metrics, seconds = run(init)
        del init
        mark("run A")
        out.update(peak_memory_allocated=torch.cuda.max_memory_allocated(),
                   launches={"rglru_scan": scan_ops.launches},
                   model_bytes=_model_bytes(mesh), metrics=metrics,
                   step_seconds=seconds)
        local = {k: t.to_local().cpu() for k, t in state.items()}
        torch.save({"local": local, "boxes": _boxes(state, mesh)},
                   f"{kept_dir}/{arch}_rank{rank}.pt")
        del state
        torch.cuda.empty_cache()
        mark("kept")
        with collectives.using(_TimedBackend()) as timed:
            again, again_metrics, again_seconds = run(
                seeded_shards(api, opt, seed, mesh, step.state_shardings))
        out.update(exchange_seconds=timed.seconds,
                   timed_step_seconds=again_seconds,
                   repeat_metrics_equal=again_metrics == metrics,
                   repeat_differs=sorted(
                       k for k, t in again.items()
                       if not torch.equal(_bits(t.to_local().cpu()),
                                          _bits(local[k]))))
        del again, local, step
        torch.cuda.empty_cache()
        mark("run B")

        # ---- the smoke config's sharded train state, saved
        small = build_model(config(arch, "bfloat16"))
        mstep = make_train_step(small, opt, _sched(),
                                ShapeConfig("t", SEQ, BATCH, "train"),
                                mesh=mesh, rules=table)
        mstate = shard_state(init_train_state(
            small, opt, torch.Generator(device="cuda").manual_seed(seed)),
            mesh, mstep.state_shardings)
        mdata = SyntheticLM(small.cfg.vocab, SEQ, BATCH, seed=seed)
        for i in range(2):
            mstate, _ = mstep(mstate, card_batch(small.cfg, mdata, i, mesh,
                                                 mstep.batch_shardings))
        mark("smoke steps")
        pack_ops.launches = 0
        t0 = time.perf_counter()
        ck = (TensorCheckpoint(DatasetStore(f"{store_dir}/{arch}", "w"))
              if rank == 0 else None)
        if ck is not None:
            ck.save_layout(layout_from_torch(mstate))
        save_torch(ck, mstate, 2)
        if ck is not None:
            ck.store.close()
        out["smoke_save_seconds"] = time.perf_counter() - t0
        out["launches"]["ckpt_pack"] = pack_ops.launches
        torch.save({"local": {k: t.to_local().cpu()
                              for k, t in mstate.items()},
                    "boxes": _boxes(mstate, mesh)},
                   f"{kept_dir}/{arch}_smoke{rank}.pt")
        del mstate, mstep
        torch.cuda.empty_cache()
        mark("smoke saved")
    return results


def card_one_serve(arch: str, layers: int, B: int, P_: int, G: int,
                   seed: int):
    """The one-process serving ``card_tp_families``' is held to, bf16, from
    the same seeded parameters on the card: the logits of the prefill and
    of G greedy decode steps [G + 1, B, V] (f32, on the host) and the
    tokens it fed [B, G]."""
    from repro_torch.launch.serve import greedy
    from repro_torch.train.step import make_decode_step

    cfg = card_config(arch, layers)
    api = build_model(cfg)
    with torch.inference_mode():
        params = api.init(torch.Generator(device="cuda").manual_seed(seed))
        logits, cache = make_prefill_step(
            api, ShapeConfig("p", P_, B, "prefill"), P_ + G)(
            params, card_prompts(cfg, B, P_, seed))
        decode = make_decode_step(api)
        seen, toks = [logits.float().cpu()], []
        for i in range(G):
            toks.append(greedy(logits))
            logits, cache = decode(params, cache, {
                "token": toks[-1], "pos": torch.full(
                    (B,), P_ + i, dtype=torch.int32, device="cuda")})
            seen.append(logits.float().cpu())
    del params, cache, logits
    torch.cuda.empty_cache()
    return torch.stack(seen), torch.cat(toks, 1).cpu()


def card_one_train(arch: str, layers: int, B: int, S: int, steps: int,
                   seed: int, lr: float):
    """The one-process steps ``card_tp_families``' are held to, on the card
    in deterministic mode and ``CARD_TRAIN_DTYPE`` from the same seed:
    (initial parameters, final state, metrics per step, ms per step), the
    states on the card, as ``helpers.torch_tp_workers.card_errors`` takes
    them."""
    from repro_torch.device import use_deterministic_algorithms

    from helpers.torch_tp_workers import card_schedule

    use_deterministic_algorithms()
    cfg = card_config(arch, layers, CARD_TRAIN_DTYPE)
    api, opt = build_model(cfg), AdamW()
    step = make_train_step(api, opt, card_schedule(lr),
                           ShapeConfig("t", S, B, "train"))
    state = init_train_state(
        api, opt, torch.Generator(device="cuda").manual_seed(seed))
    init = {k: t.clone() for k, t in state.items() if k.startswith("params/")}
    data = SyntheticLM(cfg.vocab, S, B, seed=seed)
    history, ms = [], []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).cuda() for k, v in with_frames(
            cfg, data.batch(i), i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in m.items()})
    return init, state, history, ms


def family_legs(shape, legs: dict, steps: int, seed: int, lr: float, G: int,
                scratch: str, logits_rtol: dict, timeout: float = 600
                ) -> tuple[list, dict, list]:
    """The legs of the card's tensor-parallel phase, one spawn of
    ``shape``'s processes for all of them: per arch of ``legs``, the
    one-process serving (``card_one_serve``) first; the processes sharing
    the card (``card_tp_families``); then per arch the one-process steps
    (``card_one_train``), which the TP steps must match within
    ``CARD_RTOL_F32``; the TP decode's logits within
    ``logits_rtol[arch]`` of one process's and the same greedy tokens; the
    repeat bit-equal; the smoke config's sharded state restored N -> 1 on
    the card bit-equal to every process's shards.  Returns (a record per
    leg, the launches summed over the processes and the restores, what
    failed)."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config as config_of
    from repro_torch.core.store import DatasetStore
    from repro_torch.core.tensor_ckpt import TensorCheckpoint
    from repro_torch.core.torch_io import load_torch
    from repro_torch.kernels.ckpt_pack import ops as pack_ops
    from repro_torch.launch.spawn import run_processes

    from helpers.torch_adafactor_workers import logit_agreement
    from helpers.torch_tp_workers import CARD_RTOL_F32, card_errors, load_kept

    one_serve, tokens, serve_s = {}, {}, {}
    for arch, leg in legs.items():
        t0 = time.perf_counter()
        one_serve[arch], tokens[arch] = card_one_serve(
            arch, leg["layers"], leg["B"], leg["P"], G, seed)
        serve_s[arch] = time.perf_counter() - t0
    store = tempfile.mkdtemp(prefix="tp_family_store_", dir=scratch)
    kept_dir = tempfile.mkdtemp(prefix="tp_family_kept_", dir=scratch)
    n = shape[0] * shape[1]
    records, failed = [], []
    launches = {"rglru_scan": 0, "ckpt_pack": 0}
    # the processes' f32 states, their steps' new states and gradients
    # come to some 60 GB on one 80 GB card: their allocators grow segments
    # in place rather than cache a block per size
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        t0 = time.perf_counter()
        try:
            ranks = run_processes(card_tp_families, n, (
                shape, legs, steps, seed, lr, tokens, store, kept_dir),
                timeout=timeout, pg_timeout=timeout)
        finally:
            if alloc is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        spawn_s = time.perf_counter() - t0
        for arch, leg in legs.items():
            t_leg = time.perf_counter()
            per = [r[arch] for r in ranks]
            cfg = config_of(arch)
            n_lru = (sum(k == "lru" for k in card_config(
                arch, leg["layers"]).layer_kinds())
                     if cfg.recurrent == "rglru" else 0)
            for r in per:
                got = r["launches"]
                # a prefill scans each RG-LRU layer once; a step scans it
                # forward, again in remat's recompute, and in reverse
                if (r["prefill_scan_launches"] != n_lru
                        or got["rglru_scan"] != 3 * n_lru * steps
                        or not got["ckpt_pack"]):
                    failed.append(f"rank {r['rank']} of {arch}'s leg "
                                  f"launched {got}, prefill "
                                  f"{r['prefill_scan_launches']}")
                for what in ("model_bytes", "prefill_model_bytes",
                             "decode_model_bytes"):
                    if r[what]["parameter"] or not r[what]["activation"]:
                        failed.append(f"rank {r['rank']} of {arch}'s leg "
                                      f"sent {r[what]} ({what})")
                if r["repeat_differs"] or not r["repeat_metrics_equal"]:
                    failed.append(f"rank {r['rank']} of {arch}'s leg: the "
                                  f"second run differs in "
                                  f"{r['repeat_differs']}")
                if r["metrics"] != per[0]["metrics"]:
                    failed.append(f"{arch}: the processes' metrics differ")
            agree = logit_agreement(per[0]["logits"], one_serve[arch],
                                    tokens[arch])
            if agree["logits_err_over_scale"] > logits_rtol[arch] \
                    or agree["argmax_flips"]:
                failed.append(f"{arch}'s TP decode against one process's: "
                              f"{agree}, limit {logits_rtol[arch]}")

            # ---- the one-process steps, from the same seed
            t0 = time.perf_counter()
            one = card_one_train(arch, leg["layers"], leg["B"], leg["S"],
                                 steps, seed, lr)
            one_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            kept = load_kept(kept_dir, n, f"{arch}_rank")
            ratios = card_errors(per[0]["metrics"], kept, one,
                                 device="cuda", rtol=CARD_RTOL_F32,
                                 noise_cols=noise_cols(cfg))
            compare_s = time.perf_counter() - t0
            worst = sorted(ratios.items(), key=lambda kv: -kv[1])[:5]
            one_losses, one_ms = [h["loss"] for h in one[2]], one[3]
            del kept, one
            torch.cuda.empty_cache()
            if worst[0][1] > 1.0:
                failed.append(f"{arch}'s TP steps against the one-process "
                              f"steps, error / tolerance: {worst}")

            # ---- the smoke config's sharded state N -> 1 on the card
            small = build_model(config(arch, "bfloat16"))
            pack_ops.launches = 0
            t0 = time.perf_counter()
            ck = TensorCheckpoint(DatasetStore(f"{store}/{arch}", "r"))
            target = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                      for k, v in init_train_state(
                          small, AdamW(), torch.Generator().manual_seed(seed)
                      ).items()}
            restored = load_torch(ck, target, 2, device="cuda")
            ck.store.close()
            restore_launches = pack_ops.launches
            restore_s = time.perf_counter() - t0
            smoke = load_kept(kept_dir, n, f"{arch}_smoke")
            differ = sorted({k for r in smoke for k, t in r["local"].items()
                             if not torch.equal(
                                 restored[k][r["boxes"][k]].cpu().reshape(-1)
                                 .view(torch.uint8),
                                 t.reshape(-1).view(torch.uint8))})
            if differ:
                failed.append(f"{arch}'s {n} -> 1 restore differs in "
                              f"{differ}")
            launches["rglru_scan"] += sum(r["launches"]["rglru_scan"]
                                          + r["prefill_scan_launches"]
                                          for r in per)
            launches["ckpt_pack"] += sum(r["launches"]["ckpt_pack"]
                                         for r in per) + restore_launches
            records.append({
                "leg": cfg.arch, **leg, "mesh": list(shape), "processes": n,
                "backend": "gloo", "deterministic": True,
                "train_dtype": CARD_TRAIN_DTYPE,
                "local_params": per[0]["local_params"],
                "local_shapes": per[0]["local_shapes"],
                "cache_local_shapes": per[0]["cache_local_shapes"],
                "losses": [m["loss"] for m in per[0]["metrics"]],
                "one_process_losses": one_losses,
                "worst_error_over_tolerance": worst,
                "step_ms": [[t * 1e3 for t in r["step_seconds"]]
                            for r in per],
                "one_process_step_ms": one_ms,
                "exchange_ms_per_step": [r["exchange_seconds"] * 1e3 / steps
                                         for r in per],
                "timed_step_ms": [[t * 1e3 for t in r["timed_step_seconds"]]
                                  for r in per],
                "model_axis_bytes_per_process": [r["model_bytes"]
                                                 for r in per],
                "prefill_model_axis_bytes_per_process": [
                    r["prefill_model_bytes"] for r in per],
                "decode_model_axis_bytes_per_process": [
                    r["decode_model_bytes"] for r in per],
                "peak_memory_allocated_per_process": [
                    r["peak_memory_allocated"] for r in per],
                "decode": {"prompt": leg["P"], "steps": G,
                           "prefill_ms": per[0]["prefill_ms"],
                           "decode_ms": per[0]["decode_ms"], **agree,
                           "limit": logits_rtol[arch]},
                "launches_per_process": [
                    {**r["launches"],
                     "prefill_rglru_scan": r["prefill_scan_launches"]}
                    for r in per],
                "repeat_bit_equal": not any(
                    r["repeat_differs"] or not r["repeat_metrics_equal"]
                    for r in per),
                f"restore_{n}_to_1_bit_equal": not differ,
                "init_seconds": max(r["init_seconds"] for r in per),
                "smoke_save_seconds": max(r["smoke_save_seconds"]
                                          for r in per),
                "restore_seconds": restore_s, "spawn_seconds": spawn_s,
                "one_process_serve_seconds": serve_s[arch],
                "one_process_train_seconds": one_s,
                "compare_seconds": compare_s,
                "leg_seconds_after_spawn": time.perf_counter() - t_leg,
                "marks": per[0]["marks"]})
    finally:
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(kept_dir, ignore_errors=True)
    return records, launches, failed

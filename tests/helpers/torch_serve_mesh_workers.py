"""What the port's serving-on-a-mesh tests run on every process of a mesh
(``repro_torch.launch.spawn.run_processes``; module-level functions, so
the spawned processes import them by name).  Imports torch and the port
only.

* ``serve_families``: on each 4-process mesh of ``MESHES``, every family
  of ``FAMILIES`` (f32 smoke configs on the reference's parameters)
  prefilled and decoded through the sharded step builders; the bytes each
  decode step exchanges, at two cache lengths; the sequence-parallel
  ``decode_attention`` and ``write_token`` against their one-device
  versions; and smollm's ``kv_seq``-sharded cache saved from (2, 2)
  mid-decode, one checkpoint rank per process;
* ``restore_and_decode``: that cache restored on another mesh, bit for
  bit, and the decode continued from it;
* ``serve_and_save``: ``chip_smoke.py``'s ``serve_mesh`` CPU leg, a model
  at full width served on a mesh and its sharded cache saved.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.store import DatasetStore
from repro_torch.core.tensor_ckpt import TensorCheckpoint
from repro_torch.core.torch_io import layout_from_torch, load_torch, save_torch
from repro_torch.distrib import collectives
from repro_torch.distrib.context import DimSplit, MeshContext, use_mesh_context
from repro_torch.distrib.rules import from_local, local_box, rules_for
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve import greedy, shard_params
from repro_torch.models.api import build_model, make_token_batch
from repro_torch.models.layers import decode_attention, write_token
from repro_torch.train.step import make_decode_step, make_prefill_step

FAMILIES = ("smollm_135m", "granite_moe_3b_a800m", "recurrentgemma_9b",
            "xlstm_350m", "whisper_base")
MESHES = ((2, 2), (1, 4), (4, 1))
#: the families whose decode computes on this process's heads, MLP part
#: (or experts) and vocab rows where the model axis splits: the
#: transformer family, recurrentgemma (its recurrent states' channels
#: too), whisper (the cross K/V's kv heads too) and xLSTM (its blocks'
#: inner width and gate columns; the state whole on every process)
LOCAL_ARCHS = ("smollm_135m", "qwen3_1_7b", "gemma2_2b", "qwen3_4b",
               "qwen2_vl_7b", "granite_moe_3b_a800m", "kimi_k2_1t_a32b",
               "recurrentgemma_9b", "whisper_base", "xlstm_350m")
LOCAL_MESHES = ((2, 2), (1, 4))
# batch, prompt and decode steps: the cache of P + G = 12 positions splits
# over a model axis of 2 and of 4; recurrentgemma's ring of 8 slots wraps
B, P, G = 4, 8, 4
#: the cache length of the exchange's second reading
LONGER = P + G + 8
SAVE_ARCH, SAVE_MESH, SAVE_AFTER, SAVE_STEP = "smollm_135m", (2, 2), 2, 1


def serve_config(arch: str):
    """The f32 smoke config (granite's expert-parallel variant)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl="ep"))
    return cfg


def serve_rules(arch: str):
    """The full model's rule table (its per-arch overrides apply: xlstm's
    heads and recurrentgemma's kv heads are not sharded)."""
    return rules_for(get_config(arch).arch)


def prompt(cfg) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in make_token_batch(
        cfg, ShapeConfig("p", P, B, "prefill"), seed=0).items()}


def _rows(batch, step) -> dict[str, torch.Tensor]:
    return {k: v[local_box(v.shape, step.mesh, step.batch_shardings[k])
                 .slices()] for k, v in batch.items()}


class _Exchange:
    """Counts the bytes this process sends to ``all_gather`` and
    ``all_reduce`` while it is on."""

    def __init__(self):
        self.bytes, self.on = 0, False
        self._gather, self._reduce = dist.all_gather, dist.all_reduce

    def __enter__(self):
        def gather(out, t, *a, **k):
            self.bytes += t.numel() * t.element_size() if self.on else 0
            return self._gather(out, t, *a, **k)

        def reduce(t, *a, **k):
            self.bytes += t.numel() * t.element_size() if self.on else 0
            return self._reduce(t, *a, **k)
        dist.all_gather, dist.all_reduce = gather, reduce
        return self

    def __exit__(self, *exc):
        dist.all_gather, dist.all_reduce = self._gather, self._reduce


def _model_traffic(mesh) -> dict[str, int]:
    """The bytes this process sent over the model axis since the count was
    reset, by kind."""
    if dict(zip(mesh.mesh_dim_names, mesh.shape))["model"] == 1:
        return {"activation": 0, "parameter": 0}
    group = mesh.get_group("model")
    return {k: collectives.traffic.of(group, k)
            for k in ("activation", "parameter")}


def _serve(arch, params, mesh, cache_len, steps, after=None, cfg=None,
           traffic=None):
    """Prefill and ``steps`` greedy decode steps on ``mesh``; returns the
    full logits of each ([steps + 1, B, V]), the bytes each decode step
    but the first exchanged (the first gathers the parameters), and what
    ``after(i, params, cache)`` returned after decode step i.  With a
    dict ``traffic``, it gets each decode step's bytes over the model
    axis by kind (``collectives.traffic``)."""
    cfg = cfg or serve_config(arch)
    api, rules = build_model(cfg), serve_rules(arch)
    prefill = make_prefill_step(api, ShapeConfig("p", P, B, "prefill"),
                                cache_len=cache_len, mesh=mesh, rules=rules)
    decode = make_decode_step(api, mesh=mesh, rules=rules)
    params = shard_params(api, params, mesh, rules)
    logits, cache = prefill(params, _rows(prompt(cfg), prefill))
    out, sent, kept = [logits.full_tensor()], [], {}
    tok = greedy(logits)
    with _Exchange() as ex:
        for i in range(steps):
            n = len(tok)
            pos = torch.full((n,), P + i, dtype=torch.int32)
            ex.on, ex.bytes = i > 0, 0
            collectives.traffic.reset()
            logits, cache = decode(params, cache, {"token": tok, "pos": pos})
            ex.on = False
            if traffic is not None:
                traffic.setdefault("steps", []).append(_model_traffic(mesh))
            sent.append(ex.bytes)
            out.append(logits.full_tensor())
            tok = greedy(logits)
            if after is not None:
                kept[i + 1] = after(i + 1, params, cache)
    return torch.stack(out).numpy(), sent[1:], kept


def _save(store_dir: str):
    """``after`` of the run that saves its cache after ``SAVE_AFTER``
    decode steps: one checkpoint rank per process; rank 0 keeps every
    array whole."""
    def after(i, params, cache):
        if i != SAVE_AFTER:
            return None
        ck = None
        if dist.get_rank() == 0:
            ck = TensorCheckpoint(DatasetStore(store_dir, "w"))
            ck.save_layout(layout_from_torch(cache))
        save_torch(ck, cache, SAVE_STEP)
        whole = {k: v.full_tensor().clone() for k, v in cache.items()}
        return {"cache": whole,
                "placements": {k: [str(p) for p in v.placements]
                               for k, v in cache.items()}}
    return after


def _split_attention(mesh) -> dict:
    """The sequence-parallel and head-split ``decode_attention`` over this
    mesh's model axis against the one-device one, f32: a window, a
    softcap, per-slot lengths with the last key at each shard's first and
    last slot, and a 0-d length; ``write_token`` at each shard's edges
    against the one-device write.  Returns max |err| / max |want| per
    case."""
    m = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    me = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))["model"]
    group = mesh.get_group("model") if m > 1 else None
    S, KV, Gq, hd = 4 * m, m, 3, 8
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.normal(size=(B, 1, KV * Gq, hd)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, S, KV, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, S, KV, hd)).astype(np.float32))
    lo, hi = me * S // m, (me + 1) * S // m          # this key range
    h0, h1 = me * KV // m, (me + 1) * KV // m        # these kv heads
    seq = {"k": {2: DimSplit(lo, hi, S, group)}}
    heads = {"k": {3: DimSplit(h0, h1, KV, group)}}
    # the last visible key of a row at the first or last slot of a shard
    edges = torch.tensor([1, 4, S - 3, S], dtype=torch.int32)
    out = {}
    for name, lens, kw in (
            ("per-slot, shard edges", edges, {}),
            ("window 3", edges, {"window": 3}),
            ("softcap 5", edges, {"softcap": 5.0}),
            ("window and softcap, 0-d", torch.tensor(S - 1, dtype=torch.int32),
             {"window": 5, "softcap": 5.0})):
        want = decode_attention(q, k, v, lens, **kw)
        for how, splits, kk, vv in (
                ("kv_seq", seq, k[:, lo:hi], v[:, lo:hi]),
                ("kv_heads", heads, k[:, :, h0:h1], v[:, :, h0:h1])):
            ctx = MeshContext(mesh=mesh, cache_splits=splits)
            with use_mesh_context(ctx):
                got = decode_attention(q, kk, vv, lens, entry="k", **kw)
            out[f"{how}: {name}"] = float((got - want).abs().max()
                                          / want.abs().max())
    new = torch.from_numpy(rng.normal(size=(B, 1, KV, hd)).astype(np.float32))
    for at in (torch.tensor(hi - 1, dtype=torch.int32), torch.tensor(lo),
               edges - 1):
        want = k.clone()
        write_token(want, new, at)
        got = k[:, lo:hi].clone()
        with use_mesh_context(MeshContext(mesh=mesh, cache_splits=seq)):
            write_token(got, new, at, entry="k")
        out[f"write at {at.tolist()}"] = bool(torch.equal(got,
                                                          want[:, lo:hi]))
    return out


def serve_families(inits: dict, store_dir: str) -> dict:
    """Every mesh of ``MESHES``, every family: the logits of a prefill and
    ``G`` decode steps, the bytes exchanged per decode step at cache
    lengths P + G and ``LONGER``, the split attention's errors; on
    ``SAVE_MESH`` the saved cache of ``SAVE_ARCH`` with the logits the
    uninterrupted run went on to."""
    out = {}
    for shape in MESHES:
        mesh = make_debug_mesh(*shape, device_type="cpu")
        out[shape] = {"attention": _split_attention(mesh)}
        for arch in FAMILIES:
            t0 = time.perf_counter()
            save = arch == SAVE_ARCH and shape == SAVE_MESH
            logits, sent, kept = _serve(
                arch, inits[arch], mesh, P + G, G,
                _save(store_dir) if save else None)
            _, longer, _ = _serve(arch, inits[arch], mesh, LONGER, 2)
            out[shape][arch] = {"logits": logits, "sent": sent,
                                "sent_longer": longer,
                                "seconds": time.perf_counter() - t0}
            if save:
                out[shape][arch]["saved"] = kept[SAVE_AFTER]
    for shape in LOCAL_MESHES:
        mesh = make_debug_mesh(*shape, device_type="cpu")
        for arch in LOCAL_ARCHS:
            traffic = {}
            logits, _, _ = _serve(arch, inits[arch], mesh, P + G, G,
                                  traffic=traffic)
            out[shape].setdefault(arch, {}).update(
                {"local_logits": logits, "traffic": traffic["steps"]})
        # smollm at twice its d_ff (seeded parameters): the model axis's
        # bytes a decode step sends
        cfg = dataclasses.replace(serve_config("smollm_135m"), d_ff=256)
        wide, traffic = build_model(cfg).init(
            torch.Generator().manual_seed(0)), {}
        _serve("smollm_135m", wide, mesh, P + G, G, cfg=cfg, traffic=traffic)
        out[shape]["wide"] = traffic["steps"]
        # recurrentgemma at twice its RG-LRU width: what the width adds to
        # a decode step's bytes
        cfg = dataclasses.replace(serve_config("recurrentgemma_9b"),
                                  lru_width=2 * serve_config(
                                      "recurrentgemma_9b").lru_width)
        wide, traffic = build_model(cfg).init(
            torch.Generator().manual_seed(0)), {}
        _serve("recurrentgemma_9b", wide, mesh, P + G, G, cfg=cfg,
               traffic=traffic)
        out[shape]["wide_lru"] = traffic["steps"]
    return out


def restore_and_decode(shape, store_dir: str, params: dict, tokens) -> dict:
    """Restore the saved cache on a mesh of ``shape`` (this run's
    processes) and decode from it, feeding ``tokens`` [B, 1] first:
    each process's shards, and the full logits of the steps left."""
    mesh = make_debug_mesh(*shape, device_type="cpu")
    cfg = serve_config(SAVE_ARCH)
    api, rules = build_model(cfg), serve_rules(SAVE_ARCH)
    prefill = make_prefill_step(api, ShapeConfig("p", P, B, "prefill"),
                                cache_len=P + G, mesh=mesh, rules=rules)
    ck = (TensorCheckpoint(DatasetStore(store_dir, "r"))
          if dist.get_rank() == 0 else None)
    cache = load_torch(ck, api.abstract_cache(B, P + G), SAVE_STEP,
                       device="cpu", mesh=mesh,
                       shardings=prefill.cache_shardings)
    shards = {k: (local_box(v.shape, mesh, v.placements).slices(),
                  v.to_local().clone()) for k, v in cache.items()}
    decode = make_decode_step(api, mesh=mesh, rules=rules)
    params = shard_params(api, params, mesh, rules)
    rows = local_box((B,), mesh, prefill.batch_shardings["tokens"]).slices()
    tok, logits = tokens[rows], []
    for i in range(SAVE_AFTER, G):
        pos = torch.full((len(tok),), P + i, dtype=torch.int32)
        step_logits, cache = decode(params, cache, {"token": tok, "pos": pos})
        logits.append(step_logits.full_tensor())
        tok = greedy(step_logits)
    return {"shards": shards, "logits": torch.stack(logits).numpy()}


# ------------------------------------------------ chip_smoke.py's CPU leg
def full_width_config(arch: str, layers: int):
    """``arch`` at full width with its depth cut to ``layers``, prefill
    attention through the flash kernel (its plain version on the CPU)."""
    return dataclasses.replace(get_config(arch), num_layers=layers,
                               attention_impl="pallas")


def serve_and_save(arch: str, layers: int, shape, batch: int, prompt_len: int,
                   steps: int, cache_len: int, store_dir: str, step: int,
                   keep: str, seed: int = 0) -> dict:
    """``full_width_config(arch, layers)`` on a mesh of ``shape`` (this
    run's processes): seeded parameters (a CPU generator, so every process
    draws them alike), a prefill of ``batch`` prompts of ``prompt_len``
    tokens into a cache of ``cache_len`` positions sharded by the arch's
    rule table, ``steps`` greedy decode steps, then the cache saved at
    ``step`` as one checkpoint rank per process.  Rank 0 writes the whole
    cache, the prompts and the tokens to ``keep`` (``torch.save``).
    Returns this process's seconds per phase and its cache shards'
    placements."""
    mesh = make_debug_mesh(*shape, device_type="cpu")
    cfg = full_width_config(arch, layers)
    api, rules = build_model(cfg), rules_for(cfg.arch)
    params = shard_params(api, api.init(torch.Generator().manual_seed(seed)),
                          mesh, rules)
    prompts = {k: torch.from_numpy(v) for k, v in make_token_batch(
        cfg, ShapeConfig("p", prompt_len, batch, "prefill"),
        seed=seed).items()}
    prefill = make_prefill_step(api, ShapeConfig("p", prompt_len, batch,
                                                 "prefill"),
                                cache_len=cache_len, mesh=mesh, rules=rules)
    decode = make_decode_step(api, mesh=mesh, rules=rules)
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, cache = prefill(params, _rows(prompts, prefill))
        t1 = time.perf_counter()
        toks = [greedy(logits)]
        for i in range(steps):
            pos = torch.full((len(toks[-1]),), prompt_len + i,
                             dtype=torch.int32)
            logits, cache = decode(params, cache, {"token": toks[-1],
                                                   "pos": pos})
            toks.append(greedy(logits))
    t2 = time.perf_counter()
    ck = None
    if dist.get_rank() == 0:
        ck = TensorCheckpoint(DatasetStore(store_dir, "w"))
        ck.save_layout(layout_from_torch(cache))
    save_torch(ck, cache, step)
    t3 = time.perf_counter()
    whole = {k: v.full_tensor() for k, v in cache.items()}
    tokens = from_local(torch.cat(toks, dim=1), mesh, logits.placements,
                        (batch, steps + 1)).full_tensor()
    if dist.get_rank() == 0:
        torch.save({"cache": whole, "prompts": prompts, "tokens": tokens},
                   keep)
    return {"prefill_seconds": t1 - t0, "decode_seconds": t2 - t1,
            "save_seconds": t3 - t2,
            "placements": {k: [str(p) for p in v.placements]
                           for k, v in cache.items()},
            "local_shapes": {k: list(v.to_local().shape)
                             for k, v in cache.items()}}

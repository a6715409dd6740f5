"""What tests/test_torch_adafactor_mesh.py runs on every process of a
4-process mesh (``repro_torch.launch.spawn.run_processes``): kimi-k2's
smoke config trained under Adafactor by the sharded step, its reductions
summed over the groups that split each parameter.  Imports torch and the
port only.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distrib.rules import local_box, rules_for
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.api import build_model
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optim import Adafactor
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.step import (init_train_state, make_train_step,
                                    shard_state)

from helpers.torch_tp_workers import _rows, load_kept  # noqa: F401
from helpers.torch_tp_workers import _sched as schedule

ARCH = "kimi_k2_1t_a32b"
MESHES = ((2, 2), (1, 4))
IMPLS = ("dense", "ep")
#: 2 layers: each layer-stacked parameter updated one leading slice at a
#: time; 1: the whole-array branch, where ``ln1`` [1, D] is not factored
DEPTHS = (2, 1)
DTYPES = ("float32", "bfloat16")
SEQ, BATCH, STEPS = 16, 8, 3
#: the case whose state the test restores 4 -> 1 and 4 -> 2, and whose
#: steps each mesh repeats
SAVED = ("ep", 2, "bfloat16")


def config(impl: str, layers: int, dtype: str):
    """The smoke config (qk-norm, an untied unembedding, 8 experts top-2;
    the EP variant pads them to 16) at ``layers`` and ``dtype``: the
    reference's ``test_torch_adafactor_mesh._JAX`` makes the same one."""
    cfg = get_smoke_config(ARCH)
    return dataclasses.replace(cfg, num_layers=layers, dtype=dtype,
                               moe=dataclasses.replace(cfg.moe, impl=impl))


def initial_state(impl: str, layers: int, dtype: str) -> dict:
    """The seeded Adafactor train state both packages start from."""
    return init_train_state(build_model(config(impl, layers, dtype)),
                            Adafactor(), torch.Generator().manual_seed(0))


def ref_mesh(impl: str, shape) -> tuple[int, int]:
    """The reference's mesh a port run on ``shape`` is held to: the same
    for the EP variant (its capacity follows each data rank's tokens),
    else (2, 2), whose values differ from (1, 4)'s by the rounding of the
    sharded sums only."""
    return tuple(shape) if impl == "ep" else (2, 2)


def rules():
    """The full model's rule table (the smoke arch has no overrides)."""
    return rules_for(get_config(ARCH).arch)


def train(mesh, cfg, init, steps: int = STEPS) -> dict:
    """``steps`` sharded Adafactor steps from ``init`` (whole arrays) on
    ``SyntheticLM(seed=0)``'s batches: the metrics per step, the state
    (DTensors)."""
    api = build_model(cfg)
    step = make_train_step(api, Adafactor(), schedule(),
                           ShapeConfig("t", SEQ, BATCH, "train"), mesh=mesh,
                           rules=rules())
    state = shard_state(init, mesh, step.state_shardings)
    data = SyntheticLM(cfg.vocab, SEQ, BATCH, seed=0)
    metrics = []
    for i in range(steps):
        state, m = step(state, _rows(data.batch(i), mesh,
                                     step.batch_shardings))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "state": state}


def _local(state: dict, mesh) -> dict:
    """This process's shard of every array and its box (start, stop)."""
    out = {}
    for k, t in state.items():
        box = local_box(t.shape, mesh, t.placements)
        out[k] = (t.to_local().clone(), (tuple(box.start), tuple(box.stop)))
    return out


def save(state: dict, path: str) -> None:
    """The sharded state saved by every process (rank 0 writes the store,
    ckpt_pack on its plan), at step ``STEPS``."""
    from repro_torch.core.store import DatasetStore
    from repro_torch.core.tensor_ckpt import TensorCheckpoint
    from repro_torch.core.torch_io import layout_from_torch, save_torch

    ck = (TensorCheckpoint(DatasetStore(path, "w"))
          if torch.distributed.get_rank() == 0 else None)
    if ck is not None:
        ck.save_layout(layout_from_torch(state))
    save_torch(ck, state, STEPS)
    if ck is not None:
        ck.store.close()


def cases(inits: dict, store: str) -> dict:
    """Every case on this process: per mesh, impl, depth and dtype the
    steps from ``inits[(impl, layers, dtype)]`` (metrics, the whole final
    state on rank 0, this process's shards and boxes); per mesh the
    ``SAVED`` case again (its keys whose bits differ), and the ``SAVED``
    case's (2, 2) state saved to ``store``."""
    out, rank = {}, torch.distributed.get_rank()
    for shape in MESHES:
        mesh = make_debug_mesh(*shape, device_type="cpu")
        for impl in IMPLS:
            for layers in DEPTHS:
                for dtype in DTYPES:
                    key = (impl, layers, dtype)
                    run = train(mesh, config(*key), inits[key])
                    state = run["state"]
                    full = {k: t.full_tensor() for k, t in state.items()}
                    out[(shape, *key)] = {
                        "metrics": run["metrics"],
                        "state": full if rank == 0 else None,
                        "local": _local(state, mesh)}
                    if key == SAVED:
                        again = train(mesh, config(*key), inits[key])
                        out[("repeat", shape)] = {
                            "metrics_equal": again["metrics"]
                            == run["metrics"],
                            "differ": sorted(
                                k for k, t in again["state"].items()
                                if not torch.equal(
                                    t.to_local().reshape(-1).view(
                                        torch.uint8),
                                    state[k].to_local().reshape(-1).view(
                                        torch.uint8)))}
                        if shape == (2, 2):
                            save(state, store)
    return out


# ------------------------------------------------------------- on the card
def card_config(layers: int, experts: int):
    """kimi-k2 at full width (d_model 7,168, 64 query and 8 kv heads at hd
    128, vocab 163,840, top-8 of ``experts`` experts, EP), ``layers`` of
    its 61 layers, bf16, remat, its attention on the flash kernels:
    ``chip_smoke.py``'s ``kimi_train`` model."""
    cfg = get_config(ARCH)
    return dataclasses.replace(
        cfg, num_layers=layers, attention_impl="pallas",
        moe=dataclasses.replace(cfg.moe, num_experts=experts, impl="ep"))


def card_schedule(lr: float, warmup: int, total: int):
    return functools.partial(warmup_cosine, base_lr=lr, warmup=warmup,
                             total=total)


def seeded_shards(api, opt, seed: int, mesh, shardings) -> dict:
    """This process's shards of ``init_train_state(api, opt, a card
    generator seeded with seed)``, the state the one-process run starts
    from: every parameter drawn as ``api.init`` draws it, one at a time,
    and cut to this process's box at once (no process holds the whole
    state), the slots and the step zeros."""
    from repro_torch.distrib.rules import from_local
    from repro_torch.train.step import train_state_specs

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, t in api.init_each(gen):
        key = f"params/{name}"
        box = local_box(t.shape, mesh, shardings[key])
        out[key] = from_local(t[box.slices()].clone(), mesh, shardings[key],
                              t.shape)
        del t
    for key, spec in train_state_specs(api, opt).items():
        if key.startswith("params/"):
            continue
        box = local_box(spec.shape, mesh, shardings[key])
        out[key] = from_local(
            torch.zeros(box.shape, dtype=getattr(torch, spec.dtype),
                        device="cuda"), mesh, shardings[key], spec.shape)
    return out


def _bits(t) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def card_adafactor_mesh(shape, cfg, B: int, S: int,
                        steps: int, repeat: int, seed: int, lr: float,
                        warmup: int, total: int, tokens, P: int,
                        store_dir: str, kept_dir: str) -> dict:
    """One process of a mesh of processes that share one card (gloo), in
    deterministic mode, on ``cfg`` (``card_config``'s):

    * serving: its shards of the seeded parameters, a prefill of the
      ``prompt_batch(seed)`` prompts (B rows, ``P`` tokens) and a decode
      step for each column of ``tokens`` [B, G] (the one-process run's
      greedy tokens, fed back as it fed them), on this process's heads,
      experts and vocab rows; the full logits of each and each decode
      step's ms;
    * training, run A: ``steps`` sharded Adafactor steps from the same
      shards under ``card_schedule(lr, warmup, total)`` on
      ``SyntheticLM(seed)``'s batches, with the launch counts and the
      model axis's bytes at 0 just before and read just after; this
      process's shards and their boxes written to ``kept_dir/rank<r>.pt``;
      run B, steps 1..``repeat`` again with the exchanges timed, bit-equal
      to A's state after step ``repeat``;
    * the smoke config's sharded Adafactor state (EP, 2 steps) saved to
      ``store_dir`` through ckpt_pack (rank 0 writes), its shards written
      to ``kept_dir/smoke<r>.pt``."""
    import time

    from repro_torch.core.store import DatasetStore
    from repro_torch.core.tensor_ckpt import TensorCheckpoint
    from repro_torch.core.torch_io import layout_from_torch, save_torch
    from repro_torch.device import use_deterministic_algorithms
    from repro_torch.distrib import collectives
    from repro_torch.kernels.ckpt_pack import ops as pack_ops
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import moe
    from repro_torch.train.step import make_decode_step, make_prefill_step
    from helpers.torch_tp_workers import _TimedBackend, _model_bytes

    use_deterministic_algorithms()
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = torch.distributed.get_rank()
    mesh = make_debug_mesh(*shape, device_type="cuda")
    api, opt = build_model(cfg), Adafactor()
    step = make_train_step(api, opt, card_schedule(lr, warmup, total),
                           ShapeConfig("t", S, B, "train"), mesh=mesh,
                           rules=rules())
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    init = seeded_shards(api, opt, seed, mesh, step.state_shardings)
    sync()
    init_s = time.perf_counter() - t0
    out = {"rank": rank, "init_seconds": init_s,
           "local_params": sorted(step.local_params),
           "local_shapes": {k: list(init[k].to_local().shape) for k in (
               "params/wq", "params/wk", "params/we_gate",
               "params/unembed")}}

    # ---- serving on local heads, from the seeded parameters
    params = {k[len("params/"):]: v for k, v in init.items()
              if k.startswith("params/")}
    G = tokens.shape[1]
    prefill = make_prefill_step(api, ShapeConfig("p", P, B, "prefill"),
                                cache_len=P + G, mesh=mesh, rules=rules())
    decode = make_decode_step(api, mesh=mesh, rules=rules())
    prompts = prompt_batch(cfg, B, P, torch.device("cuda"), seed=seed)
    rows = local_box((B,), mesh, prefill.batch_shardings["tokens"]).slices()
    attn_ops.launches = 0
    collectives.traffic.reset()
    with torch.inference_mode():
        logits, cache = prefill(params, {k: v[rows]
                                         for k, v in prompts.items()})
        sync()
        out["prefill_flash_launches"] = attn_ops.launches
        seen, decode_ms = [logits.full_tensor().float().cpu()], []
        for i in range(G):
            feed = {"token": tokens[rows][:, i:i + 1].cuda(),
                    "pos": torch.full((len(tokens[rows]),), P + i,
                                      dtype=torch.int32, device="cuda")}
            sync()
            t1 = time.perf_counter()
            logits, cache = decode(params, cache, feed)
            sync()
            decode_ms.append((time.perf_counter() - t1) * 1e3)
            seen.append(logits.full_tensor().float().cpu())
    out["serve_model_bytes"] = _model_bytes(mesh)
    out["decode_ms"] = decode_ms
    out["logits"] = torch.stack(seen) if rank == 0 else None
    del params, cache, logits, prefill, decode
    torch.cuda.empty_cache()

    # ---- training: run A, then steps 1..repeat again
    data = SyntheticLM(cfg.vocab, S, B, seed=seed)

    def run(n, make):
        state = make()
        metrics, seconds, held = [], [], None
        for i in range(n):
            batch = {k: v.cuda() for k, v in _rows(
                data.batch(i), mesh, step.batch_shardings).items()}
            sync()
            t1 = time.perf_counter()
            state, m = step(state, batch)
            sync()
            seconds.append(time.perf_counter() - t1)
            metrics.append({k: float(v) for k, v in m.items()})
            if i + 1 == repeat:
                held = {k: t.to_local().cpu() for k, t in state.items()}
        return state, metrics, seconds, held

    attn_ops.launches = attn_ops.bwd_launches = 0
    moe.calls = 0
    collectives.traffic.reset()
    torch.cuda.reset_peak_memory_stats()
    first = [init]
    del init
    state, metrics, seconds, held = run(steps, first.pop)
    out.update(peak_memory_allocated=torch.cuda.max_memory_allocated(),
               launches={"flash_attention": attn_ops.launches,
                         "flash_attention_bwd": attn_ops.bwd_launches,
                         "moe_ffn_ep": moe.calls},
               model_bytes=_model_bytes(mesh), metrics=metrics,
               step_seconds=seconds)
    local = {k: t.to_local().cpu() for k, t in state.items()}
    boxes = {k: (list(b.start), list(b.stop)) for k, b in (
        (k, local_box(t.shape, mesh, t.placements))
        for k, t in state.items())}
    torch.save({"local": local, "boxes": boxes}, f"{kept_dir}/rank{rank}.pt")
    del state, local
    torch.cuda.empty_cache()
    with collectives.using(_TimedBackend()) as timed:
        again, again_metrics, again_seconds, _ = run(
            repeat, lambda: seeded_shards(api, opt, seed, mesh,
                                          step.state_shardings))
    out.update(exchange_seconds=timed.seconds,
               timed_step_seconds=again_seconds,
               repeat_metrics_equal=again_metrics == metrics[:repeat],
               repeat_differs=sorted(
                   k for k, t in again.items()
                   if not torch.equal(_bits(t.to_local().cpu()),
                                      _bits(held[k]))))
    del again
    torch.cuda.empty_cache()

    # ---- the smoke config's sharded Adafactor state, saved
    small = build_model(config("ep", 2, "bfloat16"))
    sstep = make_train_step(small, opt, schedule(),
                            ShapeConfig("t", SEQ, BATCH, "train"), mesh=mesh,
                            rules=rules())
    sstate = shard_state(init_train_state(
        small, opt, torch.Generator(device="cuda").manual_seed(seed)),
        mesh, sstep.state_shardings)
    sdata = SyntheticLM(small.cfg.vocab, SEQ, BATCH, seed=seed)
    for i in range(2):
        sstate, _ = sstep(sstate, {k: v.cuda() for k, v in _rows(
            sdata.batch(i), mesh, sstep.batch_shardings).items()})
    pack_ops.launches = 0
    t0 = time.perf_counter()
    ck = (TensorCheckpoint(DatasetStore(store_dir, "w")) if rank == 0
          else None)
    if ck is not None:
        ck.save_layout(layout_from_torch(sstate))
    save_torch(ck, sstate, 2)
    if ck is not None:
        ck.store.close()
    out["smoke_save_seconds"] = time.perf_counter() - t0
    out["launches"]["ckpt_pack"] = pack_ops.launches
    torch.save({"local": {k: t.to_local().cpu() for k, t in sstate.items()},
                "boxes": {k: (list(b.start), list(b.stop)) for k, b in (
                    (k, local_box(t.shape, mesh, t.placements))
                    for k, t in sstate.items())}},
               f"{kept_dir}/smoke{rank}.pt")
    return out


def card_one_process(cfg, B: int, P: int, G: int, seed: int):
    """The one-process serving ``card_adafactor_mesh`` is held to, from
    the same seeded parameters on the card: the logits of the prefill and
    of G greedy decode steps [G + 1, B, V] (f32, on the host), and the
    tokens it fed [B, G]."""
    from repro_torch.launch.serve import greedy, prompt_batch
    from repro_torch.train.step import make_decode_step, make_prefill_step

    api = build_model(cfg)
    with torch.inference_mode():
        params = api.init(torch.Generator(device="cuda").manual_seed(seed))
        logits, cache = make_prefill_step(
            api, ShapeConfig("p", P, B, "prefill"), P + G)(
            params, prompt_batch(cfg, B, P, torch.device("cuda"),
                                 seed=seed))
        decode = make_decode_step(api)
        seen, toks = [logits.float().cpu()], []
        for i in range(G):
            toks.append(greedy(logits))
            logits, cache = decode(params, cache, {
                "token": toks[-1], "pos": torch.full(
                    (B,), P + i, dtype=torch.int32, device="cuda")})
            seen.append(logits.float().cpu())
    del params, cache
    torch.cuda.empty_cache()
    return torch.stack(seen), torch.cat(toks, 1).cpu()


def logit_agreement(tp: torch.Tensor, one: torch.Tensor,
                    tokens: torch.Tensor) -> dict:
    """The TP run's logits [G + 1, B, V] against the one-process run's:
    the largest difference over the largest logit, and where the two
    greedy choices differ, whether the one-process run's top two logits
    lie within that step's largest difference (a tie at the two runs'
    rounding)."""
    err = float((tp - one).abs().max() / one.abs().max())
    ties, flips = 0, []
    for i in range(tp.shape[0]):
        a, b = tp[i].argmax(-1), one[i].argmax(-1)
        if i < tokens.shape[1]:
            assert torch.equal(b.to(tokens.dtype), tokens[:, i])
        gap = float((tp[i] - one[i]).abs().max())
        for r in torch.nonzero(a != b).flatten().tolist():
            top2 = one[i, r].topk(2).values
            if float(top2[0] - top2[1]) <= gap:
                ties += 1
            else:
                flips.append((i, r))
    return {"logits_err_over_scale": err, "argmax_ties": ties,
            "argmax_flips": flips}


def card_one_train(cfg, B: int, S: int, steps: int, seed: int, lr: float,
                   warmup: int, total: int):
    """The one-process Adafactor steps ``card_adafactor_mesh``'s are held
    to, in deterministic mode on the card: (initial state, final state,
    metrics per step, ms per step), the states on the host, as
    ``helpers.torch_tp_workers.card_errors`` takes them."""
    import time

    from repro_torch.device import use_deterministic_algorithms

    use_deterministic_algorithms()
    api, opt = build_model(cfg), Adafactor()
    step = make_train_step(api, opt, card_schedule(lr, warmup, total),
                           ShapeConfig("t", S, B, "train"))
    state = init_train_state(
        api, opt, torch.Generator(device="cuda").manual_seed(seed))
    init = {k: t.cpu() for k, t in state.items()}
    data = SyntheticLM(api.cfg.vocab, S, B, seed=seed)
    history, ms = [], []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in data.batch(i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in m.items()})
    final = {k: t.cpu() for k, t in state.items()}
    del state
    torch.cuda.empty_cache()
    return init, final, history, ms

"""Serving on a mesh: the port's sharded prefill and decode steps across
``torch.distributed`` processes (gloo on the CPU) against the JAX
package's sharded ``make_prefill_step`` / ``make_decode_step`` on
simulated devices.

* every family's ``cache_axes`` and ``cache_shardings`` against the
  reference's, for every arch, on (2, 2), (1, 4), (4, 1) and (16, 16);
* the sequence-parallel (and head-split) ``decode_attention`` over 4
  processes against the one-device one, and ``write_token`` at the
  shards' edges;
* smollm, granite (EP), recurrentgemma, xlstm and whisper: a prefill and
  4 decode steps on (2, 2), (1, 4) and (4, 1), f32 logits within 1e-5 of
  their scale and the same greedy tokens as the reference's;
* a decode step exchanges per-token results only: its bytes do not grow
  with the cache;
* the decode on local heads of the transformer family (smollm,
  qwen3-1.7b, gemma2, qwen3-4b, qwen2-vl, granite and kimi-k2, EP for the
  MoE configs), of recurrentgemma (its states on local channels), of
  whisper (its cross K/V on local kv heads) and of xLSTM (its blocks on
  local columns, its state whole) on (2, 2) and (1, 4): logits
  within 1e-5 of the reference's sharded decode and the same tokens; no
  parameter whose split matches its activation's is gathered, the bytes
  over the model axis do not grow with d_ff, and recurrentgemma's grow
  with its RG-LRU width by the gates' reduce-scatter only; on a (1, 1)
  mesh, bit for bit the one-device steps;
* smollm's ``kv_seq``-sharded cache saved by 4 processes mid-decode
  restores bit-equal on 1 and on 2 processes, whose decode goes on with
  the uninterrupted run's tokens;
* the serve launcher on 4 processes.

The reference runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` on Auto-axis meshes
(ROADMAP.md, Reference caveats), beside the port's processes; both take
the reference's parameters (``jax.random.key(0)``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from helpers import torch_serve_mesh_workers as W
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS, get_config, get_smoke_config
from repro.configs.base import SHAPES, ShapeConfig
from repro.distrib.rules import rules_for as ref_rules_for
from repro.models.api import build_model as ref_build_model
from repro_torch.configs import get_config as torch_get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.store import DatasetStore
from repro_torch.core.tensor_ckpt import TensorCheckpoint
from repro_torch.core.torch_io import load_torch
from repro_torch.distrib.rules import cache_shardings, placements_for, rules_for
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch.spawn import run_processes
from repro_torch.models.api import build_model
from repro_torch.train.step import make_decode_step

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300
PG_TIMEOUT = 60
# f32: the packages sum the same products in other orders (the
# sequence-parallel combine, the sharded reductions of GSPMD)
TOL = 1e-5

_JAX = r"""
import dataclasses, json, sys
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config, get_smoke_config
from repro.configs.base import ShapeConfig
from repro.distrib.rules import rules_for
from repro.models.api import build_model, make_token_batch
from repro.train.step import make_decode_step, make_prefill_step

out, cells = sys.argv[1], json.loads(sys.argv[2])
B, P, G = %(bpg)r
for shape, archs in cells:
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    for arch in archs:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, impl="ep"))
        api = build_model(cfg)
        rules = rules_for(get_config(arch).arch)
        pshape = ShapeConfig("p", P, B, "prefill")
        prefill = make_prefill_step(api, mesh, rules, pshape,
                                    cache_len=P + G)
        decode = make_decode_step(api, mesh, rules,
                                  ShapeConfig("d", P + G, B, "decode"))
        params = api.init(jax.random.key(0))
        logits, cache = prefill(params, make_token_batch(cfg, pshape, 0))
        seen = [np.asarray(logits)]
        for i in range(G):
            tok = np.argmax(seen[-1], -1).astype(np.int32)[:, None]
            logits, cache = decode(params, cache, {
                "token": tok, "pos": np.full((B,), P + i, np.int32)})
            seen.append(np.asarray(logits))
        np.save(f"{out}/{shape[0]}x{shape[1]}_{arch}.npy", np.stack(seen))
print("OK")
""" % {"bpg": (W.B, W.P, W.G)}
#: the reference's cells, (mesh, archs), in two subprocesses: the
#: families on every mesh, and the rest of the transformer family on the
#: meshes whose model axis splits
_CELLS = ([[shape, list(W.FAMILIES)] for shape in W.MESHES],
          [[shape, [a for a in W.LOCAL_ARCHS if a not in W.FAMILIES]]
           for shape in W.LOCAL_MESHES])


def _ref_params(arch: str) -> dict[str, torch.Tensor]:
    """The reference's init of the family's f32 smoke config, as the
    subprocess draws it, on the CPU."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl="ep"))
    params = ref_build_model(cfg).init(jax.random.key(0))
    return params_from_jax({k: np.asarray(v) for k, v in params.items()},
                           device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref = tmp_path_factory.mktemp("serve_mesh_ref")
    store = str(tmp_path_factory.mktemp("serve_mesh_store") / "ck")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, str(ref),
                               json.dumps(cells)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cells in _CELLS]
    try:
        inits = {arch: _ref_params(arch)
                 for arch in W.FAMILIES + W.LOCAL_ARCHS}
        four = run_processes(W.serve_families, 4, (inits, store),
                             timeout=TIMEOUT, pg_timeout=PG_TIMEOUT,
                             threads=1)
        first = four[0][W.SAVE_MESH][W.SAVE_ARCH]
        resume = torch.from_numpy(
            first["logits"][W.SAVE_AFTER].argmax(-1).astype(np.int32))[:, None]
        two = run_processes(W.restore_and_decode, 2,
                            ((1, 2), store, inits[W.SAVE_ARCH], resume),
                            timeout=TIMEOUT, pg_timeout=PG_TIMEOUT, threads=1)
        for proc in procs:
            out, err = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0 and out.strip().endswith("OK"), \
                err[-4000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    return {"ref": ref, "store": store, "inits": inits, "four": four,
            "two": two, "resume": resume}


# ------------------------------------------------------- layouts, no process
class _Mesh:
    """What the reference's ``spec_for`` reads of a mesh: its shape."""

    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_match_the_reference(arch):
    want = ref_build_model(get_config(arch)).cache_axes()
    got = build_model(torch_get_config(arch)).cache_axes()
    assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1), (16, 16)])
def test_cache_shardings_match_the_reference(shape):
    """Every arch's cache at every serving shape of SHAPES (prefill and
    decode) and at the tests' own size, by the arch's rule table with and
    without the shape's perf overrides."""
    sizes = dict(zip(("data", "model"), shape))
    for arch in ARCHS:
        ref_api = ref_build_model(get_config(arch))
        api = build_model(torch_get_config(arch))
        for s in [s for s in SHAPES.values() if s.kind != "train"] + [
                ShapeConfig("t", W.P + W.G, W.B, "decode")]:
            for name in (None, s.name):
                ref_rules = ref_rules_for(ref_api.cfg.arch, shape_name=name)
                rules = rules_for(api.cfg.arch, shape_name=name)
                specs = api.cache_specs(s.global_batch, s.seq_len)
                got = cache_shardings(sizes, rules, specs, api.cache_axes())
                for k, sds in ref_api.cache_specs(s.global_batch,
                                                  s.seq_len).items():
                    want = ref_rules.spec_for(ref_api.cache_axes()[k],
                                              tuple(sds.shape), _Mesh(shape))
                    assert got[k] == placements_for(tuple(want), sizes), \
                        (arch, s.name, k, want)


# --------------------------------------------------- the split attention
@pytest.mark.parametrize("shape", W.MESHES)
def test_split_decode_attention_matches_one_device(runs, shape):
    """Over the model axis of 4, 2 and 1 processes: within 1e-6 of the
    f32 scale at a window, a softcap, per-slot lengths whose last key
    sits at a shard's first or last slot, and a 0-d length; the write
    lands in the one process whose range holds the slot."""
    for rank in runs["four"]:
        for case, value in rank[shape]["attention"].items():
            if case.startswith("write"):
                assert value is True, case
            else:
                assert value <= 1e-6, (case, value)


# ------------------------------------------------ the families, sharded
@pytest.mark.parametrize("arch", W.FAMILIES)
@pytest.mark.parametrize("shape", W.MESHES)
def test_sharded_serving_matches_the_reference(runs, shape, arch):
    """A prefill and 4 greedy decode steps: every process's full logits
    alike, within 1e-5 of the scale of the reference's sharded steps on 4
    devices of the same mesh, and the same tokens."""
    want = np.load(runs["ref"] / f"{shape[0]}x{shape[1]}_{arch}.npy")
    got = [r[shape][arch]["logits"] for r in runs["four"]]
    for g in got[1:]:
        assert np.array_equal(g, got[0])
    err = np.abs(got[0] - want).max() / np.abs(want).max()
    assert err <= TOL, err
    assert np.array_equal(got[0].argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("shape", W.MESHES)
def test_decode_exchanges_per_token_results_only(runs, shape):
    """The bytes a process sends in a decode step (its parameters already
    gathered) are the same at a cache of 12 and of 20 positions: no
    collective moves a cache entry.  Where the model axis splits an
    entry, the step does exchange (the combine, the gathers)."""
    model = shape[1]
    for rank in runs["four"]:
        for arch in W.FAMILIES:
            run = rank[shape][arch]
            sent = set(run["sent"]) | set(run["sent_longer"])
            assert len(sent) == 1, (arch, run["sent"], run["sent_longer"])
            if model > 1:
                assert sent.pop() > 0, arch


# ----------------------------------------- the decode step on local heads
@pytest.mark.parametrize("arch", W.LOCAL_ARCHS)
@pytest.mark.parametrize("shape", W.LOCAL_MESHES)
def test_local_head_decode_matches_the_reference(runs, shape, arch):
    """Every transformer-family smoke config (qk-norm, softcap and window,
    embeddings input, EP experts) on a mesh whose model axis splits: a
    prefill and 4 decode steps on this process's heads, MLP part or
    experts and vocab rows, every process's logits alike, within 1e-5 of
    the scale of the reference's sharded steps, and the same tokens."""
    want = np.load(runs["ref"] / f"{shape[0]}x{shape[1]}_{arch}.npy")
    got = [r[shape][arch]["local_logits"] for r in runs["four"]]
    for g in got[1:]:
        assert np.array_equal(g, got[0])
    err = np.abs(got[0] - want).max() / np.abs(want).max()
    assert err <= TOL, err
    assert np.array_equal(got[0].argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", W.LOCAL_ARCHS)
@pytest.mark.parametrize("shape", W.LOCAL_MESHES)
def test_local_head_decode_gathers_no_aligned_parameter(runs, shape, arch):
    """A decode step takes each parameter whose split matches its
    activation's as this process's part: the only parameter bytes over
    the model axis are the first step's gathers of the others (none on
    (2, 2); on (1, 4) the kv heads' ``wk`` and ``wv``, whose 2 heads do
    not split 4 ways), and none after it."""
    from test_torch_tp import _expected

    _, gathered = _expected(arch, shape)
    if shape == (2, 2):
        assert gathered == 0
    for r in runs["four"]:
        steps = r[shape][arch]["traffic"]
        assert steps[0]["parameter"] == gathered
        assert all(t["parameter"] == 0 for t in steps[1:])
        assert all(t["activation"] > 0 for t in steps)


@pytest.mark.parametrize("shape", W.LOCAL_MESHES)
def test_local_head_decode_bytes_do_not_grow_with_d_ff(runs, shape):
    """smollm's decode steps at d_ff 128 and 256 send the same bytes over
    the model axis (the MLP's hidden never leaves its process)."""
    for r in runs["four"]:
        narrow = r[shape]["smollm_135m"]["traffic"]
        assert narrow == r[shape]["wide"]


@pytest.mark.parametrize("shape", W.LOCAL_MESHES)
def test_rglru_decode_sends_only_the_gates_sums_for_its_width(runs, shape):
    """recurrentgemma's decode step at twice its RG-LRU width sends the
    gates' reduce-scatter more, and nothing else: per recurrent layer each
    process sends each of the other m - 1 processes its channels of its
    two partial products, [rows, W / m] f32 each.  The states, the conv
    and the gelu branch never leave their process, and the gates are not
    all-reduced (which would send twice that)."""
    m, rows = shape[1], W.B // shape[0]
    cfg = W.serve_config("recurrentgemma_9b")
    n_lru = sum(k == "lru" for k in cfg.layer_kinds())
    extra = n_lru * (m - 1) * 2 * rows * (cfg.lru_width // m) * 4
    for r in runs["four"]:
        narrow = r[shape]["recurrentgemma_9b"]["traffic"]
        wide = r[shape]["wide_lru"]
        assert len(narrow) == len(wide) == W.G
        for a, b in zip(narrow, wide):
            assert b["activation"] - a["activation"] == extra
            assert a["parameter"] == b["parameter"] == 0


@pytest.fixture
def world_of_one():
    from repro_torch.launch import mesh as launch_mesh

    launch_mesh.init_distributed("cpu", rank=0, world_size=1,
                                 init_method=f"tcp://localhost:"
                                             f"{launch_mesh.free_port()}",
                                 timeout=30)
    try:
        yield launch_mesh.make_debug_mesh(1, 1, device_type="cpu")
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("arch", W.LOCAL_ARCHS)
def test_one_process_mesh_decode_is_the_one_device_decode(world_of_one,
                                                          arch):
    """On a (1, 1) mesh the model axis splits nothing: the prefill and 4
    decode steps give the one-device steps' logits and cache bit for
    bit."""
    from repro_torch.configs.base import ShapeConfig as TorchShapeConfig
    from repro_torch.launch.serve import greedy, shard_params
    from repro_torch.train.step import make_prefill_step

    mesh, cfg = world_of_one, W.serve_config(arch)
    api, rules = build_model(cfg), W.serve_rules(arch)
    params = api.init(torch.Generator().manual_seed(0))
    pshape = TorchShapeConfig("p", W.P, W.B, "prefill")
    sharded = shard_params(api, params, mesh, rules)
    batch = W.prompt(cfg)
    with torch.no_grad():
        a = make_prefill_step(api, pshape, W.P + W.G)(params, batch)
        b = make_prefill_step(api, pshape, W.P + W.G, mesh=mesh,
                              rules=rules)(sharded, batch)
        plain = make_decode_step(api)
        split = make_decode_step(api, mesh=mesh, rules=rules)
        for i in range(W.G + 1):
            assert torch.equal(a[0].view(torch.int32),
                               b[0].to_local().view(torch.int32)), i
            for k, t in a[1].items():
                assert torch.equal(t.reshape(-1).view(torch.uint8),
                                   b[1][k].to_local().reshape(-1)
                                   .view(torch.uint8)), (i, k)
            if i == W.G:
                break
            tok = greedy(a[0])
            step = {"token": tok, "pos": torch.full((W.B,), W.P + i,
                                                    dtype=torch.int32)}
            a = plain(params, a[1], step)
            b = split(sharded, b[1], step)


def test_decode_refuses_a_split_it_does_not_take():
    """An xlstm cache whose heads the smoke name's table shards over the
    model axis: the decode step names the entry instead of computing on
    a shard it cannot."""
    from repro_torch.train.step import DECODE_SPLITS, decode_splits

    class Placed:
        def __init__(self, shape, placements):
            self.shape, self.placements = shape, placements

    api = build_model(W.serve_config("xlstm_350m"))
    cache = {"m_state": Placed((2, 4, 2, 64, 64), [Replicate(), Shard(2)])}
    assert "m_state" not in DECODE_SPLITS
    with pytest.raises(NotImplementedError, match="m_state"):
        decode_splits(api, {"data": 2, "model": 2}, cache)


# ------------------------------------------------ the cache across counts
def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _saved(runs):
    return runs["four"][0][W.SAVE_MESH][W.SAVE_ARCH]


def test_sharded_cache_is_saved_sharded_on_kv_seq(runs):
    """The cache the 4 processes save is split on its sequence dim over
    the model axis (and its rows over the data axis)."""
    placements = _saved(runs)["saved"]["placements"]
    assert placements["k"] == [str(Shard(1)), str(Shard(2))]
    assert placements["length"] == [str(Replicate())] * 2


def test_sharded_cache_restores_on_one_process(runs):
    """The cache saved by 4 processes (2, 2) restores whole on one,
    every array bit-equal; one-device decode from it goes on with the
    uninterrupted run's tokens."""
    saved = _saved(runs)["saved"]["cache"]
    api = build_model(W.serve_config(W.SAVE_ARCH))
    ck = TensorCheckpoint(DatasetStore(runs["store"], "r"))
    cache = load_torch(ck, api.abstract_cache(W.B, W.P + W.G), W.SAVE_STEP,
                       device="cpu")
    for k, v in saved.items():
        assert _bits(cache[k]) == _bits(v), k
    decode = make_decode_step(api)
    params, tok = runs["inits"][W.SAVE_ARCH], runs["resume"]
    want = _saved(runs)["logits"]
    for i in range(W.SAVE_AFTER, W.G):
        logits, cache = decode(params, cache, {
            "token": tok, "pos": torch.full((W.B,), W.P + i,
                                            dtype=torch.int32)})
        scale = np.abs(want[i + 1]).max()
        assert np.abs(logits.numpy() - want[i + 1]).max() <= TOL * scale
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        assert np.array_equal(tok[:, 0].numpy(), want[i + 1].argmax(-1))


def test_sharded_cache_restores_on_two_processes(runs):
    """The same cache on 2 processes (1, 2): each one's shard bit-equal to
    its box of the saved cache; the sharded decode from it gives the
    uninterrupted run's tokens."""
    saved = _saved(runs)["saved"]["cache"]
    want = _saved(runs)["logits"][W.SAVE_AFTER + 1:]
    for rank in runs["two"]:
        for k, (box, shard) in rank["shards"].items():
            assert _bits(shard) == _bits(saved[k][box]), k
        assert np.array_equal(rank["logits"].argmax(-1), want.argmax(-1))
        assert np.abs(rank["logits"] - want).max() <= TOL * np.abs(want).max()


# ------------------------------------------------------------ the launcher
def _launch(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_launcher.main(argv)
    return buf.getvalue()


def test_serve_launcher_on_four_processes():
    """The launcher as torchrun starts it, 4 processes with --data-mesh 2
    --model-mesh 2: rank 0 prints the reference launcher's keys with the
    tokens of the one-process run, the others nothing."""
    args = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
            "--batch", "4", "--prompt-len", "8", "--gen-len", "4"]
    out = run_processes(_launch, 4, (args + ["--data-mesh", "2",
                                             "--model-mesh", "2"],),
                        init=False, timeout=TIMEOUT, pg_timeout=PG_TIMEOUT,
                        threads=1)
    line = json.loads(out[0].strip().splitlines()[-1])
    assert {"arch", "batch", "prompt_len", "gen_len", "prefill_seconds",
            "decode_seconds", "decode_tokens_per_s",
            "sample_tokens"} <= set(line)
    assert out[1:] == ["", "", ""]
    one = json.loads(_launch(args).strip().splitlines()[-1])
    assert line["sample_tokens"] == one["sample_tokens"]

"""The port's resharder (``repro_torch.core.resharder``) and its
post-processing example against the JAX package's.

``reshard`` (in memory, N ranks to M) must give the reference's arrays and
the reference's ``CommStats``, byte for byte; ``restart_from_step`` and
``sweep_steps`` must load the reference's arrays, with the same store reads,
from step series written by either package; and
``python -m repro_torch.examples.postprocess_small_m --device cpu`` must run,
its store sweeping through the reference engine to the same arrays.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import chunk_layout as ref_layout
from repro.core.comm import Comm as RefComm
from repro.core.resharder import reshard as ref_reshard
from repro.core.resharder import restart_from_step as ref_restart_from_step
from repro.core.resharder import sweep_steps as ref_sweep_steps
from repro.core.store import DatasetStore as RefStore
from repro.core.tensor_ckpt import TensorCheckpoint as RefCheckpoint
from repro.core.tensor_ckpt import shards_from_arrays as ref_shards
from repro_torch.core import chunk_layout
from repro_torch.core.comm import Comm
from repro_torch.core.resharder import reshard, restart_from_step, sweep_steps
from repro_torch.core.star_forest import partition_starts
from repro_torch.core.store import DatasetStore
from repro_torch.core.tensor_ckpt import (TensorCheckpoint,
                                          balanced_chunk_partition,
                                          shards_from_arrays)
from repro_torch.core.torch_io import sweep_to_device, to_torch
from repro_torch.examples.postprocess_small_m import WANTED

REPO = Path(__file__).resolve().parents[1]

# (name, shape, dtype, chunk): f64, f32, int64 and bf16 (which the port
# carries as 2-byte words, the reference through ml_dtypes)
SPECS = [("w/embed", (50, 16), "float64", (16, 16)),
         ("w/dense", (24, 24), "float32", (8, 12)),
         ("w/half", (12, 10), "bfloat16", (4, 5)),
         ("opt/mu", (7,), "float64", (3,)),
         ("step", (1,), "int64", (1,))]


def _layouts():
    return tuple(mod.StateLayout(tuple(mod.ArraySpec(*s) for s in SPECS))
                 for mod in (ref_layout, chunk_layout))


def _ref_arrays(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape, dtype, _ in SPECS:
        if dtype == "int64":
            out[name] = rng.integers(0, 1000, shape).astype(dtype)
        elif dtype == "bfloat16":
            out[name] = rng.normal(size=shape).astype(ml_dtypes.bfloat16)
        else:
            out[name] = rng.normal(size=shape).astype(dtype)
    return out


def _port_arrays(ref_arrays):
    """The same bits as the port's host arrays (bf16 as uint16 words)."""
    return {k: v.view(np.uint16) if v.dtype == ml_dtypes.bfloat16 else v.copy()
            for k, v in ref_arrays.items()}


def _bits(a):
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _plan(mod, M):
    """Per target rank: its rows of the canonical partition of each array,
    cut into two boxes along the last dim where it has two columns."""
    plan = [{} for _ in range(M)]
    for name, shape, _, _ in SPECS:
        starts = partition_starts(shape[0], M)
        for m in range(M):
            a, b = int(starts[m]), int(starts[m + 1])
            if a == b:
                continue
            rest = tuple(shape[1:])
            if rest and rest[-1] >= 2:
                cut = rest[-1] // 2
                plan[m][name] = [
                    mod.Box((a,) + (0,) * len(rest), (b,) + rest[:-1] + (cut,)),
                    mod.Box((a,) + (0,) * (len(rest) - 1) + (cut,),
                            (b,) + rest)]
            else:
                plan[m][name] = [mod.Box((a,) + (0,) * len(rest),
                                         (b,) + rest)]
    return plan


def _assert_same(port_out, ref_out):
    assert len(port_out) == len(ref_out)
    for p, r in zip(port_out, ref_out):
        assert sorted(p) == sorted(r)
        for name in r:
            assert len(p[name]) == len(r[name])
            for a, b in zip(p[name], r[name]):
                assert a.shape == b.shape, name
                np.testing.assert_array_equal(_bits(a), _bits(b),
                                              err_msg=name)


@pytest.mark.parametrize("N,M", [(3, 2), (2, 3), (4, 2), (1, 3), (3, 1),
                                 (5, 4)])
def test_reshard_equals_the_reference(N, M):
    """In-memory N -> M: the same arrays, and the same CommStats on both
    communicators, byte for byte."""
    rlay, play = _layouts()
    arrays = _ref_arrays(seed=13)
    own = balanced_chunk_partition(play, N)
    rsrc, rdst = RefComm(N), RefComm(M)
    psrc, pdst = Comm(N), Comm(M)
    ref_out = ref_reshard(rlay, ref_shards(rlay, arrays, own),
                          _plan(ref_layout, M), rsrc, rdst)
    port_out = reshard(play, shards_from_arrays(play, _port_arrays(arrays),
                                                own),
                       _plan(chunk_layout, M), psrc, pdst)
    _assert_same(port_out, ref_out)
    assert dataclasses.asdict(psrc.stats) == dataclasses.asdict(rsrc.stats)
    assert dataclasses.asdict(pdst.stats) == dataclasses.asdict(rdst.stats)
    assert pdst.stats.bytes_moved > 0
    # and the arrays are the boxes of the source state
    for m, rank in enumerate(_plan(chunk_layout, M)):
        for name, boxes in rank.items():
            for box, got in zip(boxes, port_out[m][name]):
                np.testing.assert_array_equal(
                    got, _port_arrays(arrays)[name][box.slices()])


NSTEPS = 4


def _series(pkg, root, N):
    """A step series of NSTEPS steps saved from N ranks by package ``pkg``:
    ``w/embed`` and ``opt/mu`` change every step, the rest stays (and is
    stored once, aliased by the later steps)."""
    rlay, play = _layouts()
    Store, Ckpt, shards, lay, C = (
        (RefStore, RefCheckpoint, ref_shards, rlay, RefComm) if pkg == "ref"
        else (DatasetStore, TensorCheckpoint, shards_from_arrays, play, Comm))
    store = Store(str(root), "w")
    ck = Ckpt(store)
    ck.save_layout(lay)
    own = balanced_chunk_partition(play, N)
    base = _ref_arrays(seed=1)
    states = []
    for s in range(NSTEPS):
        arrays = dict(base)
        fresh = _ref_arrays(seed=100 + s)
        arrays["w/embed"], arrays["opt/mu"] = fresh["w/embed"], fresh["opt/mu"]
        store.begin_step(s)
        ck.save_state(shards(lay, arrays if pkg == "ref"
                             else _port_arrays(arrays), own), C(N), s)
        store.commit_step()
        states.append(arrays)
    store.close()
    return states


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("M", [1, 2])
def test_sweep_and_restart_equal_the_reference(tmp_path, writer, M):
    """On a series from either package, the port's ``sweep_steps`` (all
    committed steps, a subset of arrays) and ``restart_from_step`` load the
    reference's arrays bit for bit, with the same store reads."""
    states = _series(writer, tmp_path, N=3)
    arrays = ["w/embed", "w/half"]
    rck = RefCheckpoint(RefStore(str(tmp_path), "r"))
    pck = TensorCheckpoint(DatasetStore(str(tmp_path), "r"))
    ref_swept = list(ref_sweep_steps(rck, _plan(ref_layout, M), RefComm(M),
                                     arrays=arrays))
    port_swept = list(sweep_steps(pck, _plan(chunk_layout, M), Comm(M),
                                  arrays=arrays))
    assert [s for s, _ in port_swept] == [s for s, _ in ref_swept] \
        == list(range(NSTEPS))
    for (s, p), (_, r) in zip(port_swept, ref_swept):
        assert all(sorted(rank) == arrays for rank in p if rank)
        _assert_same(p, r)
        got = np.concatenate([np.concatenate(rank["w/embed"], axis=1)
                              for rank in p])
        np.testing.assert_array_equal(got, states[s]["w/embed"])
    assert pck.store.stats.as_dict()["bytes_read"] \
        == rck.store.stats.as_dict()["bytes_read"]
    assert pck.store.stats.read_calls == rck.store.stats.read_calls
    for k in (0, NSTEPS - 1):
        _assert_same(restart_from_step(pck, k, _plan(chunk_layout, M),
                                       Comm(M)),
                     ref_restart_from_step(rck, k, _plan(ref_layout, M),
                                           RefComm(M)))
    # a sweep over chosen steps yields those steps only
    assert [s for s, _ in sweep_steps(pck, _plan(chunk_layout, M), Comm(M),
                                      steps=[2], arrays=["step"])] == [2]


def test_sweep_reads_only_the_chosen_arrays(tmp_path):
    """A sweep restricted to one array reads less than a sweep of all of
    them, and never another array's vec."""
    _series("port", tmp_path, N=2)
    plan = _plan(chunk_layout, 1)
    read = {}
    for key, arrays in (("one", ["opt/mu"]), ("all", None)):
        ck = TensorCheckpoint(DatasetStore(str(tmp_path), "r"))
        for _ in sweep_steps(ck, plan, Comm(1), arrays=arrays):
            pass
        read[key] = ck.store.stats.bytes_read
    embed_vec = 50 * 16 * 8
    assert read["one"] < embed_vec < read["all"]


# ------------------------------------------------------------- the example
@pytest.fixture(scope="module")
def example_store(tmp_path_factory):
    """Run the example as a user would, on the CPU; its store and output."""
    d = tmp_path_factory.mktemp("pp") / "ckpt"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.postprocess_small_m",
         "--device", "cpu", "--ckpt-dir", str(d)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return d, res.stdout


def test_example_runs_on_the_cpu(example_store):
    _, out = example_store
    assert "saved steps [10, 20] from 8 ranks" in out
    assert "sweeping committed steps [10, 20] on 1 process, 2/" in out
    assert out.count("|embed| = ") == 2
    assert "nearest neighbours of tokens 0..7 (step 20)" in out
    assert "post-processing sweep OK" in out


def test_example_store_sweeps_through_the_reference(example_store):
    """The example's 8-rank series (bf16 parameters, f32 slots) swept by
    the reference engine gives the arrays ``sweep_to_device`` puts on the
    device, bit for bit."""
    d, _ = example_store
    rck = RefCheckpoint(RefStore(str(d), "r"))
    layout = rck.layout()
    plan = [{n: [layout.spec(n).full_box] for n in layout.names}]
    ref = dict(ref_sweep_steps(rck, plan, RefComm(1), arrays=list(WANTED)))
    pck = TensorCheckpoint(DatasetStore(str(d), "r"))
    port = dict(sweep_to_device(pck, WANTED, "cpu"))
    assert sorted(port) == sorted(ref) == [10, 20]
    for s in ref:
        for name in WANTED:
            want = ref[s][0][name][0]
            got = port[s][name]
            assert got.dtype == getattr(torch, layout.spec(name).dtype)
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.view(torch.uint8).numpy()
                                          .reshape(-1), _bits(want))
    # the two steps differ: the sweep is not reading one step twice
    assert not torch.equal(port[10]["params/embed"], port[20]["params/embed"])
    # to_torch keeps the stored dtype (bf16 words reinterpreted, not cast)
    assert to_torch(np.zeros(2, np.uint16), "bfloat16").dtype == torch.bfloat16

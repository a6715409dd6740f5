"""The port's checkpoint bridge across ``torch.distributed`` processes (gloo
on the CPU): one checkpoint rank per process, rank 0 running the engine for
all of them.

A store written by N processes must be byte-identical to the one a single
process writes with ``save_torch(ownership=<the same N ownerships>)``, and
a load on M processes of another mesh must give every process's local
shard bit for bit, in f32, bf16, int32 and the 0-d ``step``.  The saves
run on 2 processes (meshes (2, 1) and (1, 2)) and on 4 ((2, 2)); the loads
on 1, 2 and 4.  Three sets of processes (4, then 2, then 1) run every case
once, and the tests read what they returned.
"""

from __future__ import annotations

import filecmp
import os

import numpy as np
import pytest
from helpers import torch_mesh_workers as W

from repro_torch.core.store import DatasetStore
from repro_torch.core.tensor_ckpt import TensorCheckpoint
from repro_torch.core.torch_io import save_torch
from repro_torch.distrib import sharding
from repro_torch.launch.spawn import run_processes

# each set of processes runs well under this; a hang fails the test here
TIMEOUT = 240
SAVES = {"n4_2x2": (2, 2), "n2_2x1": (2, 1), "n2_1x2": (1, 2)}
# (store, mesh the load runs on): every store on another mesh, M in {1, 2, 4}
LOADS = [("n4_2x2", (4, 1)), ("n4_2x2", (1, 4)), ("n4_2x2", (1, 2)),
         ("n4_2x2", (2, 1)), ("n4_2x2", (1, 1)),
         ("n2_2x1", (1, 2)), ("n2_2x1", (1, 1)),
         ("n2_1x2", (2, 1)), ("n2_1x2", (1, 1))]


def _world(mesh):
    return mesh[0] * mesh[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every save and load, by the processes of each world size in turn:
    4 (the 4-process save and its loads on 4), 2 (the 2-process saves and
    every load on 2), 1 (every load on 1)."""
    root = tmp_path_factory.mktemp("mesh_io")
    stores = {k: str(root / k) for k in SAVES}
    out = {}
    for world in (4, 2, 1):
        saves = [((k,), m, stores[k]) for k, m in SAVES.items()
                 if _world(m) == world]
        loads = [((k, m), m, stores[k]) for k, m in LOADS
                 if _world(m) == world]
        per_rank = run_processes(W.save_and_load, world, (saves, loads),
                                 timeout=TIMEOUT, pg_timeout=60, threads=1)
        for key in per_rank[0]:
            out[key] = [r[key] for r in per_rank]
    return stores, out


@pytest.mark.parametrize("store", sorted(SAVES))
def test_n_process_save_is_byte_identical_to_one_process(runs, tmp_path,
                                                         store):
    """The store the N processes wrote equals, file for file and byte for
    byte (store.json included), the store one process writes with
    ``save_torch(ownership=...)`` of the same N ownerships and layout."""
    stores, out = runs
    recs = out[("save", store)]
    layout = recs[0]["layout"]
    assert all(r["layout"] == layout for r in recs)
    ownership = [{n: np.asarray(o, dtype=np.int64)
                  for n, o in r["ordinals"].items()} for r in recs]
    ck = TensorCheckpoint(DatasetStore(str(tmp_path), "w"))
    ck.save_layout(layout)
    save_torch(ck, W.full_state(), W.STEP, ownership=ownership)
    files = sorted(os.listdir(stores[store]))
    assert files == sorted(os.listdir(tmp_path))
    match, mismatch, errors = filecmp.cmpfiles(stores[store], tmp_path,
                                               files, shallow=False)
    assert not mismatch and not errors, mismatch
    meta = ck.store.get_attrs("meta")
    assert meta["section/w_f32/e0"]["nranks"] == len(recs)


@pytest.mark.parametrize("store", sorted(SAVES))
def test_local_shards_are_the_reference_boxes(runs, store):
    """Each process's DTensor shard (torch's own offsets) is the box that
    the reference's ``device_box`` gives its mesh coordinate, and it saves
    exactly the chunks of its owned boxes: replicas with a nonzero
    coordinate on a replicated axis (ghosts) save nothing."""
    _, out = runs
    recs = out[("save", store)]
    data, model = SAVES[store]
    coords = [{"data": r // model, "model": r % model}
              for r in range(data * model)]
    mesh = {"data": data, "model": model}
    for r, rec in enumerate(recs):
        for name, (shape, axes) in W.SPECS.items():
            spec = W.RULES.spec_for(axes, shape, mesh)
            box = sharding.device_box(shape, mesh, spec, coords[r])
            assert rec["boxes"][name] == (box.start, box.stop), (r, name)
            assert rec["dtensor_boxes"][name] == (box.start, box.stop)
            owner = sharding.is_owner(mesh, spec, coords[r], len(shape))
            grid = rec["layout"].spec(name).grid
            want = grid.chunks_intersecting(box) if owner else None
            assert rec["ordinals"].get(name) == want, (r, name)
    saved = {n for rec in recs for n in rec["ordinals"]}
    assert saved == set(W.SPECS)


@pytest.mark.parametrize("store,mesh", LOADS,
                         ids=[f"{s}-to-{m[0]}x{m[1]}" for s, m in LOADS])
def test_n_to_m_load_is_bit_equal(runs, store, mesh):
    """Loaded on M processes of another mesh, every process's local shard
    of every array is its box of the saved state, bit for bit, in the
    saved dtype and on the target placements."""
    _, out = runs
    recs = out[("load", store, mesh)]
    assert len(recs) == _world(mesh)
    dtypes = {n: str(t.dtype) for n, t in W.full_state().items()}
    for r, rec in enumerate(recs):
        assert set(rec) == set(W.SPECS)
        for name, got in rec.items():
            assert got["bit_equal"], (r, name)
            assert got["placements_match"], (r, name)
            assert got["dtype"] == dtypes[name], (r, name)

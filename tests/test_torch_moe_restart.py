"""The paper's N-to-M restart across expert-parallel degrees: granite's
smoke EP variant (16 experts, 8 of them phantoms; each expert array
sharded over the model axis on its experts and over the data axis on its
embed dim) trained and saved by 4 ``torch.distributed`` processes on a
(2, 2) mesh restores on 1 process and on 2 processes, mesh (1, 2), bit for
bit, and trains on; and the state crosses between the packages both ways.

The reference runs in subprocesses with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` on Auto-axis meshes
(ROADMAP.md, Reference caveats).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from helpers import torch_moe_workers as W
from helpers.torch_mesh_workers import _same_bits

from repro_torch.core.torch_io import to_torch
from repro_torch.launch.spawn import run_processes

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300
PG_TIMEOUT = 60

_JAX = r"""
import dataclasses, functools, json, sys
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.distrib.rules import rules_for
from repro.models.api import build_model
from repro.train import schedule
from repro.train.data import SyntheticLM
from repro.train.loop import Trainer, TrainerConfig
from repro.train.optim import AdamW
from repro.train.step import init_train_state, make_train_step

out, mode, ckpt = sys.argv[1], sys.argv[2], sys.argv[3]
SHAPE = ShapeConfig("t", %(seq)d, %(batch)d, "train")
cfg = get_smoke_config("%(arch)s")
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="ep"))
api = build_model(cfg)


def trainer(d, m, ckpt_every):
    mesh = jax.make_mesh((d, m), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    step = make_train_step(
        api, AdamW(), functools.partial(schedule.warmup_cosine,
                                        base_lr=1e-3, warmup=2, total=100),
        mesh, rules_for(cfg.arch), SHAPE)
    data = SyntheticLM(cfg.vocab, SHAPE.seq_len, SHAPE.global_batch, seed=0)
    return Trainer(step, data, TrainerConfig(ckpt_dir=ckpt,
                                             ckpt_every=ckpt_every,
                                             log_every=1),
                   init_state_fn=lambda: init_train_state(
                       api, AdamW(), jax.random.key(0)))


def dump(path, tree):
    arrays = {k: np.asarray(v) for k, v in tree.items()}
    dtypes = {k: a.dtype.name for k, a in arrays.items()}
    np.savez(path, **{k: a.view(np.uint16) if a.dtype.name == "bfloat16"
                      else a for k, a in arrays.items()})
    json.dump(dtypes, open(path + ".json", "w"))


if mode == "save":            # (2, 2) saves steps 2 and 4
    dump(f"{out}/saved_4.npz", trainer(2, 2, 2).run(4)["state"])
else:                         # (1, 4) restores the port's latest step
    state, start = trainer(1, 4, 0).restore_latest()
    assert start == 4, start
    dump(f"{out}/restored_4.npz", state)
print("OK")
""" % {"seq": W.SEQ, "batch": W.BATCH, "arch": W.ARCH}


def _jax(out: Path, mode: str, ckpt: Path) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", _JAX, str(out), mode,
                          str(ckpt)], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), \
        res.stderr[-4000:]


def _load_npz(path: Path) -> dict[str, torch.Tensor]:
    dtypes = json.loads(Path(str(path) + ".json").read_text())
    with np.load(path) as z:
        return {k: to_torch(z[k], dtypes[k]) for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference saves on (2, 2); 4 port processes save (the restart's
    step 2, and steps 2 and 4 for the reference); the reference restores
    the port's save on (1, 4); 1 port process restores step 2; 2 port
    processes restore step 2 and the reference's save."""
    root = tmp_path_factory.mktemp("moe_restart")
    ref, jck, pck, ck = (root / "ref", root / "jax_ckpt", root / "port_ckpt",
                         root / "ckpt")
    ref.mkdir()
    kept = str(root / "step2.pt")
    _jax(ref, "save", jck)
    four = run_processes(W.save_four, 4, (str(ck), kept, str(pck)),
                         timeout=TIMEOUT, pg_timeout=PG_TIMEOUT, threads=1)
    _jax(ref, "restore", pck)
    one = run_processes(W.restore_and_train, 1, ((1, 1), str(ck), kept),
                        timeout=TIMEOUT, pg_timeout=PG_TIMEOUT, threads=2)
    two = run_processes(W.restore_and_train, 2,
                        ((1, 2), str(ck), kept, str(jck)), timeout=TIMEOUT,
                        pg_timeout=PG_TIMEOUT, threads=1)
    return {"ref": ref, "four": four, "one": one[0], "two": two,
            "kept": kept}


def test_four_processes_save_the_ep_state(runs):
    """The 4 processes trained steps 1-2 with finite losses and rank 0
    kept the whole state it saved at step 2."""
    for r in runs["four"]:
        first = r["first"]
        assert first["start"] == 0 and first["losses_finite"]
        assert [s["step"] for s in first["save_log"]] == [2]
    assert "params/we_gate" in torch.load(runs["kept"])


@pytest.mark.parametrize("procs", ["one", "two"])
def test_ep_state_restores_on_other_process_counts(runs, procs):
    """Step 2 of the (2, 2) run restores on 1 process (every expert local)
    and on 2 processes, mesh (1, 2) (8 experts each, the embed dim whole),
    every array of every shard bit-equal to what the 4 processes saved, and
    trains on to step 4 with finite losses."""
    n_arrays = len(torch.load(runs["kept"]))
    per_proc = [runs["one"]] if procs == "one" else runs["two"]
    for r in (x["phase"] for x in per_proc):
        assert r["start"] == 2 and r["bit_equal_arrays"] == n_arrays
        assert r["losses_finite"]
        assert [h["step"] for h in r["history"]] == [3, 4]


def test_one_and_two_processes_train_on_alike(runs):
    """The restarted runs on 1 and 2 processes compute the same steps 3
    and 4: their losses agree within f32 1e-5 of their scale (the model
    axis sums the experts' outputs in another order)."""
    one = runs["one"]["phase"]["history"]
    two = runs["two"][0]["phase"]["history"]
    for a, b in zip(one, two):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])


def test_reference_save_restores_on_two_port_processes(runs):
    """The reference's step 4, saved on a (2, 2) mesh of 4 devices,
    restores on 2 port processes, mesh (1, 2), bit for bit, each process's
    shard its box of it."""
    want = _load_npz(runs["ref"] / "saved_4.npz")
    for r in runs["two"]:
        got = r["jax"]
        assert got["start"] == 4 and got["local_ok"]
        assert not _same_bits(got["state"], want)


def test_port_save_on_four_processes_restores_into_reference(runs):
    """The port's step 4, saved from 4 processes on (2, 2), restores into
    the reference's Trainer on a (1, 4) mesh, bit for bit."""
    got = _load_npz(runs["ref"] / "restored_4.npz")
    assert not _same_bits(got, runs["four"][0]["saved"])

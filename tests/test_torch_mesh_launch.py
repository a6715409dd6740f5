"""The port's entry points across ``torch.distributed`` processes (gloo on
the CPU): the elastic-restart example at 4 -> 2 processes, and the train
launcher as ``torchrun`` starts it."""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest

from repro_torch.core.store import DatasetStore
from repro_torch.core.tensor_ckpt import TensorCheckpoint
from repro_torch.examples import elastic_restart
from repro_torch.launch import train as train_launcher
from repro_torch.launch.spawn import run_processes

# each set of processes runs well under this; a hang fails the test here
TIMEOUT = 300
# a collective waits this long for a peer before it raises
PG_TIMEOUT = 60


def test_elastic_example_four_to_two(tmp_path):
    """The example at 4 -> 2 processes: (2, 2) saves 10 and 20, dies
    mid-save of 30, (2, 1) restarts from 20 and runs to 40."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = elastic_restart.main(["--save-mesh", "2", "2", "--load-mesh",
                                    "2", "1", "--ckpt-dir",
                                    str(tmp_path / "ck"), "--timeout",
                                    str(TIMEOUT), "--device", "cpu"])
    text = buf.getvalue()
    assert text.strip().endswith(
        "elastic N-to-M restart after an injected crash OK"), text
    first, crashed, third = out["phases"]
    assert (first["world"], crashed["world"], third["world"]) == (4, 4, 2)
    assert third["start"] == 20 and third["history"][-1]["step"] == 40
    store = DatasetStore(str(tmp_path / "ck"), "r")
    assert TensorCheckpoint(store).steps() == [10, 20, 30, 40]


def _launch(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_launcher.main(argv)
    return buf.getvalue()


def test_launcher_on_two_processes(tmp_path, monkeypatch, capsys):
    """The launcher as torchrun starts it (WORLD_SIZE, RANK, MASTER_ADDR),
    2 processes with --data-mesh 2: rank 0 prints the JSON lines, rank 1
    nothing.  A world size the mesh flags do not match exits non-zero,
    naming both numbers."""
    args = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
            "--data-mesh", "2", "--steps", "20", "--batch", "4", "--seq",
            "16", "--ckpt-every", "10", "--ckpt-dir", str(tmp_path / "ck")]
    out = run_processes(_launch, 2, (args,), init=False, timeout=TIMEOUT,
                        pg_timeout=PG_TIMEOUT, threads=1)
    lines = [json.loads(ln) for ln in out[0].splitlines()]
    assert [ln["step"] for ln in lines[:-1]] == [10, 20]
    assert lines[-1]["saved_steps"] == [10, 20]
    assert np.isfinite(lines[-1]["final_loss"])
    assert out[1] == ""
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit) as e:
        train_launcher.main(args)
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert "needs 2 processes" in err and "is 3" in err

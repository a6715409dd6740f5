"""The port's quickstart (``repro_torch/examples/quickstart.py``) against
the reference's ``examples/quickstart.py``: both run on the CPU, each into
a directory the test gives it (``tempfile.mkdtemp`` patched in both), and
their stores must hold the same files with the same bytes.  The reference
script is loaded by path and run as it is."""

from __future__ import annotations

import importlib.util
import os
import tempfile
from pathlib import Path

import pytest

from repro_torch.core.tensor_ckpt import TensorCheckpoint
from repro_torch.examples import quickstart
from repro_torch.kernels.ckpt_pack import ops as pack_ops

ROOT = Path(__file__).resolve().parents[1]


def _run_in(monkeypatch, path: Path, fn):
    """``fn()`` with ``tempfile.mkdtemp`` handing out ``path``."""
    path.mkdir()
    monkeypatch.setattr(tempfile, "mkdtemp", lambda **kw: str(path))
    try:
        return fn()
    finally:
        monkeypatch.undo()


def _files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_quickstart_store_is_byte_identical_to_the_reference(
        monkeypatch, tmp_path, capsys):
    """The port's example with ``--device cpu`` (the ckpt_pack wrapper's
    plain version, no kernel launch) prints the reference's three kinds
    of line and writes the reference script's store, file for file and
    byte for byte: the layout, the four committed steps and the section
    written once."""
    spec = importlib.util.spec_from_file_location(
        "ref_quickstart", ROOT / "examples" / "quickstart.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    _run_in(monkeypatch, tmp_path / "ref", ref.main)
    ref_text = capsys.readouterr().out
    pack_ops.launches = 0
    where = _run_in(monkeypatch, tmp_path / "port",
                    lambda: quickstart.main(["--device", "cpu"]))
    text = capsys.readouterr().out
    assert where == str(tmp_path / "port") and pack_ops.launches == 0
    want, got = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert want and sorted(got) == sorted(want)
    for name, data in want.items():
        assert got[name] == data, name
    for a, b in zip(ref_text.splitlines(), text.splitlines()):
        assert a.split()[:2] == b.split()[:2]
    assert "bit-exact" in text and "[0, 1, 2, 3]" in text
    assert os.path.isfile(tmp_path / "port" / "store.json")


def test_quickstart_refuses_a_load_that_is_not_bit_exact(monkeypatch,
                                                          tmp_path):
    """The example's own check: a loaded block with one element off by a
    last bit fails the run."""
    load = TensorCheckpoint.load_state

    def one_bit_off(self, plan, comm, step):
        out = load(self, plan, comm, step)
        block = out[1]["wq"][0]
        block.view("uint32")[2, 3, 4] ^= 1
        return out

    monkeypatch.setattr(TensorCheckpoint, "load_state", one_bit_off)
    with pytest.raises(AssertionError, match="rank 1's wq"):
        _run_in(monkeypatch, tmp_path / "port",
                lambda: quickstart.main(["--device", "cpu"]))

"""The port's checkpoint bridge (``repro_torch.core.torch_io``) against the
JAX package's (``repro.core.jax_io``): one layout, one store format, both
directions bit for bit.  Mirrors ``tests/test_jax_io.py``."""

from __future__ import annotations

import ast
import filecmp
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.jax_io import layout_from_jax, load_jax, save_jax
from repro.core.store import DatasetStore
from repro.core.tensor_ckpt import TensorCheckpoint
from repro.models.api import build_model
from repro_torch.configs import get_config as torch_get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.chunk_layout import ChunkGrid
from repro_torch.core.comm import Comm as TorchComm
from repro_torch.core.store import DatasetStore as TorchStore
from repro_torch.core.tensor_ckpt import (
    TensorCheckpoint as TorchCheckpoint,
    balanced_chunk_partition,
)
from repro_torch.core.torch_io import (
    chunk_major,
    layout_from_torch,
    load_torch,
    save_torch,
    tree_names,
)
from repro_torch.models.api import build_model as torch_build_model

REPO = Path(__file__).resolve().parents[1]


def _jax_tree():
    """A flat state with every dtype the bridge must carry: f32, int32,
    bf16 and a 0-d step."""
    rng = np.random.default_rng(0)
    return {
        "embed": jnp.asarray(rng.normal(size=(32, 8)), jnp.float32),
        "layers_int": jnp.arange(12, dtype=jnp.int32).reshape(3, 4),
        "w_bf16": jnp.asarray(rng.normal(size=(16, 6)), jnp.bfloat16),
        "step": jnp.array(7, dtype=jnp.int32),
    }


def _torch_tree():
    return params_from_jax({k: np.asarray(v) for k, v in _jax_tree().items()},
                           device="cpu")


def _targets(tree):
    return jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=a.sharding),
        tree)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.reshape(-1).view(torch.uint8).numpy()


def _jbits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def test_tree_names_sorted():
    names, leaves = tree_names({"b": torch.zeros(1), "a": torch.ones(2)})
    assert names == ["a", "b"] and leaves[0].shape == (2,)


def test_layout_matches_jax_on_smollm_shapes():
    """Same StateLayout (names, shapes, dtypes, chunk grid) for the
    full-width smollm-135m parameters, with no memory behind either."""
    api = build_model(get_config("smollm_135m"))
    dev = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    jax_abstract = {n: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=dev)
                    for n, s in api.abstract_params().items()}
    torch_abstract = torch_build_model(
        torch_get_config("smollm_135m")).abstract_params()
    want = layout_from_jax(jax_abstract)
    got = layout_from_torch(torch_abstract)
    assert got.to_json() == want.to_json()
    assert got.spec("embed").grid.counts == (16, 16)
    assert got.spec("w_gate").grid.counts == (2, 16, 16)


@pytest.mark.parametrize("shape,chunk", [((8, 12), (2, 3)), ((4, 6, 10), (2, 3, 5)),
                                         ((12,), (4,)), ((), ()),
                                         ((6, 4), (6, 4))])
def test_chunk_major_follows_chunk_grid(shape, chunk):
    """Row o of the chunk-major view is chunk o's box, row-major."""
    t = torch.arange(int(np.prod(shape)), dtype=torch.int32).reshape(shape)
    view = chunk_major(t, chunk)
    grid = ChunkGrid(shape, chunk)
    assert view.shape[0] == grid.num_chunks
    for o in range(grid.num_chunks):
        box = grid.chunk_box(o)
        np.testing.assert_array_equal(view[o].reshape(-1).numpy(),
                                      t.numpy()[box.slices()].reshape(-1))


def test_chunk_major_rejects_ragged_grid():
    with pytest.raises(ValueError):
        chunk_major(torch.zeros(10), (4,))


def test_jax_save_loads_through_torch(tmp_path):
    """save_jax -> load_torch: bit-exact in f32, int32, bf16 and 0-d."""
    tree = _jax_tree()
    ck = TensorCheckpoint(DatasetStore(str(tmp_path), "w"))
    ck.save_layout(layout_from_jax(tree))
    save_jax(ck, tree, step=3)
    target = {k: torch.empty(v.shape, dtype=getattr(torch, str(v.dtype)),
                             device="meta") for k, v in tree.items()}
    got = load_torch(TorchCheckpoint(TorchStore(str(tmp_path), "r")), target,
                     step=3, device="cpu")
    assert got["w_bf16"].dtype == torch.bfloat16
    assert got["step"].shape == ()
    for k, v in tree.items():
        np.testing.assert_array_equal(_bits(got[k]), _jbits(v), err_msg=k)


def test_torch_save_loads_through_jax(tmp_path):
    """save_torch -> load_jax: bit-exact in f32, int32, bf16 and 0-d."""
    tree = _torch_tree()
    ck = TorchCheckpoint(TorchStore(str(tmp_path), "w"))
    ck.save_layout(layout_from_torch(tree))
    save_torch(ck, tree, step=5)
    jtree = _jax_tree()
    loaded = load_jax(TensorCheckpoint(DatasetStore(str(tmp_path), "r")),
                      _targets(jtree), step=5)
    assert loaded["w_bf16"].dtype == jnp.bfloat16
    for k, v in tree.items():
        np.testing.assert_array_equal(_jbits(loaded[k]), _bits(v), err_msg=k)


@pytest.mark.parametrize("series", [False, True])
def test_both_packages_write_identical_stores(tmp_path, series):
    """Equal values give byte-identical store files (store.json included),
    plain and as a series step — whose manifest carries the content hashes
    (bf16 datasets hash under the name "bfloat16" in both)."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jst = DatasetStore(str(jdir), "w")
    jck = TensorCheckpoint(jst)
    jck.save_layout(layout_from_jax(_jax_tree()))
    tst = TorchStore(str(tdir), "w")
    tck = TorchCheckpoint(tst)
    tck.save_layout(layout_from_torch(_torch_tree()))
    for step in (0, 1):
        if series:
            jst.begin_step(step)
            tst.begin_step(step)
        save_jax(jck, _jax_tree(), step)
        save_torch(tck, _torch_tree(), step)
        if series:
            jst.commit_step()
            tst.commit_step()
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(tdir))
    match, mismatch, errors = filecmp.cmpfiles(jdir, tdir, files, shallow=False)
    assert not mismatch and not errors, mismatch
    if series:
        assert '"hashes"' in (tdir / "store.json").read_text()


def test_four_rank_save_one_rank_load(tmp_path):
    """The slice's N-to-M restart at smoke width: a bf16 model state saved
    as N=4 ranks (each rank packed through ckpt_pack's plain version)
    restores on M=1 bit-exact, through the port and through the JAX
    package alike; the stored per-chunk checksums verify."""
    cfg = torch_get_config("smollm_135m")
    api = torch_build_model(
        __import__("dataclasses").replace(cfg, num_layers=2, vocab=512))
    params = api.init(torch.Generator().manual_seed(0))
    layout = layout_from_torch(params)
    ck = TorchCheckpoint(TorchStore(str(tmp_path), "w"))
    ck.save_layout(layout)
    ownership = balanced_chunk_partition(layout, 4)
    assert all(ownership)
    save_torch(ck, params, step=0, ownership=ownership)
    meta = ck.store.get_attrs("meta")
    assert meta["section/embed/e0"]["nranks"] == 4
    reader = TorchCheckpoint(TorchStore(str(tmp_path), "r"))
    got = load_torch(reader, api.abstract_params(), step=0, device="cpu")
    for k, v in params.items():
        np.testing.assert_array_equal(_bits(got[k]), _bits(v), err_msg=k)
    assert reader.verify_step(TorchComm(1), 0)
    dev = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    jtarget = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.bfloat16,
                                       sharding=dev) for k, v in params.items()}
    loaded = load_jax(TensorCheckpoint(DatasetStore(str(tmp_path), "r")),
                      jtarget, step=0)
    for k, v in params.items():
        np.testing.assert_array_equal(_jbits(loaded[k]), _bits(v), err_msg=k)


_NO_ML_DTYPES = """
import sys, tempfile
sys.modules["ml_dtypes"] = None          # importing it now raises
import numpy as np, torch
from repro_torch.core.store import DatasetStore
from repro_torch.core.tensor_ckpt import TensorCheckpoint
from repro_torch.core.torch_io import layout_from_torch, load_torch, save_torch
g = torch.Generator().manual_seed(0)
tree = {"w": torch.randn(16, 4, generator=g).to(torch.bfloat16),
        "b": torch.randn(8, generator=g), "step": torch.tensor(3)}
d = tempfile.mkdtemp()
st = DatasetStore(d, "w")
ck = TensorCheckpoint(st)
ck.save_layout(layout_from_torch(tree))
st.begin_step(0)
save_torch(ck, tree, 0)
st.commit_step()
got = load_torch(TensorCheckpoint(DatasetStore(d, "r")),
                 {k: torch.empty_like(v, device="meta") for k, v in tree.items()},
                 0, device="cpu")
for k, v in tree.items():
    assert torch.equal(got[k], v), k
assert '"dtype": "bfloat16"' in open(d + "/store.json").read()
assert "ml_dtypes" not in {m for m, v in sys.modules.items() if v is not None}
print("OK")
"""


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_store_roundtrip_without_ml_dtypes():
    """The card's machine has no ml_dtypes: bf16 still saves, loads and is
    recorded as "bfloat16"."""
    assert _run(_NO_ML_DTYPES).strip().endswith("OK")


_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro.") or m == "ml_dtypes")
print(len(sys.modules), bad)
assert not bad, bad
"""


def test_port_imports_without_jax_or_reference():
    """Every module of the port imports with neither ``jax`` nor the JAX
    package (``repro``) nor ``ml_dtypes`` ending up in sys.modules."""
    _run(_IMPORT_ALL)


def test_port_has_no_import_of_jax_or_reference_anywhere():
    """No import statement of the port, module level or inside a function
    body (the lazy imports of ``fem.checkpoint``, ``fem.section`` and the
    FEM facade of ``core.async_io``, which importing every module never
    runs), names ``jax``, the JAX package or ``ml_dtypes``: every module of
    ``repro_torch`` (the meshes, the elastic harness and example among
    them, and the MoE layer and its collectives), ``chip_smoke.py`` and the
    helpers that the port's spawned processes import."""
    banned = ("jax", "repro", "ml_dtypes")
    found = []
    paths = sorted((REPO / "repro_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests/helpers/torch_faultstore.py",
        REPO / "tests/helpers/torch_mesh_workers.py",
        REPO / "tests/helpers/torch_moe_workers.py"]
    names = {str(p.relative_to(REPO)) for p in paths}
    assert {"repro_torch/distrib/rules.py", "repro_torch/distrib/group.py",
            "repro_torch/distrib/sharding.py", "repro_torch/launch/mesh.py",
            "repro_torch/launch/spawn.py", "repro_torch/train/elastic.py",
            "repro_torch/examples/elastic_restart.py",
            "repro_torch/models/moe.py", "repro_torch/distrib/collectives.py",
            "repro_torch/configs/granite_moe_3b_a800m.py"} <= names
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                      for n in names if n.split(".")[0] in banned]
    assert not found, found

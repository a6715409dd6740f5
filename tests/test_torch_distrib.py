"""The port's meshes against the JAX package's, in one process: the rule
tables and specs tuple for tuple, DTensor placements cutting the
reference's device boxes, the copied modules, the qwen3-1.7b smoke model,
the sharded step on a mesh of one process, the host-object collectives
without a process group, the production mesh's refusal and the port's
fault store."""

from __future__ import annotations

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.ast_copy import normalised
from helpers.torch_faultstore import FaultStore, SimulatedCrash
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor._utils import (
    _compute_local_shape_and_global_offset,
)

import repro.configs.perf as ref_perf
import repro.configs.qwen3_1_7b as ref_qwen3
import repro.distrib.sharding as ref_sharding
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config, get_smoke_config
from repro.configs.base import ShapeConfig
from repro.distrib.rules import rules_for as ref_rules_for
from repro.models.api import build_model, make_token_batch
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.configs import perf, qwen3_1_7b
from repro_torch.convert import params_from_jax
from repro_torch.core.store import DatasetStore
from repro_torch.distrib import (MeshContext, group, mesh_context, sharding,
                                 shard_hint, use_mesh_context)
from repro_torch.distrib.rules import (batch_shardings, placements_for,
                                       rules_for, spec_of)
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models.api import BatchSpec
from repro_torch.models.api import build_model as torch_build_model
from repro_torch.train.step import state_shardings

MESHES = [(1, 1), (2, 2), (4, 2), (2, 4)]
VARIANTS = {"base": {}, "perf": {"shape_name": "train_4k"}}


class _Mesh:
    """A metadata-only mesh: ``spec_for`` reads only ``mesh.shape``."""

    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


def _spec(p) -> tuple:
    return tuple(p)


# ------------------------------------------------------------- the copies
@pytest.mark.parametrize("port,ref", [(sharding, ref_sharding),
                                      (perf, ref_perf),
                                      (qwen3_1_7b, ref_qwen3)],
                         ids=["distrib.sharding", "configs.perf",
                              "configs.qwen3_1_7b"])
def test_module_is_a_copy_of_the_reference(port, ref):
    """The port keeps its own copies (the reference's ``distrib`` package
    imports jax): equal trees once docstrings and the package prefix are
    set aside."""
    assert normalised(port) == normalised(ref)


def test_qwen3_configs_equal_the_reference():
    from repro_torch.configs import get_config as torch_get_config
    assert (dataclasses.asdict(torch_get_config("qwen3-1.7b"))
            == dataclasses.asdict(get_config("qwen3_1_7b")))
    assert (dataclasses.asdict(torch_smoke_config("qwen3_1_7b"))
            == dataclasses.asdict(get_smoke_config("qwen3_1_7b")))


# ------------------------------------------------------------- rule tables
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mesh", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_specs_equal_the_reference(arch, mesh, variant):
    """``rules_for`` gives the reference's table and batch axes, and
    ``spec_for`` the reference's spec, entry for entry, for every parameter
    of the arch's smoke config, every input of a train batch and the batch
    spec; the placements of each spec cut the reference's ``device_box``
    at every mesh coordinate (torch's own offset arithmetic), the ghost
    rule agrees, and ``spec_of`` inverts ``placements_for``."""
    name = get_config(arch).arch
    kw = VARIANTS[variant]
    ref, port = ref_rules_for(name, **kw), rules_for(name, **kw)
    assert dict(port.table) == dict(ref.table)
    assert port.batch_axes == ref.batch_axes
    m = _Mesh(*mesh)
    sizes = m.shape
    for ndim in range(4):
        assert port.batch_spec(ndim) == _spec(ref.batch_spec(ndim))
    specs = build_model(get_smoke_config(arch)).param_specs
    cases = [(s.axes, s.shape) for s in specs.values()]
    cases += [(("batch", None), (8, 32)), (("batch", None), (6, 32))]
    coords = [dict(zip(sizes, c)) for c in itertools.product(
        *(range(n) for n in sizes.values()))]
    for axes, shape in cases:
        spec = port.spec_for(tuple(axes), tuple(shape), m)
        assert spec == _spec(ref.spec_for(tuple(axes), tuple(shape), m)), \
            (axes, shape)
        try:
            placements = placements_for(spec, sizes)
        except ValueError:
            # a dim over two axes against the mesh's order (perf's
            # ("model", "data")): plain Shard cannot place it
            assert any(isinstance(e, tuple) and list(e) != sorted(
                e, key=list(sizes).index) for e in spec), spec
            continue
        padded = spec + (None,) * (len(shape) - len(spec))
        assert spec_of(placements, sizes, len(shape)) == padded
        for c in coords:
            box = sharding.device_box(shape, sizes, spec, c)
            lshape, off = _compute_local_shape_and_global_offset(
                shape, list(sizes.values()), list(c.values()), placements)
            assert (tuple(off), tuple(o + n for o, n in zip(off, lshape))) \
                == (box.start, box.stop), (axes, shape, c)
            assert sharding.is_owner(sizes, spec, c, len(shape)) == \
                ref_sharding.is_owner(sizes, spec, c, len(shape))


def test_placements_follow_the_mesh_order():
    """A dim over both axes is Shard(d) on both mesh dims, major to minor;
    an unknown axis or the reverse order raises."""
    sizes = {"data": 2, "model": 2}
    assert placements_for((("data", "model"), None), sizes) == [Shard(0),
                                                               Shard(0)]
    assert placements_for((None, "model"), sizes) == [Replicate(), Shard(1)]
    assert placements_for((), sizes) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="mesh's dim order"):
        placements_for((("model", "data"),), sizes)
    with pytest.raises(ValueError, match="no axis 'pod'"):
        placements_for((("pod", "data"),), sizes)


def test_tree_helpers_give_placements():
    """``state_shardings`` and ``batch_shardings`` as the reference's,
    placements for shardings; a batch the data axis does not divide is
    replicated."""
    sizes = {"data": 2, "model": 2}
    rules = rules_for("smollm-135m")
    specs = torch_build_model(torch_smoke_config("smollm_135m")).param_specs
    got = state_shardings(sizes, rules, specs)
    # embed is (vocab, embed): the data mesh dim cuts tensor dim 1, the
    # model mesh dim tensor dim 0
    assert got["embed"] == [Shard(1), Shard(0)]
    b = batch_shardings(sizes, rules, {"tokens": BatchSpec((8, 32), "int32"),
                                       "odd": BatchSpec((3, 32), "int32"),
                                       "scalar": BatchSpec((), "int32")})
    assert b == {"tokens": [Shard(0), Replicate()],
                 "odd": [Replicate(), Replicate()],
                 "scalar": [Replicate(), Replicate()]}


# ------------------------------------------------------- context and hints
def test_shard_hint_returns_its_input_and_context_nests():
    ctx = MeshContext(mesh=None, rules=rules_for("smollm-135m"))
    x = torch.ones(2, 3)
    assert mesh_context() is None
    with use_mesh_context(ctx):
        assert mesh_context() is ctx
        assert shard_hint(x, ("batch", None)) is x
    assert mesh_context() is None


def test_root_call_and_gather_without_a_group():
    """Without a process group the collectives are local: the gather is
    this process's object, ``root_call`` runs here and raises as it
    would."""
    assert group.gather_to_root({"a": 1}) == [{"a": 1}]
    assert group.root_call(lambda: 5) == 5
    assert group.root_call(lambda: [7], scatter=True) == 7
    with pytest.raises(KeyError):
        group.root_call(lambda: {}["x"])


# ------------------------------------------------------- meshes in-process
@pytest.fixture
def world_of_one():
    """A gloo process group of this one process, torn down after."""
    launch_mesh.init_distributed("cpu", rank=0, world_size=1,
                                 init_method=f"tcp://localhost:"
                                             f"{launch_mesh.free_port()}",
                                 timeout=30)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("multi_pod,need", [(False, 256), (True, 512)])
def test_production_mesh_names_the_world_size_it_needs(world_of_one,
                                                       multi_pod, need):
    with pytest.raises(ValueError, match=f"world size of {need}; this run "
                                         f"has 1"):
        launch_mesh.make_production_mesh(multi_pod=multi_pod,
                                         device_type="cpu")
    with pytest.raises(ValueError, match="world size of 2"):
        launch_mesh.make_debug_mesh(2, 1, device_type="cpu")


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        launch_mesh.make_debug_mesh(1, 1, device_type="cpu")


def test_sharded_step_on_one_process_is_the_one_device_step(world_of_one):
    """On a (1, 1) mesh (the card's leg of the elastic run) the sharded
    step computes the one-device step bit for bit: the gather, the mean
    over one data rank and the shard of one are identities."""
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optim import AdamW
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        shard_state)

    cfg = torch_smoke_config("smollm_135m")
    api = torch_build_model(cfg)
    shape = ShapeConfig("t", 16, 4, "train")
    sched = lambda s: warmup_cosine(s, base_lr=1e-3, warmup=2,  # noqa: E731
                                    total=100)
    plain = make_train_step(api, AdamW(), sched, shape)
    mesh = launch_mesh.make_debug_mesh(1, 1, device_type="cpu")
    sharded = make_train_step(api, AdamW(), sched, shape, mesh=mesh)
    assert sharded.mesh is mesh and plain.mesh is None
    a = init_train_state(api, AdamW(), torch.Generator().manual_seed(0))
    b = shard_state(a, mesh, sharded.state_shardings)
    data = SyntheticLM(cfg.vocab, 16, 4, seed=0)
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
        a, ma = plain(a, batch)
        b, mb = sharded(b, batch)
        assert {k: float(v) for k, v in ma.items()} == \
            {k: float(v) for k, v in mb.items()}
    for k in a:
        assert a[k].dtype == b[k].dtype
        assert torch.equal(a[k].view(-1).view(torch.uint8),
                           b[k].to_local().view(-1).view(torch.uint8)), k


# ------------------------------------------------------ qwen3-1.7b (smoke)
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen3_smoke_logits_and_loss_match_reference(dtype):
    """The elastic example's model (qk-norm, GQA): prefill and one decode
    step's logits and the training loss against the reference's on its own
    parameters; tolerance per dtype as tests/test_torch_model.py."""
    cfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"), dtype=dtype)
    tcfg = dataclasses.replace(torch_smoke_config("qwen3_1_7b"), dtype=dtype)
    api, tapi = build_model(cfg), torch_build_model(tcfg)
    assert sorted(api.param_specs) == sorted(tapi.param_specs)
    assert {"q_norm", "k_norm"} <= set(tapi.param_specs)
    params = api.init(jax.random.key(0))
    tparams = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    tol = LOGIT_TOL[dtype]
    batch = make_token_batch(cfg, ShapeConfig("p", 12, 2, "prefill"), seed=1)
    logits, cache = api.prefill(params, batch, 16)
    tlogits, tcache = tapi.prefill(
        tparams, {"tokens": torch.from_numpy(batch["tokens"])}, 16)
    np.testing.assert_allclose(tlogits.float().numpy(),
                               np.asarray(logits, np.float32), rtol=tol,
                               atol=tol)
    tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
    pos = np.full((2,), 12, np.int32)
    logits, _ = api.decode_step(params, cache, {"token": jnp.asarray(tok),
                                                "pos": jnp.asarray(pos)})
    tlogits, _ = tapi.decode_step(tparams, tcache,
                                  {"token": torch.from_numpy(tok),
                                   "pos": torch.from_numpy(pos)})
    np.testing.assert_allclose(tlogits.float().numpy(),
                               np.asarray(logits, np.float32), rtol=tol,
                               atol=tol)
    train = make_token_batch(cfg, ShapeConfig("t", 16, 2, "train"), seed=2)
    loss, _ = api.loss(params, train)
    tloss, _ = tapi.loss(tparams, {k: torch.from_numpy(v)
                                   for k, v in train.items()})
    np.testing.assert_allclose(float(tloss), float(loss), rtol=tol, atol=tol)


# ------------------------------------------------------------ fault store
def test_fault_store_dies_at_its_kth_op_and_after(tmp_path):
    """The first k mutating ops complete; the next one dies before it
    touches disk, and so does every op after it."""
    st = FaultStore(str(tmp_path), "w", kill_after_ops=2)
    st.create("a", 4, (), "float64")
    st.write_rows("a", 0, np.arange(4.0))
    with pytest.raises(SimulatedCrash):
        st.set_attrs("k", 1)
    with pytest.raises(SimulatedCrash):
        st.create("b", 1, (), "float64")
    assert st.ops_seen == 2 and st.dead
    back = DatasetStore(str(tmp_path), "r")
    np.testing.assert_array_equal(back.read_rows("a", 0, 4), np.arange(4.0))
    assert not back.has_attrs("k")


def test_fault_store_tears_a_write(tmp_path):
    """With ``tear=True`` the killing data write lands half its rows."""
    st = FaultStore(str(tmp_path), "w", kill_after_ops=1, tear=True)
    st.create("a", 4, (), "float64")
    with pytest.raises(SimulatedCrash):
        st.write_rows("a", 0, np.ones(4))
    got = DatasetStore(str(tmp_path), "r").read_rows("a", 0, 4)
    np.testing.assert_array_equal(got, [1.0, 1.0, 0.0, 0.0])

"""The port's finite-element engine (``repro_torch.fem``, ``core/directory``,
the FEM facade of ``core/async_io``) against the JAX package's.

The engine modules are copies, so each is first held to its reference by
AST (markers, docstrings and the package prefix aside).  Then the reference
FE tests are mirrored on the port's copies at their own sizes and their own
tolerance, bit for bit (``tests/test_fem_checkpoint.py``, the golden store
of ``tests/test_golden_format.py``, the store-call pins of
``tests/test_iostats_independence.py`` and the async FE cases of
``tests/test_async_and_failures.py``), and the two packages are held to
one store format: the same mesh and functions saved by either give
byte-identical files, and each package loads the other's.  The N-to-M grid
of ``tests/test_fem_matrix.py`` is mirrored in ``test_torch_fem_matrix.py``.
"""

from __future__ import annotations

import ast
import hashlib
import inspect
import itertools
import json
import pathlib
import time

import numpy as np
import pytest
import torch
from helpers.ast_copy import normalised
from helpers.hypothesis_shim import given, settings, strategies as st
from helpers.torch_faultstore import FaultStore, SimulatedCrash

import repro.core.async_io as ref_async_io
import repro.core.directory as ref_directory
import repro.core.resharder as ref_resharder
import repro.fem as ref_fem
import repro.fem.checkpoint as ref_checkpoint
import repro.fem.element as ref_element
import repro.fem.function as ref_function
import repro.fem.plex as ref_plex
import repro.fem.section as ref_section
from repro.core.comm import Comm as RefComm
from repro.core.store import DatasetStore as RefStore
import repro_torch.core.async_io as async_io
import repro_torch.core.directory as directory
import repro_torch.core.resharder as resharder
import repro_torch.fem as fem
import repro_torch.fem.checkpoint as checkpoint
import repro_torch.fem.element as element
import repro_torch.fem.function as function
import repro_torch.fem.plex as plex
import repro_torch.fem.section as section
from repro_torch.core.async_io import COMMIT_LOG_KEY, AsyncCheckpointer
from repro_torch.core.comm import Comm
from repro_torch.core.star_forest import partition_starts
from repro_torch.core.store import DatasetStore
from repro_torch.fem import (
    Element, FEMCheckpoint, Function, FunctionSpace, distribute,
    interpolate, interval_mesh, node_points, tri_mesh,
)
from repro_torch.fem.checkpoint import chi_to_LP
from repro_torch.fem.element import (
    edge_node_permutation,
    triangle_interior_permutation,
    triangle_orientation,
)
from repro_torch.fem.torch_fem import functions_from_device, functions_to_device

DATA = pathlib.Path(__file__).parent / "data"
GOLDEN = DATA / "golden_store"
MANIFEST = json.loads((DATA / "golden_manifest.json").read_text())

# the two packages' FE engines, for the cross-package cases
PACKAGES = {
    "ref": (ref_fem, RefStore, RefComm),
    "port": (fem, DatasetStore, Comm),
}


def _field(pts):
    x = pts[:, 0]
    y = pts[:, 1] if pts.shape[1] > 1 else 0 * x
    return np.sin(3 * x) * (2 + np.cos(5 * y)) + x * y


def _field2(pts):
    return np.cos(2 * pts[:, 0]) - pts[:, 1] ** 2


# --------------------------------------------------------------- the copies
COPIES = [(directory, ref_directory), (resharder, ref_resharder),
          (element, ref_element), (plex, ref_plex), (section, ref_section),
          (function, ref_function), (checkpoint, ref_checkpoint),
          (fem, ref_fem)]


@pytest.mark.parametrize("port,ref", COPIES,
                         ids=[p.__name__ for p, _ in COPIES])
def test_module_is_a_copy_of_the_reference(port, ref):
    """Each engine module of the port is its reference's code: the trees
    are equal once docstrings, markers and the package prefix are set
    aside, so the lazy imports inside functions point at the port too."""
    assert normalised(port) == normalised(ref)
    for node in ast.walk(ast.parse(inspect.getsource(port))):
        if isinstance(node, ast.ImportFrom):
            assert not node.module.startswith("repro."), node.module


# ---------------------------------------------- mirror of test_fem_checkpoint
def _save(tmp, mesh, N, el, *, part="contiguous", seed=0, labels=None, bs=1):
    comm = Comm(N)
    plexes, _, _ = distribute(mesh, N, method=part, seed=seed)
    store = DatasetStore(str(tmp), "w")
    ck = FEMCheckpoint(store)
    ck.save_mesh("m", plexes, comm, labels=labels)
    spaces = [FunctionSpace(lp, el, bs=bs) for lp in plexes]
    funcs = [interpolate(sp, lambda p: np.stack([_field(p)] * bs, -1)
                         if bs > 1 else _field(p)) for sp in spaces]
    ck.save_function("m", "f", funcs, comm)
    return store, plexes


@pytest.mark.parametrize("N,M", [(1, 1), (2, 3), (3, 2), (4, 1), (1, 4), (3, 5)])
def test_mesh_topology_roundtrip(tmp_path, N, M):
    mesh = tri_mesh(3, 3, seed=7)
    store, _ = _save(tmp_path, mesh, N, Element("P", 1, "triangle"))
    loaded = FEMCheckpoint(store).load_mesh("m", Comm(M), partition="random",
                                            seed=11)
    assert loaded.E == mesh.num_entities
    owned_cells = []
    for lp in loaded.plexes:
        owned_cells.extend(int(lp.loc_g[c]) for c in lp.cell_ids_local
                           if lp.owned[c])
    assert sorted(owned_cells) == sorted(int(c) for c in mesh.cell_ids)
    for lp in loaded.plexes:
        for i in range(lp.num_entities):
            got = [int(lp.loc_g[q]) for q in lp.cones[i]]
            want = [int(q) for q in mesh.cones[int(lp.loc_g[i])]]
            assert got == want


@pytest.mark.parametrize("N,M", [(2, 3), (3, 2)])
def test_appendix_b_composition_equals_direct(tmp_path, N, M):
    mesh = tri_mesh(4, 2, seed=3)
    store, _ = _save(tmp_path, mesh, N, Element("P", 1, "triangle"))
    loaded = FEMCheckpoint(store).load_mesh("m", Comm(M), partition="random",
                                            seed=5)
    direct = chi_to_LP([lp.loc_g for lp in loaded.plexes], loaded.E)
    assert loaded.chi_IT_LP.nroots == direct.nroots
    for a, b in zip(loaded.chi_IT_LP.root_rank, direct.root_rank):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(loaded.chi_IT_LP.root_idx, direct.root_idx):
        np.testing.assert_array_equal(a, b)
    starts = partition_starts(loaded.E, M)
    ident = [np.arange(starts[m], starts[m + 1], dtype=np.int64)
             for m in range(M)]
    for lp, g in zip(loaded.plexes, loaded.chi_IT_LP.bcast(ident)):
        np.testing.assert_array_equal(g, lp.loc_g)


CASES = [
    # (mesh maker, element, N, M, save part, load part)
    (lambda: interval_mesh(9, seed=1), Element("P", 4, "interval"), 2, 3,
     "contiguous", "random"),
    (lambda: interval_mesh(7, seed=2), Element("DP", 2, "interval"), 3, 2,
     "random", "contiguous"),
    (lambda: tri_mesh(3, 3, seed=4), Element("P", 4, "triangle"), 2, 3,
     "contiguous", "random"),
    (lambda: tri_mesh(3, 3, seed=4), Element("P", 2, "triangle"), 4, 2,
     "stripes", "random"),
    (lambda: tri_mesh(2, 4, seed=8), Element("DP", 1, "triangle"), 3, 4,
     "random", "contiguous"),
    (lambda: tri_mesh(4, 4, seed=9), Element("P", 3, "triangle"), 1, 5,
     "contiguous", "random"),
    (lambda: tri_mesh(4, 4, seed=9), Element("DP", 0, "triangle"), 5, 1,
     "random", "contiguous"),
]


@pytest.mark.parametrize("make_mesh,el,N,M,sp,lp_", CASES)
def test_function_n_to_m_roundtrip(tmp_path, make_mesh, el, N, M, sp, lp_):
    """The §6.1 protocol: every loaded DoF equals the analytic field at the
    loaded (cone-derived) node point, bit for bit, for any N -> M."""
    store, _ = _save(tmp_path, make_mesh(), N, el, part=sp, seed=13)
    comm = Comm(M)
    ck = FEMCheckpoint(store)
    loaded = ck.load_mesh("m", comm, partition=lp_, seed=17)
    spaces, funcs = ck.load_function(loaded, "f", comm)
    total_owned = 0
    for space, f in zip(spaces, funcs):
        np.testing.assert_array_equal(f.values, _field(node_points(space)))
        total_owned += space.ndof_owned
    D = store.get_attrs(f"{ck._section_key('m', spaces[0])}/meta")["D"]
    assert total_owned == D


def test_vector_valued_roundtrip(tmp_path):
    store, _ = _save(tmp_path, tri_mesh(3, 2, seed=5), 2,
                     Element("P", 2, "triangle"), bs=3)
    comm = Comm(3)
    ck = FEMCheckpoint(store)
    loaded = ck.load_mesh("m", comm, partition="random", seed=23)
    spaces, funcs = ck.load_function(loaded, "f", comm)
    for space, f in zip(spaces, funcs):
        want = np.stack([_field(node_points(space))] * 3, -1).reshape(-1)
        np.testing.assert_array_equal(f.values, want)


def test_timeseries_section_saved_once(tmp_path):
    """§2.2.7: one section, many DoF vectors."""
    el = Element("P", 3, "triangle")
    comm = Comm(2)
    plexes, _, _ = distribute(tri_mesh(2, 2, seed=6), 2)
    store = DatasetStore(str(tmp_path), "w")
    ck = FEMCheckpoint(store)
    ck.save_mesh("m", plexes, comm)
    spaces = [FunctionSpace(lp, el) for lp in plexes]
    for t in range(3):
        ck.save_function("m", "u", [Function(sp, _field(node_points(sp))
                                             + 100.0 * t) for sp in spaces],
                         comm, time_index=t)
    assert sum(1 for d in store.datasets() if d.endswith("/G")) == 2
    comm2 = Comm(3)
    loaded = ck.load_mesh("m", comm2, partition="random", seed=2)
    for t in range(3):
        spaces2, funcs2 = ck.load_function(loaded, "u", comm2, time_index=t)
        for sp2, f2 in zip(spaces2, funcs2):
            np.testing.assert_array_equal(
                f2.values, _field(node_points(sp2)) + 100.0 * t)


def test_labels_roundtrip(tmp_path):
    comm = Comm(2)
    plexes, _, _ = distribute(tri_mesh(3, 3, seed=10), 2)
    labels = {"dimlabel": [lp.dims.astype(np.int64) for lp in plexes]}
    store = DatasetStore(str(tmp_path), "w")
    ck = FEMCheckpoint(store)
    ck.save_mesh("m", plexes, comm, labels=labels)
    loaded = ck.load_mesh("m", Comm(4), partition="random", seed=3)
    for lp, lab in zip(loaded.plexes, loaded.labels["dimlabel"]):
        np.testing.assert_array_equal(lab, lp.dims)


def test_exact_distribution_reload(tmp_path):
    """Same-count fast path (§3.1): identical LocG, owners and cones."""
    store, plexes = _save(tmp_path, tri_mesh(3, 3, seed=12), 3,
                          Element("P", 2, "triangle"), part="random", seed=31)
    loaded = FEMCheckpoint(store).load_mesh("m", Comm(3),
                                            exact_distribution=True)
    for a, b in zip(plexes, loaded.plexes):
        np.testing.assert_array_equal(a.loc_g, b.loc_g)
        np.testing.assert_array_equal(a.owner, b.owner)
        for ca, cb in zip(a.cones, b.cones):
            np.testing.assert_array_equal(ca, cb)


def test_edge_orientation_permutation():
    np.testing.assert_array_equal(edge_node_permutation(3, 0), [0, 1, 2])
    np.testing.assert_array_equal(edge_node_permutation(3, 1), [2, 1, 0])


def test_triangle_orientation_group():
    el = Element("P", 4, "triangle")
    ref = (10, 11, 12)
    perms = set()
    for seq in itertools.permutations(ref):
        perm = triangle_interior_permutation(el, triangle_orientation(seq, ref))
        perms.add(tuple(perm))
        assert sorted(perm) == [0, 1, 2]
    assert len(perms) == 6


def test_triangle_orientation_node_consistency():
    el = Element("P", 4, "triangle")
    v = np.array([[0.0, 0.0], [1.0, 0.0], [0.3, 0.9]])
    ref_nodes = el.cell_nodes_tri(v)
    for seq in itertools.permutations(range(3)):
        o = triangle_orientation(tuple(10 + s for s in seq), (10, 11, 12))
        nodes = el.cell_nodes_tri(v[list(seq)])
        np.testing.assert_allclose(
            nodes, ref_nodes[triangle_interior_permutation(el, o)],
            atol=1e-14)


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_element_tables_equal_the_reference(degree):
    """The orientation permutations and reference nodes that land each DoF
    at its node on a reload equal the reference's, for every orientation."""
    for family in ("P", "DP"):
        el, rel = Element(family, degree, "triangle"), \
            ref_fem.Element(family, degree, "triangle")
        for seq in itertools.permutations((10, 11, 12)):
            o = triangle_orientation(seq, (10, 11, 12))
            assert o == ref_element.triangle_orientation(seq, (10, 11, 12))
            np.testing.assert_array_equal(
                triangle_interior_permutation(el, o),
                ref_element.triangle_interior_permutation(rel, o))
        v = np.array([[0.1, 0.0], [1.0, 0.2], [0.3, 0.9]])
        np.testing.assert_array_equal(el.cell_nodes_tri(v),
                                      rel.cell_nodes_tri(v))
    for o in (0, 1):
        np.testing.assert_array_equal(
            edge_node_permutation(degree + 1, o),
            ref_element.edge_node_permutation(degree + 1, o))


@settings(max_examples=12, deadline=None)
@given(
    nx=st.integers(2, 4), ny=st.integers(1, 3),
    n=st.integers(1, 4), m=st.integers(1, 4),
    degree=st.integers(1, 4), seed=st.integers(0, 100),
    family=st.sampled_from(["P", "DP"]),
)
def test_property_roundtrip_triangle(tmp_path_factory, nx, ny, n, m, degree,
                                     seed, family):
    tmp = tmp_path_factory.mktemp("prop")
    store, _ = _save(tmp, tri_mesh(nx, ny, seed=seed), n,
                     Element(family, degree, "triangle"), part="random",
                     seed=seed)
    comm = Comm(m)
    ck = FEMCheckpoint(store)
    loaded = ck.load_mesh("m", comm, partition="random", seed=seed + 1)
    spaces, funcs = ck.load_function(loaded, "f", comm)
    for space, f in zip(spaces, funcs):
        np.testing.assert_array_equal(f.values, _field(node_points(space)))


# ------------------------------------------------------------ golden store
def _golden_field(pts):
    x, y = pts[:, 0], pts[:, 1]
    return np.sin(3 * x) * (2 + np.cos(5 * y)) + x * y


@pytest.mark.parametrize("M,part", [(1, "contiguous"), (2, "random"),
                                    (3, "contiguous"), (5, "random")])
def test_golden_store_loads(M, part):
    """The port reads the reference's committed format fixture exactly."""
    store = DatasetStore(str(GOLDEN), "r")
    ck = FEMCheckpoint(store)
    comm = Comm(M)
    loaded = ck.load_mesh("m", comm, partition=part, seed=3)
    assert loaded.E == store.get_attrs("m/meta")["E"]
    for lp, lab in zip(loaded.plexes, loaded.labels["dimlabel"]):
        np.testing.assert_array_equal(lab, lp.dims)
    spaces, funcs = ck.load_function(loaded, "f", comm)
    for sp, f in zip(spaces, funcs):
        np.testing.assert_array_equal(f.values,
                                      _golden_field(node_points(sp)))
    spaces, funcs = ck.load_function(loaded, "v", comm)
    for sp, f in zip(spaces, funcs):
        g = _golden_field(node_points(sp))
        np.testing.assert_array_equal(f.values,
                                      np.stack([g, -2.0 * g], -1).reshape(-1))


def test_writer_reproduces_golden_bytes(tmp_path):
    """The port's writer, given the fixture's inputs, writes its bytes."""
    comm = Comm(3)
    plexes, _, _ = distribute(tri_mesh(3, 2, seed=4), 3, method="random",
                              seed=7)
    store = DatasetStore(str(tmp_path / "regen"), "w")
    ck = FEMCheckpoint(store)
    ck.save_mesh("m", plexes, comm,
                 labels={"dimlabel": [lp.dims.copy() for lp in plexes]})
    sp2 = [FunctionSpace(lp, Element("P", 2, "triangle")) for lp in plexes]
    ck.save_function("m", "f", [interpolate(s, _golden_field) for s in sp2],
                     comm)
    sp1 = [FunctionSpace(lp, Element("P", 1, "triangle"), bs=2)
           for lp in plexes]
    ck.save_function("m", "v", [interpolate(
        s, lambda p: np.stack([_golden_field(p), -2.0 * _golden_field(p)],
                              -1)) for s in sp1], comm)
    regen = pathlib.Path(store.root)
    for fname, want_sha in MANIFEST.items():
        if fname == "store.json":
            assert (json.loads((regen / fname).read_text())
                    == json.loads((GOLDEN / fname).read_text()))
            continue
        got = hashlib.sha256((regen / fname).read_bytes()).hexdigest()
        assert got == want_sha, f"dataset bytes changed: {fname}"


# ------------------------------------------------------------ IOStats pins
EXPECTED_WRITE_CALLS = 13
EXPECTED_READ_CALLS = 32
EXPECTED_MESH_READ_CALLS = 28
EXPECTED_PER_STEP_READ_CALLS = 4
M_LOAD = 5


def _pin_field(pts):
    return np.sin(3 * pts[:, 0]) * (2 + np.cos(5 * pts[:, 1]))


@pytest.mark.parametrize("R", (4, 16, 64))
def test_fe_roundtrip_store_calls_are_rank_independent(tmp_path, R):
    """One mesh and one P2 function saved from R ranks, loaded on M = 5:
    13 store writes and 32 reads at every R, as the reference pins."""
    plexes, _, _ = distribute(tri_mesh(10, 10), R)
    comm = Comm(R)
    store = DatasetStore(str(tmp_path), "w")
    ck = FEMCheckpoint(store)
    ck.save_mesh("m", plexes, comm)
    spaces = [FunctionSpace(lp, Element("P", 2, "triangle")) for lp in plexes]
    ck.save_function("m", "f", [interpolate(sp, _pin_field) for sp in spaces],
                     comm)
    writes, reads0 = store.stats.write_calls, store.stats.read_calls
    comm_l = Comm(M_LOAD)
    loaded = ck.load_mesh("m", comm_l, partition="random", seed=1)
    lspaces, lfuncs = ck.load_function(loaded, "f", comm_l)
    reads = store.stats.read_calls - reads0
    for sp, f in zip(lspaces, lfuncs):
        np.testing.assert_array_equal(f.values, _pin_field(node_points(sp)))
    store.close()
    assert (writes, reads) == (EXPECTED_WRITE_CALLS, EXPECTED_READ_CALLS)


@pytest.mark.parametrize("R", (4, 16))
def test_series_per_step_store_calls_are_rank_independent(tmp_path, R):
    """A 3-step series: step 0 pays the 13 writes, later steps one write
    (the mutated vec); the mesh loads in 28 reads, each step in 4."""
    plexes, _, _ = distribute(tri_mesh(10, 10), R)
    comm = Comm(R)
    store = DatasetStore(str(tmp_path), "w")
    ck = FEMCheckpoint(store)
    spaces = [FunctionSpace(lp, Element("P", 2, "triangle")) for lp in plexes]

    def field(k):
        return lambda p: np.sin(3 * p[:, 0] + k) * (2 + np.cos(5 * p[:, 1]))

    writes = []
    for k in range(3):
        w0 = store.stats.write_calls
        store.begin_step(k)
        ck.save_mesh("m", plexes, comm)
        ck.save_function("m", "f", [interpolate(sp, field(k))
                                     for sp in spaces], comm)
        store.commit_step()
        writes.append(store.stats.write_calls - w0)
    comm_l = Comm(M_LOAD)
    r0 = store.stats.read_calls
    loaded = ck.at_step(0).load_mesh("m", comm_l, partition="random", seed=1)
    mesh_reads = store.stats.read_calls - r0
    reads = []
    for k in range(3):
        r0 = store.stats.read_calls
        lsp, lfn = ck.at_step(k).load_function(loaded, "f", comm_l)
        reads.append(store.stats.read_calls - r0)
        for sp, f in zip(lsp, lfn):
            np.testing.assert_array_equal(f.values, field(k)(node_points(sp)))
    store.close()
    assert writes == [EXPECTED_WRITE_CALLS, 1, 1]
    assert mesh_reads == EXPECTED_MESH_READ_CALLS
    assert reads == [EXPECTED_PER_STEP_READ_CALLS] * 3


# ---------------------------------------------------- one format, both ways
def _write_fe_store(pkg, root, N, part, el_args, bs, async_=False):
    """Save ``tri_mesh(4, 3, seed=21)`` from N ranks with a label, and a
    function at time indices 0 and 1, through package ``pkg``'s engine."""
    F, Store, C = PACKAGES[pkg]
    plexes, _, _ = F.distribute(F.tri_mesh(4, 3, seed=21), N, method=part,
                                seed=5)
    labels = {"dimlabel": [lp.dims.astype(np.int64) for lp in plexes]}
    store = Store(str(root), "w")
    ck = F.FEMCheckpoint(store)
    spaces = [F.FunctionSpace(lp, F.Element(*el_args), bs=bs) for lp in plexes]
    series = [[F.interpolate(sp, lambda p, fn=fn: np.stack([fn(p)] * bs, -1)
                             if bs > 1 else fn(p)) for sp in spaces]
              for fn in (_field, _field2)]
    if async_:
        ac = (ref_async_io if pkg == "ref" else async_io).AsyncCheckpointer(
            ck, C(N))
        ac.save_mesh("m", plexes, labels=labels)
        for t, funcs in enumerate(series):
            ac.save_function("m", "f", funcs, time_index=t)
        ac.wait()
    else:
        ck.save_mesh("m", plexes, C(N), labels=labels)
        for t, funcs in enumerate(series):
            ck.save_function("m", "f", funcs, C(N), time_index=t)
    store.close()


def _files(root):
    return {p.name: p.read_bytes() for p in sorted(pathlib.Path(root).iterdir())}


STORE_CASES = [(1, "contiguous", ("P", 1, "triangle"), 1, False),
               (3, "random", ("P", 4, "triangle"), 1, False),
               (4, "stripes", ("DP", 2, "triangle"), 2, False),
               (2, "random", ("P", 2, "triangle"), 3, True),
               (5, "contiguous", ("P", 3, "triangle"), 1, True)]


@pytest.mark.parametrize("N,part,el_args,bs,async_", STORE_CASES)
def test_both_packages_write_identical_fe_stores(tmp_path, N, part, el_args,
                                                 bs, async_):
    """The same mesh, labels and functions saved by either package (sync,
    or through the async facade) give the same files, byte for byte."""
    _write_fe_store("ref", tmp_path / "ref", N, part, el_args, bs, async_)
    _write_fe_store("port", tmp_path / "port", N, part, el_args, bs, async_)
    ref, port = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(ref) == sorted(port)
    for name in ref:
        assert ref[name] == port[name], name


def _load_all(pkg, root, M):
    F, Store, C = PACKAGES[pkg]
    ck = F.FEMCheckpoint(Store(str(root), "r"))
    comm = C(M)
    loaded = ck.load_mesh("m", comm, partition="random", seed=M + 3)
    out = {"loc_g": [lp.loc_g for lp in loaded.plexes],
           "labels": loaded.labels["dimlabel"],
           "dims": [lp.dims for lp in loaded.plexes]}
    for t, fn in enumerate((_field, _field2)):
        spaces, funcs = ck.load_function(loaded, "f", comm, time_index=t)
        out[t] = [f.values for f in funcs]
        out[f"want{t}"] = [np.asarray(fn(F.node_points(sp))) for sp in spaces]
    ck.store.close()
    return out


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
@pytest.mark.parametrize("M", [1, 3])
def test_fe_store_loads_across_packages(tmp_path, writer, reader, M):
    """An FE store written by either package loads through the other: the
    same distribution, labels and DoF values as its own package loads,
    and every DoF equal to the field at its node, bit for bit."""
    _write_fe_store(writer, tmp_path, 3, "random", ("P", 3, "triangle"), 1,
                    async_=True)
    got, own = _load_all(reader, tmp_path, M), _load_all(writer, tmp_path, M)
    for key in ("loc_g", "labels", "dims", 0, 1):
        for a, b in zip(got[key], own[key]):
            np.testing.assert_array_equal(a, b, err_msg=str(key))
    for t in (0, 1):
        for v, want in zip(got[t], got[f"want{t}"]):
            np.testing.assert_array_equal(v, want)
        for lab, dims in zip(got["labels"], got["dims"]):
            np.testing.assert_array_equal(lab, dims)


# ----------------------------------------------------- the async FE facade
def test_fem_async_roundtrip_and_committed_steps(tmp_path):
    plexes, _, _ = distribute(tri_mesh(3, 2, seed=41), 2)
    store = DatasetStore(str(tmp_path), "w")
    fck = FEMCheckpoint(store)
    ac = AsyncCheckpointer(fck, Comm(2))
    assert ac.fem is fck
    spaces = [FunctionSpace(lp, Element("P", 2, "triangle")) for lp in plexes]
    ac.save_mesh("m", plexes)
    for t, fn in enumerate((_field, _field2)):
        ac.save_function("m", "f", [interpolate(sp, fn) for sp in spaces],
                         time_index=t)
    ac.wait()
    assert fck.steps("m", "f") == [0, 1]
    assert [e["kind"] for e in store.get_attrs(COMMIT_LOG_KEY)] == [
        "mesh", "func", "func"]
    loaded = fck.load_mesh("m", Comm(3))
    for t, fn in enumerate((_field, _field2)):
        lsp, lfn = fck.load_function(loaded, "f", Comm(3), time_index=t)
        for sp, f in zip(lsp, lfn):
            np.testing.assert_array_equal(f.values, fn(node_points(sp)))


def test_async_facade_over_a_bare_store_builds_the_port_fem(tmp_path):
    """Given a bare store, ``fem`` is built lazily from the port's own
    ``FEMCheckpoint``, never the reference's."""
    ac = AsyncCheckpointer(DatasetStore(str(tmp_path), "w"), Comm(1))
    assert type(ac.fem) is FEMCheckpoint
    assert type(ac.fem).__module__ == "repro_torch.fem.checkpoint"


class _SlowStore(DatasetStore):
    """Writes slowed enough that submitted jobs stay in flight."""

    def write_plan(self, name, starts, arrays):
        time.sleep(0.01)
        super().write_plan(name, starts, arrays)


def test_fem_snapshot_isolation_mid_flight(tmp_path):
    """Coordinates and DoF vectors mutated while the async saves are in
    flight: the checkpoint holds the values at the call, the live state
    keeps the mutation."""
    plexes, _, _ = distribute(tri_mesh(3, 2, seed=41), 2)
    store = _SlowStore(str(tmp_path), "w")
    fck = FEMCheckpoint(store)
    ac = AsyncCheckpointer(fck, Comm(2))
    spaces = [FunctionSpace(lp, Element("P", 1, "triangle")) for lp in plexes]
    funcs = [interpolate(sp, _field) for sp in spaces]
    ref_coords = [lp.vcoords.copy() for lp in plexes]
    ac.save_mesh("m", plexes)
    ac.save_function("m", "f", funcs, time_index=0)
    for lp in plexes:
        lp.vcoords[...] += 123.0
    for f in funcs:
        f.values[...] = -7.0
    ac.wait()
    for lp, rc in zip(plexes, ref_coords):
        np.testing.assert_array_equal(lp.vcoords, rc + 123.0)
    loaded = fck.load_mesh("m", Comm(3))
    lsp, lfn = fck.load_function(loaded, "f", Comm(3), time_index=0)
    for sp, f in zip(lsp, lfn):
        np.testing.assert_array_equal(f.values, _field(node_points(sp)))


def test_fem_steps_legacy_sync_store_without_log(tmp_path):
    plexes, _, _ = distribute(tri_mesh(3, 2, seed=41), 2)
    store = DatasetStore(str(tmp_path), "w")
    fck = FEMCheckpoint(store)
    comm = Comm(2)
    fck.save_mesh("m", plexes, comm)
    spaces = [FunctionSpace(lp, Element("P", 1, "triangle")) for lp in plexes]
    for t in (0, 2):
        fck.save_function("m", "f", [interpolate(sp, _field)
                                     for sp in spaces], comm, time_index=t)
    assert not store.has_attrs(COMMIT_LOG_KEY)
    assert fck.steps("m", "f") == [0, 2]
    fck.load_mesh("m", Comm(3))


FE_FIELDS = (_field, _field2)


def _run_fem_seq(root, n, plexes, kill_after):
    store = FaultStore(str(root), "w", kill_after_ops=kill_after)
    ac, crashed = None, False
    try:
        ac = AsyncCheckpointer(FEMCheckpoint(store), Comm(n))
        ac.save_mesh("m", plexes)
        spaces = [FunctionSpace(lp, Element("P", 2, "triangle"))
                  for lp in plexes]
        for t, fn in enumerate(FE_FIELDS):
            ac.save_function("m", "f", [interpolate(sp, fn) for sp in spaces],
                             time_index=t)
        ac.wait()
    except (SimulatedCrash, RuntimeError):
        crashed = True
    if ac is not None:
        try:
            ac.wait()
        except (SimulatedCrash, RuntimeError):
            pass
    store.close()
    return crashed, store.ops_seen


def _assert_fem_recoverable(root, n, m):
    store = DatasetStore(str(root), "r")
    try:
        fck = FEMCheckpoint(store)
        comm_m = Comm(m)
        if not store.has_attrs(COMMIT_LOG_KEY):
            with pytest.raises((ValueError, KeyError)):
                fck.load_mesh("m", comm_m)
            return
        log = store.get_attrs(COMMIT_LOG_KEY)
        if not any(e.get("kind") == "mesh" for e in log):
            with pytest.raises(ValueError, match="commit"):
                fck.load_mesh("m", comm_m)
            return
        loaded = fck.load_mesh("m", comm_m, partition="random",
                               seed=m + 100 * n)
        steps = fck.steps("m", "f")
        assert steps == list(range(len(steps)))
        if steps:
            last = steps[-1]
            lsp, lfn = fck.load_function(loaded, "f", comm_m, time_index=last)
            for sp, f in zip(lsp, lfn):
                np.testing.assert_array_equal(
                    f.values, FE_FIELDS[last](node_points(sp)))
        if len(steps) < len(FE_FIELDS):
            # the torn time index stays invisible
            with pytest.raises(ValueError, match="not committed"):
                fck.load_function(loaded, "f", comm_m, time_index=len(steps))
    finally:
        store.close()


@pytest.mark.parametrize("n,m", [(2, 3), (3, 2)])
def test_fem_crash_point_grid(tmp_path, n, m):
    """A mesh and two time indices through the port's async facade, the
    process killed at every mutating store op in turn: the committed prefix
    loads bit for bit on another rank count, a crash mid-``save_function``
    leaves that time index invisible."""
    plexes, _, _ = distribute(tri_mesh(3, 2, seed=41), n)
    crashed, total = _run_fem_seq(tmp_path / "probe", n, plexes, None)
    assert not crashed and total > 20
    for k in range(total):
        root = tmp_path / f"k{k}"
        crashed, _ = _run_fem_seq(root, n, plexes, k)
        assert crashed
        _assert_fem_recoverable(root, n, m)


# ---------------------------------------------------- the bridge to tensors
def _spaces_and_funcs(N, bs=1):
    plexes, _, _ = distribute(tri_mesh(4, 3, seed=2), N, method="random",
                              seed=3)
    spaces = [FunctionSpace(lp, Element("P", 3, "triangle"), bs=bs)
              for lp in plexes]
    return spaces, [interpolate(sp, lambda p: np.stack([_field(p)] * bs, -1)
                                if bs > 1 else _field(p)) for sp in spaces]


@pytest.mark.parametrize("N,bs", [(1, 1), (4, 1), (3, 2)])
def test_functions_round_trip_through_tensors(N, bs):
    """To tensors and back, bit for bit: one buffer for all ranks each way,
    dtype kept (float64)."""
    spaces, funcs = _spaces_and_funcs(N, bs)
    tensors = functions_to_device(funcs, "cpu")
    assert [t.dtype for t in tensors] == [torch.float64] * N
    assert len({t.untyped_storage().data_ptr() for t in tensors}) == 1
    for t, f in zip(tensors, funcs):
        np.testing.assert_array_equal(t.numpy(), f.values)
    back = functions_from_device(spaces, tensors)
    assert len({f.values.base is not None and id(f.values.base)
                for f in back}) == 1
    for b, f, sp in zip(back, funcs, spaces):
        assert b.space is sp
        np.testing.assert_array_equal(b.values, f.values)
    # the host copy is fresh: the tensors stay as they were
    back[0].values[...] = 0.0
    np.testing.assert_array_equal(tensors[0].numpy(), funcs[0].values)


def test_bridge_checks_its_arguments():
    spaces, funcs = _spaces_and_funcs(2)
    tensors = functions_to_device(funcs, "cpu")
    with pytest.raises(ValueError, match="spaces"):
        functions_from_device(spaces, tensors[:1])
    with pytest.raises(ValueError, match="local DoFs"):
        functions_from_device(spaces, [tensors[0], tensors[1][:-1]])
    assert functions_to_device([], "cpu") == []
    assert functions_from_device([], []) == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            functions_to_device(funcs)          # the card is the default


def test_fe_round_trip_through_tensors_n4_to_m1(tmp_path):
    """DoF vectors kept as tensors are saved from N = 4 through the async
    facade and loaded on M = 1 into a tensor, every DoF at its node."""
    spaces, funcs = _spaces_and_funcs(4)
    tensors = functions_to_device(funcs, "cpu")
    store = DatasetStore(str(tmp_path), "w")
    ac = AsyncCheckpointer(FEMCheckpoint(store), Comm(4))
    ac.save_mesh("m", [sp.plex for sp in spaces])
    ac.save_function("m", "f", functions_from_device(spaces, tensors),
                     time_index=0)
    ac.wait()
    ck = FEMCheckpoint(DatasetStore(str(tmp_path), "r"))
    loaded = ck.load_mesh("m", Comm(1))
    lspaces, lfuncs = ck.load_function(loaded, "f", Comm(1), time_index=0)
    (got,) = functions_to_device(lfuncs, "cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  _field(node_points(lspaces[0])))

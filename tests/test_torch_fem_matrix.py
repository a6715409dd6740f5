"""The N-to-M matrix of ``tests/test_fem_matrix.py`` on the port's FE engine.

Saves on N ranks and loads on M ranks over the whole grid N, M in
{1, 2, 3, 4, 7, 8} x {contiguous, random} partitions (70 cases, one
parametrised case each), bit for bit, for a scalar P1 space, a scalar P2
space and a vector-valued (bs=3) P1 space sharing one store.  Every case
also loads the port's store through the reference engine, which must place
the same values on the same distribution.
"""

import numpy as np
import pytest

from repro.core.comm import Comm as RefComm
from repro.core.store import DatasetStore as RefStore
from repro.fem import FEMCheckpoint as RefFEMCheckpoint
from repro_torch.core.comm import Comm
from repro_torch.core.store import DatasetStore
from repro_torch.fem import (
    Element, FEMCheckpoint, FunctionSpace, distribute, interpolate,
    node_points, tri_mesh,
)

RANKS = (1, 2, 3, 4, 7, 8)
PARTS = ("contiguous", "random")
GRID = [(n, m, part) for n in RANKS for m in RANKS for part in PARTS
        if (n, m) != (1, 1)]


def _field(pts):
    x, y = pts[:, 0], pts[:, 1]
    return np.sin(3 * x) * (2 + np.cos(5 * y)) + x * y


def _vec_field(pts):
    f = _field(pts)
    return np.stack([f, 2.0 * f, f * f], -1)


_SPACES = [
    ("p1", Element("P", 1, "triangle"), 1, _field),
    ("p2", Element("P", 2, "triangle"), 1, _field),
    ("p1v", Element("P", 1, "triangle"), 3, _vec_field),
]


@pytest.mark.parametrize("n,m,part", GRID)
def test_n_to_m_matrix(tmp_path, n, m, part):
    mesh = tri_mesh(3, 2, seed=41)
    comm_n = Comm(n)
    plexes, _, _ = distribute(mesh, n, method=part, seed=n + 10 * m)
    store = DatasetStore(str(tmp_path), "w")
    ck = FEMCheckpoint(store)
    ck.save_mesh("m", plexes, comm_n)
    for name, el, bs, fn in _SPACES:
        spaces = [FunctionSpace(lp, el, bs=bs) for lp in plexes]
        ck.save_function("m", name, [interpolate(sp, fn) for sp in spaces],
                         comm_n)

    comm_m = Comm(m)
    loaded = ck.load_mesh("m", comm_m, partition=part, seed=m + 100 * n)
    rck = RefFEMCheckpoint(RefStore(str(tmp_path), "r"))
    rloaded = rck.load_mesh("m", RefComm(m), partition=part, seed=m + 100 * n)
    assert loaded.E == rloaded.E == mesh.num_entities
    for lp, rlp in zip(loaded.plexes, rloaded.plexes):
        np.testing.assert_array_equal(lp.loc_g, rlp.loc_g)
    for name, el, bs, fn in _SPACES:
        spaces, funcs = ck.load_function(loaded, name, comm_m)
        _, rfuncs = rck.load_function(rloaded, name, RefComm(m))
        total_owned = 0
        for sp, f, rf in zip(spaces, funcs, rfuncs):
            want = np.asarray(fn(node_points(sp)))
            if want.ndim == 1:
                want = want[:, None]
            # bit-exact: identical IEEE values, not merely close
            np.testing.assert_array_equal(f.values, want.reshape(-1))
            np.testing.assert_array_equal(rf.values, f.values)
            total_owned += sp.ndof_owned
        D = store.get_attrs(f"{ck._section_key('m', spaces[0])}/meta")["D"]
        assert total_owned == D

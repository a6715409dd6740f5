"""Star forests (PetscSF analogue) — the communication-pattern algebra of the paper.

A star forest maps *leaves* to *roots*, where both live in "union sets" of the form
``U = ∪_r {r} × {0..n_r-1}`` (a local index space per rank).  A leaf may be attached
to at most one root; a root may have many leaves.  This mirrors PetscSF exactly
[Zhang et al., IEEE TPDS 2022]; the key operations are

  * ``bcast``   — copy root data to every attached leaf          (PetscSFBcast)
  * ``reduce``  — combine leaf data into roots                   (PetscSFReduce)
  * ``compose`` — ``C = compose(A, B)``: leaves of A → roots of B, where A's root
                  space is B's leaf space                        (PetscSFCompose)
  * ``invert``  — swap roots/leaves for a bijective SF

All per-rank state is held in plain numpy arrays; "communication" is performed
through a :class:`~repro_torch.core.comm.Comm` object so that the identical rank-local
code runs under the in-process simulator (tests) or a real multi-host runtime.

Every SF carries a precomputed :class:`SFPlan` — the analogue of PetscSF's
packed message plans [Zhang et al., IEEE TPDS 2022]: flattened gather indices
into the concatenated root space, the scatter permutation into the
concatenated leaf space, CSR rank offsets, and the sparse list of nonempty
(leaf rank, root rank) pairs.  ``bcast``/``reduce`` are then a concatenate,
one fancy-indexed gather/scatter, and a split — no per-rank-pair Python
loops, so simulated rank counts of 64+ stay cheap.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.comm import split_segments

_INT = np.int64


@dataclasses.dataclass(frozen=True)
class SFPlan:
    """Packed communication plan for one star forest.

    The root and leaf union sets are flattened rank-major:
    ``root_offsets[r]`` is the position of root ``(r, 0)`` in the
    concatenated root space (likewise ``leaf_offsets``).  One entry per
    *attached* leaf, in leaf-rank-major, leaf-index order:

      * ``gather[e]``  — flattened root position feeding that leaf
      * ``scatter[e]`` — flattened leaf position receiving it

    ``pair_*`` enumerate the nonempty (root rank → leaf rank) pairs with
    their edge counts — the neighborhood the equivalent MPI exchange would
    touch, exposed for sparse collectives and traffic accounting.  They are
    derived lazily from ``gather``/``scatter`` on first access: ``bcast``/
    ``reduce`` never consult them, and the derivation costs a full sort of
    the attachment set — waste that dominated plan compilation at
    paper-scale leaf counts (tens of millions of element-level edges).
    """

    root_offsets: np.ndarray       # (R_root + 1,)
    leaf_offsets: np.ndarray       # (R_leaf + 1,)
    gather: np.ndarray             # (n_attached,)
    scatter: np.ndarray            # (n_attached,)

    @property
    def n_attached(self) -> int:
        return len(self.gather)

    def _pairs(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        cached = getattr(self, "_pair_cache", None)
        if cached is None:
            rr_att = np.searchsorted(self.root_offsets, self.gather,
                                     side="right") - 1
            leaf_rank = np.searchsorted(self.leaf_offsets, self.scatter,
                                        side="right") - 1
            n_leaf = max(len(self.leaf_offsets) - 1, 1)
            pair_key, pair_cnt = np.unique(
                rr_att * n_leaf + leaf_rank, return_counts=True)
            cached = ((pair_key // n_leaf).astype(_INT),
                      (pair_key % n_leaf).astype(_INT),
                      pair_cnt.astype(_INT))
            object.__setattr__(self, "_pair_cache", cached)
        return cached

    @property
    def pair_src(self) -> np.ndarray:
        return self._pairs()[0]

    @property
    def pair_dst(self) -> np.ndarray:
        return self._pairs()[1]

    @property
    def pair_cnt(self) -> np.ndarray:
        return self._pairs()[2]

    def split_leafwise(self, flat: np.ndarray) -> list[np.ndarray]:
        """Cut a concatenated-leaf-space array back into per-rank views."""
        return [flat[a:b] for a, b in zip(self.leaf_offsets[:-1],
                                          self.leaf_offsets[1:])]


@dataclasses.dataclass(frozen=True)
class StarForest:
    """A star forest over union sets.

    Per rank ``r`` there are ``nleaves[r]`` leaves and ``nroots[r]`` roots.
    ``root_rank[r][i]`` / ``root_idx[r][i]`` give the root attached to leaf
    ``(r, i)`` (or ``-1`` if the leaf is unattached).
    """

    nroots: tuple[int, ...]
    root_rank: tuple[np.ndarray, ...]
    root_idx: tuple[np.ndarray, ...]

    # ------------------------------------------------------------------ basics
    @property
    def nranks_root(self) -> int:
        """Rank count on the root side.  The paper's maps are all *square*
        (I_T, I_P, L_P all live on the M loading ranks), but the in-memory
        N→M resharder builds rectangular SFs between different communicators,
        so leaf- and root-side rank counts are tracked independently."""
        return len(self.nroots)

    @property
    def nranks_leaf(self) -> int:
        return len(self.root_rank)

    @property
    def nranks(self) -> int:
        if self.nranks_root != self.nranks_leaf:
            raise ValueError(f"square SF expected, got {self.nranks_root} "
                             f"root ranks / {self.nranks_leaf} leaf ranks")
        return self.nranks_root

    @property
    def nleaves(self) -> tuple[int, ...]:
        return tuple(len(a) for a in self.root_rank)

    def __post_init__(self):
        if len(self.root_rank) != len(self.root_idx):
            raise ValueError(f"{len(self.root_rank)} root_rank arrays for "
                             f"{len(self.root_idx)} root_idx arrays")
        for rr, ri in zip(self.root_rank, self.root_idx):
            if rr.shape != ri.shape:
                raise ValueError(f"attachment arrays disagree: root_rank "
                                 f"{rr.shape} != root_idx {ri.shape}")
        nleaves = np.array([len(a) for a in self.root_rank], dtype=_INT)
        rr_all = (np.concatenate(self.root_rank) if self.nranks_leaf
                  else np.empty(0, _INT)).astype(_INT, copy=False)
        ri_all = (np.concatenate(self.root_idx) if self.nranks_leaf
                  else np.empty(0, _INT)).astype(_INT, copy=False)
        self._compile(rr_all, ri_all, nleaves)

    def _compile(self, rr_all: np.ndarray, ri_all: np.ndarray,
                 nleaves: np.ndarray) -> None:
        """Compile the packed communication plan (PetscSFSetUp analogue)
        from the concatenated leaf-major attachment buffers."""
        leaf_offsets = np.concatenate([[0], np.cumsum(nleaves)])
        root_sizes = np.asarray(self.nroots, dtype=_INT)
        root_offsets = np.concatenate([[0], np.cumsum(root_sizes)])
        scatter = np.flatnonzero(rr_all >= 0).astype(_INT)
        if len(scatter) == len(rr_all):
            rr_att, ri_att = rr_all, ri_all    # fully attached: no gather
        else:
            rr_att, ri_att = rr_all[scatter], ri_all[scatter]
        if rr_att.size and rr_att.max() >= self.nranks_root:
            raise ValueError(f"attachment root rank {int(rr_att.max())} out "
                             f"of range for {self.nranks_root} root ranks")
        if rr_att.size and not ((ri_att >= 0).all()
                                and (ri_att < root_sizes[rr_att]).all()):
            raise ValueError("attachment root index out of range for its "
                             "root rank's local space")
        gather = root_offsets[rr_att] + ri_att
        plan = SFPlan(
            root_offsets=root_offsets,
            leaf_offsets=leaf_offsets,
            gather=gather,
            scatter=scatter,
        )
        object.__setattr__(self, "plan", plan)

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_flat_attachments(cls, nroots: Sequence[int],
                              leaf_sizes: Sequence[int] | np.ndarray,
                              rr_flat: np.ndarray, ri_flat: np.ndarray
                              ) -> "StarForest":
        """Construct directly from the concatenated (leaf-rank-major)
        attachment buffers: the per-rank arrays are disjoint views and the
        plan compile consumes the flat buffers as-is — no per-rank
        round-trip and no re-concatenation copy, which matters at
        element-level leaf counts (tens of millions)."""
        leaf_sizes = np.asarray(leaf_sizes, dtype=_INT)
        rr_flat = np.asarray(rr_flat, dtype=_INT)
        ri_flat = np.asarray(ri_flat, dtype=_INT)
        self = object.__new__(cls)
        object.__setattr__(self, "nroots", tuple(int(s) for s in nroots))
        object.__setattr__(self, "root_rank",
                           tuple(split_segments(rr_flat, leaf_sizes)))
        object.__setattr__(self, "root_idx",
                           tuple(split_segments(ri_flat, leaf_sizes)))
        self._compile(rr_flat, ri_flat, leaf_sizes)
        return self

    @staticmethod
    def from_edges(
        nranks: int,
        nroots: Sequence[int],
        nleaves: Sequence[int],
        edges: Sequence[tuple[tuple[int, int], tuple[int, int]]],
    ) -> "StarForest":
        """Build from explicit ((leaf_rank, leaf_idx), (root_rank, root_idx)) edges."""
        rr = [np.full(nl, -1, dtype=_INT) for nl in nleaves]
        ri = [np.full(nl, -1, dtype=_INT) for nl in nleaves]
        for (lr, li), (rtr, rti) in edges:
            rr[lr][li] = rtr
            ri[lr][li] = rti
        return StarForest(tuple(nroots), tuple(rr), tuple(ri))

    @staticmethod
    def from_partition(total: int, nranks_root: int, nranks_leaf: int) -> "StarForest":
        """The canonical partition map χ (paper eq. 2.6 / 2.15) as a bijective SF.

        The global index space ``{0..total-1}`` is split into near-equal
        *contiguous* chunks on both sides; the SF maps leaf-side positions to
        root-side positions of the same global index.  With matching rank
        counts this is the identity.
        """
        leaf_sizes = partition_sizes(total, nranks_leaf)
        root_sizes = partition_sizes(total, nranks_root)
        root_starts = np.concatenate([[0], np.cumsum(root_sizes)])
        rr, ri = [], []
        off = 0
        for nl in leaf_sizes:
            g = np.arange(off, off + nl, dtype=_INT)
            r = np.searchsorted(root_starts, g, side="right") - 1
            rr.append(r.astype(_INT))
            ri.append(g - root_starts[r])
            off += nl
        return StarForest(tuple(int(s) for s in root_sizes), tuple(rr), tuple(ri))

    @staticmethod
    def from_flat_global_numbers(
        flat_globals: np.ndarray, leaf_sizes: Sequence[int] | np.ndarray,
        total: int, nranks_root: int
    ) -> "StarForest":
        """SF from the *concatenated* (leaf-rank-major) LocG array plus the
        per-rank leaf counts — the flat fast path of the load-side engine.
        One searchsorted over the whole concatenation resolves every leaf's
        canonical root; the per-rank arrays are disjoint views of the two
        flat attachment buffers, so no per-rank array work is done at any
        rank count."""
        flat_globals = np.asarray(flat_globals, dtype=_INT)
        leaf_sizes = np.asarray(leaf_sizes, dtype=_INT)
        if int(leaf_sizes.sum()) != len(flat_globals):
            raise ValueError(f"leaf_sizes sum to {int(leaf_sizes.sum())} "
                             f"but flat_globals has {len(flat_globals)} ids")
        root_sizes = partition_sizes(total, nranks_root)
        starts = np.concatenate([[0], np.cumsum(root_sizes)])
        rr_flat = (np.searchsorted(starts, flat_globals, side="right") - 1
                   ).astype(_INT)
        ri_flat = flat_globals - starts[rr_flat]
        return StarForest.from_flat_attachments(
            [int(s) for s in root_sizes], leaf_sizes, rr_flat, ri_flat)

    @staticmethod
    def from_global_numbers(
        leaf_globals: Sequence[np.ndarray], total: int, nranks_root: int
    ) -> "StarForest":
        """SF whose leaf ``(r, i)`` attaches to the canonical-partition root that
        owns global number ``leaf_globals[r][i]`` (paper: constructing χ_{I_T}^{L_P}
        and χ_{I_P}^{L_P} from LocG arrays)."""
        sizes = [len(g) for g in leaf_globals]
        flat = (np.concatenate([np.asarray(g, dtype=_INT)
                                for g in leaf_globals])
                if leaf_globals else np.empty(0, _INT))
        return StarForest.from_flat_global_numbers(flat, sizes, total,
                                                   nranks_root)

    @staticmethod
    def from_sorted_global_numbers(
        leaf_globals: Sequence[np.ndarray], total: int, nranks_root: int
    ) -> "StarForest":
        """:meth:`from_global_numbers` for *presorted* per-rank id arrays
        (ascending) — closure ids, ownership candidates, and directory
        publishes are all sorted sets on the load path.  Shares the flat
        one-pass engine; the ascending precondition is checked once over the
        concatenation (segment boundaries excluded)."""
        sizes = np.asarray([len(g) for g in leaf_globals], dtype=_INT)
        flat = (np.concatenate([np.asarray(g, dtype=_INT)
                                for g in leaf_globals])
                if leaf_globals else np.empty(0, _INT))
        if len(flat) > 1:
            interior = np.ones(len(flat) - 1, dtype=bool)
            bounds = np.cumsum(sizes)[:-1]
            interior[bounds[(bounds > 0) & (bounds < len(flat))] - 1] = False
            if not (np.diff(flat)[interior] >= 0).all():
                raise ValueError(
                    "from_sorted_global_numbers: ids must be ascending "
                    "within each rank's segment")
        return StarForest.from_flat_global_numbers(flat, sizes, total,
                                                   nranks_root)

    # ------------------------------------------------------------- operations
    def bcast(self, root_data: "Sequence[np.ndarray] | np.ndarray",
              fill=0, return_flat: bool = False):
        """Copy root values to attached leaves (PetscSFBcast).

        ``root_data[r]`` has leading dim ``nroots[r]``; returns per-rank leaf
        arrays (unattached leaves hold ``fill``, zero by default).  One
        gather through the precomputed plan; the per-rank outputs are
        disjoint views of a single concatenated-leaf-space buffer.

        ``root_data`` may also be a single ndarray — the root-rank-major
        concatenation a flat caller already holds — skipping the per-rank
        concatenate copy.  With ``return_flat`` the leaf buffer is returned
        directly (leaf-rank-major; segment bounds are ``plan.leaf_offsets``)
        so flat pipelines skip the per-rank split too.
        """
        plan: SFPlan = self.plan
        if isinstance(root_data, np.ndarray):
            flat_in = root_data
            # -O-proof: a stale/foreign buffer would silently gather from
            # the wrong prefix
            if len(flat_in) != int(plan.root_offsets[-1]):
                raise ValueError(
                    f"bcast: flat root buffer has {len(flat_in)} rows, "
                    f"root space holds {int(plan.root_offsets[-1])}")
            trailing, dtype = flat_in.shape[1:], flat_in.dtype
        else:
            if len(root_data) != self.nranks_root:
                raise ValueError(f"bcast: {len(root_data)} per-rank root "
                                 f"buffers for {self.nranks_root} root ranks")
            flat_in = None
            trailing, dtype = root_data[0].shape[1:], root_data[0].dtype
        nleaf_flat = int(plan.leaf_offsets[-1])

        def _flat_root():
            if flat_in is not None:
                return flat_in
            return np.concatenate(
                [np.asarray(a).reshape((len(a),) + trailing)
                 for a in root_data])

        if plan.n_attached == nleaf_flat and nleaf_flat:
            # fully attached: scatter is the identity — ONE fancy gather,
            # no fill pass (the element-level vec broadcast hot path)
            out_flat = _flat_root()[plan.gather]
            if out_flat.dtype != dtype:     # heterogeneous roots: match the
                out_flat = out_flat.astype(dtype)  # fill-path buffer dtype
        else:
            out_flat = np.full((nleaf_flat,) + trailing, fill, dtype=dtype)
            if plan.n_attached:
                out_flat[plan.scatter] = _flat_root()[plan.gather]
        if return_flat:
            return out_flat
        return plan.split_leafwise(out_flat)

    def reduce(
        self,
        leaf_data: "Sequence[np.ndarray] | np.ndarray",
        op: str = "replace",
        root_data: Sequence[np.ndarray] | None = None,
        trailing: tuple[int, ...] = (),
        dtype=None,
        fill=None,
        return_flat: bool = False,
    ):
        """Combine leaf values into roots (PetscSFReduce). op ∈ {replace,sum,min,max}.

        Runs as one scatter through the plan: attached leaf values are
        gathered leaf-rank-major (so duplicate-root resolution order matches
        the rank-sequential reference semantics — later ranks win under
        ``replace``) and combined into the concatenated root space in one
        ``ufunc.at``/assignment.  Provided ``root_data`` arrays are updated
        in place and returned.  Without ``root_data``, the roots are
        initialised flat to ``fill`` (the op's identity by default) and the
        per-rank results come back as disjoint views of one concatenated
        buffer — no per-rank allocation at any rank count; ``return_flat``
        hands back that buffer itself.  ``leaf_data`` may be the flat
        leaf-rank-major concatenation (one ndarray), skipping the
        concatenate copy.
        """
        leaf_is_flat = isinstance(leaf_data, np.ndarray)
        dtype = dtype or (leaf_data.dtype if leaf_is_flat
                          else leaf_data[0].dtype)
        plan: SFPlan = self.plan
        if leaf_is_flat and len(leaf_data) != int(plan.leaf_offsets[-1]):
            # -O-proof, mirroring bcast: a stale/foreign buffer would
            # silently combine the wrong leaf values into the roots
            raise ValueError(
                f"reduce: flat leaf buffer has {len(leaf_data)} rows, "
                f"leaf space holds {int(plan.leaf_offsets[-1])}")

        def _flat_leaf(trail):
            if leaf_is_flat:
                return leaf_data
            return np.concatenate(
                [np.asarray(a).reshape((len(a),) + trail)
                 for a in leaf_data])

        if root_data is None:
            if fill is None:
                fill = {"sum": 0, "replace": 0,
                        "min": np.iinfo(_INT).max
                        if np.issubdtype(dtype, np.integer) else np.inf,
                        "max": np.iinfo(_INT).min
                        if np.issubdtype(dtype, np.integer) else -np.inf}[op]
            flat_root = np.full((int(plan.root_offsets[-1]),) + trailing,
                                fill, dtype=dtype)
            if plan.n_attached:
                self._combine(flat_root, _flat_leaf(trailing)[plan.scatter],
                              op)
            if return_flat:
                return flat_root
            return [flat_root[a:b] for a, b in
                    zip(plan.root_offsets[:-1], plan.root_offsets[1:])]
        root_data = list(root_data)
        if not plan.n_attached:
            return root_data
        trail = root_data[0].shape[1:]
        vals = _flat_leaf(trail)[plan.scatter]
        flat_root = np.concatenate(
            [np.asarray(a).reshape((len(a),) + trail) for a in root_data])
        self._combine(flat_root, vals, op)
        for r, (a, b) in enumerate(zip(plan.root_offsets[:-1],
                                       plan.root_offsets[1:])):
            np.copyto(root_data[r], flat_root[a:b].reshape(root_data[r].shape))
        return root_data

    def _combine(self, flat_root: np.ndarray, vals: np.ndarray,
                 op: str) -> None:
        plan: SFPlan = self.plan
        if op == "replace":
            # numpy fancy assignment applies in index order: the last
            # occurrence (highest leaf rank / index) wins, as in the
            # rank-sequential reference loop
            flat_root[plan.gather] = vals
        elif op == "sum":
            np.add.at(flat_root, plan.gather, vals)
        elif op == "min":
            np.minimum.at(flat_root, plan.gather, vals)
        elif op == "max":
            np.maximum.at(flat_root, plan.gather, vals)
        else:
            raise ValueError(op)

    def compose(self, other: "StarForest") -> "StarForest":
        """``self``: L_A → R_A; ``other``: L_B(=R_A) → R_B.  Result: L_A → R_B.

        (PetscSFCompose.)  Implemented as a bcast of ``other``'s attachment
        arrays through ``self`` — which is exactly how it is done distributed.
        """
        if self.nroots != other.nleaves:
            raise ValueError(
                f"compose: root space {self.nroots} != other's leaf space "
                f"{other.nleaves}")
        # leaves unattached in self stay unattached: bcast fills them with -1
        # directly, so no per-rank masking pass is needed afterwards; the
        # flat buffers feed the plan compile without a re-concatenation
        new_rr = self.bcast([a for a in other.root_rank], fill=-1,
                            return_flat=True)
        new_ri = self.bcast([a for a in other.root_idx], fill=-1,
                            return_flat=True)
        return StarForest.from_flat_attachments(
            other.nroots, np.asarray(self.nleaves, dtype=_INT),
            new_rr, new_ri)

    def invert(self, allow_partial: bool = False) -> "StarForest":
        """Invert an injective SF (paper: (χ_{I_P}^{L_P})⁻¹).

        Every root must have at most one attached leaf.  With
        ``allow_partial`` (the shrunk-section case of §2.2.2, where entities
        with no DoFs have no section row), roots with no leaf invert to
        unattached leaves; composing through them leaves targets unattached,
        which downstream bcasts zero-fill — exactly the "no DoFs here"
        semantics.  Implemented with a reduce of the leaf identities onto the
        roots, as PetscSF does.
        """
        nl = np.asarray(self.nleaves, dtype=_INT)
        total_l = int(nl.sum())
        offs = np.concatenate([[0], np.cumsum(nl)]).astype(_INT)
        leaf_rank_flat = np.repeat(np.arange(self.nranks_leaf, dtype=_INT),
                                   nl)
        leaf_idx_flat = np.arange(total_l, dtype=_INT) - np.repeat(offs[:-1],
                                                                   nl)
        inv_rr = self.reduce(leaf_rank_flat, "replace", dtype=_INT,
                             fill=-1, return_flat=True)
        inv_ri = self.reduce(leaf_idx_flat, "replace", dtype=_INT,
                             fill=-1, return_flat=True)
        if not allow_partial and not (inv_rr >= 0).all():
            # -O-proof: unattached inverse leaves would silently bcast fill
            # values downstream
            raise ValueError(
                f"invert: SF not surjective — "
                f"{int((inv_rr < 0).sum())} of {len(inv_rr)} roots have no "
                "leaf (pass allow_partial=True for shrunk sections)")
        return StarForest.from_flat_attachments(
            self.nleaves, np.asarray(self.nroots, dtype=_INT),
            inv_rr, inv_ri)


def partition_sizes(total: int, nranks: int) -> np.ndarray:
    """Near-equal contiguous partition sizes (differ by at most one) — the
    paper's partition formula (eq. 2.6): rank m owns [m*total//M, (m+1)*total//M)."""
    m = np.arange(nranks + 1, dtype=_INT)
    bounds = m * total // nranks
    return np.diff(bounds)


def partition_starts(total: int, nranks: int) -> np.ndarray:
    m = np.arange(nranks + 1, dtype=_INT)
    return m * total // nranks


def partition_segments(total: int, nranks: int) -> tuple[list[int], list[int]]:
    """The canonical partition as ``(starts, counts)`` lists — the per-rank
    segment shape :meth:`DatasetStore.write_plan`/``read_plan`` consume."""
    starts = partition_starts(total, nranks)
    return ([int(s) for s in starts[:nranks]],
            [int(starts[r + 1] - starts[r]) for r in range(nranks)])


def partition_rank_of(global_idx: np.ndarray, total: int, nranks: int) -> np.ndarray:
    """Which rank owns each global index under the canonical partition."""
    starts = partition_starts(total, nranks)
    return (np.searchsorted(starts, np.asarray(global_idx, dtype=_INT), side="right") - 1).astype(_INT)

"""Fault injection over the port's store, for its crash-consistency tests.

``FaultStore`` wraps :class:`repro_torch.core.store.DatasetStore` as
``tests/helpers/faultstore.py`` wraps the reference's: the first
``kill_after_ops`` mutating store operations complete normally, the next
one dies before touching disk (or, with ``tear=True`` on data writes,
midway through), and every op after that dies at once: the process is
gone.  ``ops_seen`` counts the completed ones.  Every completed op is on
disk, so a fresh ``DatasetStore(root, "r")`` sees what a new process
would after a real kill at that point.

``SimulatedCrash`` derives from ``BaseException`` so no engine
``except Exception`` path swallows the "process died" event.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.store import DatasetStore


class SimulatedCrash(BaseException):
    """The simulated process death (never catch this outside a test)."""


class FaultStore(DatasetStore):
    mutating_ops = ("create", "write_rows", "write_plan", "write_rows_at",
                    "set_attrs", "commit_step")

    def __init__(self, root: str, mode: str = "w", *,
                 kill_after_ops: int | None = None, tear: bool = False, **kw):
        super().__init__(root, mode, **kw)
        self.kill_after_ops = kill_after_ops
        self.tear = tear
        self.ops_seen = 0          # mutating ops that completed
        self.dead = False

    def _fatal(self) -> bool:
        """Count the current op; True iff it is the one that kills (every
        op after the kill dies at once)."""
        if self.dead:
            self._die()
        if (self.kill_after_ops is not None
                and self.ops_seen >= self.kill_after_ops):
            self.dead = True
            return True
        self.ops_seen += 1
        return False

    def _die(self):
        raise SimulatedCrash(f"simulated process death at mutating store "
                             f"op {self.ops_seen}")

    def create(self, name, rows, row_shape=(), dtype="float64"):
        if self._fatal():
            self._die()
        super().create(name, rows, row_shape, dtype)

    def set_attrs(self, key, value):
        if self._fatal():
            self._die()
        super().set_attrs(key, value)

    def commit_step(self):
        # the series commit is ONE atomic flush: dying here leaves the step
        # out of the manifest, invisible as a whole
        if self._fatal():
            self._die()
        super().commit_step()

    def write_rows(self, name, start, data):
        if self._fatal():
            if self.tear:
                data = np.asarray(data)
                super().write_rows(name, start, data[:len(data) // 2])
            self._die()
        super().write_rows(name, start, data)

    def write_plan(self, name, starts, arrays):
        if self._fatal():
            if self.tear:
                torn = [np.asarray(a)[:max(0, len(a) // 2)] for a in arrays]
                super().write_plan(name, [int(s) for s in starts], torn)
            self._die()
        super().write_plan(name, starts, arrays)

    def write_rows_at(self, name, row_idx, data):
        if self._fatal():
            if self.tear:
                row_idx, data = np.asarray(row_idx), np.asarray(data)
                half = len(row_idx) // 2
                super().write_rows_at(name, row_idx[:half], data[:half])
            self._die()
        super().write_rows_at(name, row_idx, data)

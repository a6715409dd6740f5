"""DoF vectors on the card, checkpointed through the unchanged FE engine.

A GPU finite-element code keeps each rank's local DoF vector (owned and
ghost values, in the space's cone-derived order) as a tensor on the card.
The engine's save and load paths work on host ``Function``s, so this
bridge moves every rank's vector across in one copy each way: ranks are
concatenated on the side the data starts on and split into views on the
other.  It computes nothing itself; the owned-DoF gather of a save stays
the engine's host code (``FEMCheckpoint.save_function``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fem.function import Function
from repro_torch.fem.section import FunctionSpace


def functions_to_device(funcs: list[Function], device="cuda"
                        ) -> list[torch.Tensor]:
    """Every rank's ``Function.values`` as a tensor on ``device`` (the card
    unless the caller asks for the CPU), one host-to-device copy for all
    ranks; the tensors are views of one device buffer, dtype kept."""
    dev = resolve_device(device)
    if not funcs:
        return []
    sizes = [int(f.values.size) for f in funcs]
    host = np.concatenate([np.ascontiguousarray(f.values).reshape(-1)
                           for f in funcs])
    return list(torch.from_numpy(host).to(dev).split(sizes))


def functions_from_device(spaces: list[FunctionSpace],
                          values: list[torch.Tensor]) -> list[Function]:
    """One ``Function`` per rank from per-rank tensors of ``ndof_local``
    values each (on any device), one device-to-host copy for all ranks; the
    functions' values are views of one fresh host array."""
    if len(spaces) != len(values):
        raise ValueError(f"{len(spaces)} spaces but {len(values)} value "
                         f"tensors")
    if not values:
        return []
    host = torch.cat([v.reshape(-1) for v in values]).cpu().numpy()
    bounds = np.cumsum([0] + [int(v.numel()) for v in values])
    return [Function(sp, host[a:b])
            for sp, a, b in zip(spaces, bounds[:-1], bounds[1:])]

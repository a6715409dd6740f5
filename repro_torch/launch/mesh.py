"""Process groups and device meshes, the counterpart of the JAX package's
``launch/mesh.py``.

One ``torch.distributed`` process per device of the mesh: gloo on the CPU,
NCCL on the card (with gloo beside it for the host-object collectives
through which rank 0 drives the checkpoint engine).  The meshes are
functions, never module-level constants, so importing this module starts
nothing.
"""

from __future__ import annotations

import datetime
import math
import os
import socket

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

#: seconds a collective waits for its peers before it raises
DEFAULT_TIMEOUT = 120.0


def free_port() -> int:
    """A TCP port on localhost that nothing listens on right now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device_type: str = "cuda", *, rank: int | None = None,
                     world_size: int | None = None,
                     init_method: str | None = None,
                     timeout: float = DEFAULT_TIMEOUT) -> None:
    """Start this process's default process group.

    ``rank`` and ``world_size`` default to ``RANK`` and ``WORLD_SIZE`` (what
    ``torchrun`` sets; 0 and 1 without them).  ``init_method`` defaults to
    ``env://`` when ``MASTER_ADDR`` is set, else, for a world of one, to a
    free port on localhost; pass ``file://<path>`` (a path that does not
    exist yet) or ``tcp://localhost:<port>`` otherwise.  ``device_type``
    "cpu" runs gloo; "cuda" runs NCCL for the card's tensors (and gloo for
    host objects), selects the card ``LOCAL_RANK`` (default 0) and raises
    when there is no card or no NCCL.  ``timeout`` bounds every
    collective's wait for its peers."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    if init_method is None:
        if os.environ.get("MASTER_ADDR"):
            init_method = "env://"
        elif world_size == 1:
            init_method = f"tcp://localhost:{free_port()}"
        else:
            raise ValueError("init_distributed: a world of several processes "
                             "needs init_method or MASTER_ADDR/MASTER_PORT")
    if device_type == "cuda":
        resolve_device("cuda")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL: the card's process "
                               "group cannot start")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
        backend = "cpu:gloo,cuda:nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: no backend for {device_type!r}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))


def _mesh(device_type: str, shape: tuple[int, ...], axes: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"mesh {dict(zip(axes, shape))}: no process group "
                           f"(call init_distributed first, in each of "
                           f"{need} process(es))")
    have = dist.get_world_size()
    if have != need:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs a world size "
                         f"of {need}; this run has {have} process(es)")
    if device_type == "cuda":
        # the card ``LOCAL_RANK`` selects, as ``init_distributed("cuda")``
        # does (several processes may share one card); ``DeviceMesh`` would
        # otherwise select card ``LOCAL_RANK`` itself
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
        torch.cuda.init()
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (16, 16) ("data", "model") = 256 devices.
    Multi-pod:  (2, 16, 16) ("pod", "data", "model") = 512 devices.
    Raises, naming the world size it needs, in a run of another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_debug_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A small ("data", "model") mesh over this run's processes."""
    return _mesh(device_type, (data, model), ("data", "model"))

"""Where the port runs: the CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

import os

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must be present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    return dev


def use_deterministic_algorithms() -> None:
    """Make runs on the card repeat bit for bit, as a train restart needs:
    cuBLAS's fixed workspace (``CUBLAS_WORKSPACE_CONFIG``, which cuBLAS
    reads when it first allocates one, so call this before the first
    product on the card) and ``torch.use_deterministic_algorithms``, under
    which an operation without a deterministic implementation raises."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)


def empty_unfilled(shape, dtype, device) -> torch.Tensor:
    """``torch.empty`` for a tensor that its caller writes whole (a kernel's
    output).  Deterministic mode fills the memory of every new tensor
    (``torch.utils.deterministic.fill_uninitialized_memory``), one more
    full write that nothing reads: it is off for this allocation."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        return torch.empty(shape, dtype=dtype, device=device)
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = fill

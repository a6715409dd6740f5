"""Bring the JAX package's parameters into the port.

``params_from_jax`` takes them as NumPy arrays (``np.asarray`` of each
``jax.Array``; bfloat16 arrives as an ``ml_dtypes`` array) and returns the
port's tensors, bit for bit, so both packages compute on the same weights.
Nothing here imports JAX or ``ml_dtypes``: a bfloat16 array is recognised by
its dtype name and reinterpreted through its 2-byte words.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.store import HOST_WORDS
from repro_torch.core.torch_io import to_torch
from repro_torch.device import resolve_device


def params_from_jax(np_params: Mapping[str, np.ndarray], device="cuda"
                    ) -> dict[str, torch.Tensor]:
    dev = resolve_device(device)
    out = {}
    for name, arr in np_params.items():
        arr = np.asarray(arr)
        dtype = arr.dtype.name
        if dtype in HOST_WORDS:        # an ml_dtypes array: take its words
            arr = arr.view(HOST_WORDS[dtype])
        out[name] = to_torch(arr, dtype).to(dev)
    return out

"""Quickstart: the N-to-M checkpointing API in five minutes — the port of
the JAX package's ``examples/quickstart.py`` (the paper's Listing 1,
CheckpointFile, for tensor state), on the CUDA card by default:

    save two tensors from N=4 simulated ranks (``ckpt_pack`` gathers each
    rank's chunks on the device, one device-to-host copy a rank)  ->  load
    on M=3 ranks with a completely different partition, bit-exact against
    the tensors on the device.

The arrays, the layout, the load plan and the steps are the reference
script's, so the two write the same store byte for byte.

Run:  python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core.chunk_layout import ArraySpec, Box, StateLayout
from repro_torch.core.comm import Comm
from repro_torch.core.store import DatasetStore
from repro_torch.core.tensor_ckpt import TensorCheckpoint, balanced_chunk_partition
from repro_torch.core.torch_io import shards_from_tensors, to_torch
from repro_torch.device import resolve_device


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def main(argv=None) -> str:
    """Runs the example and returns the store's directory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- a "model": two tensors with different shapes ------------------
    rng = np.random.default_rng(0)
    host = {
        "embed": rng.normal(size=(256, 64)).astype(np.float32),
        "wq": rng.normal(size=(8, 64, 64)).astype(np.float32),
    }
    tensors = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    layout = StateLayout((
        ArraySpec("embed", (256, 64), "float32", (64, 64)),
        ArraySpec("wq", (8, 64, 64), "float32", (2, 64, 64)),
    ))

    # --- save from N=4 ranks (paper §2.2.3/2.2.4) -----------------------
    N = 4
    ownership = balanced_chunk_partition(layout, N)
    per_rank = shards_from_tensors(layout, tensors, ownership)
    tmp = tempfile.mkdtemp(prefix="quickstart_")
    ck = TensorCheckpoint(DatasetStore(tmp, "w"))
    ck.save_layout(layout)
    ck.save_state(per_rank, Comm(N), step=0)
    print(f"saved 2 arrays from N={N} ranks on {device.type} -> {tmp}")

    # --- load on M=3 ranks with arbitrary target regions (§2.3) ---------
    M = 3
    plan = [
        {"embed": [Box((0, 0), (100, 64))]},                   # rank 0
        {"embed": [Box((100, 0), (256, 64))],
         "wq": [Box((0, 0, 0), (3, 64, 64))]},                 # rank 1
        {"wq": [Box((3, 0, 0), (8, 64, 64))]},                 # rank 2
    ]
    out = ck.load_state(plan, Comm(M), step=0)
    for rank, rank_plan in enumerate(plan):
        for name, boxes in rank_plan.items():
            got = to_torch(out[rank][name][0], "float32").to(device)
            if not _same_bits(got, tensors[name][boxes[0].slices()]):
                raise AssertionError(f"rank {rank}'s {name} {boxes[0]} is "
                                     f"not the saved tensor's block")
    print(f"loaded on M={M} ranks with a different partition: bit-exact")

    # --- time series: many steps, section written once (§2.2.7) ---------
    for step in (1, 2, 3):
        ck.save_state(per_rank, Comm(N), step=step)
    print(f"committed steps: {ck.steps()} "
          f"(G/DOF/OFF written once, one vec per step)")
    return tmp


if __name__ == "__main__":
    main()

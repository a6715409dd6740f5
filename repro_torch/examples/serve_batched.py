"""Batched serving example: prefill once, stream decode steps against the
KV cache (gemma2 family: alternating local/global attention, softcaps) —
the port of the JAX package's ``examples/serve_batched.py``, through the
serving launcher's ``serve_batch`` (the one-process step builders), on the
CUDA card by default.

Run:  python -m repro_torch.examples.serve_batched [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import prompt_batch, serve_batch
from repro_torch.models.api import build_model

ARCH = "gemma2_2b"
B, P, G = 4, 24, 12


def serve(api, params, device: torch.device) -> np.ndarray:
    """The example's work on ``params``: B prompts of P tokens (the
    reference's batch, seed 3) prefilled once, then G greedy decode steps
    through the launcher's ``serve_batch``; prints the reference example's
    lines and returns the tokens [B, G + 1] (the prefill's greedy token,
    then each step's)."""
    seen = {}

    def on_prefill(logits, cache):
        seen["length"] = int(cache["length"])

    out, t = serve_batch(api, params, prompt_batch(api.cfg, B, P, device,
                                                   seed=3),
                         G, device, on_prefill=on_prefill)
    print(f"prefill: {B} prompts x {P} tokens in "
          f"{t['prefill_seconds']:.2f}s; cache length={seen['length']}")
    dt = t["decode_seconds"]
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "1 CPU device")
    print(f"decode: {G} steps x {B} sequences in {dt:.2f}s "
          f"({B*G/dt:.1f} tok/s on {where})")
    for b in range(B):
        print(f"  seq {b}: {out[b].tolist()}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    api = build_model(get_smoke_config(ARCH))
    params = api.init(torch.Generator(device=device).manual_seed(0))
    return serve(api, params, device)


if __name__ == "__main__":
    main()

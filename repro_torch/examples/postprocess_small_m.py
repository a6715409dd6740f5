"""The paper's headline use case, save big and post-process small, on the
port: the counterpart of the JAX package's ``examples/postprocess_small_m.py``,
on the CUDA card by default.

The N side trains the smollm smoke config for 20 steps and saves steps 10
and 20 as a step series from 8 simulated ranks (``save_torch`` with
``balanced_chunk_partition(layout, 8)``: simulated ranks in one process,
where the reference trains on a (4, 2) mesh; ``examples/elastic_restart``
runs the port's real processes).  The M side, one
device, sweeps every committed step with ``core/resharder.sweep_steps``,
loading ONLY the embedding table and the final norm (one host-to-device copy
per array) without touching the rest of the state and without knowing the
save-time distribution (paper §1: "post-process the result on a local
workstation using a much smaller number of processes").

Run:  python -m repro_torch.examples.postprocess_small_m [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import os
import shutil
import tempfile

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.store import DatasetStore
from repro_torch.core.tensor_ckpt import (TensorCheckpoint,
                                          balanced_chunk_partition)
from repro_torch.core.torch_io import (layout_from_torch, save_torch,
                                      sweep_to_device)
from repro_torch.device import resolve_device, use_deterministic_algorithms
from repro_torch.models.api import build_model
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optim import make_optimizer
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.step import init_train_state, make_train_step

WANTED = ("params/embed", "params/final_norm")
NRANKS, STEPS, EVERY, SEQ, BATCH = 8, 20, 10, 32, 8


def train_phase(ckpt_dir: str, device) -> dict:
    """Train ``STEPS`` steps and save every ``EVERY``-th as one series step
    from ``NRANKS`` simulated ranks.  Returns the final state."""
    cfg = get_smoke_config("smollm_135m")
    api = build_model(cfg)
    opt = make_optimizer(cfg.optimizer)
    sched = functools.partial(warmup_cosine, base_lr=3e-3, warmup=5,
                              total=30)
    step = make_train_step(api, opt, sched,
                           ShapeConfig("pp", SEQ, BATCH, "train"))
    data = SyntheticLM(cfg.vocab, SEQ, BATCH, seed=0)
    state = init_train_state(api, opt,
                             torch.Generator(device=device).manual_seed(0))
    store = DatasetStore(ckpt_dir, "w")
    ck = TensorCheckpoint(store)
    layout = layout_from_torch(state)
    ck.save_layout(layout)
    ownership = balanced_chunk_partition(layout, NRANKS)
    for i in range(STEPS):
        state, _ = step(state, {k: torch.from_numpy(v).to(device)
                                for k, v in data.batch(i).items()})
        if (i + 1) % EVERY == 0:
            store.begin_step(i + 1)
            save_torch(ck, state, i + 1, ownership=ownership)
            store.commit_step()
    store.close()
    print(f"[N side] trained {STEPS} steps on {device.type}; saved steps "
          f"{list(range(EVERY, STEPS + 1, EVERY))} from {NRANKS} ranks to "
          f"{ckpt_dir}")
    return state


def postprocess_phase(ckpt_dir: str, device) -> dict:
    """The M = 1 'workstation': a selective sweep over every committed step
    of the stream, no model."""
    ck = TensorCheckpoint(DatasetStore(ckpt_dir, "r"))
    print(f"[M side] sweeping committed steps {ck.steps()} on 1 process, "
          f"{len(WANTED)}/{len(ck.layout().names)} arrays each:")
    swept = {}
    for step, arrays in sweep_to_device(ck, WANTED, device):
        embed = arrays["params/embed"]
        norm = arrays["params/final_norm"]
        swept[step] = arrays
        print(f"  step {step:>3}: "
              f"|embed| = {float(embed.float().abs().mean()):.4f}, "
              f"final_norm mean = {float(norm.float().mean()):.4f}")
    # nearest-neighbour demo over the last step's embeddings
    e = embed.float()
    e = e / (torch.linalg.vector_norm(e, dim=1, keepdim=True) + 1e-6)
    sims = e[:8] @ e.T
    sims[:, :8].fill_diagonal_(-1)
    neighbours = sims.argmax(1).tolist()
    print(f"  nearest neighbours of tokens 0..7 (step {ck.steps()[-1]}): "
          f"{neighbours}")
    ck.store.close()
    return {"swept": swept, "neighbours": neighbours}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "ex_postprocess_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        use_deterministic_algorithms()
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    state = train_phase(args.ckpt_dir, device)
    out = postprocess_phase(args.ckpt_dir, device)
    last = out["swept"][max(out["swept"])]
    for name in WANTED:
        if not torch.equal(last[name], state[name]):
            raise AssertionError(f"swept {name} differs from the trained "
                                 f"state")
    print("post-processing sweep OK: the last step's arrays equal the "
          "trained state bit for bit")
    return out


if __name__ == "__main__":
    main()

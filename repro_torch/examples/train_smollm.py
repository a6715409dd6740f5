"""End-to-end example: train a smollm-family model with async N-to-M
checkpointing, kill it mid-run, and restart from the last committed step —
the port of the JAX package's ``examples/train_smollm.py``, on the CUDA card
by default (in PyTorch's deterministic mode there).

Reduced config, a few hundred steps; ``--device cpu`` runs it on the CPU.

Run:  python -m repro_torch.examples.train_smollm [--steps 200] [--device cpu]
"""

import argparse
import functools
import os
import shutil
import tempfile

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device, use_deterministic_algorithms
from repro_torch.models.api import build_model
from repro_torch.train.data import SyntheticLM
from repro_torch.train.loop import (SimulatedPreemption, TorchTrainer,
                                    TrainerConfig)
from repro_torch.train.optim import make_optimizer
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.step import init_train_state, make_train_step


def build(steps, ckpt_dir, device, seq=64, batch=8):
    cfg = get_smoke_config("smollm_135m")
    api = build_model(cfg)
    shape = ShapeConfig("ex", seq, batch, "train")
    opt = make_optimizer(cfg.optimizer)
    sched = functools.partial(warmup_cosine, base_lr=3e-3, warmup=20,
                              total=steps)
    step = make_train_step(api, opt, sched, shape)
    data = SyntheticLM(cfg.vocab, seq, batch, seed=0)
    tcfg = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=25, log_every=25)
    return TorchTrainer(step, data, tcfg, device=device,
                        init_state_fn=lambda: init_train_state(
                            api, opt,
                            torch.Generator(device=device).manual_seed(0)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "ex_smollm_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        use_deterministic_algorithms()
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    # phase 1: train, then get "preempted" mid-run
    trainer = build(args.steps, args.ckpt_dir, device)
    kill_at = args.steps * 3 // 5
    try:
        trainer.run(args.steps, fail_at=kill_at)
    except SimulatedPreemption as e:
        print(f"!! {e} — last committed steps survive on disk")
    for h in trainer.history:
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}")

    # phase 2: fresh trainer (fresh process in real life) restarts from
    # the last committed checkpoint and finishes the run
    trainer2 = build(args.steps, args.ckpt_dir, device)
    trainer2.run(args.steps)
    print(f"resumed from committed step and ran to {args.steps}:")
    for h in trainer2.history:
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}")
    first = trainer.history[0]["loss"]
    last = trainer2.history[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'no improvement'})")
    return {"first_loss": first, "last_loss": last,
            "resumed_history": trainer2.history}


if __name__ == "__main__":
    main()

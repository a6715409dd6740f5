"""Training launcher, the counterpart of the JAX package's
``launch/train.py``: the same flags and the same JSON lines (one per logged
step, then a summary).  Runs on the CUDA card, in PyTorch's deterministic
mode (so a restart continues bit for bit); ``--smoke --device cpu`` runs the
reduced config on the CPU through the plain PyTorch versions.  Every
architecture trains: the decoder-only family (dense, MoE, VLM on
embeddings), the RG-LRU hybrid (its scans through ``rglru_scan`` under
autograd), xLSTM and the whisper encoder-decoder (the trainer feeds zero
``enc_frames``, as the reference's does), each under its config's
optimizer (kimi-k2: Adafactor).

One process trains on one device.  Under ``torchrun`` (which sets
``WORLD_SIZE``, ``RANK`` and the rendezvous address) the state is sharded
over a ("data", "model") mesh of ``--data-mesh`` x ``--model-mesh``
processes, which must be the world size (``--production-mesh``: 16 x 16,
256 processes); only rank 0 prints.

    python -m repro_torch.launch.train --arch smollm-135m --steps 60 \\
        --batch 4 --seq 2048 --ckpt-dir /tmp/ck --ckpt-every 20
    python -m repro_torch.launch.train --arch xlstm-350m --steps 20 \\
        --batch 4 --seq 512 --ckpt-every 10
    python -m repro_torch.launch.train --arch recurrentgemma_9b --smoke \\
        --device cpu --steps 10 --batch 2 --seq 16
    torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch smollm-135m --smoke --device cpu --data-mesh 2
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device, use_deterministic_algorithms
from repro_torch.distrib.rules import rules_for
from repro_torch.launch.mesh import (init_distributed, make_debug_mesh,
                                     make_production_mesh)
from repro_torch.models.api import build_model
from repro_torch.train.data import SyntheticLM
from repro_torch.train.loop import TorchTrainer, TrainerConfig
from repro_torch.train.optim import make_optimizer
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", 1))
    if args.production_mesh:
        mesh_of, procs = "the production mesh", 256
    else:
        mesh_of = f"--data-mesh {args.data_mesh} x --model-mesh {args.model_mesh}"
        procs = args.data_mesh * args.model_mesh
    if procs != world:
        ap.error(f"{mesh_of} needs {procs} processes, but the world size "
                 f"(WORLD_SIZE) is {world}")

    device = resolve_device(args.device)
    if device.type == "cuda":
        use_deterministic_algorithms()
    mesh = None
    if world > 1 or args.production_mesh:
        init_distributed(device.type)
        mesh = (make_production_mesh(device_type=device.type)
                if args.production_mesh
                else make_debug_mesh(args.data_mesh, args.model_mesh,
                                     device_type=device.type))
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    api = build_model(cfg)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    opt = make_optimizer(cfg.optimizer)
    sched = functools.partial(warmup_cosine, base_lr=args.lr,
                              warmup=max(2, args.steps // 20),
                              total=args.steps)
    step = make_train_step(api, opt, sched, shape, mesh=mesh,
                           rules=rules_for(cfg.arch) if mesh else None)
    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed)
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir or os.path.join(
                             tempfile.gettempdir(), "repro_torch_ckpt"),
                         ckpt_every=args.ckpt_every, log_every=10)
    trainer = TorchTrainer(
        step, data, tcfg, device=device,
        init_state_fn=lambda: init_train_state(
            api, opt, torch.Generator(device=device).manual_seed(args.seed)))
    try:
        result = trainer.run(args.steps, fail_at=args.fail_at)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    if int(os.environ.get("RANK", 0)) != 0:
        return
    for h in result["history"]:
        print(json.dumps(h))
    print(json.dumps({"final_loss": result["history"][-1]["loss"]
                      if result["history"] else None,
                      "saved_steps": result["saved_steps"],
                      "seconds": round(result["seconds"], 2)}))


if __name__ == "__main__":
    main()

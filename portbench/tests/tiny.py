"""A cell's spec cut to a size the CPU runs in a second: the program runs
its plain versions of the kernels on the CPU."""

from __future__ import annotations

import time

import torch

from portbench import bench

TINY_MODEL = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                  vocab_size=256)


def spec(workload: str) -> dict:
    s = bench.load_cell(workload)
    s["config"].update(TINY_MODEL)
    mix = s["mix"]
    if mix["kind"] == "train":
        mix.update(batch=4, seq=32, reference_tokens=64)
    else:
        mix.update(max_seq=80, slots=4, clients=4, checked=3, checked_among=4,
                   prompt_len={"dist": "log_uniform", "lo": 8, "hi": 64,
                               "count": 8})
    return s


def run(workload: str, seed: int = 2 ** 31 + 7, seconds: float = 0.3,
        trace: bool = False, spec_of=spec) -> bench.Run:
    return bench.Run(spec=spec_of(workload), seed=seed, seconds=seconds,
                     trace=trace, device=torch.device("cpu"),
                     t_start=time.time())


WORKLOADS = ("qwen3-1.7b.train_ckpt", "qwen3-4b.prefill_pool")

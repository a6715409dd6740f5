"""Readings that the limits are set from, at a cell's own size.  Not run by
the benchmark's runs; run it on the chip by hand:

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 ... \\
        [--control 4 5 6] [--faults 7 8 9] [--seconds 10]

One JSON line per reading: ``{"kind", "seed", "numbers", "correct",
"checks", "seconds"}``, where ``checks`` holds the numbers that
``limits/<cell>.json`` names, each beside its limit, as ``Run.check`` records
them in a benchmark run, and ``correct`` is the verdict on them.

* ``program``: the program's numbers on each seed (training: its checked
  steps and one more, read as the window's step ``at`` is, with no window;
  serving: a window of ``--seconds`` at the cell's own load);
* ``control``: the reference computed in float8 (e4m3, one scale per
  tensor, ``reference.qwen3.fake_fp8``) in the program's place, against the
  float32 reference (training: the checked steps, and one step from the
  state that the program held after them);
* ``fault``: the program with one fault planted: training, half of each
  batch left out (the mean over the rest); serving, the served token
  altered (each prefill's logits shifted by one id).  A step that returns
  its state unchanged reads 1 by the change-norm measure and needs no run.
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import time

import torch

from portbench import bench, generator
from portbench.drivers import serve, train
from portbench.reference import qwen3 as ref
from portbench.trace import Tracer


def _run(workload: str, seed: int, seconds: float, device) -> bench.Run:
    return bench.Run(spec=bench.load_cell(workload), seed=seed,
                     seconds=seconds, trace=False, device=device,
                     t_start=time.time())


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def half_batch(fn):
    """The step on the first half of each batch's rows alone."""
    return lambda state, batch: fn(state, {k: v[:v.shape[0] // 2]
                                           for k, v in batch.items()})


def unchanged_state(fn):
    """The step returns the state it was given."""
    return lambda state, batch: (state, fn(state, batch)[1])


def train_readings(run: bench.Run, wrap=None):
    """The program's checked steps and one more, step ``CHECKED_STEPS``,
    read as a window's step ``at`` is: (checked readings, that step's
    readings, the state before it on the host, its index)."""
    trainer, watch, start = train.build(run, wrap)
    at = train.CHECKED_STEPS
    try:
        state, prog = train.checked(trainer, watch, start)
        watch.arm(at, state, Tracer(False))
        trainer.run(at + 1, start_state=state, start_step=at)
    finally:
        shutil.rmtree(trainer.cfg.ckpt_dir, ignore_errors=True)
    del trainer, state
    _free(run.device)
    return prog, train.window_readings(watch, run.device), watch.before, at


def _numbers(checked: dict, window: dict) -> dict:
    out = dict(checked)
    out.update({f"window_{k}": v for k, v in window.items()})
    return out


def train_program(run: bench.Run, wrap=None) -> dict:
    prog, prog_at, held, at = train_readings(run, wrap)
    return _numbers(
        train.gaps(prog, train.reference(run)),
        train.gaps(prog_at, train.reference(run, held=held, at=at)))


def train_control(run: bench.Run) -> dict:
    """The float8 reference in the program's place: the checked steps from
    the seed's weights, and one step from the state the program held."""
    _, _, held, at = train_readings(run)
    return _numbers(
        train.gaps(train.reference(run, quant=True), train.reference(run)),
        train.gaps(train.reference(run, quant=True, held=held, at=at),
                   train.reference(run, held=held, at=at)))


def shift_token(logits, one):
    """The served token altered: the logits shifted by one id."""
    return torch.roll(logits, 1, dims=-1), one


def unspliced(logits, one):
    """The prefill's K/V never reach the slot: zeros are spliced."""
    return logits, {**one, "k": torch.zeros_like(one["k"]),
                    "v": torch.zeros_like(one["v"])}


def serve_program(run: bench.Run, alter=None) -> dict:
    with torch.inference_mode():
        engine, cap, stream, _ = serve.build(run, alter=alter)
        serve.warm(engine, run.mix, run.config["vocab_size"])
        w = serve.window(run, engine, cap, stream, Tracer(False))
        kept = cap.kept
        del engine, cap
        _free(run.device)
        return serve.reference(run, stream, kept, w["done"])


def serve_control(run: bench.Run) -> dict:
    """The float8 prefill of each checked prompt in the program's place,
    its token the one that float8 puts first."""
    cfg, dev = run.config, run.device
    stream = generator.PromptStream(run.mix, run.seed, cfg["vocab_size"])
    checked = stream.checked(run.mix["checked"], run.mix["checked_among"])
    kept, done = {}, {}
    with torch.inference_mode():
        ref.exact_matmuls()
        params = ref.make_weights(cfg, run.seed, dev)
        for k in checked:
            prompt = torch.from_numpy(stream.prompt(k)).to(dev)
            ks, vs = [], []
            last = ref.prefill(cfg, params, prompt, quant=True,
                               on_kv=lambda i, kk, vv: (ks.append(kk[0]),
                                                        vs.append(vv[0])))
            kept[k] = {"k": torch.stack(ks), "v": torch.stack(vs),
                       "logits": last}
            done[k] = int(last.argmax())
            del ks, vs
        del params
        _free(dev)
        return serve.reference(run, stream, kept, done)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--faults", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    kind = bench.load_cell(args.workload)["mix"]["kind"]
    jobs = ([("program", s) for s in args.seeds]
            + [("control", s) for s in args.control]
            + [("fault", s) for s in args.faults])
    for what, seed in jobs:
        run = _run(args.workload, seed, args.seconds, device)
        t0 = time.perf_counter()
        if kind == "train":
            numbers = {"program": train_program,
                       "control": train_control,
                       "fault": lambda r: train_program(r, half_batch)
                       }[what](run)
        else:
            numbers = {"program": serve_program,
                       "control": serve_control,
                       "fault": lambda r: serve_program(r, shift_token)
                       }[what](run)
        for name, value in numbers.items():
            if name in run.spec["limits"]:
                run.check(name, value)
        print(json.dumps({"kind": what, "seed": seed, "numbers": numbers,
                          "correct": run.correct, "checks": run.checks,
                          "seconds": time.perf_counter() - t0}), flush=True)
        _free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The training driver: the program's ``TorchTrainer.run`` over its
``make_train_step`` (AdamW, remat, deterministic mode as the train launcher
sets it), fed by the benchmark's token generator.

Set-up builds one trainer from the seed's state and runs its first
``CHECKED_STEPS`` steps through ``run`` (a cold start); those are the steps
the reference follows, and they time a step.  The window is one more call
of ``run`` on the same trainer, of as many steps as fill ``--seconds`` at
that step time.  The step past half of them is ``at``: with ``save`` in the
mix, the trainer's own ``ckpt_every`` rule saves once, just before it (the
count is fixed from the set-up's step time, so the bytes written do not grow
as the program gets faster), and ``run`` returns only when the write has
committed.

The step's function is wrapped by a ``Watch``, which reads the program
without holding anything on the card: the checked steps' losses and step
0's first moment, and the state before and after step ``at``, copied into
pinned host buffers made in set-up.

The numbers (``limits/<workload>.json`` names those compared; ``judge``
prints the rest): ``loss_gap``, the largest gap of the checked steps'
losses; ``grad_norm_gap`` and ``change_norm_gap``, the worst parameter's gap
between the program's and the reference's norms of the first gradient (the
program's from its first moment) and of the change over the checked steps,
and ``grad_dist``, the worst parameter's distance between the two first
gradients, each over the larger of the reference's norm of that parameter
and of the median parameter, over the parameters whose reference gradient
is at least ``MOVED`` of the median's.  ``window_*``: the same
numbers of step ``at``, which the reference takes from the state the program
held before it.  With a save, ``store_mismatch``: the arrays whose committed
bytes differ from that state.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import math
import os
import shutil
import statistics
import sys
import tempfile
import time

import torch

from portbench import bench, generator, yardstick
from portbench.reference import qwen3 as ref
from portbench.reference.store_reader import StoreReader
from portbench.trace import Tracer

CHECKED_STEPS = 3
#: a parameter counts where its reference gradient norm is at least this
#: share of the median parameter's
MOVED = 1e-3


class Watch:
    """The step's function, reading the program as it runs.  Calls
    0 .. CHECKED_STEPS - 1 (set-up) are synchronised and timed, their losses
    kept, and call 0's first gradient read off its first moment.  Call
    ``at`` has its state before and after (parameters and first moment)
    copied to pinned host buffers, on the step's own stream."""

    def __init__(self, fn, b1: float):
        self.fn, self.b1 = fn, b1
        self.calls, self.at, self.tracer = 0, None, Tracer(False)
        self.losses, self.times, self.grads = [], [], {}
        self.before = self.after = self.loss_at = None
        self._save_span = None

    def arm(self, at: int, state: dict, tracer: Tracer) -> None:
        """Read call ``at``; the buffers take the shapes of ``state``."""
        pin = lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=(
            t.device.type == "cuda"))
        self.at, self.tracer = at, tracer
        self.before = {n: pin(t) for n, t in state.items()}
        self.after = {n: pin(t) for n, t in state.items()
                      if not n.startswith("opt/v/") and n != "step"}

    @property
    def step_s(self) -> float:
        """A step's seconds in set-up (the last checked one)."""
        return self.times[-1] - self.times[-2]

    def __call__(self, state, batch):
        i, dev = self.calls, batch["tokens"].device
        self.calls += 1
        if i == self.at:
            self._close_save_span()
            _to_host(state, self.before)
        with self.tracer.span("bench.step"):
            new, metrics = self.fn(state, batch)
        if i < CHECKED_STEPS:
            self.losses.append(metrics["loss"])
            if i == 0:
                for key, m in new.items():
                    if key.startswith("opt/m/"):
                        g = m / (1 - self.b1)
                        self.grads[key[6:]] = (float(g.norm()), g.cpu())
            bench.sync(dev)
            self.times.append(time.perf_counter())
        elif i == self.at:
            _to_host(new, self.after)
            self.loss_at = metrics["loss"]
        elif self.at is not None and i == self.at - 1:
            # the save follows this step: it starts on an idle card
            bench.sync(dev)
            self._save_span = self.tracer.span("bench.save_and_feed")
            self._save_span.__enter__()
        if i == CHECKED_STEPS and new is not state:
            # ``run`` keeps the dict it started from for its whole loop; a
            # cold start holds nothing, so neither does the window
            state.clear()
        return new, metrics

    def _close_save_span(self):
        if self._save_span is not None:
            self._save_span.__exit__(None, None, None)
            self._save_span = None


def _to_host(state: dict, bufs: dict) -> None:
    for n, buf in bufs.items():
        buf.copy_(state[n], non_blocking=True)


def build(run: bench.Run, wrap=None):
    """The trainer on the seed's state, its watch, and the initial
    parameters (on the host).  ``wrap`` (the planted faults of
    ``control.py`` and the tests only) wraps the step's function."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.device import use_deterministic_algorithms
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import TorchTrainer, TrainerConfig
    from repro_torch.train.optim import AdamW
    from repro_torch.train.schedule import constant
    from repro_torch.train.step import make_train_step

    dev, cfg, mix = run.device, run.config, run.mix
    if dev.type == "cuda":
        use_deterministic_algorithms()
    api = build_model(bench.port_config(cfg))
    bench.check_param_layout(api, ref.param_table(cfg))
    opt = AdamW()
    step = make_train_step(
        api, opt, functools.partial(constant, base_lr=mix["lr"]),
        ShapeConfig("bench", mix["seq"], mix["batch"], "train"))
    if wrap is not None:
        step.fn = wrap(step.fn)
    watch = Watch(step.fn, opt.b1)
    step.fn = watch
    feed = generator.TrainFeed(run.seed, mix["batch"], mix["seq"],
                               cfg["vocab_size"])
    params = ref.make_weights(cfg, run.seed, dev)
    start = {n: p.cpu() for n, p in params.items()}
    state = {f"params/{n}": p for n, p in params.items()}
    state.update({f"opt/{k}": v
                  for k, v in opt.init(api.param_specs, dev).items()})
    state["step"] = torch.zeros((), dtype=torch.int32, device=dev)
    held = [state]
    trainer = TorchTrainer(
        step, feed, TrainerConfig(
            ckpt_dir=tempfile.mkdtemp(prefix="portbench_ckpt_"),
            ckpt_every=0, async_ckpt=True, log_every=0),
        init_state_fn=held.pop, device=dev)
    return trainer, watch, start


def checked(trainer, watch: Watch, start: dict) -> tuple[dict, dict]:
    """Steps 0 .. CHECKED_STEPS - 1 through ``run`` from a cold start, and
    the program's readings of them."""
    state = trainer.run(CHECKED_STEPS)["state"]
    dev = state["step"].device
    change = {n: float((state[f"params/{n}"].float()
                        - p.to(dev).float()).norm())
              for n, p in start.items()}
    return state, {
        "losses": [float(x) for x in watch.losses],
        "grads": {n: g for n, (_, g) in watch.grads.items()},
        "grad_norms": {n: s for n, (s, _) in watch.grads.items()},
        "change_norms": change}


def window_readings(watch: Watch, dev) -> dict:
    """The program's readings of step ``at``: its loss, its gradient from
    the first moment before and after, and each parameter's change."""
    b, a, b1 = watch.before, watch.after, watch.b1
    grads, norms, change = {}, {}, {}
    for key in a:
        if not key.startswith("params/"):
            continue
        n = key[7:]
        g = ((a[f"opt/m/{n}"].to(dev) - b1 * b[f"opt/m/{n}"].to(dev))
             / (1 - b1))
        norms[n], grads[n] = float(g.norm()), g.cpu()
        change[n] = float((a[key].to(dev).float()
                           - b[key].to(dev).float()).norm())
    return {"losses": [float(watch.loss_at)], "grads": grads,
            "grad_norms": norms, "change_norms": change}


def reference(run: bench.Run, quant: bool = False, held: dict | None = None,
              at: int = 0) -> dict:
    """The reference's readings of the checked steps from the seed's
    weights, or with ``held`` (a state as the program holds it) of step
    ``at`` from that state (``quant``: the control)."""
    cfg, mix, dev = run.config, run.mix, run.device
    ref.exact_matmuls()
    torch.use_deterministic_algorithms(False)
    feed = generator.TrainFeed(run.seed, mix["batch"], mix["seq"],
                               cfg["vocab_size"])
    steps = range(CHECKED_STEPS) if held is None else [at]
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in feed.batch(i).items()} for i in steps]
    rows = max(1, mix["reference_tokens"] // mix["seq"])
    if held is None:
        return ref.train_steps(cfg, ref.make_weights(cfg, run.seed, dev),
                               batches, mix["lr"], quant=quant,
                               rows_per_pass=rows)
    slot = lambda kind: {k[len(kind):]: t.to(dev) for k, t in held.items()
                         if k.startswith(kind)}
    return ref.train_steps(cfg, slot("params/"), batches, mix["lr"],
                           quant=quant, rows_per_pass=rows,
                           m=slot("opt/m/"), v=slot("opt/v/"),
                           done=int(held["step"]))


def gaps(prog: dict, refr: dict) -> dict:
    """The compared numbers of the program's readings against the
    reference's; ``left_out``, the parameters that ``MOVED`` leaves out;
    and ``worst``, the parameter that sets each number."""
    g_ref = refr["grad_norms"]
    med_g = statistics.median(g_ref.values())
    counted = [n for n, g in g_ref.items() if g >= MOVED * med_g]
    at = {}

    def worst(key, gap, name):
        r = refr[key]
        med = statistics.median(r[n] for n in counted)
        value, at[name] = max((gap(n) / max(r[n], med), n) for n in counted)
        return value

    def dist(n):
        g = refr["grads"][n]
        return float((prog["grads"][n].to(g.device) - g).norm())

    return {"loss_gap": max(abs(a - b) for a, b in
                            zip(prog["losses"], refr["losses"])),
            "grad_norm_gap": worst("grad_norms", lambda n: abs(
                prog["grad_norms"][n] - g_ref[n]), "grad_norm_gap"),
            "grad_dist": worst("grad_norms", dist, "grad_dist"),
            "change_norm_gap": worst("change_norms", lambda n: abs(
                prog["change_norms"][n] - refr["change_norms"][n]),
                "change_norm_gap"),
            "left_out": sorted(set(g_ref) - set(counted)), "worst": at}


def store_mismatch(store: str, step: int, held: dict) -> int:
    """Arrays of committed step ``step`` whose bytes differ from ``held``
    (host tensors), or that are missing."""
    stored = StoreReader(store).read(step)
    bad = 0
    for name, t in held.items():
        got = stored.get(name)
        want = t.contiguous().view(
            torch.int16 if t.dtype == torch.bfloat16 else t.dtype).numpy()
        if got is None or got[0].tobytes() != want.tobytes():
            bad += 1
    return bad + len(set(stored) - set(held))


def plan(run: bench.Run, step_s: float) -> tuple[int, int]:
    """(steps, at): the window's steps at ``step_s`` a step (4 at least),
    and the step past half of them, whose saving boundary ``ckpt_every``
    marks once in the window: 2 * at is past its last step."""
    n = max(4, math.ceil(run.seconds / step_s))
    return n, CHECKED_STEPS + 1 + n // 2


def window(run: bench.Run, trainer, state: dict, steps: int, at: int,
           tracer: Tracer) -> dict:
    """``run`` over the window's steps; with a save in the mix, the
    trainer's ``ckpt_every`` saves once, at ``at``."""
    trainer.cfg = dataclasses.replace(
        trainer.cfg, ckpt_every=at if "save" in run.mix else 0)
    with tracer.span("bench.window"):
        t0 = time.perf_counter()
        out = trainer.run(CHECKED_STEPS + steps, start_state=state,
                          start_step=CHECKED_STEPS)
        bench.sync(run.device)
        window_s = time.perf_counter() - t0
    return {"window_s": window_s, "saved": out["saved_steps"]}


def drive(run: bench.Run, wrap=None) -> None:
    trainer, watch, start = build(run, wrap)
    store = trainer.cfg.ckpt_dir
    try:
        prog, at = _timed(run, trainer, watch, start)
        del trainer
        gc.collect()
        if "save" in run.mix:
            run.check("store_mismatch",
                      store_mismatch(store, at, watch.before))
    finally:
        shutil.rmtree(store, ignore_errors=True)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    prog_at = window_readings(watch, run.device)
    judge(run, gaps(prog, reference(run)), "")
    judge(run, gaps(prog_at, reference(run, held=watch.before, at=at)),
          "window_")


def judge(run: bench.Run, numbers: dict, prefix: str) -> None:
    """Record the numbers that the cell's limits name; print the rest."""
    print(f"# {prefix or 'checked_'}left_out (MOVED): {numbers['left_out']}; "
          f"set by: {numbers['worst']}", file=sys.stderr)
    for name, value in numbers.items():
        if name in ("left_out", "worst"):
            continue
        if prefix + name in run.spec["limits"]:
            run.check(prefix + name, value)
        else:
            print(f"# {prefix}{name} {value!r} (not compared)",
                  file=sys.stderr)


def _timed(run: bench.Run, trainer, watch: Watch, start: dict):
    """Set-up's checked steps, then the window; returns the program's
    readings of the checked steps and the step ``at``."""
    import repro_torch.kernels.build as kbuild

    cfg, mix, dev = run.config, run.mix, run.device
    state, prog = checked(trainer, watch, start)
    steps, at = plan(run, watch.step_s)
    tracer = Tracer(run.trace)
    watch.arm(at, state, tracer)
    if dev.type == "cuda" and "save" in mix:
        kbuild.library("ckpt_pack")
    bench.sync(dev)
    run.setup_done()
    with tracer:
        # the watch empties ``state`` after the window's first step
        w = window(run, trainer, state, steps, at, tracer)
    del state
    run.trace_data = tracer.result
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    B, S = mix["batch"], mix["seq"]
    run.window_s = w["window_s"]
    run.attempted = steps
    tokens = steps * B * S
    run.e2e["train_tokens_per_s"] = tokens / w["window_s"]
    shape = yardstick.Shape.of(cfg)
    run.facts.update(
        shape=shape, batch=B, seq=S, steps=steps,
        model_flops=steps * yardstick.train_step_flops(shape, B, S))
    print(f"# window: {steps} steps, {tokens} tokens in "
          f"{w['window_s']:.3f} s; step {at} read", file=sys.stderr)
    if "save" not in mix:
        return prog, at
    if w["saved"] != [at]:
        raise bench.NoResult(f"the window saved {w['saved']}, not [{at}]")
    save = trainer.save_log[-1]
    writer = [j for j in trainer._async.job_log
              if j["label"].endswith(f"s{at}")]
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(trainer.cfg.ckpt_dir) for f in fs)
    run.facts.update(
        ckpt_stall_s=save["seconds"],
        ckpt_writer_s=sum(j["seconds"] for j in writer),
        state_bytes=sum(t.numel() * t.element_size()
                        for t in watch.before.values()))
    print(f"# save: 1 at step {at}, stall {save['seconds']:.4f} s, "
          f"writer {run.facts['ckpt_writer_s']:.3f} s, {nbytes} bytes "
          f"written", file=sys.stderr)
    return prog, at

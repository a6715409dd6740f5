"""The serving driver: the program's ``TorchServeEngine`` (continuous
batching, per-slot cache, the flash kernel in its prefill) in a closed loop
of ``clients`` clients, each sending its next request when the last one
returns.

Set-up makes the weights and the engine and warms the mix's shortest and
longest prompts.  In the window every client keeps one request in the
engine; the window closes at the return of the first ``engine.step()``
after ``--seconds``, when no request is left in flight (a request of
``max_new`` 1 gets its token in the step that admits it).  A request's time
to first token runs from its ``submit`` to the return of the step that gave
it its first token.

Compared (``limits/<workload>.json``), over the requests that
``PromptStream.checked`` names (drawn from the seed, with the longest; all
finish in any window): ``token_gap``, the largest gap by which a served
token's logit lies below the reference's best; ``logits_err``, the largest
gap of the last position's logits over the reference's standard deviation
of them; ``kv_err``, the worst layer's distance of the K or V that the
engine spliced into the request's slot from the reference's, over the
reference's norm.  The engine's ``api.prefill`` is wrapped to keep a copy of
the checked requests' K/V and logits, in pinned host buffers made in set-up:
nothing of the harness's stays on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import sys
import time

import numpy as np
import torch

from portbench import bench, generator, yardstick
from portbench.reference import qwen3 as ref
from portbench.trace import Tracer


class Capture:
    """Wraps the engine's ``api.prefill`` and ``api.decode_step``.  The k-th
    prefill after ``start()`` is request k's (the engine admits in
    submission order): a checked request's logits are copied there.  Its
    K/V rows are copied from its slot of the engine's cache just before the
    decode step of the ``engine.step()`` that admitted it, after the splice.
    The copies go into pinned host buffers made beforehand, on the engine's
    stream."""

    def __init__(self, api, want: dict[int, int], device, tracer=None,
                 alter=None):
        cfg = api.cfg
        self.inner, self._decode = api.prefill, api.decode_step
        self.on, self.k, self.engine = False, 0, None
        self.tracer, self.alter = tracer, alter
        self.lengths: list[int] = []
        shape = lambda P: (cfg.num_layers, P, cfg.num_kv_heads, cfg.head_dim_)
        pin = functools.partial(torch.empty, dtype=getattr(torch, cfg.dtype),
                                pin_memory=device.type == "cuda")
        self.kept = {k: {"k": pin(shape(P)), "v": pin(shape(P)),
                         "logits": pin(cfg.vocab, dtype=torch.float32)}
                     for k, P in want.items()}
        self.api = dataclasses.replace(api, prefill=self.prefill,
                                       decode_step=self.decode)

    def start(self):
        self.on, self.k, self.lengths = True, 0, []

    def _span(self, name):
        return (self.tracer.span(name) if self.tracer is not None
                else contextlib.nullcontext())

    def prefill(self, params, batch, Smax=None):
        with self._span("bench.prefill"):
            logits, one = self.inner(params, batch, Smax)
        if not self.on:
            return logits, one
        buf = self.kept.get(self.k)
        if buf is not None:
            buf["logits"].copy_(logits[0], non_blocking=True)
        if self.alter is not None:
            logits, one = self.alter(logits, one)
        self.lengths.append(batch["tokens"].shape[1])
        self.k += 1
        return logits, one

    def decode(self, params, cache, batch):
        if self.on:
            for slot, req in enumerate(self.engine.active):
                buf = None if req is None else self.kept.get(req.rid)
                if buf is not None and len(req.generated) == 1:
                    P = len(req.prompt)
                    # a layer at a time: each is contiguous, so no copy
                    # is staged on the card
                    for key in ("k", "v"):
                        for i in range(buf[key].shape[0]):
                            buf[key][i].copy_(cache[key][i, slot, :P],
                                              non_blocking=True)
        with self._span("bench.decode"):
            return self._decode(params, cache, batch)


def build(run: bench.Run, tracer=None, alter=None):
    """The engine on the seed's weights, its prefill wrapped by a Capture
    of the checked requests, and the prompt stream."""
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import TorchServeEngine

    cfg, mix, dev = run.config, run.mix, run.device
    api = build_model(bench.port_config(cfg))
    bench.check_param_layout(api, ref.param_table(cfg))
    stream = generator.PromptStream(mix, run.seed, cfg["vocab_size"])
    checked = stream.checked(mix["checked"], mix["checked_among"])
    cap = Capture(api, {k: stream.length(k) for k in checked}, dev,
                  tracer, alter)
    params = ref.make_weights(cfg, run.seed, dev)
    engine = TorchServeEngine(cap.api, params, slots=mix["slots"],
                              max_seq=mix["max_seq"])
    cap.engine = engine
    return engine, cap, stream, checked


def warm(engine, mix: dict, vocab: int) -> None:
    """One prefill at the mix's shortest length and one at its longest."""
    lengths = generator.prompt_lengths(mix)
    for rid, P in enumerate((lengths[0], lengths[-1])):
        engine.submit(-1 - rid, np.zeros(P, np.int32) + rid % vocab,
                      mix["max_new"])
    engine.run()
    engine.finished.clear()


def window(run: bench.Run, engine, cap: Capture, stream, tracer) -> dict:
    mix, seconds = run.mix, run.seconds
    sent, done, ttft, tokens = {}, {}, [], 0
    k, closing = 0, False
    cap.start()
    with tracer.span("bench.window"):
        t0 = time.perf_counter()
        for _ in range(mix["clients"]):
            engine.submit(k, stream.prompt(k), mix["max_new"])
            sent[k], k = time.perf_counter(), k + 1
        while True:
            with tracer.span("bench.step"):
                engine.step()
            now = time.perf_counter()
            closing = closing or now - t0 >= seconds
            for req in engine.finished:
                ttft.append(now - sent[req.rid])
                tokens += len(req.prompt)
                done[req.rid] = req.generated[0]
                if not closing:
                    engine.submit(k, stream.prompt(k), mix["max_new"])
                    sent[k], k = time.perf_counter(), k + 1
            engine.finished.clear()
            if closing and not engine.queue and not any(engine.active):
                break
        window_s = now - t0
    return {"window_s": window_s, "ttft": ttft, "tokens": tokens,
            "done": done, "sent": len(sent)}


def reference(run: bench.Run, stream, kept: dict, done: dict) -> dict:
    """The checked numbers of the kept outputs (``kept[k]``: request k's
    K/V [L, P, KV, hd] and last logits; ``done[k]``: its served token)
    against the reference's prefill of each checked prompt."""
    cfg, dev = run.config, run.device
    ref.exact_matmuls()
    params = ref.make_weights(cfg, run.seed, dev)
    out = {"token_gap": 0.0, "logits_err": 0.0, "kv_err": 0.0}
    for k, buf in kept.items():
        prompt = torch.from_numpy(stream.prompt(k)).to(dev)

        def on_kv(i, kr, vr, buf=buf):
            for got, want in ((buf["k"][i], kr[0]), (buf["v"][i], vr[0])):
                got = got.to(want.device).float()
                err = float((got - want).norm() / want.norm())
                out["kv_err"] = max(out["kv_err"], err)

        logits = ref.prefill(cfg, params, prompt, on_kv=on_kv)
        if k not in done:
            out["token_gap"] = float("inf")
            continue
        gap = float(logits.max() - logits[int(done[k])])
        err = float((buf["logits"].to(dev) - logits).abs().max()
                    / logits.std())
        out["token_gap"] = max(out["token_gap"], gap)
        out["logits_err"] = max(out["logits_err"], err)
    return out


def drive(run: bench.Run, alter=None) -> None:
    """``alter`` (the planted faults of ``control.py`` and the tests only)
    changes each window prefill's (logits, cache) before the engine sees
    them."""
    cfg, mix, dev = run.config, run.mix, run.device
    with torch.inference_mode():
        tracer = Tracer(run.trace)
        engine, cap, stream, checked = build(run, tracer, alter)
        warm(engine, mix, cfg["vocab_size"])
        bench.sync(dev)
        run.setup_done()
        with tracer:
            w = window(run, engine, cap, stream, tracer)
        run.trace_data = tracer.result
        if dev.type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
        shape = yardstick.Shape.of(cfg)
        run.window_s = w["window_s"]
        run.attempted, run.failed = w["sent"], w["sent"] - len(w["done"])
        run.e2e["prompt_tokens_per_s"] = w["tokens"] / w["window_s"]
        run.e2e["ttft_p90_ms"] = 1e3 * float(np.percentile(w["ttft"], 90))
        run.facts.update(
            shape=shape, prefills=list(cap.lengths),
            model_flops=sum(yardstick.prefill_flops(shape, P)
                            for P in cap.lengths))
        print(f"# window: {len(w['done'])} of {w['sent']} requests, "
              f"{w['tokens']} prompt tokens in {w['window_s']:.3f} s, "
              f"checked {checked}", file=sys.stderr)
        kept = cap.kept
        del engine, cap
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        for name, value in reference(run, stream, kept, w["done"]).items():
            run.check(name, value)

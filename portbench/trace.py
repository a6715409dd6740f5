"""The device trace of a ``--trace 1`` run: ``torch.profiler`` around the
measured window, reduced to the device's intervals, the window's span and
the host's spans.

The harness marks the window and its calls into the program with
``torch.profiler.record_function`` spans named ``bench.*``; the device
intervals are every CUDA activity (kernels, copies, fills) that the
profiler saw inside the window's span.
"""

from __future__ import annotations

import contextlib
import dataclasses

#: gaps shorter than this are summed under one name, not attributed
SHORT_GAP_NS = 50_000


@dataclasses.dataclass
class Trace:
    window: tuple[int, int]                       # ns, the window's span
    device: list[tuple[str, int, int]]            # (name, start, end) ns
    host: list[tuple[str, int, int]]              # main thread's spans

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def union(self) -> list[tuple[int, int]]:
        """The device's busy intervals, merged, clipped to the window."""
        lo, hi = self.window
        out: list[list[int]] = []
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.union()) / 1e9

    def idle_share(self) -> float | None:
        """The share of the window in which no operation ran on the card,
        in %, or None where the trace holds no device interval."""
        if self.window_s <= 0 or not self.device:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernels(self, *names: str) -> list[tuple[str, int, int]]:
        """The device intervals whose name contains any of ``names``."""
        return [e for e in self.device
                if any(n in e[0] for n in names)
                and e[1] >= self.window[0] and e[2] <= self.window[1]]

    def seconds(self, *names: str) -> float:
        return sum(b - a for _, a, b in self.kernels(*names)) / 1e9

    def gaps(self) -> list[tuple[int, int]]:
        busy, out, at = self.union(), [], self.window[0]
        for a, b in busy:
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.window[1] > at:
            out.append((at, self.window[1]))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps by
        the innermost host span open at each gap's middle."""
        ops: dict[str, float] = {}
        for name, a, b in self.kernels(""):
            ops[name] = ops.get(name, 0.0) + (b - a) / 1e9
        idle: dict[str, float] = {}
        spans = sorted(self.host, key=lambda e: (e[1], -e[2]))
        stack: list[tuple[str, int, int]] = []
        i = 0
        for a, b in self.gaps():
            if b - a < SHORT_GAP_NS:
                key = "gaps under 50 us"
            else:
                mid = (a + b) // 2
                while i < len(spans) and spans[i][1] <= mid:
                    while stack and stack[-1][2] < spans[i][1]:
                        stack.pop()
                    stack.append(spans[i])
                    i += 1
                while stack and stack[-1][2] < mid:
                    stack.pop()
                key = stack[-1][0] if stack else "no host span"
            idle[key] = idle.get(key, 0.0) + (b - a) / 1e9
        pick = lambda d: [[k[:200], v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": pick(ops), "idle_gaps": pick(idle)}


class Tracer:
    """``with Tracer(on) as t: ...; t.result`` is the Trace (None when
    off).  ``span(name)`` marks a host span either way."""

    def __init__(self, on: bool):
        self.on = on
        self.result: Trace | None = None
        self._prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        from torch.autograd import DeviceType
        events = self._prof.profiler.kineto_results.events()
        on_host = [e for e in events if e.device_type() != DeviceType.CUDA]
        marks = [e for e in on_host if e.name() == "bench.window"]
        if not marks:
            raise RuntimeError("the trace holds no bench.window span")
        window = _span(marks[0])
        main = marks[0].start_thread_id()
        # a bench.* span also shows on the device's timeline as an
        # annotation, which is no work of the card's
        device = [(e.name(), *_span(e)) for e in events
                  if e.device_type() == DeviceType.CUDA
                  and not e.name().startswith("bench.")]
        host = [(e.name(), *_span(e)) for e in on_host
                if e.start_thread_id() == main]
        self.result = Trace(window, device, host)
        self._prof = None
        return False


def _span(e) -> tuple[int, int]:
    """(start, end) of a profiler event in ns."""
    start = e.start_ns()
    return start, start + e.duration_ns()

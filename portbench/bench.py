"""What every cell shares: reading ``BENCHMARK.json`` and the cell's files
by name, the set-up clock, the port's configuration, the device facts, the
trace of a ``--trace 1`` run, the per-layer readers and the result line.

A cell's files, found by the names in ``BENCHMARK.json``:

* ``configs[...]["file"]``: the configuration as it runs (Hugging Face keys,
  the cut, and a ``port`` group of the program's own settings);
* ``traffic/<traffic>.json``: the mix; its ``kind`` names the driver
  (``drivers/<kind>.py``), the rest are the generator's parameters;
* ``limits/<workload>.json``: the limit of each number the cell compares;
* ``metrics/<metric>.py``: one reader per per-layer metric, ``read(run)``
  returning a number, or None where the run has nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

#: top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoResult(RuntimeError):
    """The run cannot give a result: the harness prints why and exits
    non-zero."""


def process_start() -> float:
    """This process's start on the epoch clock: its age from ``/proc`` (the
    kernel's start time in clock ticks after boot, against the boot clock),
    or the harness's own import time where ``/proc`` cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return _IMPORTED
    now = time.time()
    return now - age if 0 <= age < now - _IMPORTED + 600 else _IMPORTED


_IMPORTED = time.time()


# ------------------------------------------------------------------- spec
def load_cell(workload: str) -> dict:
    """The workload's entry, its configuration, mix and limits, and the
    metrics it reports, from ``BENCHMARK.json`` and the files it names."""
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise NoResult(f"{path} is missing")
    bench = json.loads(path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise NoResult(f"no workload {workload!r} in BENCHMARK.json "
                       f"(it has {sorted(cells)})")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {
        "bench": bench, "cell": cell,
        "config": json.loads((ROOT / conf["file"]).read_text()),
        "mix": json.loads((PKG / "traffic" / f"{cell['traffic']}.json")
                          .read_text()),
        "limits": json.loads((PKG / "limits" / f"{workload}.json")
                             .read_text()),
        "end_to_end": reported(bench["end_to_end"], workload),
        "per_layer": reported(bench["per_layer"], workload),
    }


def reported(metrics: list[dict], workload: str) -> list[dict]:
    """The metrics a cell reports: those that list it, and those with no
    list."""
    return [m for m in metrics
            if workload in m.get("workloads", [workload])]


# --------------------------------------------------------------- the port
def port_config(config: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig

    port = config["port"]
    return ModelConfig(
        arch=port["arch"], family=port["family"],
        num_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"],
        num_heads=config["num_attention_heads"],
        num_kv_heads=config["num_key_value_heads"],
        d_ff=config["intermediate_size"], vocab=config["vocab_size"],
        head_dim=config["head_dim"], qk_norm=port["qk_norm"],
        rope_theta=float(config["rope_theta"]),
        tie_embeddings=config["tie_word_embeddings"],
        dtype=config["torch_dtype"], attention_impl=port["attention_impl"],
        remat=port["remat"], source=config["source"])


def check_param_layout(api, table: dict) -> None:
    """The benchmark's weights must fill the program's parameters name for
    name and shape for shape."""
    ours = {n: tuple(s) for n, (s, _) in table.items()}
    theirs = {n: tuple(s.shape) for n, s in api.param_specs.items()}
    if ours != theirs:
        raise NoResult(f"the program's parameters {theirs} differ from the "
                       f"benchmark's {ours}")


# -------------------------------------------------------------------- run
@dataclasses.dataclass
class Run:
    """One run of one cell: its inputs, and what the driver leaves for the
    result line and the readers."""
    spec: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    e2e: dict = dataclasses.field(default_factory=dict)
    facts: dict = dataclasses.field(default_factory=dict)
    checks: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    trace_data: object = None           # Trace, with --trace 1

    @property
    def config(self) -> dict:
        return self.spec["config"]

    @property
    def mix(self) -> dict:
        return self.spec["mix"]

    def setup_done(self) -> None:
        """Set-up ends here: the next operation is timed."""
        self.setup_s = time.time() - self.t_start

    def check(self, name: str, value: float) -> None:
        """Record a compared number beside its limit."""
        limit = self.spec["limits"][name]
        self.checks[name] = {"value": float(value), "limit": float(limit)}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.checks.values())


def sync(device) -> None:
    if getattr(device, "type", "cpu") == "cuda":
        import torch
        torch.cuda.synchronize(device)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def read_per_layer(run: Run) -> dict:
    out = {}
    for m in run.spec["per_layer"]:
        path = PKG / "metrics" / f"{m['name']}.py"
        mod_spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        value = mod.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def result(run: Run) -> dict:
    """The contract's last line."""
    import torch

    if run.trace:
        metrics = read_per_layer(run)
    else:
        metrics = {m["name"]: {"value": float(run.e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in run.spec["end_to_end"]}
    on_card = getattr(run.device, "type", "cpu") == "cuda"
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if on_card
              else "cpu",
              "count": 1, "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    if run.trace and run.trace_data is not None:
        device["busy_s"] = run.trace_data.busy_s
        device["window_s"] = run.trace_data.window_s
        out["breakdown"] = run.trace_data.breakdown()
    out["checks"] = run.checks
    return out

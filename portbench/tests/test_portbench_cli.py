"""The command as a benchmark check runs it: without a card it exits
non-zero and prints no result, as it does in a directory that holds only the
benchmark; what the harness and a run load, and what the reference loads."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from portbench import bench

ARGS = ["--workload", "qwen3-1.7b.train_ckpt", "--seed", str(2 ** 31 + 3),
        "--seconds", "1", "--trace", "0"]


def _env(**extra) -> dict:
    """Two threads: the suite's other workers share the CPUs."""
    return dict(os.environ, OMP_NUM_THREADS="2", **extra)


def _cli(cwd, env=None):
    spec = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    return subprocess.run(spec["command"] + ARGS, cwd=cwd, env=env or _env(),
                          capture_output=True, text=True, timeout=120)


def _no_result(p) -> bool:
    last = (p.stdout.strip().splitlines() or [""])[-1]
    return p.returncode != 0 and not last.startswith("{")


def test_exits_without_a_card():
    p = _cli(bench.ROOT, _env(CUDA_VISIBLE_DEVICES=""))
    assert _no_result(p), (p.returncode, p.stdout, p.stderr)
    assert "CUDA" in p.stderr or "program" in p.stderr


def test_exits_with_the_benchmark_alone(tmp_path):
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path)
    assert _no_result(p), (p.returncode, p.stdout, p.stderr)


PROBE = """
import sys, time, torch
sys.path.insert(0, {root!r})
from portbench import bench
from portbench.drivers import {driver}
from portbench.tests import tiny
run = tiny.run({workload!r}, seconds=0.2)
{driver}.drive(run)
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def _loaded(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=bench.ROOT, env=_env())
    assert p.returncode == 0, p.stderr
    return set(eval(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_reference_package():
    for workload, driver in (("qwen3-1.7b.train_ckpt", "train"),
                             ("qwen3-4b.prefill_pool", "serve")):
        top = _loaded(PROBE.format(root=str(bench.ROOT), driver=driver,
                                   workload=workload))
        assert "repro_torch" in top
        assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys\n"
            f"sys.path.insert(0, {str(bench.ROOT)!r})\n"
            "import portbench.reference.qwen3, "
            "portbench.reference.store_reader, portbench.yardstick, "
            "portbench.generator\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    top = _loaded(code)
    assert not top & {"repro_torch", "jax", "jaxlib", "flax", "repro"}

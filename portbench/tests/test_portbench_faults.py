"""A run at a small size on the CPU, the harness's look for a card skipped:
sound, it comes out correct; with the timed path broken underneath
(control.py's planted faults), or with the float8 control in the program's
place, it comes out not correct."""

from __future__ import annotations

import pytest

from portbench import control
from portbench.drivers import serve, train
from portbench.tests import tiny

TRAIN = ("qwen3-1.7b.train_ckpt",)


@pytest.fixture(autouse=True)
def few_threads():
    """Two threads: the suite's other workers share the CPUs."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", tiny.WORKLOADS)
def test_sound_run_is_correct(workload):
    run = tiny.run(workload)
    (train if run.mix["kind"] == "train" else serve).drive(run)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    assert run.e2e and run.setup_s > 0 and run.window_s >= run.seconds


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_train_faults_are_caught(workload, fault):
    run = tiny.run(workload)
    train.drive(run, wrap=getattr(control, fault))
    assert not run.correct, run.checks


def _from_the_window(fault):
    """``fault`` from the window's first step on; set-up's steps sound."""
    def wrap(fn):
        bad, calls = fault(fn), [0]

        def step(state, batch):
            calls[0] += 1
            late = calls[0] > train.CHECKED_STEPS
            return (bad if late else fn)(state, batch)
        return step
    return wrap


def double_step(fn):
    """The step applied twice: every parameter moves double."""
    return lambda state, batch: fn(fn(state, batch)[0], batch)


@pytest.mark.parametrize("fault", [control.unchanged_state, double_step])
def test_train_faults_in_the_window_alone_are_caught(fault):
    run = tiny.run("qwen3-1.7b.train_ckpt")
    train.drive(run, wrap=_from_the_window(fault))
    assert not run.correct, run.checks
    failing = {k for k, c in run.checks.items() if c["value"] > c["limit"]}
    assert failing and all(k.startswith("window_") for k in failing)


@pytest.mark.parametrize("step_s", [0.05, 0.93, 2.8, 20.0, 60.0])
def test_the_window_saves_once_before_its_read_step(step_s):
    """The trainer's ``ckpt_every`` rule marks one step boundary of the
    window, and the read step follows it inside the window."""
    run = tiny.run("qwen3-1.7b.train_ckpt", seconds=51)
    steps, at = train.plan(run, step_s)
    first, last = train.CHECKED_STEPS, train.CHECKED_STEPS + steps - 1
    assert [i + 1 for i in range(first, last + 1) if (i + 1) % at == 0] \
        == [at]
    assert first < at <= last


@pytest.mark.parametrize("fault", ["shift_token", "unspliced"])
def test_serve_faults_are_caught(fault):
    run = tiny.run("qwen3-4b.prefill_pool")
    serve.drive(run, alter=getattr(control, fault))
    assert not run.correct, run.checks


def _fails(run, numbers) -> bool:
    return any(numbers[k] > run.spec["limits"][k] for k in run.spec["limits"]
               if k in numbers)


def _separates(program: dict, ctl: dict) -> bool:
    """The rule a limit is set by: the control reads 3 times the program
    or more on some number."""
    return any(ctl[k] >= 3 * program[k] > 0 for k in program
               if isinstance(program[k], float))


@pytest.mark.parametrize("workload", TRAIN)
def test_train_control_fails(workload):
    run = tiny.run(workload)
    ctl = control.train_control(run)
    assert _fails(run, ctl)
    assert _separates(control.train_program(tiny.run(workload)), ctl)


def test_serve_control_separates():
    """At a CPU size float8's errors stay under the card's limits, set at
    36 layers; the control still reads several times the program."""
    run = tiny.run("qwen3-4b.prefill_pool")
    ctl = control.serve_control(run)
    assert _separates(control.serve_program(
        tiny.run("qwen3-4b.prefill_pool")), ctl)

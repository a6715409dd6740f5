"""The FLOP and byte counters against values worked out by hand."""

from __future__ import annotations

import json

import pytest

from portbench import bench, yardstick
from portbench.yardstick import Shape

SMALL = Shape(layers=1, d_model=8, heads=2, kv_heads=1, head_dim=4, d_ff=16,
              vocab=10)


def test_parameter_counts():
    # q, k, v, o: 8*8 + 8*4 + 8*4 + 8*8; MLP 3*8*16; norms 2*8 + 2*4
    assert SMALL.layer_params == 64 + 32 + 32 + 64 + 384 + 16 + 8
    assert SMALL.nonembed_params == 600 + 8
    assert SMALL.params == 608 + 80
    cfg = json.loads((bench.PKG / "configs" / "qwen3-1.7b.json").read_text())
    assert Shape.of(cfg).params == 240_241_664
    cfg = json.loads((bench.PKG / "configs" / "qwen3-4b.json").read_text())
    assert Shape.of(cfg).params == 4_022_468_096


def test_train_and_prefill_flops():
    # B 2, S 3: 6 * 688 * 6 tokens + 3 layers' worth of 2*2*2*9*4 = 288
    assert yardstick.train_step_flops(SMALL, 2, 3) == 6 * 688 * 6 + 3 * 288
    # S 3: 2 * 608 * 3 + 2 * 8 * 10 + 2*1*2*9*4
    assert yardstick.prefill_flops(SMALL, 3) == 3648 + 160 + 144


def test_flash_work():
    # B 1, S 2: q 16 elements, k and v 8 each, o 16; lse 4 f32
    ops, nbytes = yardstick.flash_fwd_work(SMALL, 1, 2)
    assert ops == 2 * 1 * 2 * 4 * 4 and nbytes == 2 * (16 + 16 + 16) + 16
    ops, nbytes = yardstick.flash_bwd_work(SMALL, 1, 2)
    # read q, o, dO (3 * 16), k, v (2 * 8), lse; write dq, dk, dv
    assert ops == 2.5 * 64 and nbytes == 2 * 64 + 16 + 2 * 32


def test_roofline_takes_the_larger_bound():
    assert yardstick.roofline_seconds(989e12, 0) == pytest.approx(1.0)
    assert yardstick.roofline_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert yardstick.pack_bytes(100) == 200


def test_issue_figures():
    """The step FLOPs the cells' predictions were written from."""
    cfg = json.loads((bench.PKG / "configs" / "qwen3-1.7b.json").read_text())
    s = Shape.of(cfg)
    assert yardstick.train_step_flops(s, 16, 4096) == pytest.approx(1.08e14,
                                                                    rel=5e-3)
    assert yardstick.train_step_flops(s, 4, 16384) == pytest.approx(1.47e14,
                                                                    rel=5e-3)

"""The generator: the same seed gives the same inputs, and every seed the
same work in another order."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import bench, generator

SEEDS = (7, 2 ** 31 + 11, 2 ** 40 + 3)


def test_train_batches_repeat_from_the_seed():
    a = generator.train_tokens(SEEDS[1], 5, 2, 16, 18992)
    b = generator.train_tokens(SEEDS[1], 5, 2, 16, 18992)
    c = generator.train_tokens(SEEDS[1], 6, 2, 16, 18992)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert np.array_equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    assert a["tokens"].max() < 18992 and a["mask"].all()


def test_every_seed_serves_the_same_rounds():
    mix = bench.load_cell("qwen3-4b.prefill_pool")["mix"]
    lengths = generator.prompt_lengths(mix)
    assert len(lengths) == 64 and lengths[0] >= 2048 and lengths[-1] <= 16384
    rounds = None
    for seed in SEEDS:
        s = generator.PromptStream(mix, seed, 151936)
        for cycle in range(2):
            ks = range(64 * cycle, 64 * (cycle + 1))
            assert sorted(s.length(k) for k in ks) == lengths
            got = sorted(tuple(sorted(s.length(k) for k in range(r, r + 4)))
                         for r in ks[::4])
            assert rounds is None or got == rounds
            rounds = got
        p = s.prompt(3)
        assert len(p) == s.length(3) and np.array_equal(p, s.prompt(3))
    a = [generator.PromptStream(mix, SEEDS[0], 9).length(k) for k in range(64)]
    b = [generator.PromptStream(mix, SEEDS[1], 9).length(k) for k in range(64)]
    assert a != b


def test_every_round_is_the_same_work():
    """A window ends after a round; whichever rounds it holds, each has the
    same prompt tokens and attention work, within a few parts in a
    thousand."""
    mix = bench.load_cell("qwen3-4b.prefill_pool")["mix"]
    s = generator.PromptStream(mix, SEEDS[0], 151936)
    assert sorted(P for g in s.groups for P in g) == (
        generator.prompt_lengths(mix))
    assert all(len(g) == mix["clients"] for g in s.groups)
    for work in ([sum(g) for g in s.groups],
                 [sum(P * P for P in g) for g in s.groups]):
        assert max(work) / min(work) < 1.002


@pytest.mark.parametrize("seed", SEEDS)
def test_checked_requests_hold_the_longest_and_span_the_window(seed):
    mix = bench.load_cell("qwen3-4b.prefill_pool")["mix"]
    s = generator.PromptStream(mix, seed, 151936)
    n, among = mix["checked"], mix["checked_among"]
    checked = s.checked(n, among)
    assert checked == s.checked(n, among)
    assert len(set(checked)) == n and all(0 <= k < among for k in checked)
    assert max(s.length(k) for k in checked) == max(
        s.length(k) for k in range(among))
    # one in each of the n - 1 parts of the first ``among`` requests
    parts = {k * (n - 1) // among for k in checked}
    assert parts == set(range(n - 1))

"""The one traffic generator.  A mix is a JSON file under ``traffic/``; its
``kind`` names the driver (``train`` or ``serve``) and the rest are the
parameters read here.  Everything is a pure function of ``--seed`` and the
mix, so the same seed gives the same inputs, and every seed gives the same
multiset of sizes in another order (the work of a run does not depend on the
seed; for serving, the same rounds of concurrent requests).

Seeds of any size are folded into the 64-bit first word of the key of NumPy's
Philox; the second word names the stream.
"""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1


def rng(seed: int, stream: int) -> np.random.Generator:
    """A counter-based generator for (seed, stream)."""
    return np.random.Generator(np.random.Philox(
        key=[int(seed) & _MASK64, int(stream) & _MASK64]))


# ------------------------------------------------------------------ train
def train_tokens(seed: int, step: int, batch: int, seq: int,
                 vocab: int) -> dict[str, np.ndarray]:
    """Step ``step``'s batch: ids uniform over the vocabulary, each row a
    window of S + 1 ids whose first S are the inputs and last S the
    targets; every target counts."""
    ids = rng(seed, 1 << 32 | step).integers(
        0, vocab, size=(batch, seq + 1), dtype=np.int64).astype(np.int32)
    return {"tokens": np.ascontiguousarray(ids[:, :-1]),
            "targets": np.ascontiguousarray(ids[:, 1:]),
            "mask": np.ones((batch, seq), np.float32)}


class TrainFeed:
    """What the trainer asks of a data pipeline: ``batch(step)`` and the
    pipeline state that rides in a checkpoint."""

    def __init__(self, seed: int, batch: int, seq: int, vocab: int):
        self.seed, self.global_batch, self.seq_len = seed, batch, seq
        self.vocab = vocab

    def batch(self, step: int) -> dict[str, np.ndarray]:
        return train_tokens(self.seed, step, self.global_batch, self.seq_len,
                            self.vocab)

    def state(self, next_step: int) -> dict:
        return {"pipeline_seed": int(self.seed) & _MASK64,
                "next_step": int(next_step)}


# ------------------------------------------------------------------ serve
def prompt_lengths(mix: dict) -> list[int]:
    """The mix's fixed multiset of prompt lengths: ``count`` quantiles of
    its distribution, sorted.  ``log_uniform``: lo * (hi / lo) ** u at
    u = (i + 0.5) / count, rounded to a multiple of ``multiple``."""
    d = mix["prompt_len"]
    if d["dist"] != "log_uniform":
        raise ValueError(f"unknown prompt length distribution {d['dist']!r}")
    lo, hi, n, m = d["lo"], d["hi"], d["count"], d.get("multiple", 1)
    out = []
    for i in range(n):
        x = lo * (hi / lo) ** ((i + 0.5) / n)
        out.append(int(min(hi, max(lo, m * round(x / m)))))
    return sorted(out)


class PromptStream:
    """Request ``k``'s prompt.  The mix's lengths (``prompt_lengths``) are
    cut into fixed groups of ``clients``: a closed loop sends one group a
    round, as each round's requests return together.  The groups are
    balanced, so that every round is the same work: the sorted lengths are
    dealt out a block of one per group at a time, longest block first, the
    block's longest to the group with the least attention work so far (the
    sum of its lengths squared).  Each cycle through the lengths sends the
    groups in a new seeded order, so every seed serves the same rounds in
    another order, and a window that ends after any of them holds the same
    work a round.  The ids are uniform over the vocabulary."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        lengths = prompt_lengths(mix)
        g = mix["clients"]
        if len(lengths) % g:
            raise ValueError(f"{len(lengths)} lengths do not split into "
                             f"rounds of {g}")
        n_groups = len(lengths) // g
        self.groups = [[] for _ in range(n_groups)]
        for b in reversed(range(g)):
            block = lengths[b * n_groups:(b + 1) * n_groups]
            least = sorted(self.groups, key=lambda q: sum(P * P for P in q))
            for group, P in zip(least, reversed(block)):
                group.append(P)
        self.n, self.g = len(lengths), g
        self.seed, self.vocab = seed, vocab
        self._orders: dict[int, np.ndarray] = {}

    def length(self, k: int) -> int:
        cycle, i = divmod(k, self.n)
        order = self._orders.get(cycle)
        if order is None:
            order = rng(self.seed, 2 << 32 | cycle).permutation(
                len(self.groups))
            self._orders[cycle] = order
        j, t = divmod(i, self.g)
        return self.groups[int(order[j])][t]

    def prompt(self, k: int) -> np.ndarray:
        return rng(self.seed, 3 << 32 | k).integers(
            0, self.vocab, size=self.length(k), dtype=np.int64
        ).astype(np.int32)

    def checked(self, count: int, among: int) -> list[int]:
        """The requests whose outputs are compared, spread over the first
        ``among`` (every one of them finishes inside any window): one drawn
        from the seed in each of ``count`` - 1 equal parts of them, and one
        of the places of the longest prompt there."""
        r = rng(self.seed, 4 << 32)
        edges = [among * j // (count - 1) for j in range(count)]
        out = {int(r.integers(lo, hi)) for lo, hi in zip(edges, edges[1:])}
        top = max(self.length(k) for k in range(among))
        out.add(int(r.choice([k for k in range(among)
                              if self.length(k) == top])))
        rest = [k for k in range(among) if k not in out]
        out.update(int(k) for k in r.choice(rest, size=count - len(out),
                                            replace=False))
        return sorted(out)

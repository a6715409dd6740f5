"""Synthetic-but-structured data pipeline with checkpointable state (a copy
of the JAX package's ``train/data.py``, which is NumPy only but whose package
imports JAX).

Counter-based (Philox) generation: batch ``i`` is a pure function of
``(seed, i)``, so the pipeline "state" is just the next step index — it
rides inside the N-to-M checkpoint like any other state, and a restart
on a different process count regenerates exactly the same global batches
(each loading rank slices its rows of the same global batch).

The token stream is not uniform noise: a Zipf-ish unigram distribution
plus a deterministic bigram rule gives the LM something learnable, so
the end-to-end example's loss curve is a real signal (examples/train_*).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def __post_init__(self):
        # fixed Zipf unigram table (shared across steps; derived from seed)
        rng = np.random.Generator(np.random.Philox(key=[self.seed, 2 ** 40]))
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._probs = p / p.sum()
        self._perm = rng.permutation(self.vocab)

    # ------------------------------------------------------------- batches
    def batch(self, step: int) -> dict[str, np.ndarray]:
        """The full global batch for ``step`` (callers slice their shard)."""
        rng = np.random.Generator(np.random.Philox(key=[self.seed, step]))
        B, S = self.global_batch, self.seq_len
        draws = rng.choice(self.vocab, size=(B, S), p=self._probs)
        tokens = self._perm[draws].astype(np.int32)
        # bigram rule: token at odd positions repeats (token+1 mod V) of the
        # previous position 50% of the time — learnable structure
        coin = rng.random((B, S)) < 0.5
        shifted = (np.roll(tokens, 1, axis=1) + 1) % self.vocab
        odd = (np.arange(S) % 2 == 1)[None, :]
        tokens = np.where(odd & coin, shifted, tokens).astype(np.int32)
        targets = np.roll(tokens, -1, axis=1)
        mask = np.ones((B, S), np.float32)
        mask[:, -1] = 0.0
        return {"tokens": tokens, "targets": targets, "mask": mask}

    def shard_rows(self, step: int, lo: int, hi: int) -> dict[str, np.ndarray]:
        """Rows [lo, hi) of the global batch — what one loading rank feeds
        its devices.  Pure function of (seed, step): N-to-M friendly."""
        full = self.batch(step)
        return {k: v[lo:hi] for k, v in full.items()}

    # ------------------------------------------------------------ ckpt API
    def state(self, next_step: int) -> dict:
        return {"pipeline_seed": self.seed, "next_step": int(next_step)}

    @staticmethod
    def restore_step(state: dict) -> int:
        return int(state["next_step"])

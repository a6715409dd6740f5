"""The benchmark's own yardstick: the H100's published peaks and the
operations and bytes of the work a cell does, counted from shapes.

Nothing here imports the program.  The counts follow the model's equations
(a decoder-only transformer with GQA attention and a SwiGLU MLP), in the way
the program's ``launch/dryrun.py::model_flops`` and ``launch/roofline.py``
count them, with the causal attention term added:

* a dense product of an [m, k] by a [k, n] matrix is 2 m k n operations;
* model FLOPs count each product of the forward once, and a training step
  three times (forward, and the backward's two products per forward
  product); work recomputed under remat is not counted;
* causal attention over S positions computes half of the S x S scores:
  QK^T and PV are 2 B Hq S^2 hd operations together in the forward.
"""

from __future__ import annotations

import dataclasses

#: NVIDIA's data sheet for one H100 SXM (dense, no sparsity), at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes of a decoder-only model that the counters need."""
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    @staticmethod
    def of(cfg: dict) -> "Shape":
        """From a configuration file's keys (Hugging Face names)."""
        return Shape(cfg["num_hidden_layers"], cfg["hidden_size"],
                     cfg["num_attention_heads"], cfg["num_key_value_heads"],
                     cfg["head_dim"], cfg["intermediate_size"],
                     cfg["vocab_size"])

    @property
    def layer_params(self) -> int:
        """Parameters of one layer: q, k, v, o, the three MLP matrices, the
        two norms and the q and k norms."""
        D, hd = self.d_model, self.head_dim
        attn = D * self.heads * hd * 2 + D * self.kv_heads * hd * 2
        return attn + 3 * D * self.d_ff + 2 * D + 2 * hd

    @property
    def nonembed_params(self) -> int:
        return self.layers * self.layer_params + self.d_model

    @property
    def params(self) -> int:
        """All parameters, the tied table once."""
        return self.nonembed_params + self.vocab * self.d_model


def causal_attention_fwd_flops(s: Shape, batch: int, seq: int) -> float:
    """QK^T and PV of one layer's causal attention, forward."""
    return 2.0 * batch * s.heads * seq * seq * s.head_dim


def train_step_flops(s: Shape, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 N per token for every product
    (the tied table counted once, as the unembedding) plus 3 times the
    causal attention forward of every layer."""
    tokens = batch * seq
    return (6.0 * s.params * tokens
            + 3.0 * s.layers * causal_attention_fwd_flops(s, batch, seq))


def prefill_flops(s: Shape, prompt: int) -> float:
    """Model FLOPs of one B 1 prefill that returns the last position's
    logits: 2 N per token for the layers, the unembedding of one position,
    and the causal attention of every layer."""
    return (2.0 * s.nonembed_params * prompt + 2.0 * s.d_model * s.vocab
            + s.layers * causal_attention_fwd_flops(s, 1, prompt))


# ------------------------------------------------------------ kernel work
def flash_fwd_work(s: Shape, batch: int, seq: int) -> tuple[float, float]:
    """(operations, bytes) of one causal flash forward call with its
    log-sum-exp: q, k and v read once, o (bf16) and the f32 log-sum-exp
    written once."""
    q = batch * seq * s.heads * s.head_dim
    kv = batch * seq * s.kv_heads * s.head_dim
    return (causal_attention_fwd_flops(s, batch, seq),
            2.0 * (q + 2 * kv + q) + 4.0 * batch * s.heads * seq)


def flash_bwd_work(s: Shape, batch: int, seq: int) -> tuple[float, float]:
    """(operations, bytes) of one causal flash backward call: five products
    (the scores again, dP, dV, dQ, dK), 2.5 times the forward's; q, k, v,
    o, dO and the log-sum-exp read once, dq, dk and dv written once."""
    q = batch * seq * s.heads * s.head_dim
    kv = batch * seq * s.kv_heads * s.head_dim
    ops = 2.5 * causal_attention_fwd_flops(s, batch, seq)
    read = 2.0 * (3 * q + 2 * kv) + 4.0 * batch * s.heads * seq
    write = 2.0 * (q + 2 * kv)
    return ops, read + write


def pack_bytes(state_bytes: int) -> float:
    """Bytes a full snapshot's chunk gather moves: every byte of the state
    read once and written once into the staging buffer."""
    return 2.0 * state_bytes


def roofline_seconds(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of its two bounds."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)

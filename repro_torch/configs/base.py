"""Model configuration schema shared by all assigned architectures."""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    impl: Literal["dense", "ep"] = "ep"   # one-hot dispatch vs sorted EP

    @property
    def num_experts_padded(self) -> int:
        """EP shards experts over the 16-wide model axis; non-divisible
        counts are padded with router-masked phantom experts (granite:
        40 -> 48).  Multiples of 16 also divide the 1/2/4/8-way test
        meshes."""
        if self.impl == "ep":
            return -(-self.num_experts // 16) * 16
        return self.num_experts


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: Literal["dense", "moe", "vlm", "audio", "ssm", "hybrid"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                     # 0 -> d_model // num_heads

    # attention behaviour
    qk_norm: bool = False
    logit_softcap: float = 0.0            # gemma2: 30.0 final logits
    attn_softcap: float = 0.0             # gemma2: 50.0 attention logits
    local_window: int = 0                 # sliding-window size for local layers
    layer_pattern: Literal[
        "all_global",       # every layer full (causal) attention
        "alt_local_global", # gemma2: local, global, local, ...
        "rglru_1_2",        # recurrentgemma: lru, lru, local-attn, ...
        "xlstm_alt",        # xlstm: mLSTM / sLSTM alternation
    ] = "all_global"
    rope_theta: float = 10_000.0
    mrope: bool = False                   # qwen2-vl multimodal RoPE
    tie_embeddings: bool = True

    # modality frontend (audio/vlm): inputs are precomputed embeddings
    input_mode: Literal["tokens", "embeds"] = "tokens"

    # encoder-decoder (whisper)
    enc_dec: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500               # whisper: 30 s of 10 ms frames / 2

    # recurrent families
    recurrent: Literal["none", "xlstm", "rglru"] = "none"
    lru_width: int = 0                    # rg-lru state width (0 -> d_model)
    conv_width: int = 4

    moe: MoEConfig | None = None

    # numerics / implementation
    dtype: str = "bfloat16"
    attention_impl: Literal["xla_flash", "naive", "pallas"] = "xla_flash"
    attn_block_q: int = 512
    attn_block_k: int = 1024
    vocab_chunk: int = 0                  # chunked CE: seq positions per chunk
    remat: bool = True
    remat_group: int = 1                  # layers per remat checkpoint (1 = per-layer)
    optimizer: Literal["adamw", "adafactor"] = "adamw"

    # notes for DESIGN/EXPERIMENTS
    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def mrope_sections(self) -> tuple[int, int, int]:
        """M-RoPE (t, h, w) frequency-lane split over head_dim//2
        (Qwen2-VL uses 16/24/24 for hd=128; scaled proportionally)."""
        half = self.head_dim_ // 2
        t = half // 4
        h = (half - t) // 2
        return (t, h, half - t - h)

    @property
    def q_per_kv(self) -> int:
        assert self.num_heads % max(self.num_kv_heads, 1) == 0
        return self.num_heads // self.num_kv_heads

    def layer_kinds(self) -> list[str]:
        """Per-layer block kind, derived from the pattern."""
        L = self.num_layers
        if self.layer_pattern == "all_global":
            return ["global"] * L
        if self.layer_pattern == "alt_local_global":
            return ["local" if i % 2 == 0 else "global" for i in range(L)]
        if self.layer_pattern == "rglru_1_2":
            # 1 local-attention layer per 2 recurrent layers (Griffin: 2 RG-LRU
            # blocks then 1 local-attn block)
            return ["lru" if i % 3 != 2 else "local" for i in range(L)]
        if self.layer_pattern == "xlstm_alt":
            return ["mlstm" if i % 2 == 0 else "slstm" for i in range(L)]
        raise ValueError(self.layer_pattern)

    # ------------------------------------------------------------ accounting
    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        D, H, KV, hd, F, V, L = (self.d_model, self.num_heads,
                                 self.num_kv_heads, self.head_dim_,
                                 self.d_ff, self.vocab, self.num_layers)
        n = V * D
        if not self.tie_embeddings:
            n += V * D
        kinds = self.layer_kinds()
        for k in kinds:
            if k in ("global", "local"):
                n += D * H * hd + 2 * D * KV * hd + H * hd * D    # qkvo
                n += 2 * D                                         # norms
                if self.moe is not None:
                    n += D * self.moe.num_experts                  # router
                    n += 3 * self.moe.num_experts * D * self.moe.d_ff_expert
                elif F:
                    n += 3 * D * F                                 # swiglu
            elif k == "lru":
                W = self.lru_width or D
                n += 2 * D                                     # norms
                n += 3 * D * F                                 # mlp
                n += 2 * D * W                                 # w_y, w_x
                n += self.conv_width * W                       # causal conv
                n += 2 * W * W + W                             # w_a, w_i, lam
                n += W * D                                     # w_out
            elif k == "mlstm":
                Di = 2 * D
                n += D                                         # ln
                n += 2 * D * Di                                # w_up, w_gate
                n += 3 * Di * Di                               # wq, wk, wv
                n += Di * 2 * H                                # w_if
                n += Di * D                                    # w_down
            elif k == "slstm":
                n += D                                         # ln
                n += 4 * D * D + 4 * D                         # w, b
                n += 4 * D * (D // max(H, 1))                  # r (per-head)
                n += D * D                                     # w_out
        if self.enc_dec:
            for _ in range(self.encoder_layers):
                n += D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * F + 2 * D
            # decoder cross-attention
            n += self.num_layers * (D * H * hd + 2 * D * KV * hd + H * hd * D + D)
        return n

    def active_param_count(self) -> int:
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        expert_all = (3 * self.moe.num_experts * self.d_ff_expert_total())
        expert_active = 3 * self.moe.top_k * self.moe.d_ff_expert * self.d_model
        return full - expert_all + self.num_layers * expert_active

    def d_ff_expert_total(self) -> int:
        return self.num_layers * self.d_model * self.moe.d_ff_expert


# ------------------------------------------------------------- shape tables
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: only SSM/hybrid run it (gemma2's
# global layers are full attention, so it is skipped too — see DESIGN.md).
LONG_CONTEXT_ARCHS = {"xlstm-350m", "recurrentgemma-9b"}


def cell_is_applicable(arch: str, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, ("skip: full-attention architecture — 512k dense "
                       "attention is quadratic (DESIGN.md §shape-skips)")
    return True, ""

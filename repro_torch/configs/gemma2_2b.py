"""gemma2-2b — dense LM with local/global alternating attention + softcaps.

[arXiv:2408.00118; hf]  26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000, head_dim 256, sliding window 4096 on local layers,
attention softcap 50.0, final-logit softcap 30.0.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch="gemma2-2b",
        family="dense",
        num_layers=26,
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        d_ff=9216,
        vocab=256_000,
        head_dim=256,
        logit_softcap=30.0,
        attn_softcap=50.0,
        local_window=4096,
        layer_pattern="alt_local_global",
        rope_theta=10_000.0,
        tie_embeddings=True,
        source="arXiv:2408.00118 (Gemma 2)",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="gemma2-2b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab=256,
        head_dim=16,
        logit_softcap=30.0,
        attn_softcap=50.0,
        local_window=8,
        layer_pattern="alt_local_global",
        rope_theta=10_000.0,
        tie_embeddings=True,
        attention_impl="naive",
        remat=False,
        source="reduced gemma2 family",
    )

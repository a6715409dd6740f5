"""recurrentgemma-9b — RG-LRU + local-attention hybrid, 1 attn : 2 lru
(runs long_500k).

[arXiv:2402.19427; unverified]  38L d_model=4096 16H (MQA kv=1,
head_dim 256) d_ff=12288 vocab=256000, RG-LRU width 4096, sliding
window 2048 on the attention layers.  Decode state is O(window + lru
width): attention caches are ring buffers, recurrent state is [B, W].
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        d_ff=12288,
        vocab=256_000,
        head_dim=256,
        local_window=2048,
        layer_pattern="rglru_1_2",
        recurrent="rglru",
        lru_width=4096,
        conv_width=4,
        rope_theta=10_000.0,
        tie_embeddings=True,
        source="arXiv:2402.19427 (Griffin / RecurrentGemma)",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="recurrentgemma-9b-smoke",
        family="hybrid",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        d_ff=128,
        vocab=256,
        head_dim=16,
        local_window=8,
        layer_pattern="rglru_1_2",
        recurrent="rglru",
        lru_width=64,
        conv_width=4,
        rope_theta=10_000.0,
        tie_embeddings=True,
        attention_impl="naive",
        remat=False,
        source="reduced recurrentgemma family",
    )

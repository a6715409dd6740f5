"""qwen3-1.7b — dense LM with qk-norm and GQA.

[hf:Qwen/Qwen3-8B family; hf]  28L d_model=2048 16H (GQA kv=8)
d_ff=6144 vocab=151936, head_dim 128, qk_norm, RoPE theta 1e6.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch="qwen3-1.7b",
        family="dense",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=6144,
        vocab=151_936,
        head_dim=128,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        source="hf:Qwen/Qwen3-1.7B (family card Qwen/Qwen3-8B)",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen3-1.7b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab=256,
        head_dim=16,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        attention_impl="naive",
        remat=False,
        source="reduced qwen3 family",
    )

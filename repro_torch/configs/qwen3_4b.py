"""qwen3-4b — dense LM with qk-norm and GQA.

[hf:Qwen/Qwen3-8B family; hf]  36L d_model=2560 32H (GQA kv=8)
d_ff=9728 vocab=151936, head_dim 128 (q projection 2560 -> 4096),
qk_norm, RoPE theta 1e6.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch="qwen3-4b",
        family="dense",
        num_layers=36,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        d_ff=9728,
        vocab=151_936,
        head_dim=128,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        source="hf:Qwen/Qwen3-4B (family card Qwen/Qwen3-8B)",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen3-4b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=8,
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

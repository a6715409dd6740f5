"""qwen2-vl-7b — VLM backbone (transformer only; patch frontend is a STUB).

[arXiv:2409.12191; hf]  28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, head_dim 128, M-RoPE with (t, h, w) = (16, 24, 24)
frequency-lane sections over head_dim/2 = 64.

Per the assignment, ``input_specs()`` provides precomputed patch
embeddings (``input_mode="embeds"``) plus the 3-component M-RoPE
position ids; the dynamic-resolution ViT frontend is out of scope.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab=152_064,
        head_dim=128,
        rope_theta=1_000_000.0,
        mrope=True,
        input_mode="embeds",
        tie_embeddings=False,
        source="arXiv:2409.12191 (Qwen2-VL)",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-vl-7b-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab=256,
        head_dim=16,
        rope_theta=1_000_000.0,
        mrope=True,
        input_mode="embeds",
        tie_embeddings=False,
        attention_impl="naive",
        remat=False,
        source="reduced qwen2-vl family",
    )

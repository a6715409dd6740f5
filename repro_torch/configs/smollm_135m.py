"""smollm-135m — llama-arch small dense LM.

[hf:HuggingFaceTB/SmolLM-135M; hf]  30L d_model=576 9H (GQA kv=3)
d_ff=1536 vocab=49152, head_dim 64, tied embeddings, RoPE theta 10k.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch="smollm-135m",
        family="dense",
        num_layers=30,
        d_model=576,
        num_heads=9,
        num_kv_heads=3,
        d_ff=1536,
        vocab=49152,
        head_dim=64,
        rope_theta=10_000.0,
        tie_embeddings=True,
        source="hf:HuggingFaceTB/SmolLM-135M",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="smollm-135m-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab=256,
        head_dim=16,
        rope_theta=10_000.0,
        tie_embeddings=True,
        attention_impl="naive",
        remat=False,
        source="reduced smollm family",
    )

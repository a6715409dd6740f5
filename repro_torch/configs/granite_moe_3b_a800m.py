"""granite-moe-3b-a800m — fine-grained MoE LM.

[hf:ibm-granite/granite-3.0-1b-a400m-base family; hf]  32L d_model=1536
24H (GQA kv=8, head_dim 64) d_ff_expert=512 vocab=49155, MoE with the
ASSIGNED 40 experts top-8 (the HF base card's 3b-a800m lists 40 experts).

TPU-mesh adaptation (DESIGN.md §Arch-applicability): 40 experts do not
divide the 16-wide "model" mesh axis, so the EP path pads the expert
dimension to 48 (8 zero-initialised, router-masked phantom experts);
padding is excluded from parameter counts and never routed to.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        d_ff=512,
        vocab=49155,
        head_dim=64,
        rope_theta=10_000.0,
        tie_embeddings=True,
        moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512,
                      capacity_factor=1.25, impl="ep"),
        source="hf:ibm-granite/granite-3.0-3b-a800m-base (assigned 40e top-8)",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="granite-moe-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=32,
        vocab=256,
        head_dim=16,
        rope_theta=10_000.0,
        tie_embeddings=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                      capacity_factor=2.0, impl="dense"),
        attention_impl="naive",
        remat=False,
        source="reduced granite-moe family",
    )

"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table config).

[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H (GQA kv=8)
d_ff_expert=2048 vocab=163840, MoE 384 experts top-8.

head_dim is set to 128 explicitly (7168/64 = 112 is not MXU-aligned;
DeepSeek-V3-lineage models use 128) — recorded as a hardware adaptation.
The optimizer is Adafactor: AdamW fp32 (m, v) at 1T params needs 16 TB
of state, which exceeds the 512 x 16 GiB production mesh; factored
second moments + bf16 params fit (see EXPERIMENTS.md §Dry-run).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        d_ff=2048,
        vocab=163_840,
        head_dim=128,
        qk_norm=True,
        rope_theta=50_000.0,
        tie_embeddings=False,
        moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                      capacity_factor=1.25, impl="ep"),
        optimizer="adafactor",
        source="arXiv:2501.kimi2 (paper-table; unverified)",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="kimi-k2-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=32,
        vocab=256,
        head_dim=16,
        qk_norm=True,
        rope_theta=50_000.0,
        tie_embeddings=False,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                      capacity_factor=2.0, impl="dense"),
        optimizer="adafactor",
        attention_impl="naive",
        remat=False,
        source="reduced kimi-k2 family",
    )

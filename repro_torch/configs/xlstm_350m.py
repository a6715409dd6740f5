"""xlstm-350m — attention-free sLSTM + mLSTM stack (runs long_500k).

[arXiv:2405.04517; unverified]  24L alternating mLSTM/sLSTM,
d_model=1024 4H vocab=50304, d_ff=0 (the blocks carry their own
up-projections).  O(1) decode state: mLSTM matrix memory [H, hd, hd],
sLSTM scalar memories — the 512k-context cell runs on this family.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch="xlstm-350m",
        family="ssm",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab=50304,
        head_dim=256,
        layer_pattern="xlstm_alt",
        recurrent="xlstm",
        tie_embeddings=True,
        source="arXiv:2405.04517 (xLSTM)",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="xlstm-350m-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=2,
        num_kv_heads=2,
        d_ff=0,
        vocab=256,
        head_dim=32,
        layer_pattern="xlstm_alt",
        recurrent="xlstm",
        tie_embeddings=True,
        remat=False,
        source="reduced xlstm family",
    )

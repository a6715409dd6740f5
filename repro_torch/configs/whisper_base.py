"""whisper-base — encoder-decoder audio backbone (conv frontend is a STUB).

[arXiv:2212.04356; unverified]  6L encoder + 6L decoder, d_model=512,
8H (MHA, kv=8) d_ff=2048 vocab=51865, encoder_seq 1500 (30 s of audio
at 2x-downsampled 10 ms frames).

Per the assignment, ``input_specs()`` provides precomputed frame
embeddings for the encoder (the mel+conv frontend is stubbed).  RoPE is
used instead of Whisper's learned absolute positions (recorded as an
adaptation; the checkpointing technique is insensitive to it).

NOTE: vocab 51865 is odd (not divisible by the 16-wide model axis), so
the sharding rules replicate the vocab dim and shard the embed dim
instead — a per-arch rule-table entry, not a code change.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch="whisper-base",
        family="audio",
        num_layers=6,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        d_ff=2048,
        vocab=51865,
        head_dim=64,
        rope_theta=10_000.0,
        tie_embeddings=True,
        enc_dec=True,
        encoder_layers=6,
        encoder_seq=1500,
        input_mode="tokens",        # decoder side consumes tokens
        source="arXiv:2212.04356 (Whisper)",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="whisper-base-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab=256,
        head_dim=16,
        rope_theta=10_000.0,
        tie_embeddings=True,
        enc_dec=True,
        encoder_layers=2,
        encoder_seq=16,
        attention_impl="naive",
        remat=False,
        source="reduced whisper family",
    )

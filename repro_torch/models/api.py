"""Common model interface of the port, the counterpart of the JAX package's
``models/api.py``: parameter specs with the reference's names, shapes and
dtypes, and the training loss and serving functions over a flat
``dict[str, Tensor]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis names
    dtype: str = "bfloat16"
    init: str = "normal"                   # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


@dataclasses.dataclass(frozen=True)
class TorchModelApi:
    cfg: ModelConfig
    param_specs: dict[str, ParamSpec]
    prefill: Callable                # (params, batch, Smax) -> (logits, cache)
    decode_step: Callable            # (params, cache, batch) -> (logits, cache)
    cache_specs: Callable            # (batch, seq) -> {name: BatchSpec}
    cache_axes: Callable             # () -> {name: logical axes tuple}
    # (params, batch) -> (loss, metrics); None where training is not ported
    loss: Callable | None = None
    input_specs: Callable | None = None   # ShapeConfig -> {name: BatchSpec}
    # () -> the parameters the loss and prefill take as this process's part
    # of their split over the installed context's model axis; None for a
    # family whose compute repeats over that axis
    split_params: Callable | None = None

    def init(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """Random parameters on the generator's device: the reference's
        recipe (sorted names; normal(0, scale) drawn in f32, then cast), but
        torch's numbers — ``jax.random`` cannot be reproduced, so tests load
        the reference's init through ``convert.params_from_jax`` instead."""
        return dict(self.init_each(generator))

    def init_each(self, generator: torch.Generator):
        """``init``'s (name, parameter) pairs one at a time, in its order
        and with its draws: a caller that keeps a part of each holds one
        whole parameter at a time."""
        device = generator.device
        for name, spec in sorted(self.param_specs.items()):
            dtype = getattr(torch, spec.dtype)
            if spec.init == "zeros":
                yield name, torch.zeros(spec.shape, dtype=dtype, device=device)
            elif spec.init == "ones":
                yield name, torch.ones(spec.shape, dtype=dtype, device=device)
            else:
                yield name, (spec.scale * torch.randn(
                    spec.shape, generator=generator, dtype=torch.float32,
                    device=device)).to(dtype)

    def abstract_params(self) -> dict[str, torch.Tensor]:
        """Shape-and-dtype stand-ins on the ``meta`` device (no memory)."""
        return {name: torch.empty(spec.shape, dtype=getattr(torch, spec.dtype),
                                  device="meta")
                for name, spec in self.param_specs.items()}

    def abstract_cache(self, B: int, Smax: int) -> dict[str, torch.Tensor]:
        """The serving cache's stand-ins on the ``meta`` device (a restore's
        target)."""
        return {name: torch.empty(spec.shape, dtype=getattr(torch, spec.dtype),
                                  device="meta")
                for name, spec in self.cache_specs(B, Smax).items()}


def build_model(cfg: ModelConfig) -> TorchModelApi:
    """The model of ``cfg``, dispatched as the reference's ``build_model``:
    the RG-LRU hybrid, xLSTM, the encoder-decoder (whisper), else the
    decoder-only transformer (dense and MoE FFNs, and the VLM backbone on
    embeddings input)."""
    if cfg.recurrent == "rglru":
        from repro_torch.models import rglru
        return rglru.build(cfg)
    if cfg.recurrent == "xlstm":
        from repro_torch.models import xlstm
        return xlstm.build(cfg)
    if cfg.enc_dec:
        from repro_torch.models import whisper
        return whisper.build(cfg)
    from repro_torch.models import transformer
    return transformer.build(cfg)


# ----------------------------------------------------------- input helpers
@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """Shape and dtype name of one input (``jax.ShapeDtypeStruct``'s role)."""
    shape: tuple[int, ...]
    dtype: str


def token_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Stand-ins for a step's inputs (no allocation), in the reference's
    order — ``make_token_batch`` draws from its generator in this order."""
    B, S = shape.global_batch, shape.seq_len
    sds = BatchSpec
    if shape.kind == "train":
        if cfg.input_mode == "embeds":
            batch = {"embeds": sds((B, S, cfg.d_model), cfg.dtype),
                     "targets": sds((B, S), "int32"),
                     "mask": sds((B, S), "float32")}
            if cfg.mrope:
                batch["positions"] = sds((B, S, 3), "int32")
            else:
                batch["positions"] = sds((B, S), "int32")
        else:
            batch = {"tokens": sds((B, S), "int32"),
                     "targets": sds((B, S), "int32"),
                     "mask": sds((B, S), "float32")}
        if cfg.enc_dec:
            batch["enc_frames"] = sds((B, cfg.encoder_seq, cfg.d_model),
                                      cfg.dtype)
        return batch
    if shape.kind == "prefill":
        if cfg.input_mode == "embeds":
            batch = {"embeds": sds((B, S, cfg.d_model), cfg.dtype)}
            batch["positions"] = sds((B, S, 3) if cfg.mrope else (B, S),
                                     "int32")
        else:
            batch = {"tokens": sds((B, S), "int32")}
        if cfg.enc_dec:
            batch["enc_frames"] = sds((B, cfg.encoder_seq, cfg.d_model),
                                      cfg.dtype)
        return batch
    # decode: one new token against a cache of seq_len
    batch = {"token": sds((B, 1), "int32"),
             "pos": sds((B,), "int32")}
    return batch


def make_token_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0
                     ) -> dict[str, np.ndarray]:
    """Concrete random batch matching token_batch_specs (NumPy; the same
    arrays as the reference's for the same seed)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in token_batch_specs(cfg, shape).items():
        if s.dtype in ("int32", "int64"):
            hi = cfg.vocab if k in ("tokens", "targets", "token") else 64
            out[k] = rng.integers(0, max(hi, 2), s.shape).astype(np.int32)
        elif k == "mask":
            out[k] = np.ones(s.shape, dtype=np.float32)
        else:
            out[k] = rng.normal(size=s.shape, scale=0.5).astype("float32")
    return out

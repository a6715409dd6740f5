#!/usr/bin/env python3
"""xlstm-350m's bf16-to-f32 distance in each package, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/xlstm_bf16_distance.py [--smoke]
        [--batch 1] [--seq 128] [--depths N [N ...]]

Builds the full xlstm-350m config (24 layers, D 1,024, vocab 50,304; its
smoke config with ``--smoke``) in the JAX package and in the port, with the reference's parameters from
``key(0)`` (bf16, brought over by ``params_from_jax``), and runs one
prefill of B x S seeded tokens in each package twice: with the bf16
parameters under ``dtype="bfloat16"``, and with the same parameters cast
to f32 under ``dtype="float32"``.  Prints one JSON line: each package's
bf16-to-f32 distance of the logits (max |bf16 - f32| over max |f32|), the
two packages' f32 logits against each other and their bf16 logits
against each other, on the same scale.  ``--depths`` adds the same
readings with the depth cut to each n given (the first n layers, then the
final norm and the unembedding), to find the first layer where the
packages part.
Imports JAX, so it runs where the reference does (this is not a port
module); takes a few minutes and a few GB of host memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--depths", type=int, nargs="*", default=[])
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_config, get_smoke_config
    from repro.models.api import build_model
    from repro_torch.configs import get_config as torch_get_config
    from repro_torch.configs import get_smoke_config as torch_smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models.api import build_model as torch_build_model

    rng = np.random.default_rng(0)
    cfg = (get_smoke_config if args.smoke else get_config)("xlstm_350m")
    tokens = rng.integers(0, cfg.vocab, size=(args.batch, args.seq),
                          dtype=np.int32)
    params16 = build_model(dataclasses.replace(cfg, dtype="bfloat16")).init(
        jax.random.key(0))
    host16 = {k: np.asarray(v) for k, v in params16.items()}
    del params16

    def run(dtype: str, layers: int | None = None):
        """(reference, port) prefill logits as f32 NumPy, of the whole
        model or of its first ``layers`` layers."""
        kw = dict(dtype=dtype) if layers is None else dict(
            dtype=dtype, num_layers=layers)
        api = build_model(dataclasses.replace(cfg, **kw))
        tapi = torch_build_model(dataclasses.replace(
            (torch_smoke_config if args.smoke else torch_get_config)(
                "xlstm_350m"), **kw))
        jp = {k: jnp.asarray(v[tuple(slice(0, n) for n in spec.shape)],
                             dtype)
              for k, v in host16.items()
              for spec in [api.param_specs[k]]}
        tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                             device="cpu")
        ref, _ = jax.jit(api.prefill)(jp, {"tokens": tokens})
        with torch.no_grad():
            got, _ = tapi.prefill(tp, {"tokens": torch.from_numpy(tokens)})
        return (np.asarray(jnp.asarray(ref, jnp.float32)),
                got.float().numpy())

    def readings(r16, t16, r32, t32) -> dict:
        scale = float(np.abs(r32).max())

        def rel(x, y):
            return float(np.abs(x - y).max()) / scale
        return {"reference_bf16_vs_f32": rel(r16, r32),
                "port_bf16_vs_f32": rel(t16, t32),
                "packages_f32": rel(t32, r32),
                "packages_bf16": rel(t16, r16), "scale": scale}

    r16, t16 = run("bfloat16")
    r32, t32 = run("float32")
    line = {"arch": cfg.arch, "batch": args.batch, "seq": args.seq,
            "device": "cpu", "logits": readings(r16, t16, r32, t32)}
    line["logits_by_depth"] = {
        n: readings(*run("bfloat16", n), *run("float32", n))
        for n in args.depths}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

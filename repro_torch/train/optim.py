"""Optimizers over the flat train state, the counterpart of the JAX
package's ``train/optim.py`` (no ``torch.optim``: the state is named slots
that the N-to-M checkpointer saves like parameters).

An optimizer exposes:

  * ``state_specs(param_specs)`` — ParamSpec metadata for every state slot
    (flat ``"slot/param_name"`` keys, the reference's names);
  * ``init(param_specs, device)`` — concrete zero state;
  * ``update(params, grads, state, lr, step)`` — returns (new_params,
    new_state), computed in float32 in the reference's order.

AdamW keeps float32 (m, v).  Adafactor is not ported yet: it serves kimi-k2
only, whose MoE layers are not ported either.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.api import ParamSpec

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    name = "adamw"

    def state_specs(self, param_specs: dict[str, ParamSpec]
                    ) -> dict[str, ParamSpec]:
        out: dict[str, ParamSpec] = {}
        for n, s in param_specs.items():
            out[f"m/{n}"] = ParamSpec(s.shape, s.axes, "float32", init="zeros")
            out[f"v/{n}"] = ParamSpec(s.shape, s.axes, "float32", init="zeros")
        return out

    def init(self, param_specs: dict[str, ParamSpec], device="cpu"):
        return {k: torch.zeros(s.shape, dtype=F32, device=device)
                for k, s in self.state_specs(param_specs).items()}

    def update(self, params, grads, state, lr, step):
        t = (step + 1).to(F32)
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t
        new_p, new_s = {}, {}
        for n, p in params.items():
            g = grads[n].to(F32)
            m = self.b1 * state[f"m/{n}"] + (1 - self.b1) * g
            v = self.b2 * state[f"v/{n}"] + (1 - self.b2) * g * g
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            upd = upd + self.weight_decay * p.to(F32)
            new_p[n] = (p.to(F32) - lr * upd).to(p.dtype)
            new_s[f"m/{n}"] = m
            new_s[f"v/{n}"] = v
        return new_p, new_s


def make_optimizer(name: str):
    if name == "adamw":
        return AdamW()
    if name == "adafactor":
        raise NotImplementedError(
            "Adafactor is not ported yet: it serves kimi-k2 only, whose MoE "
            "layers are not ported either (ROADMAP.md, Queue 1)")
    raise ValueError(name)

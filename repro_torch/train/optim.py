"""Optimizers over the flat train state, the counterpart of the JAX
package's ``train/optim.py`` (no ``torch.optim``: the state is named slots
that the N-to-M checkpointer saves like parameters).

An optimizer exposes:

  * ``state_specs(param_specs)`` — ParamSpec metadata for every state slot
    (flat ``"slot/param_name"`` keys, the reference's names);
  * ``init(param_specs, device)`` — concrete zero state;
  * ``update(params, grads, state, lr, step)`` — returns (new_params,
    new_state), computed in float32 in the reference's order.

AdamW keeps float32 (m, v) and updates each element alone
(``elementwise``), so a sharded step applies it to each process's shard.
Adafactor keeps factored float32 second moments (row and column means,
``vr/`` and ``vc/``; ``v/`` for a vector) and scales each update by
reductions over a whole parameter, or over each leading slice of a
layer-stacked one: it is not elementwise.  A sharded step applies it to
each process's shard too, and tells it which mesh groups split which dims
of each parameter (``update(..., splits=)``): every reduction over such a
dim is the local sum added over those groups (``collectives.all_sum``, in
f32 in rank order, so every process of a group gets the same bits), over
the global count.  A reduction over dims that no group splits is the
plain ``torch.mean``, so one process, or a (1, 1) mesh, computes the
one-device update bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distrib.collectives import all_sum, group_size
from repro_torch.models.api import ParamSpec

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    name = "adamw"
    elementwise = True

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


def _mean(x, dim, split, keepdim: bool = False):
    """``x.mean(dim)`` (the whole of ``x`` for ``dim`` None).  ``split``
    maps dims of ``x`` (non-negative) to the mesh groups that split them;
    where it names a dim reduced here, ``x`` is this process's part and the
    mean is its local sum added over those groups, over the global
    count."""
    over = range(x.dim()) if dim is None else (dim % x.dim(),)
    groups = [g for d in over for g in split.get(d, ())]
    if not groups:
        return x.mean() if dim is None else x.mean(dim, keepdim=keepdim)
    total = x.sum() if dim is None else x.sum(dim, keepdim=keepdim)
    count = math.prod(x.shape[d] for d in over)
    for g in groups:
        total = all_sum(total, g)
        count *= group_size(g)
    return total / count


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Shazeer & Stern (2018): factored second moments, no first moment,
    update clipping, relative step scaling.  The reference's slots, order
    of operations and per-slice updates; its reductions are XLA's, so an
    update matches within f32 rounding, not bit for bit."""

    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_threshold: float = 1.0
    decay_pow: float = 0.8

    name = "adafactor"
    elementwise = False

    def _factored(self, shape) -> bool:
        return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1

    def state_specs(self, param_specs: dict[str, ParamSpec]
                    ) -> dict[str, ParamSpec]:
        out: dict[str, ParamSpec] = {}
        for n, s in param_specs.items():
            if self._factored(s.shape):
                out[f"vr/{n}"] = ParamSpec(s.shape[:-1], s.axes[:-1],
                                           "float32", init="zeros")
                out[f"vc/{n}"] = ParamSpec(s.shape[:-2] + s.shape[-1:],
                                           s.axes[:-2] + s.axes[-1:],
                                           "float32", init="zeros")
            else:
                out[f"v/{n}"] = ParamSpec(s.shape, s.axes, "float32",
                                          init="zeros")
        return out

    def init(self, param_specs: dict[str, ParamSpec], device="cpu"):
        return {k: torch.zeros(s.shape, dtype=F32, device=device)
                for k, s in self.state_specs(param_specs).items()}

    def decay(self, step) -> torch.Tensor:
        """f32 ``1 - (step + 1) ** -decay_pow``, as XLA computes it: the
        exponent rounded to f32 (the reference's weakly typed constant),
        the power in f64 rounded once to f32 (``_rope_freq``'s way).  With
        the exponent left in f64, 5 of steps 0-99 land an ulp off."""
        t = (step + 1).to(F32)
        expo = torch.tensor(-self.decay_pow, dtype=F32).item()
        return 1.0 - (t.double() ** expo).float()

    def _one(self, p, g, vr, vc, v, lr, decay, split=None):
        """One parameter's update in f32; returns (p', vr', vc', v').
        ``split``: {dim of p: mesh groups} where ``p`` is this process's
        part (see :func:`_mean`); ``vr`` and ``vc`` are then its parts of
        the slots, whose dims are p's with one dropped."""
        split = split or {}
        g = g.to(F32)
        g2 = g * g + self.eps1
        if vr is not None:
            vr = decay * vr + (1 - decay) * _mean(g2, -1, split)
            vc = decay * vc + (1 - decay) * _mean(g2, -2, split)
            denom = (vr / torch.clamp(_mean(vr, -1, split, keepdim=True),
                                      min=self.eps1))[..., None] \
                * vc[..., None, :]
            u = g / torch.sqrt(denom + self.eps1)
        else:
            v = decay * v + (1 - decay) * g2
            u = g / torch.sqrt(v + self.eps1)
        rms_u = torch.sqrt(_mean(u * u, None, split) + self.eps1)
        u = u / torch.clamp(rms_u / self.clip_threshold, min=1.0)
        scale = torch.clamp(torch.sqrt(_mean(p.to(F32) ** 2, None, split)),
                            min=self.eps2)
        new_p = (p.to(F32) - lr * scale * u).to(p.dtype)
        return new_p, vr, vc, v

    def update(self, params, grads, state, lr, step, splits=None):
        """``splits``: {name: {dim: mesh groups}} for the parameters of
        which ``params`` holds this process's part (the sharded step's
        local shards), each dim split over those groups; the slots in
        ``state`` are then this process's parts as well."""
        decay = self.decay(step)
        new_p, new_s = {}, {}
        for n, p in params.items():
            g = grads[n]
            split = (splits or {}).get(n, {})
            shape = [s * math.prod(group_size(x) for x in split.get(d, ()))
                     for d, s in enumerate(p.shape)]
            factored = self._factored(shape)
            vr = state.get(f"vr/{n}") if factored else None
            vc = state.get(f"vc/{n}") if factored else None
            v = state.get(f"v/{n}") if not factored else None
            if len(shape) >= 3 and shape[0] > 1 and factored:
                # a layer-stacked parameter: one leading slice at a time,
                # each its own parameter (per-slice RMS clip and scale), as
                # the reference's scan over the slices; no mesh splits the
                # layers, so a slice's dims are the next ones
                if 0 in split:
                    raise NotImplementedError(
                        f"{n}: its layer dim is split over a mesh axis")
                inner = {d - 1: gs for d, gs in split.items()}
                outs = [self._one(p[i], g[i], vr[i], vc[i], None, lr, decay,
                                  inner)
                        for i in range(p.shape[0])]
                new_p[n] = torch.stack([o[0] for o in outs])
                new_s[f"vr/{n}"] = torch.stack([o[1] for o in outs])
                new_s[f"vc/{n}"] = torch.stack([o[2] for o in outs])
            else:
                np_, nvr, nvc, nv = self._one(p, g, vr, vc, v, lr, decay,
                                              split)
                new_p[n] = np_
                if factored:
                    new_s[f"vr/{n}"] = nvr
                    new_s[f"vc/{n}"] = nvc
                else:
                    new_s[f"v/{n}"] = nv
        return new_p, new_s


def make_optimizer(name: str):
    if name == "adamw":
        return AdamW()
    if name == "adafactor":
        return Adafactor()
    raise ValueError(name)

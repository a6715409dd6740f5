"""Continuous-batching serving engine (transformer / KV-cache families), the
counterpart of the JAX package's ``serve/engine.py``.

Requests arrive at any time; the engine keeps a fixed pool of B cache
slots.  A free slot admits the next queued request by running a B=1
prefill and splicing its K/V into the batched cache at the slot index;
all active slots then decode TOGETHER, each writing its own cache
position (per-slot length vectors — see transformer.decode_step).
Finished sequences (max_new reached or EOS) free their slot immediately,
so long and short requests share a batch without head-of-line blocking.

The batched cache lives on the parameters' device and is updated in place:
the splice copies the prefill's K/V into the slot's rows, and each decode
step writes the new token's K/V into its slot's next position.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class TorchRequest:
    rid: int
    prompt: np.ndarray                 # [P] int32
    max_new: int
    eos_id: int | None = None
    generated: list = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_new:
            return True
        return (self.eos_id is not None and self.generated
                and self.generated[-1] == self.eos_id)


class TorchServeEngine:
    def __init__(self, api, params, *, slots: int, max_seq: int):
        self.api = api
        self.cfg: ModelConfig = api.cfg
        self.params = params
        self.device = params["embed"].device
        self.B = slots
        self.max_seq = max_seq
        self.queue: list[TorchRequest] = []
        self.active: list[TorchRequest | None] = [None] * slots
        self.finished: list[TorchRequest] = []

        # batched cache with PER-SLOT lengths
        c_specs = api.cache_specs(slots, max_seq)
        other = sorted(set(c_specs) - {"k", "v", "length"})
        if other:
            # the splice moves k and v only: a recurrent state (h, conv)
            # would stay zero and the slot would decode wrong tokens
            raise ValueError(
                f"{self.cfg.arch}: TorchServeEngine serves KV-cache families "
                f"only; the cache also holds {other}")
        self.cache = {k: torch.zeros(s.shape, dtype=getattr(torch, s.dtype),
                                     device=self.device)
                      for k, s in c_specs.items() if k != "length"}
        self.cache["length"] = torch.zeros(slots, dtype=torch.int32,
                                           device=self.device)

    # ----------------------------------------------------------------- api
    def submit(self, rid: int, prompt: np.ndarray, max_new: int,
               eos_id: int | None = None):
        self.queue.append(TorchRequest(rid, np.asarray(prompt, np.int32),
                                       max_new, eos_id))

    def _admit(self):
        for slot in range(self.B):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            P = len(req.prompt)
            tokens = torch.from_numpy(req.prompt[None, :]).to(self.device)
            logits, one = self.api.prefill(self.params, {"tokens": tokens},
                                           self.max_seq)
            # splice: one[key] [L, 1, S, KV, hd] -> slot row of [L, B, S, KV, hd]
            for key in ("k", "v"):
                self.cache[key][:, slot] = one[key][:, 0]
            self.cache["length"][slot] = P
            req.generated.append(int(torch.argmax(logits[0])))
            self.active[slot] = req

    def step(self) -> int:
        """Admit + one batched decode step; returns #active sequences."""
        self._admit()
        act = [i for i, r in enumerate(self.active) if r is not None]
        if not act:
            return 0
        tok = np.zeros((self.B, 1), np.int32)
        for i in act:
            tok[i, 0] = self.active[i].generated[-1]
        pos = self.cache["length"].clone()
        logits, self.cache = self.api.decode_step(
            self.params, self.cache,
            {"token": torch.from_numpy(tok).to(self.device), "pos": pos})
        nxt = torch.argmax(logits, dim=-1).tolist()
        lengths = self.cache["length"].tolist()
        for i in act:
            req = self.active[i]
            req.generated.append(int(nxt[i]))
            if req.done or lengths[i] + 1 >= self.max_seq:
                req.generated = req.generated[:req.max_new]
                self.finished.append(req)
                self.active[i] = None          # slot freed immediately
        # idle slots decode too (their outputs are ignored); hold their
        # lengths at 0 so their writes stay inside the cache (the
        # reference's scatter drops out-of-range writes instead)
        idle = [i for i, r in enumerate(self.active) if r is None]
        if idle:
            self.cache["length"][idle] = 0
        return len(act)

    def run(self) -> dict[int, list[int]]:
        """Drain queue + active slots; returns rid -> generated tokens."""
        while self.queue or any(r is not None for r in self.active):
            self.step()
        return {r.rid: r.generated[:r.max_new] for r in self.finished}

"""Perf-iteration state: per-(arch, shape, mesh) rule overrides and step
knobs.

THIS FILE IS THE HILLCLIMB LOG'S EXECUTABLE HALF — every entry here maps
to a hypothesis -> change -> before/after record in EXPERIMENTS.md §Perf.
Empty tables == paper-faithful baseline.

Keys are (arch_id, shape_name, mesh_tag) with mesh_tag in
{"single", "multi", "*"}.  Mesh-keying exists because iteration 1
REFUTED mesh-blind overrides: pure-DP at 512 chips with global batch 256
is not divisible, and the divisibility fallback silently replicated the
batch (temp 606 GiB/device) — see EXPERIMENTS.md §Perf P2.b.
"""

from __future__ import annotations

RULE_OVERRIDES: dict[tuple[str, str, str], dict] = {
    # P2: smollm-135m is 135M params — 16-way TP serves no purpose and
    # every layer pays 2 bf16 activation all-reduces.  Pure 256-way DP
    # (batch over data AND model) + 16-way ZeRO-3 on the embed dim kills
    # the TP collectives and shrinks per-device activations 16x.
    # SINGLE-POD ONLY: 512 chips > batch 256 (refuted at multi, P2.b).
    ("smollm-135m", "train_4k", "single"): {
        "batch": ("data", "model"),
        "heads": None, "kv_heads": None, "mlp": None, "vocab": None,
        "embed": "model",
    },
    # P3: recurrentgemma-9b, same trade at 9B — and ZeRO-3 over the FULL
    # 256-chip mesh (embed dim 4096 divides 256) so AdamW's fp32 (m, v)
    # shard 256-way instead of 16-way (iteration P3.b: 16-way left
    # 4.7 GiB/device of optimizer state).
    # P3.c: "mlp": None left the lru w_a/w_i (2 x W^2 per layer) and
    # their fp32 AdamW moments REPLICATED (args 13.1 -> 8.4 GiB after
    # P3.b).  Weight-only dims must keep a ZeRO target even when TP is
    # off: map both embed and mlp to the full 256-way (model, data) —
    # activation hints drop them anyway (batch consumes both axes).
    ("recurrentgemma-9b", "train_4k", "single"): {
        "batch": ("data", "model"),
        "heads": None, "kv_heads": None, "vocab": None,
        "mlp": ("model", "data"),
        "embed": ("model", "data"),
    },
    # P1: kimi-k2 1T CANNOT train on one pod (bf16 params + grads alone
    # are 15.6 GiB/chip at 256 chips) — single-pod stays baseline and is
    # reported infeasible.  Multi-pod: ZeRO-3 over BOTH the data and pod
    # axes -> 3.9 GiB params + 3.9 GiB grad accumulators per chip.
    ("kimi-k2-1t-a32b", "train_4k", "multi"): {
        "embed": ("data", "pod"),
        "expert_in": ("data", "pod"),
    },
    # P4 (bonus, beyond the three assigned cells): qwen3-1.7b gets the
    # generalized P2/P3 medicine — models under ~10B at batch >= chips
    # should be DP+ZeRO, not TP-16.  embed 2048 and mlp 6144 both divide
    # 256, so ZeRO-3 runs over the full mesh.
    ("qwen3-1.7b", "train_4k", "single"): {
        "batch": ("data", "model"),
        "heads": None, "kv_heads": None, "vocab": None,
        "mlp": ("model", "data"),
        "embed": ("model", "data"),
    },
}

STEP_KNOBS: dict[tuple[str, str, str], dict] = {
    # P1.b: 8 grad-accumulation microbatches shrink remat carries 8x but
    # re-run the per-layer ZeRO-3 expert gathers A times (coll 2.5
    # TB/device).  P1.c (group remat) REFUTED: the un-remat'd inner scan
    # kept 8 layers of residuals live during each group's backward (temp
    # 274 GiB).  P1.d: microbatches=8 + per-layer-scanned Adafactor
    # update (fp32 optimizer temporaries shrink 61x) is the combination
    # that fits; the A-fold gather traffic is the recorded price.
    ("kimi-k2-1t-a32b", "train_4k", "multi"): {"microbatches": 8},
}


def _get(table: dict, arch: str, shape_name: str, mesh_tag: str) -> dict:
    out: dict = {}
    out.update(table.get((arch, shape_name, "*"), {}))
    out.update(table.get((arch, shape_name, mesh_tag), {}))
    return out


def rule_overrides(arch: str, shape_name: str, mesh_tag: str) -> dict:
    return _get(RULE_OVERRIDES, arch, shape_name, mesh_tag)


def step_knobs(arch: str, shape_name: str, mesh_tag: str) -> dict:
    return _get(STEP_KNOBS, arch, shape_name, mesh_tag)

"""The H100 roofline of the port's dry run (``launch/dryrun.py``), the
counterpart of the JAX package's ``benchmarks/roofline.py`` (which holds
TPU v5e's peaks).

Per (arch x shape x mesh) record, from the per-device FLOPs and bytes
that the dry run counted on ``meta`` tensors:

    compute term = FLOPs / peak       (989 TFLOP/s, bf16 dense)
    memory term  = bytes / HBM rate   (3.35 TB/s)
    bound        = the larger of the two, named as the binding term

with the useful-compute fraction model_flops / (FLOPs x chips) beside it
and whether the device's state fits the card's 80 GB.  The peaks are
NVIDIA's published ones for the H100 SXM at its 700 W power limit; a card
set lower runs slower under load.  The bound is the least time the card
could take for what one process computes: the records come from the CPU,
and no number here is a chip time.

    python -m repro_torch.launch.roofline [--mesh single|multi|both]
"""

from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch.dryrun import DEVICE_BYTES, RESULTS

PEAK_FLOPS = 989e12          # bf16 dense, per card
HBM_BW = 3.35e12             # bytes/s per card
CARD = ("NVIDIA H100 SXM (H100 80GB HBM3), power limit 700 W: 989 TFLOP/s "
        "bf16 dense, 3.35 TB/s HBM3, 80 GB")


def load_cells(mesh: str = "single", results: pathlib.Path = RESULTS
               ) -> list[dict]:
    d = results / mesh
    return [json.loads(p.read_text()) for p in sorted(d.glob("*.json"))] \
        if d.exists() else []


def terms(rec: dict) -> dict | None:
    """The roofline of one counted record; None for a skipped cell or a
    null count."""
    if rec.get("status") != "ok" or rec.get("flops") is None:
        return None
    compute = rec["flops"] / PEAK_FLOPS
    memory = rec["bytes"] / HBM_BW
    return {"compute_s": compute, "memory_s": memory,
            "bound_s": max(compute, memory),
            "binding": "compute" if compute >= memory else "memory",
            "useful_flops_frac": rec["model_flops"]
            / max(rec["flops"] * rec["chips"], 1.0)}


def table(mesh: str = "single", results: pathlib.Path = RESULTS
          ) -> tuple[list[dict], str]:
    """(rows, markdown): one row per record, skipped and null ones
    included."""
    recs = sorted(load_cells(mesh, results),
                  key=lambda r: (r["arch"], r["shape"]))
    lines = [
        f"### H100 roofline of the dry run ({mesh} mesh)",
        "",
        f"Peaks: {CARD}.  Per-device FLOPs and bytes counted on `meta` "
        f"tensors on the CPU (`repro_torch/launch/dryrun.py`): no chip time.",
        "",
        "| arch | shape | params | model FLOPs | state GB/device | fits 80 GB "
        "| FLOPs/device | bytes/device | compute s | memory s | bound s "
        "| binding | useful FLOPs |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    rows = []
    for r in recs:
        head = f"| {r['arch']} | {r['shape']} | {r['params']:,} " \
               f"| {r['model_flops']:.3e} "
        if r["status"] == "skip":
            lines.append(head + "| | | | | | | | skip: full attention | |")
            continue
        state = (f"| {r['state_bytes_per_device'] / 1e9:.3f} "
                 f"| {'yes' if r['state_bytes_per_device'] <= DEVICE_BYTES else 'no'} ")
        t = terms(r)
        if t is None:
            lines.append(head + state + "| null | null | | | | "
                         f"not counted: {r.get('null_reason', '')} | |")
            continue
        rows.append({**r, **t})
        lines.append(head + state
                     + f"| {r['flops']:.3e} | {r['bytes']:.3e} "
                     f"| {t['compute_s']:.4g} | {t['memory_s']:.4g} "
                     f"| {t['bound_s']:.4g} | {t['binding']} "
                     f"| {t['useful_flops_frac']:.3f} |")
    return rows, "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description="H100 roofline of the dry run")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--results", default=str(RESULTS))
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for mesh in meshes:
        recs = load_cells(mesh, pathlib.Path(args.results))
        if recs:
            print(table(mesh, pathlib.Path(args.results))[1])
            print()


if __name__ == "__main__":
    main()

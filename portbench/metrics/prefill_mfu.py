"""Model FLOPs of the window's prefills (``yardstick.prefill_flops`` of each
prompt) over the window's seconds times the card's published bf16 peak,
in %."""

from portbench import yardstick


def read(run):
    if not run.facts.get("prefills") or run.window_s <= 0:
        return None
    return (100.0 * run.facts["model_flops"]
            / (run.window_s * yardstick.PEAK_BF16_FLOPS))

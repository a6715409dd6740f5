"""Model FLOPs of the window's training steps (``yardstick.train_step_flops``)
over the window's seconds times the card's published bf16 peak, in %."""

from portbench import yardstick


def read(run):
    if "steps" not in run.facts or run.window_s <= 0:
        return None
    return (100.0 * run.facts["model_flops"]
            / (run.window_s * yardstick.PEAK_BF16_FLOPS))

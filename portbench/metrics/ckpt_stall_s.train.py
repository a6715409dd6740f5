"""The seconds the training loop is blocked by the window's save: the
``seconds`` of the trainer's own ``save_log`` entry for it (snapshot and
hand-off to the writer), the card idle when it starts (one sample a run)."""


def read(run):
    return run.facts.get("ckpt_stall_s")

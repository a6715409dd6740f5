"""The async writer's own seconds for the window's save: the program's
``AsyncCheckpointer.job_log`` entries of that step (open, state, commit)."""


def read(run):
    return run.facts.get("ckpt_writer_s")

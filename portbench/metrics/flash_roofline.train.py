"""The flash attention kernels' share of their roofline in the training
window: for every forward launch (``flash_fwd_kernel``) and every backward
call (``flash_bwd_dq_kernel``, one a call) the least time the chip could
take at the step's shape, over the device time of the forward and backward
kernels (``flash_fwd_kernel``, ``flash_bwd_*``) in the trace, in %."""

from portbench import yardstick


def read(run):
    t = run.trace_data
    if t is None or "steps" not in run.facts:
        return None
    fwd, bwd = t.kernels("flash_fwd_kernel"), t.kernels("flash_bwd_dq_kernel")
    spent = t.seconds("flash_fwd_kernel", "flash_bwd_")
    if not fwd or spent <= 0:
        return None
    s, B, S = run.facts["shape"], run.facts["batch"], run.facts["seq"]
    least = (len(fwd) * yardstick.roofline_seconds(
                 *yardstick.flash_fwd_work(s, B, S))
             + len(bwd) * yardstick.roofline_seconds(
                 *yardstick.flash_bwd_work(s, B, S)))
    return 100.0 * least / spent

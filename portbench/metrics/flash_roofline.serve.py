"""The flash attention forward's share of its roofline in the serving
window: the least time of one B 1 causal forward at each prefilled prompt's
length, times the launches each prefill made (the trace's
``flash_fwd_kernel`` launches over the window's prefills, which must
divide evenly), over those launches' device time, in %."""

from portbench import yardstick


def read(run):
    t, lengths = run.trace_data, run.facts.get("prefills")
    if t is None or not lengths:
        return None
    fwd = t.kernels("flash_fwd_kernel")
    spent = t.seconds("flash_fwd_kernel")
    if not fwd or spent <= 0 or len(fwd) % len(lengths):
        return None
    s, per = run.facts["shape"], len(fwd) // len(lengths)
    least = per * sum(yardstick.roofline_seconds(
        *yardstick.flash_fwd_work(s, 1, P)) for P in lengths)
    return 100.0 * least / spent

"""The ``ckpt_pack`` kernel's share of its roofline in the window's save:
every byte of the train state read once and written once
(``yardstick.pack_bytes``) at the card's published HBM bandwidth, over the
kernel's device time in the trace, in %."""

from portbench import yardstick


def read(run):
    t, nbytes = run.trace_data, run.facts.get("state_bytes")
    if t is None or not nbytes:
        return None
    spent = t.seconds("ckpt_pack_kernel")
    if spent <= 0:
        return None
    return (100.0 * yardstick.pack_bytes(nbytes)
            / yardstick.PEAK_HBM_BYTES_PER_S / spent)

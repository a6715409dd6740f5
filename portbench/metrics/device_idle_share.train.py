"""The share of the traced training window in which no operation ran on the
card: 1 - the union of the device's kernel, copy and fill intervals over the
window's span, in % (``Trace.idle_share``)."""


def read(run):
    return None if run.trace_data is None else run.trace_data.idle_share()

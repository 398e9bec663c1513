"""Share of the traced segment in which no operation ran on the card:
100 (1 - busy / window), busy the union of the trace's kernel, copy and
set intervals.  Returns nothing without a device trace."""


def read(run, args):
    tr = run.trace
    if tr is None or tr.busy_s() <= 0 or tr.window_s() <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())

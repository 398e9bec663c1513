"""Device operations a forward launches: the kernel, copy and set events
that start inside the traced segment's window, over the program's
``model.forward`` spans recorded in the segment (``args["span"]``).

Everything the segment enqueues counts, not only the model's: in a served
cell each frame's copy in, served sum, cast and copy out are in it too.
The sink is ``program_span_ms``'s, installed once a run.  Returns nothing
without a device trace, or where the program recorded no such span.
"""

from perfbench.readers.program_span_ms import install  # noqa: F401


def read(run, args):
    tr = run.trace
    if tr is None:
        return None
    _, forwards = run.spans.total(args["span"], "trace")
    if not forwards:
        return None
    lo, hi = tr.window
    return sum(lo <= t0 <= hi for _, t0, _ in tr.events) / forwards

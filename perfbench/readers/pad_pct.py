"""Share of the slice rows a volumetric path forwarded that were padding:
100 (launches x chunk - slices) / (launches x chunk), the launches the
program's spans of ``args["span"]`` in the measured window (one a chunk),
``chunk`` the configuration's, ``slices`` the window's count of the rows
handed over (``args["per"]``).

The sink is ``program_span_ms``'s, installed once a run.  Returns nothing
where the program recorded no such span.
"""

from perfbench.readers.program_span_ms import install  # noqa: F401


def read(run, args):
    _, launches = run.spans.total(args["span"])
    slices = run.window.get(args["per"], 0)
    if not launches or not slices:
        return None
    rows = launches * run.config["chunk"]
    return 100.0 * (rows - slices) / rows

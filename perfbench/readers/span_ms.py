"""Host milliseconds a unit spent in one span of the measured window.

``args``: ``span`` (its name), ``per`` (the window's count that divides
it: ``images`` or ``forwards``...), and to install the span, ``target``
(a program object the driver exposes) with ``attr`` (the method wrapped;
``generator`` when it yields, timing each step of it).  Returns nothing
where the window recorded no such span.
"""

from perfbench import tracing


def install(run, args):
    if "attr" in args:
        obj = run.objects[args["target"]]
        run.undo.append(tracing.wrap_method(run.spans, obj, args["attr"],
                                            args["span"],
                                            args.get("generator", False)))


def read(run, args):
    secs, count = run.spans.total(args["span"])
    units = run.window.get(args["per"], 0)
    if not count or not units:
        return None
    return secs * 1e3 / units

"""A hand kernel's share of its roofline: the least time of its launches
(``work.forward_bound_s`` of a forward's calls, scaled by the launches
traced) over their summed device time in the trace.

``args``: ``kernel`` (its name in ``work.py``), ``event`` (a substring of
its launches' names in the trace).  Returns nothing where the trace holds
no such launch, as when a later program takes the kernel off the path.
"""

from perfbench import work


def read(run, args):
    if run.trace is None:
        return None
    secs, launches = run.trace.by_name(args["event"])
    if not launches or secs <= 0:
        return None
    cfg, t = run.config, run.traffic
    per_forward = work.forward_calls(args["kernel"], cfg)
    bound = work.forward_bound_s(args["kernel"], cfg, cfg["input_size"],
                                 t["batch_size"])
    return 100.0 * bound * launches / per_forward / secs

"""Host milliseconds a forward spends from the model's forward pre-hook to
its forward hook (public ``nn.Module`` hooks, no synchronise): the eager
dispatch of one forward, waits for a full launch queue included.

``args``: ``target`` (the model among the driver's objects), ``span``.
"""

import time


def install(run, args):
    model = run.objects[args.get("target", "model")]
    open_at = []

    def pre(_module, _inputs):
        open_at.append(time.perf_counter())

    def post(_module, _inputs, _out):
        if open_at:
            run.spans.add(args["span"], open_at.pop(), time.perf_counter())

    run.undo += [model.register_forward_pre_hook(pre).remove,
                 model.register_forward_hook(post).remove]


def read(run, args):
    secs, count = run.spans.total(args["span"])
    return secs * 1e3 / count if count else None

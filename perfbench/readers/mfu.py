"""The whole step's share of the card's peak: the FLOPs of the work the
window completed, counted over the benchmark's frozen reference
(``work.flops_per_image``), over the window's length, over the peak of
the precision the step's products run in (``args["peak"]``, a key of
``work.PEAKS``).

``args``: ``train`` (count the training forward and backward at each of
the traffic's ``rates``, averaged, as each pass is one image at one rate;
else the eval forward at the input size), ``units`` (the window's count of
images or passes), ``peak``.
"""

from perfbench import work
from perfbench.reference.train import rate_size


def read(run, args):
    if not run.cuda:
        return None  # the peak is the card's
    w, cfg, t = run.window, run.config, run.traffic
    units, secs = w.get(args["units"], 0), w.get("elapsed_s", 0)
    if not units or not secs:
        return None
    if args.get("train"):
        sizes = [rate_size(t["trainsize"], r) for r in t["rates"]]
        flops = sum(work.flops_per_image(cfg, s, True)
                    for s in sizes) / len(sizes)
    else:
        flops = work.flops_per_image(cfg, cfg["input_size"], False)
    return 100.0 * flops * units / secs / work.PEAKS[args["peak"]]

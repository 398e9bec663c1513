"""An EMCAD forward's share of the card's peak: the FLOPs of the images
the window completed, counted over the benchmark's frozen reference
(``reference/emcad.py``, ``flops_per_image``), over the window's length,
over the peak of the precision the forward's products run in
(``args["peak"]``, a key of ``work.PEAKS``).

``args``: ``units`` (the window's count of images), ``peak``.  Returns
nothing off the card (the peak is the card's).
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import work
from perfbench.reference import emcad


def flops_per_image(config: dict, size: int) -> float:
    """FLOPs of one image at ``size`` through the reference's eval
    forward, counted by ``FlopCounterMode`` on the meta device (no
    arithmetic runs): the count does not move when the program
    restructures a layer."""
    with torch.device("meta"):
        ref = emcad.build(config).eval()
        x = torch.empty((1, config["in_channels"], size, size))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref(x)
    return float(counter.get_total_flops())


def read(run, args):
    if not run.cuda:
        return None
    w, cfg = run.window, run.config
    units, secs = w.get(args["units"], 0), w.get("elapsed_s", 0)
    if not units or not secs:
        return None
    flops = flops_per_image(cfg, cfg["input_size"])
    return 100.0 * flops * units / secs / work.PEAKS[args["peak"]]

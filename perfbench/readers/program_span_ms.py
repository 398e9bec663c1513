"""Host milliseconds a unit spent in one of the program's own spans
(``pranet2_tpu_torch.utils.profiling.span``) in the measured window.

``install`` turns the program's recording on, once a run however many
metrics read it, with a sink that adds each span to ``run.spans`` under
its own name; the harness's phases then keep or drop the program's spans
as they do its own, and ``Trace.idle_gaps`` names idle gaps by them.  A
program that records no spans (no ``profiling.recording``) is left as it
is, and every metric of this reader then reads nothing.

``args``: ``span`` (the program's span name), ``per`` (the window's count
that divides it: ``images``, ``batches``...).  ``read`` is
``span_ms.read``.
"""

from perfbench.readers import span_ms


def install(run, args):
    if getattr(run, "program_spans", False):
        return
    run.program_spans = True
    from pranet2_tpu_torch.utils import profiling

    recording = getattr(profiling, "recording", None)
    if recording is None:
        return
    rec = recording(lambda name, t0, t1, parent, key:
                    run.spans.add(name, t0, t1))
    rec.__enter__()
    run.undo.append(lambda: rec.__exit__(None, None, None))


def read(run, args):
    return span_ms.read(run, args)

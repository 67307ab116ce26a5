"""The whole step's share of the card's bf16 peak over the profiled
sub-window: the FLOPs of the sub-window's training steps and evals (the
cell file's ``profile``: steps, evals, members), counted on the
reference model, over the trace's span of device activity, from the
first kernel's start to the last one's end, times 989 TFLOP/s."""

from benchmark.reference import counts
from benchmark.readers import subwindow_holds_its_work


def read(run):
    if not subwindow_holds_its_work(run) or not run.profile["device_span_s"]:
        return None
    prof = run.cell["profile"]
    f_step, f_eval = counts.member_flops(run.cfg)
    flops = prof["members"] * (prof["steps"] * f_step + prof.get("evals", 0) * f_eval)
    return 100.0 * flops / (run.profile["device_span_s"] * counts.PEAK_BF16_FLOPS)

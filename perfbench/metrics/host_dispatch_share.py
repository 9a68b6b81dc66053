"""host_dispatch_share: the summed host dispatch time of the window's
engine step launches (the port's KernelProfiler split: time to return
from the step call, before the wait for the card) over the window, in
percent.  Moves tokens_per_s."""


def read(ctx):
    steps = [s for s in ctx["steps"] if ctx["w0"] <= s["t0"]
             and s["t1"] <= ctx["w1"]]
    if not steps:
        return None
    return 100.0 * sum(s["dispatch_s"] for s in steps) / ctx["window_s"]

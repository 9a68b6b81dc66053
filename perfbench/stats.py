"""Window arithmetic of the end-to-end metrics, on the harness's own
records of every request (pure Python, no device).

A record is a dict with ``due`` (wall seconds the request was due: its
open-loop arrival, or the instant its closed-loop client got the previous
answer), ``done`` (wall seconds the Router handed it back, or None),
``outcome`` (``"done"``, ``"served"`` from the result cache, ``"dropped"``,
or None while in flight), ``prompt`` and ``served`` (token counts) and, on
a deadline mix, ``deadline_ms``.  Every metric here is taken over all the
requests of the window and all its time: no request is left out and no
time is trimmed, so a stall anywhere in the window moves it.
"""

from __future__ import annotations

import math

ANSWERED = ("done", "served")


def percentile(values, q: float) -> float:
    """Exact percentile with linear interpolation between order
    statistics (numpy's default), over every value given."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def completed_in(records, w0: float, w1: float) -> list:
    """Requests the Router answered inside [w0, w1]."""
    return [r for r in records if r["outcome"] in ANSWERED
            and w0 <= r["done"] <= w1]


def due_in(records, w0: float, w1: float) -> list:
    return [r for r in records if w0 <= r["due"] < w1]


def tokens_per_s(records, w0: float, w1: float) -> float:
    """The prompt and answer tokens of every request the Router answered in
    the window (by the engine, a merge or the result cache alike), over
    its wall seconds: taken from the harness's own records, so nothing the
    program counts or plans enters it."""
    return sum(r["prompt"] + r["served"]
               for r in completed_in(records, w0, w1)) / (w1 - w0)


def latencies_ms(records, w0: float, w1: float) -> list:
    """Due-to-answer wall time of every request answered in the window."""
    return [(r["done"] - r["due"]) * 1e3
            for r in completed_in(records, w0, w1)]


def on_time(r) -> bool:
    return (r["outcome"] in ANSWERED
            and (r["done"] - r["due"]) * 1e3 <= r["deadline_ms"])


def on_time_share(records, w0: float, w1: float) -> float:
    """Percent of the requests due in the window answered by their
    deadline; a dropped, failed or unanswered request is a miss."""
    due = due_in(records, w0, w1)
    return 100.0 * sum(on_time(r) for r in due) / len(due)


def resolved(r, now: float) -> bool:
    """Nothing more can change whether ``r`` met its deadline."""
    if r["outcome"] is not None:
        return True
    return (now - r["due"]) * 1e3 > r["deadline_ms"]


def _kernel(ctx, kernel: str):
    """(counted work, device seconds) of a kernel's launches in a traced
    span, or None.  A profiler session can drop events, so the device
    time is that of the launches it kept, scaled to the launches
    counted."""
    tr, k = ctx["trace"], ctx["kernels"].get(kernel)
    if tr is None or not k or not k["counted"]:
        return None
    n, s = tr["kernel_n"][kernel], tr["kernel_s"][kernel]
    if not n or s <= 0:
        return None
    return k, s * k["counted"] / n


def kernel_roofline(ctx, kernel: str):
    """Percent of a kernel's roofline over a traced span: the least time
    its launches could take (the larger of their counted bytes over the
    HBM peak and their FLOPs over the bf16 peak) over its device time."""
    got, peaks = _kernel(ctx, kernel), ctx["peaks"]
    if got is None or not peaks:
        return None
    k, t = got
    least = max(k["bytes"] / peaks["hbm_bytes_per_s"],
                k["flops"] / peaks["bf16_flops_per_s"])
    return 100.0 * least / t

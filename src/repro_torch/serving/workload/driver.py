"""The closed-loop pump (DESIGN.md §2.11).

``WorkloadDriver`` interleaves generator arrivals with plane events on the
virtual clock, strictly event-driven — each iteration processes whichever
comes first: the pool's earliest pending arrival (submitted through
``Router.submit`` so routing signals are current) or the planes' earliest
scheduled event (advanced via ``Router.step`` just past that instant, so
the completion callbacks fire and sessions wake *before* the clock moves
on).  Wakeups never enter a plane's event heap directly: the control
plane's ``on_complete`` hook only feeds the pool's own heap, and the next
turn re-enters through the front door like any other arrival.

Termination is by construction: sessions have bounded turns, DAGs have
finitely many stages, and new starts stop at the user/DAG cap or the
horizon — so the final ``Router.drain()`` pumps the generator dry instead
of spinning on an always-refilling arrival heap.

A copy of ``repro.serving.workload.driver`` for the port, unchanged but for this line.
"""

from __future__ import annotations

__all__ = ["WorkloadDriver"]

#: run(until) is *strictly before* ``until``; the nudge makes "advance to
#: the next event" include the events at that exact instant
_EPS = 1e-9


class WorkloadDriver:
    """Pump one workload pool (SessionPool / StagedPool) through a Router.

    ``record_hit_depth=True`` additionally peeks the chosen plane's prefix
    index right after each submit (a read-only trie walk — the same score
    routing uses) and reports it to the pool as that turn's hit depth.
    """

    def __init__(self, router, pool, record_hit_depth: bool = False):
        self.router = router
        self.pool = pool
        self.record_hit_depth = record_hit_depth
        self.submitted = 0
        router.attach_workload(self)

    # -- control-plane hook (fans out to the pool) ----------------------------
    def on_complete(self, obj, now: float, outcome: str) -> None:
        self.pool.on_complete(obj, now, outcome)

    # -- the pump -------------------------------------------------------------
    def _submit(self, t: float, item) -> None:
        plane = self.router.submit(item, t)
        self.submitted += 1
        if self.record_hit_depth:
            toks = getattr(item, "prompt", None)
            if toks is None:
                toks = getattr(item, "tokens", None)
            if toks:
                self.pool.note_hit_depth(getattr(item, "turn", 0),
                                         plane.prefix_overlap(toks))

    def run(self) -> dict:
        """Drive the pool to exhaustion and return the drained stats."""
        router, pool = self.router, self.pool
        while True:
            ta = pool.next_time()
            te = router.next_event_time()
            if te is not None and (ta is None or te < ta):
                router.step(te + _EPS)
                continue
            if ta is None:
                break                     # quiescent: nothing pending anywhere
            self._submit(*pool.pop())
        return router.drain()

    def pump(self, router) -> bool:
        """Drain-time refill: submit every arrival the generator has pending
        (completions during the quiescence run may have woken sessions) and
        report whether any were submitted.  Exhausted (max turns / horizon
        reached) means False — the drain loop's termination condition."""
        fired = False
        while self.pool.next_time() is not None:
            self._submit(*self.pool.pop())
            fired = True
        return fired

"""The port's twin of ``tests/test_oversubscription.py``: the OSL ->
adaptive-alpha map (Eq. 4.3 / §4.5.3) and the Eq. 5.11 EWMA +
Schmitt-trigger DropToggle of ``repro_torch.core.oversubscription``, which
both the pruner and the cost-aware autoscaler build on.

Each case runs its body on the port and on
``repro.core.oversubscription`` with the same inputs
(``torch_jax_side.both``): the same toggle states, EWMA history, alpha and
OSL on both, before it checks the reference's invariants on the port's."""

import pytest

from torch_jax_side import both


def _task(side, deadline, arrival=0.0):
    return side.Task(ttype="t0", data_id="d", op="op", arrival=arrival,
                     deadline=deadline)


def _toggle_run(misses, **kw):
    """Toggle states and EWMA history over ``misses``, on both packages:
    the port's (off level, states, history)."""
    def run(s):
        tg = s.DropToggle(**kw)
        return tg.off_level, [tg.observe(m) for m in misses], tg.history

    return both(run)


class TestDropToggle:
    def test_engages_at_on_level_and_holds_through_noise(self):
        """A noisy miss sequence oscillating across the on-level (but above
        the off-level) must produce exactly one engage transition — no
        chatter (Section 5.3.5's 20% separation is the point)."""
        off, states, _ = _toggle_run((3, 3, 1, 3, 1, 3, 1, 3), lam=0.5,
                                     on_level=2.0)
        assert off == pytest.approx(1.6)
        # d: 1.5, 2.25*, 1.625, 2.3125, 1.656, 2.328, 1.664, 2.332 — the
        # dips stay above off_level, so once engaged it stays engaged
        assert states[0] is False
        assert all(states[1:])
        transitions = sum(1 for a, b in zip([False] + states, states)
                          if a != b)
        assert transitions == 1

    def test_without_schmitt_the_same_sequence_chatters(self):
        _, states, _ = _toggle_run((3, 3, 1, 3, 1, 3, 1, 3), lam=0.5,
                                   on_level=2.0, use_schmitt=False)
        transitions = sum(1 for a, b in zip([False] + states, states)
                          if a != b)
        assert transitions > 2   # naive threshold flips on every dip

    def test_disengages_only_at_off_level(self):
        def run(s):
            tg = s.DropToggle(lam=0.5, on_level=2.0)
            log = [(tg.observe(10), tg.d)]   # d = 5.0 -> engaged
            while tg.d > tg.off_level:
                tg.observe(0)
                log.append((tg.engaged, tg.d))
            return tg.off_level, log

        off, log = both(run)
        assert log[0][0]
        for engaged, d in log[1:-1]:
            assert d > off and engaged       # still above: must hold
        assert log[-1][1] <= off
        assert not log[-1][0]                # crossed off_level: released

    def test_ewma_matches_eq_5_11(self):
        misses = (4, 0, 7, 2, 0, 0, 9)
        _, _, history = _toggle_run(misses, lam=0.3, on_level=100.0)
        d = 0.0
        assert len(history) == 7
        for m, got in zip(misses, history):
            d = m * 0.3 + d * 0.7
            assert got == pytest.approx(d)


class TestAdaptiveAlpha:
    @pytest.mark.parametrize("osl,alpha", [
        (0.0, 2.0),          # no oversubscription: conservative 2-sigma
        (0.25, 1.0),
        (0.5, 0.0),
        (1.0, -2.0),         # fully oversubscribed: aggressive
    ])
    def test_linear_map(self, osl, alpha):
        assert both(lambda s: s.adaptive_alpha(osl)) == pytest.approx(alpha)

    @pytest.mark.parametrize("osl", [1.5, 4.0, 100.0, 1e9])
    def test_clamped_at_extreme_oversubscription(self, osl):
        assert both(lambda s: s.adaptive_alpha(osl)) == -2.0

    @pytest.mark.parametrize("osl", [-0.1, -5.0])
    def test_clamped_below(self, osl):
        assert both(lambda s: s.adaptive_alpha(osl)) == 2.0


def _osl(queue, mu, sd=0.0, running=None, run_end=None, **kw):
    """One machine's OSL on both packages: ``queue`` and ``running`` are
    (deadline, arrival) pairs, every task estimated at (mu, sd)."""
    def run(s):
        m = s.Machine(mid=0)
        m.queue = [_task(s, *t) for t in queue]
        if running is not None:
            m.running = _task(s, *running)
            m.run_end = run_end
        return s.oversubscription_level([m], lambda task, mach: (mu, sd),
                                        0.0, **kw)

    return both(run)


class TestOversubscriptionLevel:
    def test_empty_queues_zero(self):
        assert _osl([], 10.0) == 0.0

    def test_on_time_tasks_contribute_zero(self):
        assert _osl([(100.0,), (120.0,)], 10.0) == 0.0

    def test_infeasible_tasks_contribute_zero(self):
        # W = deadline - arrival - e < 0: the request was never servable,
        # so it cannot count as oversubscription pressure
        assert _osl([(5.0,)], 10.0) == 0.0

    def test_severity_capped_at_four(self):
        # e=10, deadline=11 -> W=1; completion ~10k -> ratio huge, capped
        osl = _osl([(11.0, 0.0)], 10.0, running=(1e6,), run_end=1e4)
        assert osl == pytest.approx(4.0)
        assert both(lambda s: s.adaptive_alpha(osl)) == -2.0

    def test_alpha_widens_estimates(self):
        # alpha enters e = mu + alpha*sigma: a fat-sigma estimate can turn
        # an on-time queue oversubscribed
        queue = [(30.0,), (32.0,)]
        assert _osl(queue, 10.0, sd=1.0, alpha=2.0) == 0.0
        assert _osl(queue, 14.0, sd=4.0, alpha=2.0) > 0.0

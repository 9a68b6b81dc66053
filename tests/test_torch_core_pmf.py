"""The port's twin of ``tests/test_core_pmf.py``: unit and property tests
for the PMF algebra (Eqs. 5.1-5.7) of ``repro_torch.core.pmf``, every case
of the reference with its ``settings``.

Each case runs its body on the port and on ``repro.core.pmf`` with the same
numbers (``torch_jax_side.both``) and asserts that the two give the same
PMFs bin for bin, offsets and chances alike, before it checks the
reference's invariants on the port's."""

import numpy as np
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # minimal install: keep unit tests, skip property tests
    from conftest import given, settings, st  # noqa: F401

from torch_jax_side import JAX, PORT, both


def _rand_pmf(side, rng, n=None, offset=None):
    n = n or int(rng.integers(1, 40))
    v = rng.random(n) + 1e-3
    return side.PMF(v / v.sum(), offset=int(offset if offset is not None
                                            else rng.integers(0, 30)))


# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------

def test_impulse_stats():
    def run(s):
        p = s.PMF.impulse(7)
        return (p, p.mean(), p.std(), p.mass, p.success_before(7),
                p.success_before(6))

    _, mean, std, mass, at7, at6 = both(run)
    assert mean == 7 and std == 0 and mass == 1.0
    assert at7 == 1.0 and at6 == 0.0


def test_from_normal_moments():
    def run(s):
        p = s.PMF.from_normal(100, 7)
        return p, p.mean(), p.std(), p.mass

    _, mean, std, mass = both(run)
    assert abs(mean - 100) < 0.5
    assert abs(std - 7) < 0.5
    assert abs(mass - 1.0) < 1e-9


def test_negative_values_rejected():
    for side in (PORT, JAX):
        with pytest.raises(ValueError):
            side.PMF(np.array([0.5, -0.5]))


def test_scale_speed():
    def run(s):
        q = s.PMF.from_normal(100, 5).scale(0.5)  # 2x faster machine
        return q, q.mean()

    _, mean = both(run)
    assert abs(mean - 50) < 1.0


def test_skewness_signs():
    right, left, sym = both(lambda s: [
        s.PMF(np.array(v)).skewness()
        for v in ([0.7, 0.2, 0.1], [0.1, 0.2, 0.7], [0.2, 0.6, 0.2])])
    assert right > 0
    assert left < 0
    assert abs(sym) < 1e-9


# ---------------------------------------------------------------------------
# convolution forms (Eqs. 5.2-5.5)
# ---------------------------------------------------------------------------

def test_no_drop_is_plain_convolution():
    def run(s):
        rng = np.random.default_rng(0)
        e, c = _rand_pmf(s, rng), _rand_pmf(s, rng)
        out = s.convolve_pct(e, c, deadline=None, mode=s.DropMode.NO_DROP)
        return e.mean() + c.mean(), out, out.mean(), out.mass

    total, _, mean, mass = both(run)
    assert abs(mean - total) < 1e-9
    assert abs(mass - 1.0) < 1e-9


def test_pend_drop_mass_conserved_and_split():
    def run(s):
        rng = np.random.default_rng(1)
        cases = []
        for _ in range(20):
            e, c = _rand_pmf(s, rng), _rand_pmf(s, rng)
            dl = int(c.mean() + e.mean())
            cases.append((c, dl, s.convolve_pct(
                e, c, deadline=dl, mode=s.DropMode.PEND_DROP)))
        return cases

    for c, dl, out in both(run):
        assert abs(out.mass - 1.0) < 1e-9
        # late prev mass passes through untouched
        late = sum(c.values[max(0, dl - c.offset):])
        # all mass at/after dl in `out` >= pass-through mass
        tail = (sum(out.values[max(0, dl - out.offset):])
                if out.support_end >= dl else 0)
        assert tail >= late - 1e-9


def test_evict_drop_support_bounded():
    def run(s):
        rng = np.random.default_rng(2)
        cases = []
        for _ in range(20):
            e, c = _rand_pmf(s, rng), _rand_pmf(s, rng)
            dl = int(c.offset + e.offset + 3)
            cases.append((c, dl, s.convolve_pct(
                e, c, deadline=dl, mode=s.DropMode.EVICT_DROP)))
        return cases

    for c, dl, out in both(run):
        assert abs(out.mass - 1.0) < 1e-9
        # the machine is guaranteed free of this task by max(dl, prev frees)
        assert out.support_end <= max(dl, c.support_end)


def test_chance_matches_materialized_convolution():
    def run(s):
        rng = np.random.default_rng(3)
        cases = []
        for _ in range(30):
            e, c = _rand_pmf(s, rng), _rand_pmf(s, rng)
            dl = int(e.mean() + c.mean() + rng.integers(-5, 10))
            # no-drop: memoized == full convolution CDF
            cases.append((
                s.chance_of_success(e, c, dl, droppable_prev=False),
                s.convolve_pct(e, c, None,
                               s.DropMode.NO_DROP).success_before(dl)))
        return cases

    for p_memo, p_full in both(run):
        assert abs(p_memo - p_full) < 1e-9


def test_chance_pend_drop_excludes_late_starts():
    # prev frees at exactly the deadline -> task i is dropped, chance 0
    def run(s):
        e = s.PMF.impulse(1)          # exec takes 1
        c = s.PMF.impulse(10)         # prev frees at 10
        return [s.chance_of_success(e, c, dl, droppable_prev=True)
                for dl in (10, 11)]

    assert both(run) == [0.0, 1.0]


def test_queue_pcts_monotone_means():
    def run(s):
        rng = np.random.default_rng(4)
        pets = [_rand_pmf(s, rng) for _ in range(4)]
        pcts = s.queue_pcts(pets, [10**6] * 4, mode=s.DropMode.NO_DROP)
        return pcts, [p.mean() for p in pcts]

    _, means = both(run)
    assert all(b > a for a, b in zip(means, means[1:]))


# ---------------------------------------------------------------------------
# compaction (Fig. 5.7)
# ---------------------------------------------------------------------------

def test_compaction_preserves_mass_and_mean():
    def run(s):
        p = s.PMF.from_normal(120, 9)
        return p, p.compact(4)

    p, q = both(run)
    assert abs(q.mass - p.mass) < 1e-12
    assert abs(q.mean() - p.mean()) < 4.0
    assert len([v for v in q.values if v > 0]) <= \
        int(np.ceil(len(p.values) / 4)) + 1


def test_compaction_range_clamps():
    q = both(lambda s: s.PMF.from_normal(50, 3).compact(2, lo=48, hi=52))
    assert q.offset >= 48 and q.support_end <= 52 + 2
    assert abs(q.mass - 1.0) < 1e-12


# ---------------------------------------------------------------------------
# property tests
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.integers(1, 30), st.integers(1, 30), st.integers(0, 60),
       st.integers(0, 1000))
def test_prop_mass_conservation(n1, n2, dl_off, seed):
    def run(s):
        rng = np.random.default_rng(seed)
        e, c = _rand_pmf(s, rng, n1), _rand_pmf(s, rng, n2)
        dl = e.offset + c.offset + dl_off
        return [(mode, s.convolve_pct(e, c, dl, mode=mode))
                for mode in s.DropMode]

    for mode, out in both(run):
        assert abs(out.mass - 1.0) < 1e-9, mode


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 25), st.integers(1, 25), st.integers(0, 1000))
def test_prop_chance_bounds_and_monotonicity(n1, n2, seed):
    def run(s):
        rng = np.random.default_rng(seed)
        e, c = _rand_pmf(s, rng, n1), _rand_pmf(s, rng, n2)
        lo = e.offset + c.offset
        hi = e.support_end + c.support_end
        chances = [s.chance_of_success(e, c, dl, droppable_prev=False)
                   for dl in range(lo - 1, hi + 2, max(1, (hi - lo) // 8))]
        # past the joint support the chance is certain
        return chances, s.chance_of_success(e, c, hi + 1,
                                            droppable_prev=False)

    chances, past = both(run)
    prev = 0.0
    for p in chances:
        assert -1e-12 <= p <= 1.0 + 1e-12
        assert p >= prev - 1e-12       # CDF is monotone in the deadline
        prev = p
    assert past > 1 - 1e-9


@settings(max_examples=40, deadline=None)
@given(st.integers(2, 8), st.integers(0, 1000))
def test_prop_compaction_mass(bucket, seed):
    def run(s):
        rng = np.random.default_rng(seed)
        p = _rand_pmf(s, rng, int(rng.integers(5, 120)))
        return p, p.compact(bucket)

    p, q = both(run)
    assert abs(q.mass - p.mass) < 1e-12
    assert abs(q.mean() - p.mean()) <= bucket

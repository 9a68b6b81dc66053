"""The model's own spans and counters (DESIGN.md §2.9).

The model functions know nothing of the engine that calls them, so their
spans (``model.*``) go to the Telemetry that ``recording`` sets for the
duration of a launch: the unit runner sets its engine's around each step
launch.  Outside one, and with the engine's default ``NULL``, a span
records nothing.

``COUNTS`` holds what the model computed, counted on the host from sizes
it knows without a sync: expert rows, each routed (row, choice) pair of
each expert layer (``moe_real_rows``: the dropless path routes real rows
only), and latent tokens decompressed for the chunked
prefill's attention (``mla_expand_tokens``, once a step: every layer
decompresses the same tokens).  It only grows; a reader
takes the difference around the calls it cares for.
"""

from __future__ import annotations

from contextlib import contextmanager

from ..obs.telemetry import NULL

COUNTS = {"moe_real_rows": 0, "mla_expand_tokens": 0}
_TEL = [NULL]


def span(name: str):
    """A span of the Telemetry set by ``recording`` (none: records
    nothing)."""
    return _TEL[0].span(name)


@contextmanager
def recording(tel):
    """Send the model's spans to ``tel`` while the block runs."""
    prev = _TEL[0]
    _TEL[0] = tel
    try:
        yield
    finally:
        _TEL[0] = prev


def count(name: str, n: int) -> None:
    COUNTS[name] += int(n)

"""The benchmark's one traffic generator, driven by a mix file.

A mix file (``perfbench/traffic/<name>.json``) holds only parameters:
lengths, rates, sharing and deadlines.  This module turns a mix, a cell's
settings and a seed into requests.  Nothing here knows a mix by name.

Sizes are *stratified*: each block of ``strata`` consecutive requests
carries the same multiset of sizes, the distribution's quantiles at
(i + 0.5) / strata.  The run's seed draws everything else: the sizes'
order within each block, the documents' order, which document each
request asks about, the repeats, the open loop's arrival times and every
token id (uniform over the vocabulary).  So every seed does the same set
of work in another order: the port's chunked prefill pads each chunk
launch to the step's token budget, so the order in which prompts meet
moves how much a window holds, and the bound has to cover that.

Mix keys:

* ``loop``: ``"closed"`` (each client sends its next request when its last
  returns; the client count is the cell's) or ``"open"`` (Poisson arrivals
  at ``rate_per_s``, the schedule fixed before the run);
* ``prompt`` / ``output``: ``{"dist": "lognormal", "median", "sigma",
  "min", "max"}`` or ``{"dist": "uniform", "min", "max"}``;
* ``documents`` (optional): ``{"count", "min", "max", "zipf_s"}``: every
  prompt is a shared document, picked by Zipf popularity, followed by a
  unique question whose length is ``prompt``'s;
* ``repeat_share`` / ``repeat_window`` (optional): that share of requests
  repeats exactly one of the previous ``repeat_window`` requests;
* ``deadline_ms`` (optional): ``{"a", "b", "c"}``, a request's deadline
  a + b * prompt tokens + c * output tokens milliseconds after it is due;
* ``why`` / ``sources``: what the mix stands for and the public sources of
  its parameters (read by no code).

The arrival and hash primitives are frozen copies of the port's
``serving/workload/arrivals.py`` (``PoissonProcess.iter_times``,
``mix64``), so the yardstick does not move when the program does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

_MASK = (1 << 64) - 1


def mix64(*vals: int) -> int:
    """SplitMix64-style avalanche over a tuple of ints (frozen copy of the
    port's ``serving.workload.arrivals.mix64``)."""
    h = 0x9E3779B97F4A7C15
    for v in vals:
        h = (h + (int(v) & _MASK)) & _MASK
        h ^= h >> 30
        h = (h * 0xBF58476D1CE4E5B9) & _MASK
        h ^= h >> 27
        h = (h * 0x94D049BB133111EB) & _MASK
        h ^= h >> 31
    return h


def poisson_times(rng, rate: float, start: float = 0.0):
    """Homogeneous Poisson instants at ``rate`` a unit of time, forever
    (frozen copy of ``PoissonProcess.iter_times`` at weight 1)."""
    t = float(start)
    scale = 1.0 / rate
    while True:
        t += rng.exponential(scale)
        yield t


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(mix64(seed, *stream))


def quantiles(spec: dict, n: int) -> list[int]:
    """The n stratified sizes of a length distribution, clipped."""
    lo, hi = int(spec["min"]), int(spec["max"])
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            x = spec["median"] * math.exp(spec["sigma"]
                                          * NormalDist().inv_cdf(u))
        elif spec["dist"] == "uniform":
            x = lo + (hi - lo) * u
        else:
            raise ValueError(f"unknown length distribution {spec['dist']!r}")
        out.append(min(hi, max(lo, int(round(x)))))
    return out


def zipf_counts(n_docs: int, s: float, n: int) -> list[int]:
    """How many of ``n`` requests pick each document under Zipf(s), by
    largest remainder so the counts sum to ``n``."""
    w = [1.0 / (i + 1) ** s for i in range(n_docs)]
    tot = sum(w)
    raw = [n * x / tot for x in w]
    cnt = [int(x) for x in raw]
    order = sorted(range(n_docs), key=lambda i: cnt[i] - raw[i])
    for i in order[:n - sum(cnt)]:
        cnt[i] += 1
    return cnt


@dataclass
class Spec:
    """One request of the mix."""
    index: int
    prompt: tuple
    n_new: int
    deadline_ms: float | None = None
    doc: int = -1
    repeat_of: int = -1


class Traffic:
    """The requests of one run of one cell: ``spec(k)`` is the k-th request
    (closed loop: in the order clients ask), ``arrivals`` the open loop's
    due times in seconds after traffic opens, ``documents`` the shared
    documents a cell may load into the prefix cache before traffic."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.strata = int(mix.get("strata", 64))
        self._p = quantiles(mix["prompt"], self.strata)
        self._o = quantiles(mix["output"], self.strata)
        self._blocks: dict[int, dict] = {}
        self._specs: dict[int, Spec] = {}
        self.docs: list[tuple] = []
        d = mix.get("documents")
        if d is not None:
            lens = quantiles({"dist": "uniform", "min": d["min"],
                              "max": d["max"]}, d["count"])
            lens = [lens[i] for i in _rng(self.seed, 6).permutation(len(lens))]
            r = _rng(self.seed, 1)
            self.docs = [tuple(int(t) for t in r.integers(1, self.vocab, n))
                         for n in lens]
        self._times = None

    @property
    def closed(self) -> bool:
        return self.mix["loop"] == "closed"

    def _block(self, b: int) -> dict:
        blk = self._blocks.get(b)
        if blk is None:
            r = _rng(self.seed, 2, b)
            n = self.strata
            blk = {"p": [self._p[i] for i in r.permutation(n)],
                   "o": [self._o[i] for i in r.permutation(n)]}
            d = self.mix.get("documents")
            if d is not None:
                cnt = zipf_counts(d["count"], d["zipf_s"], n)
                docs = [i for i, c in enumerate(cnt) for _ in range(c)]
                blk["doc"] = [docs[i] for i in r.permutation(n)]
            share = float(self.mix.get("repeat_share", 0.0))
            rep = np.zeros(n, bool)
            rep[r.permutation(n)[:int(round(share * n))]] = True
            blk["rep"] = rep.tolist()
            blk["back"] = r.integers(
                1, int(self.mix.get("repeat_window", 1)) + 1, n).tolist()
            self._blocks[b] = blk
        return blk

    def spec(self, k: int) -> Spec:
        s = self._specs.get(k)
        if s is not None:
            return s
        b, i = divmod(k, self.strata)
        blk = self._block(b)
        if blk["rep"][i] and k - blk["back"][i] >= 0:
            src = self.spec(k - blk["back"][i])
            s = Spec(k, src.prompt, src.n_new, src.deadline_ms, src.doc,
                     src.index)
        else:
            r = _rng(self.seed, 3, k)
            body = tuple(int(t) for t in r.integers(1, self.vocab,
                                                    blk["p"][i]))
            doc = blk["doc"][i] if "doc" in blk else -1
            prompt = (self.docs[doc] + body) if doc >= 0 else body
            n_new = blk["o"][i]
            dl = self.mix.get("deadline_ms")
            dms = (None if dl is None else
                   dl["a"] + dl["b"] * len(prompt) + dl["c"] * n_new)
            s = Spec(k, prompt, n_new, dms, doc)
        self._specs[k] = s
        if len(self._specs) > 4 * self.strata:
            # a closed loop only looks back ``repeat_window`` requests
            for old in [j for j in self._specs if j < k - 2 * self.strata]:
                del self._specs[old]
        return s

    def arrival(self, k: int) -> float:
        """Open loop: the k-th request's due time in seconds."""
        if self._times is None:
            self._times = []
            self._gen = poisson_times(_rng(self.seed, 4),
                                      float(self.mix["rate_per_s"]))
        while len(self._times) <= k:
            self._times.append(next(self._gen))
        return self._times[k]

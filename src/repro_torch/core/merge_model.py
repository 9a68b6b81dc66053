"""Execution-time model of (merged) video transcoding tasks (Chapter 3).

The dissertation benchmarks 3,159 two-second 720p H.264 segments across 18
transcoding tasks (Table 3.2) and finds the structure that merged tasks
share the *load + decode* work and pay per-parameter *encode* work:

    T_individual(op) = L + E_op
    T_merged(ops)    = L + sum_op E_op          (one shared load/decode)

with L ≈ 0.52 * T_vic reproducing the measured merge-savings: ~26% at 2P,
~37% at 3P, ~40% at 4P/5P (Fig. 3.3a), and codec-changing encodes up to 8x
a VIC task making codec merges far less profitable (Fig. 3.3b): MPEG-4
behaves like VIC, HEVC saves consistently less, VP9 saves the least.

This model is the ground-truth generator for the Chapter-3 benchmark, the
GBDT training set, and the Chapter-4 merging simulator.  In the TPU serving
adaptation the same structure holds with L = weight-residency + prefill and
E = per-request decode (see DESIGN.md §2).

A copy of ``repro.core.merge_model`` for the port, unchanged but for this line.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

VIC_OPS = ("bitrate", "framerate", "resolution")
CODEC_PARAMS = ("mpeg4", "hevc", "vp9")

# encode cost relative to a VIC task's total time
_ENCODE_SCALE = {"bitrate": 1.0, "framerate": 0.92, "resolution": 1.08,
                 "mpeg4": 1.3, "hevc": 5.0, "vp9": 7.0}
# fraction of shared (load+decode) work reusable when merging *into* this op
_SHARE_EFFICIENCY = {"mpeg4": 1.0, "hevc": 0.55, "vp9": 0.3}

SHARED_FRACTION = 0.52   # L / T_vic — calibrated to Fig. 3.3a


@dataclass(frozen=True)
class VideoMeta:
    """Static features of a segment (Table 3.3 left columns)."""
    duration: float = 2.0        # seconds
    size_kb: float = 900.0
    fps: float = 30.0
    width: int = 1280
    height: int = 720
    complexity: float = 1.0      # latent content factor (motion/detail)

    @staticmethod
    def sample(rng: np.random.Generator) -> "VideoMeta":
        dur = float(rng.uniform(0.8, 2.0))
        w, h = 1280, 720
        comp = float(rng.lognormal(0.0, 0.45))
        size = 450.0 * dur * comp * float(rng.uniform(0.9, 1.1))
        return VideoMeta(duration=round(dur, 1), size_kb=round(size, 0),
                         fps=30.0, width=w, height=h, complexity=comp)


class VideoExecModel:
    """Calibrated execution-time + merge-saving oracle."""

    def __init__(self, base_rate: float = 1.9, noise: float = 0.03,
                 seed: int = 0):
        # base_rate: seconds of compute per second of 720p video for a VIC op
        self.base_rate = base_rate
        self.noise = noise
        self._rng = np.random.default_rng(seed)

    # -- building blocks ----------------------------------------------------
    def t_vic(self, v: VideoMeta) -> float:
        res_factor = (v.width * v.height) / (1280.0 * 720.0)
        return self.base_rate * v.duration * v.complexity * res_factor ** 0.5

    def shared_fraction(self, v: VideoMeta) -> float:
        """Content-dependent decode share: complex (high-motion/detail)
        segments spend relatively more time in decode, so they merge better.
        Mean ≈ 0.52 (the Fig. 3.3a calibration point); GBDT can recover the
        content factor from size_kb/duration while the op-signature Naive
        lookup cannot (the Fig. 3.5 gap)."""
        sf = SHARED_FRACTION + 0.02 + 0.28 * np.tanh(1.2 * (v.complexity - 1.0)) \
            + 0.05 * (v.duration - 1.4)
        return float(np.clip(sf, 0.12, 0.88))

    def shared_time(self, v: VideoMeta) -> float:
        return self.shared_fraction(v) * self.t_vic(v)

    def encode_time(self, v: VideoMeta, op: str) -> float:
        t = self.t_vic(v)
        return _ENCODE_SCALE[op] * t - (self.shared_time(v) if op in VIC_OPS else 0.0)

    # -- public API -----------------------------------------------------------
    def individual_time(self, v: VideoMeta, op: str, noisy: bool = True) -> float:
        t = self.shared_time(v) + self.encode_time(v, op)
        return self._jitter(t) if noisy else t

    def merged_time(self, v: VideoMeta, ops: list[str], noisy: bool = True) -> float:
        """One shared load/decode + per-op encodes.  Codec participants reuse
        only part of the shared work (Fig. 3.3b behaviour)."""
        if not ops:
            return 0.0
        share_eff = min(_SHARE_EFFICIENCY.get(op, 1.0) for op in ops)
        shared = self.shared_time(v)
        t = shared + sum(self.encode_time(v, op) for op in ops)
        # imperfect sharing with codec ops: a fraction of the shared work
        # must be redone per codec participant
        n_codec = sum(1 for op in ops if op in CODEC_PARAMS)
        if n_codec and len(ops) > 1:
            t += (1.0 - share_eff) * shared * n_codec
        return self._jitter(t) if noisy else t

    def saving(self, v: VideoMeta, ops: list[str], noisy: bool = False) -> float:
        """Merge-saving ratio: 1 - T_merged / sum_i T_individual."""
        if len(ops) < 2:
            return 0.0
        tot = sum(self.individual_time(v, op, noisy=noisy) for op in ops)
        return 1.0 - self.merged_time(v, ops, noisy=noisy) / tot

    def _jitter(self, t: float) -> float:
        return float(t * self._rng.normal(1.0, self.noise))

    # -- dataset for the predictor (Table 3.3 layout) -------------------------
    FEATURES = ["duration", "size_kb", "fps", "width", "height",
                "B", "S", "R", "mpeg4", "vp9", "hevc"]

    def featurize(self, v: VideoMeta, ops: list[str]) -> np.ndarray:
        return np.array([
            v.duration, v.size_kb, v.fps, v.width, v.height,
            float(sum(1 for o in ops if o == "bitrate")),
            float(sum(1 for o in ops if o == "framerate")),
            float(sum(1 for o in ops if o == "resolution")),
            float(sum(1 for o in ops if o == "mpeg4")),
            float(sum(1 for o in ops if o == "vp9")),
            float(sum(1 for o in ops if o == "hevc")),
        ])

    def make_dataset(self, n: int, rng: np.random.Generator,
                     max_degree: int = 5) -> tuple[np.ndarray, np.ndarray]:
        """Sample merge cases like benchmark steps (B)-(D) of §3.2.2."""
        xs, ys = [], []
        ops_pool = list(VIC_OPS)
        for _ in range(n):
            v = VideoMeta.sample(rng)
            k = int(rng.integers(2, max_degree + 1))
            if rng.random() < 0.25:  # codec-inclusive merge (step D)
                codec = str(rng.choice(CODEC_PARAMS))
                ops = [codec] + [str(rng.choice(ops_pool)) for _ in range(k - 1)]
            else:                      # pure-VIC merge (steps B/C)
                ops = [str(rng.choice(ops_pool)) for _ in range(k)]
            xs.append(self.featurize(v, ops))
            ys.append(self.saving(v, ops, noisy=True))
        return np.stack(xs), np.asarray(ys)

"""Roofline terms of one step on one rank, the twin of
``repro.parallel.roofline`` with NVIDIA H100 constants.

    compute term    = dot FLOPs / peak FLOPs                (per rank)
    memory term     = HBM bytes / HBM bandwidth             (per rank)
    collective term = sum over groups of collective bytes / link bandwidth

The counts come from ``op_cost``: what rank 0 executes, the hand-written
kernels credited by their wrappers.

Hardware model: the H100 SXM as NVIDIA's H100 Tensor Core GPU datasheet
states it — 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 900 GB/s per
GPU (450 GB/s each way); a node holds 8 GPUs on NVLink, and a
collective whose group has more than 8 ranks leaves the NVLink domain
and runs at one 400 Gb/s InfiniBand NDR port per GPU, 50 GB/s.  A group
of at most 8 ranks is taken to lie within one node.  These are datasheet
values, not measurements.
"""

from __future__ import annotations

from dataclasses import dataclass, field

PEAK_FLOPS = 989e12          # bf16 dense, H100 SXM
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_BW = 450e9            # bytes/s per direction per GPU
IB_BW = 50e9                 # bytes/s per GPU, one NDR port
NVLINK_DOMAIN = 8            # GPUs a node joins by NVLink


def link_bw(group: int) -> float:
    """The bandwidth a collective over ``group`` ranks runs at."""
    return NVLINK_BW if group <= NVLINK_DOMAIN else IB_BW


@dataclass
class Roofline:
    flops: float                 # per rank
    bytes_accessed: float        # per rank
    collective_bytes: float      # per rank
    collectives: dict
    collective_counts: dict
    model_flops_total: float     # 6*N*D style, whole step, all ranks
    chips: int
    collective_groups: dict = field(default_factory=dict)  # size -> bytes
    kernels: dict = field(default_factory=dict)
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / self.hbm_bw

    @property
    def t_collective(self) -> float:
        """Each group's bytes over its link; bytes no group claims (a
        hand-built ``Roofline``) go at the slower link."""
        grouped = sum(self.collective_groups.values())
        t = sum(b / link_bw(int(g))
                for g, b in self.collective_groups.items())
        return t + max(self.collective_bytes - grouped, 0.0) / IB_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total counted FLOPs (catches remat/redundancy)."""
        total = self.flops * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def mfu_roofline(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        denom = self.step_time * self.chips * self.peak_flops
        return self.model_flops_total / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes_accessed,
            "collective_bytes_per_chip": self.collective_bytes,
            "collectives": self.collectives,
            "collective_counts": self.collective_counts,
            "collective_bytes_by_group": {str(g): b for g, b in
                                          self.collective_groups.items()},
            "kernels": self.kernels,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_step_time_s": self.step_time,
            "model_flops_total": self.model_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_roofline": self.mfu_roofline,
            "chips": self.chips,
        }


def from_cost(cost, model_flops_total: float, chips: int,
              fused: bool = False) -> Roofline:
    """The roofline of an ``op_cost.OpCost``; ``fused`` reads its fused
    regions' bytes (``bytes_fused``)."""
    return Roofline(
        flops=cost.flops,
        bytes_accessed=cost.bytes_fused if fused else cost.bytes_accessed,
        collective_bytes=cost.collective_bytes,
        collectives=dict(cost.collectives),
        collective_counts=dict(cost.collective_counts),
        collective_groups=dict(cost.collective_groups),
        kernels={k: dict(v) for k, v in cost.kernels.items()},
        model_flops_total=model_flops_total, chips=chips)


def analyze(fn, *args, model_flops_total: float, chips: int,
            fused: bool = False) -> Roofline:
    """Run ``fn(*args)`` under ``op_cost.OpCounter`` and return the
    roofline of what this rank ran (``fused``: with the fused regions
    costed at their boundary bytes)."""
    from .op_cost import count
    _, cost = count(fn, *args)
    return from_cost(cost, model_flops_total, chips, fused)

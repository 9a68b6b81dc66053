"""Workload generators for the Chapter 4/5 experiments (back-compat home).

The generator bodies moved to ``repro.serving.workload.generators``, where
their arrival shaping runs through the shared :class:`ArrivalProcess`
abstraction (the Chapter-4 base/high-load cycle is a ``DiurnalProcess``,
the Chapter-5 per-type bursts a ``SpikeSchedule``) — see DESIGN.md §2.11.
These wrappers preserve the original import path and, draw-for-draw, the
original RNG sequences: same seed, same tasks as before the re-host.

* ``video_streaming_workload`` — Chapter 4: tasks arrive in groups of five
  consecutive segments; the arrival rate toggles between a base period and a
  2x high-load period (~3:1 duration ratio), emulating the two-peak daily
  pattern of live streaming (Baccour et al.).  Multiple viewers request the
  same segments, creating mergeable (identical/similar) tasks.

* ``spiky_hc_workload`` — Chapter 5 (Fig. 5.9): heterogeneous task types
  with bursty per-type arrival spikes on top of a base rate.

A copy of ``repro.core.workload`` for the port, unchanged but for this line.
"""

from __future__ import annotations

from dataclasses import dataclass

from .merge_model import VideoExecModel, VideoMeta
from .tasks import Machine, PETMatrix, Task


@dataclass
class VideoWorkload:
    tasks: list[Task]
    videos: dict[str, VideoMeta]
    exec_model: VideoExecModel
    span: float


@dataclass
class HCWorkload:
    tasks: list[Task]
    pet: PETMatrix
    machines: list[Machine]
    span: float


def video_streaming_workload(n_tasks: int, span: float = 600.0,
                             n_videos: int = 12, seg_per_video: int = 12,
                             seed: int = 0, deadline_slack=(2.0, 6.0),
                             codec_share: float = 0.15) -> VideoWorkload:
    """Chapter-4 workload: ``n_tasks`` transcoding requests over ``span``
    seconds with base/high-load cycles and overlapping viewer interests."""
    # lazy: core must stay importable without the serving package loaded
    from ..serving.workload.generators import build_video_streaming_workload
    return build_video_streaming_workload(
        n_tasks, span=span, n_videos=n_videos, seg_per_video=seg_per_video,
        seed=seed, deadline_slack=deadline_slack, codec_share=codec_share)


def spiky_hc_workload(n_tasks: int, span: float = 500.0, n_task_types: int = 12,
                      n_machines: int = 8, n_machine_types: int = 4,
                      queue_size: int = 4, seed: int = 0,
                      deadline_slack=(1.5, 4.0), cv: float = 0.3,
                      homogeneous: bool = False,
                      uncertainty_mult: float = 1.0) -> HCWorkload:
    """Chapter-5 workload (Fig. 5.9): per-type arrival spikes over a base
    rate, inconsistently heterogeneous PET matrix, machines of
    ``n_machine_types`` types with distinct cost/power rates."""
    from ..serving.workload.generators import build_spiky_hc_workload
    return build_spiky_hc_workload(
        n_tasks, span=span, n_task_types=n_task_types, n_machines=n_machines,
        n_machine_types=n_machine_types, queue_size=queue_size, seed=seed,
        deadline_slack=deadline_slack, cv=cv, homogeneous=homogeneous,
        uncertainty_mult=uncertainty_mult)

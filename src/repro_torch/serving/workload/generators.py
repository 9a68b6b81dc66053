"""Chapter 4/5 trace generators, re-hosted on :mod:`arrivals`.

These are the dissertation's bounded workload generators, moved here from
``repro.core.workload`` (which keeps byte-compatible wrappers) so their
arrival shaping runs through the :class:`ArrivalProcess` abstraction the
closed-loop subsystem shares: the Chapter-4 base/high-load cycle is a
:class:`DiurnalProcess`, the Chapter-5 per-type bursts a
:class:`SpikeSchedule`.  Re-hosting preserved the original RNG draw
sequences exactly — same seed, same tasks.

A copy of ``repro.serving.workload.generators`` for the port, unchanged but
for its docstring.
"""

from __future__ import annotations

import numpy as np

from ...core.merge_model import CODEC_PARAMS, VIC_OPS, VideoMeta
from ...core.merge_model import VideoExecModel
from ...core.tasks import Machine, PETMatrix, Task
from .arrivals import DiurnalProcess, SpikeSchedule

__all__ = ["build_video_streaming_workload", "build_spiky_hc_workload"]


_VIC_PARAMS = {
    "bitrate": ("384K", "512K", "768K", "1024K", "1536K"),
    "framerate": ("10", "15", "20", "30", "40"),
    "resolution": ("352x288", "680x320", "720x480", "1280x800", "1920x1080"),
}


def build_video_streaming_workload(n_tasks: int, span: float = 600.0,
                                   n_videos: int = 12, seg_per_video: int = 12,
                                   seed: int = 0, deadline_slack=(2.0, 6.0),
                                   codec_share: float = 0.15):
    """Chapter-4 workload: ``n_tasks`` transcoding requests over ``span``
    seconds with base/high-load cycles and overlapping viewer interests."""
    from ...core.workload import VideoWorkload   # dataclass stays put
    rng = np.random.default_rng(seed)
    exec_model = VideoExecModel(seed=seed + 1)
    videos = {}
    for vid in range(n_videos):
        for seg in range(seg_per_video):
            videos[f"v{vid}s{seg}"] = VideoMeta.sample(rng)

    # base/high-load cycle: high period = span / (15 cycles * 4), 2x rate —
    # the daily pattern of live streaming, as a DiurnalProcess with one
    # high window at the head of each cycle
    n_cycles = 15
    cycle = span / n_cycles
    arrivals = DiurnalProcess(cycle=cycle, peaks=((0.0, cycle / 4.0),),
                              high=2.0)
    times = arrivals.sample_times(rng, n_tasks, span)

    tasks = []
    i = 0
    while i < len(times):
        # groups of 5 consecutive segments per "viewer" request burst
        vid = int(rng.integers(0, n_videos))
        seg0 = int(rng.integers(0, seg_per_video))
        if rng.random() < codec_share:
            op = str(rng.choice(CODEC_PARAMS))
            param = op
        else:
            op = str(rng.choice(VIC_OPS))
            param = str(rng.choice(_VIC_PARAMS[op]))
        user = f"u{int(rng.integers(0, max(4, n_tasks // 50)))}"
        for g in range(5):
            if i >= len(times):
                break
            seg = (seg0 + g) % seg_per_video
            data_id = f"v{vid}s{seg}"
            v = videos[data_id]
            exec_est = exec_model.individual_time(v, op, noisy=False)
            slack = float(rng.uniform(*deadline_slack))
            t_arr = times[i]
            tasks.append(Task(ttype=op, data_id=data_id, op=op, params=(param,),
                              arrival=t_arr, deadline=t_arr + slack * exec_est,
                              user=user))
            i += 1
    return VideoWorkload(tasks=tasks, videos=videos, exec_model=exec_model,
                         span=span)


def build_spiky_hc_workload(n_tasks: int, span: float = 500.0,
                            n_task_types: int = 12, n_machines: int = 8,
                            n_machine_types: int = 4, queue_size: int = 4,
                            seed: int = 0, deadline_slack=(1.5, 4.0),
                            cv: float = 0.3, homogeneous: bool = False,
                            uncertainty_mult: float = 1.0):
    """Chapter-5 workload (Fig. 5.9): per-type arrival spikes over a base
    rate, inconsistently heterogeneous PET matrix, machines of
    ``n_machine_types`` types with distinct cost/power rates."""
    from ...core.workload import HCWorkload      # dataclass stays put
    rng = np.random.default_rng(seed)
    ttypes = [f"t{i}" for i in range(n_task_types)]
    mtypes = ["m0"] if homogeneous else [f"m{i}" for i in range(n_machine_types)]
    pet = PETMatrix.generate(ttypes, mtypes, rng, mean_range=(8, 40), cv=cv,
                             inconsistent=not homogeneous)

    machines = []
    for j in range(n_machines):
        mt = mtypes[j % len(mtypes)]
        # faster machine types cost more (Fig. 5.19 cost/energy model)
        idx = mtypes.index(mt)
        machines.append(Machine(mid=j, mtype=mt, queue_size=queue_size,
                                cost_rate=1.0 + 0.5 * idx,
                                power=1.0 + 0.35 * idx))

    # per-type spike schedule: each type gets 2-4 spike windows of
    # span*0.05, weight 4x inside — the keyed bursty process
    sched = SpikeSchedule.sample(rng, ttypes, span, n_range=(2, 5),
                                 width=0.05, high=4.0)

    tasks = []
    while len(tasks) < n_tasks:
        tt = str(rng.choice(ttypes))
        t = float(rng.uniform(0, span))
        if rng.random() < sched.weight(tt, t) / sched.high:
            mean_exec = np.mean([pet.mean(tt, m) for m in machines])
            slack = float(rng.uniform(*deadline_slack))
            tasks.append(Task(ttype=tt, data_id=f"d{len(tasks)}", op=tt,
                              arrival=t, deadline=t + slack * mean_exec))
    tasks.sort(key=lambda x: x.arrival)

    if uncertainty_mult != 1.0:
        # ground-truth runtimes get (5SD/10SD experiments) wider spread than
        # the estimator believes — see Simulator.exec_sample
        pass
    return HCWorkload(tasks=tasks, pet=pet, machines=machines, span=span)

"""One package's classes behind one name, so a test body runs unchanged on
the port (``repro_torch``) and on its JAX reference (``repro``).

The port's twins of the JAX test files build the class under test from
``PORT`` and run the same inputs through ``JAX`` as the referee::

    from torch_jax_side import JAX, PORT, both

    out = both(lambda side: side.convolve_pct(...))

``both`` runs the body on each package and asserts that the two results
are equal (``same``): a PMF bin for bin, a simulator's stats field for
field but for their wall times.

``PORT`` passes ``device="cpu"`` to every engine and simulator it builds
(``PORT.dev``); ``JAX`` passes nothing.  Names resolve lazily, one module
at a time, so a file that needs only ``core.pmf`` imports only that.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib

import numpy as np

#: where each name lives, relative to the package root (the same in both)
_WHERE = {
    **dict.fromkeys(("PMF", "DropMode", "chance_of_success", "convolve_pct",
                     "queue_pcts"), "core.pmf"),
    **dict.fromkeys(("Machine", "PETMatrix", "Task"), "core.tasks"),
    **dict.fromkeys(("MergeLevel", "SimilarityDetector", "merge_tasks",
                     "common_prefix_len"), "core.merging"),
    **dict.fromkeys(("DropToggle", "adaptive_alpha",
                     "oversubscription_level"), "core.oversubscription"),
    **dict.fromkeys(("Pruner", "PruningConfig"), "core.pruning"),
    **dict.fromkeys(("HEURISTICS", "MappingContext", "make_heuristic"),
                    "core.heuristics"),
    **dict.fromkeys(("PETOracle", "SimConfig", "Simulator", "VideoOracle"),
                    "core.simulation"),
    **dict.fromkeys(("FleetSpec", "MachineSpec"), "core.fleet"),
    **dict.fromkeys(("spiky_hc_workload", "video_streaming_workload"),
                    "core.workload"),
    **dict.fromkeys(("BlockPool", "PrefixIndex", "PrefixKVCache"),
                    "serving.kvcache"),
    "StepBatchingConfig": "serving.batching",
    "ElasticityConfig": "serving.autoscale",
    **dict.fromkeys(("EngineConfig", "Request", "ServingEngine"),
                    "serving.engine"),
    "Router": "serving.cluster",
    "Telemetry": "obs",
}

#: the reference's MSD pruning (``tests/test_controlplane.py``)
MSD_PRUNING = dict(initial_defer_threshold=0.1, base_drop_threshold=0.05,
                   dynamic_defer=True)


class Side:
    """The classes of package ``pkg`` and the helpers the twins share: the
    reference's PET draws, request traces, their simulator tasks, and one
    simulator or stub-engine run."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        self.dev = {"device": "cpu"} if pkg == "repro_torch" else {}

    def __getattr__(self, name):
        if name not in _WHERE:
            raise AttributeError(name)
        obj = getattr(importlib.import_module(f"{self.pkg}.{_WHERE[name]}"),
                      name)
        setattr(self, name, obj)
        return obj

    def pet(self, seed=3, ttypes=("generate",), mtypes=("m0",),
            mean_range=(8, 16), **kw):
        return self.PETMatrix.generate(list(ttypes), list(mtypes),
                                       np.random.default_rng(seed),
                                       mean_range=mean_range, **kw)

    def request_trace(self, n=40, seed=1, n_prompts=5, deadline=80.0,
                      rate=0.5):
        """``n`` generate requests over ``n_prompts`` 8-token prompts,
        Poisson arrivals at ``rate``, each due ``deadline`` after it
        arrives: [(arrival, Request)]."""
        rng = np.random.default_rng(seed)
        prompts = [tuple(rng.integers(1, 1000, size=8).tolist())
                   for _ in range(n_prompts)]
        out, t = [], 0.0
        for _ in range(n):
            out.append((t, self.Request(
                prompt=prompts[int(rng.integers(0, n_prompts))],
                op="generate", n_new=int(rng.integers(1, 4)),
                seed=int(rng.integers(0, 2)), deadline=t + deadline)))
            t += float(rng.exponential(1.0 / rate))
        return out

    @staticmethod
    def mirror_tasks(trace):
        """Simulator tasks built exactly as the engine's ingest does."""
        return [req.to_task(t, i) for i, (t, req) in enumerate(trace)]

    def config(self, kw):
        """A copy of ``kw`` with its ``pruning``, ``elasticity`` and
        ``batching`` dicts built as this package's config objects."""
        kw = dict(kw)
        for key, cls in (("pruning", "PruningConfig"),
                         ("elasticity", "ElasticityConfig"),
                         ("batching", "StepBatchingConfig")):
            if isinstance(kw.get(key), dict):
                kw[key] = getattr(self, cls)(**kw[key])
        return kw

    def fleet(self, fleet):
        """A FleetSpec from its text, or ``homogeneous(n)`` from an int."""
        return (self.FleetSpec.homogeneous(fleet) if isinstance(fleet, int)
                else self.FleetSpec.parse(fleet))

    def simulate(self, trace, fleet=2, pet=None, oracle_seed=11, tel=None,
                 **cfg_kw):
        """This package's simulator on the mirror of ``trace``: (simulator,
        stats), its ``cp.trace`` recorded.  Hard deadlines go with pruning
        unless ``cfg_kw`` says otherwise."""
        kw = self.config(cfg_kw)
        kw.setdefault("hard_deadlines", kw.get("pruning") is not None)
        pet = self.pet() if pet is None else pet
        sim = self.Simulator(self.mirror_tasks(trace), self.fleet(fleet),
                             self.PETOracle(pet, seed=oracle_seed),
                             self.SimConfig(**kw), **self.dev)
        if tel is not None:
            sim.attach_telemetry(tel)
        sim.cp.trace = []
        return sim, sim.run()

    def stub_engine(self, pet=None, n_units=2, oracle_seed=11, tel=None,
                    **cfg_kw):
        """A stub-execution engine on this package's oracle, its
        ``cp.trace`` recorded."""
        kw = dict(elasticity=None, result_cache=False, prefix_cache=False)
        kw.update(self.config(cfg_kw))
        pet = self.pet() if pet is None else pet
        eng = self.ServingEngine(None, None, self.EngineConfig(
            n_units=n_units, **kw),
            stub_oracle=self.PETOracle(pet, seed=oracle_seed), **self.dev)
        if tel is not None:
            eng.attach_telemetry(tel)
        eng.cp.trace = []
        return eng


PORT, JAX = Side("repro_torch"), Side("repro")


def same(x):
    """``x`` in a form that compares by value across the two packages: an
    array as its dtype, shape and numbers, an enum member as its name, a
    dataclass (a PMF, a simulator's stats) as its fields but for wall
    times, containers element by element."""
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, tuple(x.ravel().tolist()))
    if isinstance(x, enum.Enum):
        return x.name
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: same(getattr(x, f.name))
                for f in dataclasses.fields(x) if "wall" not in f.name}
    if isinstance(x, dict):
        return {k: same(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(same(v) for v in x)
    return x


def both(run):
    """``run(side)`` on the port and on the reference, the same inputs to
    each: the port's result, after asserting that it equals the
    reference's."""
    port, ref = run(PORT), run(JAX)
    assert same(port) == same(ref)
    return port


#: the port's config fields that the JAX package's dataclasses lack (latent
#: attention and DeepSeek-V2's gates), each at the value that leaves a JAX
#: twin's model as JAX's: no latent attention, renormalised gates, no scale
PORT_ONLY_CONFIG = {"mla": None, "moe": {"norm_topk_prob": True,
                                          "routed_scaling_factor": 1.0}}


def config_fields(cfg) -> dict:
    """A port ``ModelConfig`` as ``dataclasses.asdict`` with the fields the
    JAX package lacks taken out, after asserting each holds the value that
    keeps the model JAX's (``PORT_ONLY_CONFIG``): comparable with the JAX
    config's ``asdict``."""
    d = dataclasses.asdict(cfg)
    for key, want in PORT_ONLY_CONFIG.items():
        if isinstance(want, dict):
            if d[key] is not None:
                for k, v in want.items():
                    assert d[key].pop(k) == v, (cfg.name, key, k)
        else:
            assert d.pop(key) == want, (cfg.name, key)
    return d

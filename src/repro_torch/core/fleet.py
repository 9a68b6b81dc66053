"""Heterogeneous machine-fleet catalog (the dissertation's machine-type axis).

The scheduling and cost results of Ch. 4-5 (Fig. 5.19 in particular) are
defined over a *heterogeneous* machine pool: the PET matrix is keyed by
(task type x machine type) and cost is a per-machine *rate*, not a count.
:class:`FleetSpec` is that pool as a first-class object, threaded through
every layer that constructs machines — the serving engine's processing
units, the discrete-event simulator, the Router's plane factories and the
serve launcher — so a mixed fleet is described once and both substrates
build *the same* machines from it by construction (the PET keys, speeds,
cost rates and queue depths can never drift between an engine and the
simulator mirroring it).

A :class:`MachineSpec` row also names the *backend* a unit runs on
(ROADMAP "heterogeneous substrates"): ``compiled`` — a real JAX
processing unit; ``stub`` — an oracle-timed remote-endpoint stand-in;
``emulated`` — a compiled unit whose virtual timeline is scaled by
``speed`` (the thesis's emulation mode run deliberately slow).  ``auto``
resolves to whatever the owning engine runs (compiled when live, stub in
stub-execution mode).

A spec also carries a *phase* role for prefill/decode disaggregation
(DESIGN.md §2.13): ``prefill`` machines run chunked prefills and hand the
finished KV off, ``decode`` machines run the batched decode loops, and
``mixed`` (the default) does both — today's unified behavior.  The phase
rides on the mtype slot as an ``@`` suffix so every existing fleet string
stays valid.

Launcher syntax (parse/serialize roundtrip)::

    tpu:4:1.0:1.0,cpu:4:0.25:0.2
    pre@prefill:1:1.5:1.25,dec@decode:2:0.5:0.35
    mtype[@phase]:count[:speed[:cost_rate[:backend[:queue_size[:power]]]]]

No JAX imports here — the catalog must stay importable by the pure-NumPy
simulation path.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from .tasks import Machine

__all__ = ["BACKENDS", "DEFAULT_MTYPE", "PHASES", "MachineSpec", "FleetSpec",
           "kv_block_budget"]

#: unit backend kinds (see module docstring); "auto" follows the engine mode
BACKENDS = ("auto", "compiled", "stub", "emulated")

#: phase roles for prefill/decode disaggregation; "mixed" = unified serving
PHASES = ("mixed", "prefill", "decode")

#: admission-aware KV budget weights: a prefill plane holds blocks only
#: until the handoff migrates them out (transient working set), a decode
#: plane accumulates every migrated prefix (resident set), mixed keeps the
#: historical uniform budget
_PHASE_KV_WEIGHT = {"prefill": 0.5, "decode": 1.5, "mixed": 1.0}


def kv_block_budget(base: int, phase: str = "mixed",
                    speed: float = 1.0) -> int:
    """Per-unit block budget sized from the machine's role and speed: a
    fast machine admits proportionally more prefill work per unit time, so
    it earns a proportionally larger pool; the phase weight encodes the
    transient-vs-resident working-set asymmetry above.  ``base`` is the
    config-level budget (`kv_cache_blocks` / `prefix_cache_blocks`), and
    ``mixed`` at speed 1 reproduces it exactly."""
    return max(1, int(round(base * _PHASE_KV_WEIGHT[phase] * speed)))

#: the one default machine type shared by every layer.  Historically the
#: live engine said "tpu" while the stub engine and the simulator said
#: "m0", so PET matrices keyed for one substrate silently missed the
#: other; a single default makes trace-equivalence tests exercise the
#: same PET keys by construction.
DEFAULT_MTYPE = "m0"


@dataclass(frozen=True)
class MachineSpec:
    """One machine-type row of the fleet catalog (count units of it)."""

    mtype: str = DEFAULT_MTYPE
    count: int = 1
    speed: float = 1.0          # consistent heterogeneity: time scale 1/speed
    cost_rate: float = 1.0      # $ per virtual time unit (Fig. 5.19)
    backend: str = "auto"       # BACKENDS member
    queue_size: int = 4         # pending slots (excl. executing task)
    power: float = 1.0          # energy per time unit
    phase: str = "mixed"        # PHASES member (§2.13 disaggregation role)

    def __post_init__(self):
        if not self.mtype:
            raise ValueError("MachineSpec needs a non-empty mtype")
        if self.count < 1:
            raise ValueError(f"MachineSpec count must be >= 1, got {self.count}")
        if self.speed <= 0:
            raise ValueError(f"MachineSpec speed must be > 0, got {self.speed}")
        if self.cost_rate < 0:
            raise ValueError("MachineSpec cost_rate must be >= 0")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"have {BACKENDS}")
        if self.phase not in PHASES:
            raise ValueError(f"unknown phase {self.phase!r}; have {PHASES}")

    def build_machine(self, mid: int) -> Machine:
        return Machine(mid=mid, mtype=self.mtype, speed=self.speed,
                       queue_size=self.queue_size, cost_rate=self.cost_rate,
                       power=self.power, phase=self.phase)

    def kv_blocks(self, base: int) -> int:
        """Admission-aware per-unit block budget (see kv_block_budget)."""
        return kv_block_budget(base, self.phase, self.speed)

    def serialize(self) -> str:
        mt = self.mtype if self.phase == "mixed" else \
            f"{self.mtype}@{self.phase}"
        out = (f"{mt}:{self.count}:{self.speed:g}"
               f":{self.cost_rate:g}:{self.backend}:{self.queue_size}")
        if self.power != 1.0:           # keep the common case short
            out += f":{self.power:g}"
        return out


@dataclass(frozen=True)
class FleetSpec:
    """An ordered catalog of machine-type rows — the whole pool."""

    specs: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))
        if not self.specs:
            raise ValueError("FleetSpec needs at least one MachineSpec")

    # -- constructors ---------------------------------------------------------
    @classmethod
    def homogeneous(cls, n: int, **spec_kw) -> "FleetSpec":
        """The default fleet: ``n`` identical units — reproduces today's
        pools (mtype ``m0``, speed 1, cost rate 1, queue 4, auto backend)."""
        return cls((MachineSpec(count=n, **spec_kw),))

    @classmethod
    def parse(cls, text: str) -> "FleetSpec":
        """``mtype[@phase]:count[:speed[:cost_rate[:backend[:queue_size
        [:power]]]]]`` rows, comma-separated (the ``--fleet`` syntax)."""
        specs = []
        for row in text.split(","):
            parts = [p.strip() for p in row.split(":")]
            if not parts[0]:
                raise ValueError(f"empty mtype in fleet row {row!r}")
            if len(parts) < 2 or len(parts) > 7:
                raise ValueError(
                    f"bad fleet row {row!r}: want mtype[@phase]:count[:speed"
                    "[:cost_rate[:backend[:queue_size[:power]]]]]")
            mtype, _, phase = parts[0].partition("@")
            kw = dict(mtype=mtype, count=int(parts[1]))
            if phase:
                kw["phase"] = phase
            if len(parts) > 2:
                kw["speed"] = float(parts[2])
            if len(parts) > 3:
                kw["cost_rate"] = float(parts[3])
            if len(parts) > 4:
                kw["backend"] = parts[4]
            if len(parts) > 5:
                kw["queue_size"] = int(parts[5])
            if len(parts) > 6:
                kw["power"] = float(parts[6])
            specs.append(MachineSpec(**kw))
        return cls(tuple(specs))

    def serialize(self) -> str:
        """Roundtrips through :meth:`parse`."""
        return ",".join(s.serialize() for s in self.specs)

    # -- catalog views --------------------------------------------------------
    @property
    def total(self) -> int:
        return sum(s.count for s in self.specs)

    @property
    def mtypes(self) -> list:
        """Distinct machine types, declaration order."""
        seen: dict = {}
        for s in self.specs:
            seen.setdefault(s.mtype, None)
        return list(seen)

    @property
    def disaggregated(self) -> bool:
        """True when any row declares a non-mixed phase role (§2.13)."""
        return any(s.phase != "mixed" for s in self.specs)

    @property
    def is_homogeneous(self) -> bool:
        return len({(s.mtype, s.speed, s.cost_rate, s.backend, s.queue_size,
                     s.power, s.phase) for s in self.specs}) == 1

    def expand(self) -> list:
        """Per-unit specs (count=1 each), declaration order — the exact
        construction order of engine units and simulator machines."""
        return [replace(s, count=1) for s in self.specs for _ in
                range(s.count)]

    def cheapest(self) -> MachineSpec:
        """The scale-up prototype: lowest cost rate wins, declaration order
        breaks ties — with a homogeneous fleet this is the one spec, so
        elastic growth reproduces the legacy clone-machines[0] behavior."""
        return min((replace(s, count=1) for s in self.specs),
                   key=lambda s: s.cost_rate)

    def cost_rate_total(self) -> float:
        return sum(s.cost_rate * s.count for s in self.specs)

    # -- machine construction -------------------------------------------------
    def build_machines(self, start_mid: int = 1) -> list:
        """Fresh :class:`Machine` rows, mids sequential from ``start_mid``
        (1 by default — the serving engine's unit ids also start at 1, so a
        simulator built from the same spec mirrors the engine's machines
        field-for-field)."""
        return [spec.build_machine(start_mid + i)
                for i, spec in enumerate(self.expand())]

"""``ScenarioSpec``: the composed-adversity grammar.

A copy of the JAX package's ``scenario/spec.py`` on the port's
``fedcore.faults``, ``serving.chaos`` and ``utils.seeds`` (numpy only,
no device): the same spec expands to the same plans, array for array
and dtype for dtype, so a schedule digest is the same in both packages
and the committed campaigns re-derive here.

One master seed, a handful of INTENSITY knobs in ``[0, 1]`` (one per
underlying grammar) and small event counts expand — deterministically,
bitwise — into everything a scenario run needs:

- a ``FaultSpec``/``FaultPlan`` for the train leg (drop / straggle /
  corrupt / lie rates scaled by ``faults``),
- a ``ChaosSpec``/``ChaosPlan`` for the replica dispatch boundary
  (wedge / flaky / slow scaled by ``chaos``; never KILL — process
  death is an EVENT here, recoverable, so the fleet can rejoin),
- a ``LoadSpec`` arrival schedule (peak scaled by ``load``) replayed
  time-compressed as inter-submit gaps,
- a ``NetChaosSpec``/``NetChaosPlan`` for the socket transports
  (partition / refuse / lag scaled by ``net``),
- an event schedule: weight swaps, worker SIGKILL+rejoin pairs, and
  scripted autoscale add/remove events, each pinned to a submit index.

Sub-seeds come from ``utils.seeds.derive_seed`` (splittable hash), so
no two grammars under one master ever share an RNG stream and no two
masters alias each other's streams.

Event placement is structured, not uniform: kills land in the first
half of the request stream and swaps in the second, with a killed
worker rejoining ``restart_delay`` submits after its death. That
ordering is the hostile one — a swap announced while a worker is down
is exactly the announce gap the worker-side ``sync`` handshake
(``serving.transport.PodWorker``) exists to close, and the oracle's
version-agreement invariant fails loudly without it.

Spec string syntax (the ``FaultSpec.parse`` contract)::

    seed=7,rounds=3,clients=8,replicas=2,requests=24,faults=0.3,
    chaos=0.2,load=0.5,net=0.1,swaps=1,kills=1,scales=0

The grammar grew twice. Two COUNT knobs script the carried pod fault
classes (emitted in ``canonical()`` only when non-zero, so
every pre-existing spec string, digest, and committed campaign stays
bitwise identical): ``announce_restarts=N`` restarts N workers
mid-announce (each race pinned to one swap ordinal through the
``net``/``announce_restart`` sub-stream) and ``forges=N`` turns N
workers into byzantine sync peers serving forged weights under a
forged version (the ``net``/``forge`` sub-stream draws victims and
versions). And a MUTATION tail ``mut=STREAM@N[+STREAM@N...]`` re-keys
exactly one sub-grammar's seed stream per entry
(``derive_seed(stream_seed, "mut", N)``): the coverage-guided hunter
perturbs a near-miss scenario along the stream that nearly violated —
keeping every OTHER stream bitwise intact — instead of redrawing the
whole scenario.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from ..fedcore.faults import FaultPlan, FaultSpec
from ..serving.chaos import (ChaosPlan, ChaosSpec, LoadSpec,
                             NetChaosPlan, NetChaosSpec)
from ..utils.seeds import derive_rng, derive_seed

#: SLO-class mix of the synthetic request stream: mostly interactive
#: (the protected class), the rest split between batch and shadow (the
#: two classes ``serving.control.DEFAULT_SHED_ORDER`` may shed).
CLASS_NAMES = ("interactive", "batch", "shadow")
CLASS_WEIGHTS = (0.5, 0.3, 0.2)

#: Corrupt modes the fault sub-spec may draw (the full FaultSpec menu).
_CORRUPT_MODES = ("nan", "inf", "sign", "scale")

#: Event kinds, in tie-break order at one submit index.
EVENT_KINDS = ("kill", "restart", "swap", "scale_up", "scale_down")

#: Chaos/net plans must outlive the request stream: retries, hedges and
#: failover walks dispatch more often than requests arrive.
_HORIZON_PER_REQUEST = 8
_MIN_HORIZON = 64

#: Sub-grammar streams the mutation tail may re-key. The intra-stream
#: shape draws ("mode"/"shape"/"classes") stay master-tied on purpose:
#: a mutant explores the SAME kind of adversity at different timing,
#: not a different scenario altogether.
MUT_STREAMS = ("faults", "chaos", "load", "net", "events")


@dataclasses.dataclass(frozen=True)
class ScenarioEvent:
    """One scheduled mid-stream event: fires just before submit ``at``.

    ``arg`` is the kind's operand — the worker/host index for
    ``kill``/``restart``, the swap ordinal for ``swap``, and the
    scale-event ordinal for ``scale_up``/``scale_down``.
    """

    at: int
    kind: str
    arg: int = 0

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(
                f"event kind must be one of {EVENT_KINDS}, got "
                f"{self.kind!r}")
        if self.at < 0 or self.arg < 0:
            raise ValueError(
                f"event at={self.at} arg={self.arg} must be >= 0")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Master seed + intensity knobs + event counts (module docstring).

    Intensities are fractions of each grammar's composable rate
    budget, NOT raw rates — ``faults=1.0`` keeps the per-cell role
    rates summing under 1 (the grammars' own precedence contract), so
    every point of the knob cube is a valid scenario.
    """

    seed: int = 0
    rounds: int = 3
    clients: int = 8
    replicas: int = 2
    requests: int = 24
    faults: float = 0.0
    chaos: float = 0.0
    load: float = 0.0
    net: float = 0.0
    swaps: int = 0
    kills: int = 0
    scales: int = 0
    announce_restarts: int = 0
    forges: int = 0
    mut: tuple = ()

    def __post_init__(self):
        if self.seed < 0:
            raise ValueError(f"seed={self.seed} must be >= 0")
        for name, lo in (("rounds", 1), ("clients", 2), ("replicas", 1),
                         ("requests", 1)):
            v = getattr(self, name)
            if not isinstance(v, int) or v < lo:
                raise ValueError(
                    f"{name}={v!r} must be an int >= {lo}")
        for name in ("faults", "chaos", "load", "net"):
            v = getattr(self, name)
            if not (np.isfinite(v) and 0.0 <= v <= 1.0):
                raise ValueError(
                    f"intensity {name}={v} must be in [0, 1]")
        for name in ("swaps", "kills", "scales", "announce_restarts",
                     "forges"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 0:
                raise ValueError(f"{name}={v!r} must be an int >= 0")
        mut = tuple((str(s), int(n)) for s, n in self.mut)
        object.__setattr__(self, "mut", mut)
        for s, n in mut:
            if s not in MUT_STREAMS:
                raise ValueError(
                    f"mut stream {s!r} must be one of "
                    f"{'/'.join(MUT_STREAMS)}")
            if n < 1:
                raise ValueError(
                    f"mut attempt {n} for stream {s!r} must be >= 1")
        if self.announce_restarts > self.swaps:
            raise ValueError(
                f"announce_restarts={self.announce_restarts} needs one "
                f"swap per race (swaps={self.swaps}) — the race IS a "
                "restart during a version announce")
        if self.announce_restarts > 0 and self.replicas < 2:
            raise ValueError(
                f"announce_restarts={self.announce_restarts} needs "
                "replicas >= 2 — the restarting victim must have a "
                "peer to resync from")
        if self.announce_restarts > self.replicas:
            raise ValueError(
                f"announce_restarts={self.announce_restarts} exceeds "
                f"replicas={self.replicas}: one race per host")
        if self.forges > 0 and self.replicas < 2 * self.forges + 2:
            raise ValueError(
                f"forges={self.forges} needs replicas >= "
                f"{2 * self.forges + 2}: fingerprint quorum holds only "
                "while a rejoiner's HONEST peers outnumber forgers by "
                "a strict majority — fewer replicas measures a lost "
                "pod, not the defense")
        if self.kills > 0 and self.replicas < 2:
            raise ValueError(
                f"kills={self.kills} needs replicas >= 2 — with one "
                "worker down and no survivor, every dispatch fails "
                "and the scenario measures nothing but the outage")
        if (self.swaps or self.kills or self.scales) \
                and self.requests < 8:
            raise ValueError(
                f"requests={self.requests} leaves no room for "
                "mid-stream events (need >= 8)")

    # -- string grammar ------------------------------------------------
    _FIELDS = ("seed", "rounds", "clients", "replicas", "requests",
               "faults", "chaos", "load", "net", "swaps", "kills",
               "scales", "announce_restarts", "forges", "mut")
    _INT_FIELDS = frozenset(("seed", "rounds", "clients", "replicas",
                             "requests", "swaps", "kills", "scales",
                             "announce_restarts", "forges"))
    #: Fields canonical() emits unconditionally — the string layout
    #: before the count knobs and the mutation tail, frozen so every
    #: committed digest/regression key survives the grammar growth
    #: byte-for-byte.
    _ALWAYS_FIELDS = _FIELDS[:12]

    @classmethod
    def parse(cls, text: str) -> "ScenarioSpec":
        """Parse the spec syntax (module docstring). Unknown keys and
        malformed values raise ``ValueError`` naming the token — the
        ``FaultSpec.parse`` fail-at-the-boundary contract."""
        kw: dict = {}
        for token in text.split(","):
            token = token.strip()
            if not token:
                continue
            if "=" not in token:
                raise ValueError(
                    f"scenario spec token {token!r} is not key=value "
                    "(expected e.g. 'seed=7,faults=0.3,kills=1')")
            key, val = token.split("=", 1)
            key = key.strip().lower()
            if key not in cls._FIELDS:
                raise ValueError(
                    f"unknown scenario spec key {key!r} (expected "
                    f"{'/'.join(cls._FIELDS)})")
            if key == "mut":
                kw[key] = cls._parse_mut(token, val)
                continue
            try:
                kw[key] = (int(val) if key in cls._INT_FIELDS
                           else float(val))
            except ValueError as e:
                raise ValueError(
                    f"scenario spec token {token!r}: {e}") from None
        return cls(**kw)

    @staticmethod
    def _parse_mut(token: str, val: str) -> tuple:
        out = []
        for part in val.split("+"):
            try:
                stream, n = part.split("@", 1)
                out.append((stream.strip(), int(n)))
            except ValueError:
                raise ValueError(
                    f"scenario spec token {token!r}: expected "
                    "STREAM@N[+STREAM@N...] (e.g. 'mut=events@1')"
                ) from None
        return tuple(out)

    def canonical(self) -> str:
        """The full round-trippable spec string — every field, fixed
        order, so ``parse(canonical())`` is identity and the string is
        a stable digest/regression key. The count knobs and the
        mutation tail append only when ACTIVE, so every earlier spec's
        canonical string — and everything keyed on it — is
        unchanged."""
        parts = []
        for name in self._ALWAYS_FIELDS:
            v = getattr(self, name)
            parts.append(f"{name}={v:g}" if isinstance(v, float)
                         else f"{name}={v}")
        for name in ("announce_restarts", "forges"):
            if getattr(self, name):
                parts.append(f"{name}={getattr(self, name)}")
        if self.mut:
            parts.append("mut=" + "+".join(
                f"{s}@{n}" for s, n in self.mut))
        return ",".join(parts)

    # -- sub-grammar derivation ---------------------------------------
    def _sub_seed(self, label: str) -> int:
        """The seed of one sub-grammar stream: the plain
        ``derive_seed`` split, re-keyed once per matching ``mut``
        entry. With an empty mutation tail this IS the plain
        derivation — same integer, same stream, bitwise — and a
        mutant's OTHER streams stay on their parent's seeds."""
        s = derive_seed(self.seed, label)
        for stream, n in self.mut:
            if stream == label:
                s = derive_seed(s, "mut", n)
        return s

    def fault_spec(self) -> FaultSpec:
        """The train-leg fault grammar at this intensity. Rates sum to
        ``0.85 * faults`` — under the FaultPlan precedence budget at
        every knob setting."""
        mode = _CORRUPT_MODES[int(
            derive_rng(self.seed, "faults", "mode").randint(
                len(_CORRUPT_MODES)))]
        return FaultSpec(
            drop=round(0.25 * self.faults, 6),
            straggle=round(0.25 * self.faults, 6), straggle_frac=0.4,
            corrupt=round(0.20 * self.faults, 6), corrupt_mode=mode,
            corrupt_scale=25.0,
            lie=round(0.15 * self.faults, 6), lie_frac=0.2,
            seed=self._sub_seed("faults"))

    def chaos_spec(self) -> ChaosSpec:
        """Replica-boundary chaos at this intensity. ``kill`` stays 0
        by design: a ChaosPlan KILL is a permanent replica death the
        router retires, while the scenario grammar wants RECOVERABLE
        process kills (the ``kill``/``restart`` event pair) so the
        rejoin path is exercised."""
        return ChaosSpec(
            wedge=round(0.15 * self.chaos, 6), wedge_s=0.05,
            flaky=round(0.25 * self.chaos, 6),
            slow=round(0.20 * self.chaos, 6), slow_mult=2.0,
            seed=self._sub_seed("chaos"))

    def load_spec(self) -> LoadSpec:
        """Arrival schedule: shape drawn from the sub-seeded stream,
        peak scaled by ``load`` (``load=0`` is a steady trickle)."""
        shape = ("diurnal", "flash", "overload")[int(
            derive_rng(self.seed, "load", "shape").randint(3))]
        base = 40.0
        return LoadSpec(
            shape=shape, base_rps=base,
            peak_rps=base * (1.0 + 19.0 * self.load),
            duration_s=2.0, at=0.4, width=0.2,
            seed=self._sub_seed("load"))

    def net_spec(self) -> NetChaosSpec:
        """Wire faults at this intensity. ``kill_host`` stays empty —
        process kills are scenario EVENTS (submit-indexed, restartable)
        rather than dispatch-indexed scripted deaths, so one schedule
        drives them wherever retries move the dispatch counter.

        The two carried pod fault classes ride here: ``announce_restarts``
        races distinct victim hosts against distinct swap ordinals
        (race j targets ordinal j — validation guarantees a swap per
        race), ``forges`` turns distinct hosts byzantine under forged
        versions drawn far above any honest announce (100..199, so a
        pre-fix rejoiner's newest-wins rule reliably prefers the
        forgery). Both draw from their OWN ``net`` sub-streams — a
        spec without them derives the same NetChaosSpec it always
        did."""
        announce, forged = (), ()
        if self.announce_restarts:
            rng = derive_rng(self.seed, "net", "announce_restart")
            hosts = rng.permutation(self.replicas)
            announce = tuple(
                (int(hosts[j]), j)
                for j in range(self.announce_restarts))
        if self.forges:
            rng = derive_rng(self.seed, "net", "forge")
            hosts = rng.permutation(self.replicas)
            forged = tuple(
                (int(hosts[j]), int(100 + rng.randint(100)))
                for j in range(self.forges))
        return NetChaosSpec(
            partition=round(0.08 * self.net, 6), partition_s=0.05,
            refuse=round(0.15 * self.net, 6),
            lag=round(0.15 * self.net, 6), lag_s=0.005,
            restart_during_announce=announce, forge_sync=forged,
            seed=self._sub_seed("net"))

    # -- event schedule -----------------------------------------------
    @property
    def restart_delay(self) -> int:
        """Submits between a worker's kill and its rejoin — half the
        stream, so a second-half swap lands INSIDE the dead window
        (the announce-gap ordering the oracle's version-agreement
        invariant exists to catch)."""
        return max(3, self.requests // 2)

    def events(self) -> tuple:
        """The scripted mid-stream schedule, sorted by submit index
        (ties broken by :data:`EVENT_KINDS` order). Placement: kills
        early (fractions of the first half), swaps late (second half),
        scale events across the middle, each jittered by the events
        sub-stream — different masters move them, one master never
        does."""
        rng = np.random.RandomState(self._sub_seed("events"))
        out = []

        def place(frac: float) -> int:
            frac += float(rng.uniform(-0.03, 0.03))
            return int(min(max(frac, 0.02), 0.98) * self.requests)

        for j in range(self.kills):
            at = place(0.10 + 0.30 * (j + 1) / (self.kills + 1))
            host = int(rng.randint(self.replicas))
            out.append(ScenarioEvent(at=at, kind="kill", arg=host))
            out.append(ScenarioEvent(
                at=min(at + self.restart_delay, self.requests - 1),
                kind="restart", arg=host))
        for j in range(self.swaps):
            at = place(0.55 + 0.35 * (j + 1) / (self.swaps + 1))
            out.append(ScenarioEvent(at=at, kind="swap", arg=j))
        ups = 0
        for j in range(self.scales):
            at = place(0.20 + 0.60 * (j + 1) / (self.scales + 1))
            if j % 2 == 0:
                out.append(ScenarioEvent(at=at, kind="scale_up", arg=j))
                ups += 1
            else:
                # a down with nothing added is a no-op the oracle skips
                out.append(ScenarioEvent(at=at, kind="scale_down",
                                         arg=j))
        out.sort(key=lambda e: (e.at, EVENT_KINDS.index(e.kind), e.arg))
        return tuple(out)

    def max_fleet(self) -> int:
        """Hosts the plans must cover: the initial fleet plus every
        scale-up the event schedule can add."""
        return self.replicas + (self.scales + 1) // 2

    def slo_classes(self) -> tuple:
        """Per-request SLO class, drawn from the classes sub-stream."""
        rng = derive_rng(self.seed, "classes")
        idx = rng.choice(len(CLASS_NAMES), size=self.requests,
                         p=CLASS_WEIGHTS)
        return tuple(CLASS_NAMES[int(i)] for i in idx)

    def arrival_gaps(self) -> np.ndarray:
        """Inter-submit gaps (seconds, uncompressed) for the request
        stream, cut from the LoadSpec's thinned-Poisson offsets and
        cycled when the draw is shorter than the stream."""
        offs = self.load_spec().offsets()
        if offs.size < 2:
            return np.zeros(self.requests, dtype=np.float64)
        gaps = np.diff(offs)
        reps = int(np.ceil(self.requests / gaps.size))
        return np.tile(gaps, reps)[:self.requests]

    # -- full expansion + the bitwise contract ------------------------
    def expand(self) -> "ScenarioPlan":
        horizon = max(_MIN_HORIZON,
                      self.requests * _HORIZON_PER_REQUEST)
        fleet = self.max_fleet()
        return ScenarioPlan(
            spec=self,
            fault_plan=FaultPlan.build(self.fault_spec(), self.rounds,
                                       self.clients),
            chaos_plan=ChaosPlan.build(self.chaos_spec(), fleet,
                                       horizon=horizon),
            net_plan=NetChaosPlan.build(self.net_spec(), fleet,
                                        horizon=horizon),
            gaps=self.arrival_gaps(),
            classes=self.slo_classes(),
            events=self.events())

    def schedule_digest(self) -> str:
        """sha256 over every expanded schedule byte — the composed
        same-seed-bitwise-same-schedule contract in one comparable
        string (tests pin ``parse(canonical()).schedule_digest()``
        against the original's)."""
        return self.expand().digest()


@dataclasses.dataclass(frozen=True)
class ScenarioPlan:
    """One spec, fully expanded: every schedule the oracle consumes,
    in plan form (host arrays), plus the digest that proves two
    expansions identical."""

    spec: ScenarioSpec
    fault_plan: FaultPlan
    chaos_plan: ChaosPlan
    net_plan: NetChaosPlan
    gaps: np.ndarray
    classes: tuple
    events: tuple

    def digest(self) -> str:
        h = hashlib.sha256()
        h.update(self.spec.canonical().encode())
        fp = self.fault_plan
        for a in (fp.drop, fp.straggle, fp.corrupt, fp.scale,
                  fp.poison, fp.fill, fp.report, fp.lie):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(np.ascontiguousarray(self.chaos_plan.roles).tobytes())
        h.update(np.float64(
            [self.chaos_plan.wedge_s,
             self.chaos_plan.slow_mult]).tobytes())
        h.update(np.ascontiguousarray(self.net_plan.roles).tobytes())
        h.update(np.float64(
            [self.net_plan.partition_s, self.net_plan.lag_s]).tobytes())
        h.update(repr(sorted(self.net_plan.kills.items())).encode())
        if self.net_plan.announce_restarts or self.net_plan.forges:
            # appended ONLY when the announce-race or forged-sync
            # classes are armed: every digest hashed before the grammar grew (committed
            # campaigns, regression keys) stays byte-identical
            h.update(repr((
                sorted(self.net_plan.announce_restarts.items()),
                sorted(self.net_plan.forges.items()))).encode())
        h.update(np.ascontiguousarray(self.gaps).tobytes())
        h.update(",".join(self.classes).encode())
        h.update(repr([(e.at, e.kind, e.arg)
                       for e in self.events]).encode())
        return h.hexdigest()

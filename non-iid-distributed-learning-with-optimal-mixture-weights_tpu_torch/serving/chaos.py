"""Deterministic chaos injection for the serving replica fleet.

A copy of the JAX package's ``serving/chaos.py`` (numpy only): the same
grammars, the same seeded generators, so a spec builds the same plan in
both packages, cell for cell.

The serving twin of ``fedcore/faults.py``: training proves its defenses
under a seeded :class:`~fedcore.faults.FaultPlan`, and the failover
layer (``serving/replica.py``) must be proven the same way — under a
schedule of replica deaths and stalls that is **reproducible**, not
hoped for. A :class:`ChaosSpec` (parsed from the CLI-style string
syntax below) expands once, host-side, into a :class:`ChaosPlan` — a
dense ``(n_replicas, horizon)`` role matrix seeded by the spec, so the
same seed always yields the same kill/wedge/flaky/slow schedule. The
plan is consulted at the **engine-dispatch boundary**
(``Replica.predict``), which is where real failures happen: the batch
was formed, the request was routed, and then the replica died under it.

Chaos kinds (mutually exclusive per ``(replica, dispatch)`` cell,
sampled from one uniform draw — kill wins over wedge over flaky over
slow, mirroring the fault plane's role precedence):

- **kill**: the replica dies on this dispatch and STAYS dead — this
  dispatch and every later one raise ``ReplicaDead``. The router must
  re-queue the in-flight batch against survivors.
- **wedge**: the dispatch stalls for ``wedge_s`` seconds (a hung
  backend — long enough to blow a typical request deadline) and then
  fails transiently. A hedging router masks the stall by mirroring to
  a second replica at the latency threshold.
- **flaky**: the dispatch fails immediately with a transient error
  (:class:`ChaosFault` is a ``ConnectionError``, so the service's
  transient-retry classifier treats it exactly like a real tunnel
  blip).
- **slow**: the dispatch succeeds but takes ``slow_mult`` times as
  long (the real work plus a proportional stall) — the health plane's
  EWMA latency must steer traffic away from it.

Spec string syntax (mirrors the ``faults=`` grammar)::

    kill=0.01,wedge=0.02:0.25,flaky=0.05,slow=0.1:3.0,seed=7
         ^rate       ^rate ^stall_s   ^rate      ^rate ^multiplier

Rates are per (replica, dispatch) cell. Past the plan ``horizon``
(default 4096 dispatches per replica) every cell is clean — a bounded
experiment, not an unbounded hazard. For exact placement (the bench
kills replica 1 on its 25th dispatch, mid-stream, every run),
:meth:`ChaosPlan.scripted` builds the cells explicitly instead of by
rate; both constructions are plain data and fully deterministic.

Two sibling grammars share the determinism contract: :class:`LoadSpec`
scripts how TRAFFIC arrives, and :class:`NetChaosSpec`
scripts how the WIRE fails — partition/refuse/lag rates
plus scripted worker-process SIGKILLs, consumed by
``serving.transport.SocketTransport`` at the cross-process dispatch
boundary.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Role codes in the plan matrix (int8). CLEAN must be 0 so a
#: zero-initialized matrix is the clean plan.
CLEAN, KILL, WEDGE, FLAKY, SLOW = 0, 1, 2, 3, 4

_ROLE_NAMES = {CLEAN: "clean", KILL: "kill", WEDGE: "wedge",
               FLAKY: "flaky", SLOW: "slow"}


class ChaosFault(ConnectionError):
    """An injected TRANSIENT dispatch failure (flaky / post-stall
    wedge). Subclasses ``ConnectionError`` on purpose: the service's
    transient classifier (``service._is_transient``) must treat
    injected chaos exactly like the real connectivity failures it
    stands in for — no chaos-aware special case anywhere downstream."""


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Rates and shapes of the chaos to inject, plus the plan seed."""

    kill: float = 0.0
    wedge: float = 0.0
    wedge_s: float = 0.25
    flaky: float = 0.0
    slow: float = 0.0
    slow_mult: float = 3.0
    seed: int = 0

    def __post_init__(self):
        for name in ("kill", "wedge", "flaky", "slow"):
            r = getattr(self, name)
            if not 0.0 <= r <= 1.0:
                raise ValueError(
                    f"chaos rate {name}={r} must be in [0, 1]")
        total = self.kill + self.wedge + self.flaky + self.slow
        if total > 1.0:
            raise ValueError(
                f"chaos rates must sum to <= 1 (a dispatch is at most "
                f"one of kill/wedge/flaky/slow), got "
                f"kill+wedge+flaky+slow={total}")
        if not (np.isfinite(self.wedge_s) and self.wedge_s > 0):
            raise ValueError(
                f"wedge_s={self.wedge_s} must be a positive stall "
                "(seconds the wedged dispatch hangs before failing)")
        if not (np.isfinite(self.slow_mult) and self.slow_mult >= 1.0):
            raise ValueError(
                f"slow_mult={self.slow_mult} must be >= 1 (the latency "
                "multiplier of a slow dispatch)")

    @classmethod
    def parse(cls, text: str) -> "ChaosSpec":
        """Parse the spec syntax (module docstring). Unknown keys and
        malformed values raise ``ValueError`` naming the token — same
        fail-at-the-flag-boundary contract as ``FaultSpec.parse``."""
        kw: dict = {}
        for token in text.split(","):
            token = token.strip()
            if not token:
                continue
            if "=" not in token:
                raise ValueError(
                    f"chaos spec token {token!r} is not key=value "
                    "(expected e.g. 'kill=0.01,flaky=0.05,seed=7')")
            key, val = token.split("=", 1)
            key = key.strip().lower()
            if key not in ("kill", "wedge", "flaky", "slow", "seed"):
                raise ValueError(
                    f"unknown chaos spec key {key!r} (expected "
                    "kill/wedge/flaky/slow/seed)")
            try:
                if key == "wedge":
                    rate, _, stall = val.partition(":")
                    kw["wedge"] = float(rate)
                    if stall:
                        kw["wedge_s"] = float(stall)
                elif key == "slow":
                    rate, _, mult = val.partition(":")
                    kw["slow"] = float(rate)
                    if mult:
                        kw["slow_mult"] = float(mult)
                elif key == "seed":
                    kw["seed"] = int(val)
                else:
                    kw[key] = float(val)
            except ValueError as e:
                raise ValueError(
                    f"chaos spec token {token!r}: {e}") from None
        return cls(**kw)


class ChaosPlan:
    """Dense per-``(replica, dispatch)`` chaos schedule.

    ``roles`` is a host-side ``(n_replicas, horizon)`` int8 matrix of
    role codes (:data:`CLEAN`/:data:`KILL`/:data:`WEDGE`/
    :data:`FLAKY`/:data:`SLOW`); ``wedge_s``/``slow_mult`` shape the
    wedge stall and slow multiplier for every such cell. Construction
    is deterministic in the spec: the same :class:`ChaosSpec` always
    builds the identical plan, which is what makes the failover test
    suite's "same seed ⇒ same kill schedule, same requeue counts"
    pins possible. Dispatches past the horizon are clean.
    """

    def __init__(self, roles, wedge_s: float = 0.25,
                 slow_mult: float = 3.0):
        roles = np.asarray(roles, np.int8)
        if roles.ndim != 2:
            raise ValueError(
                f"ChaosPlan roles must be (n_replicas, horizon), got "
                f"shape {roles.shape}")
        if roles.size and (roles.min() < CLEAN or roles.max() > SLOW):
            raise ValueError(
                f"ChaosPlan roles must be codes in [{CLEAN}, {SLOW}], "
                f"got range [{roles.min()}, {roles.max()}]")
        if not (np.isfinite(wedge_s) and wedge_s > 0):
            raise ValueError(f"wedge_s={wedge_s} must be positive")
        if not (np.isfinite(slow_mult) and slow_mult >= 1.0):
            raise ValueError(f"slow_mult={slow_mult} must be >= 1")
        self.roles = roles
        self.wedge_s = float(wedge_s)
        self.slow_mult = float(slow_mult)
        self.n_replicas, self.horizon = roles.shape

    @classmethod
    def build(cls, spec: ChaosSpec, n_replicas: int,
              horizon: int = 4096) -> "ChaosPlan":
        """Expand a spec over the full horizon: one uniform draw per
        cell assigns at most one role (kill wins over wedge over flaky
        over slow), so rates compose without overlap — the
        ``FaultPlan.build`` construction on the serving axis."""
        if n_replicas < 1 or horizon < 1:
            raise ValueError(
                f"need n_replicas >= 1 and horizon >= 1, got "
                f"({n_replicas}, {horizon})")
        rs = np.random.RandomState(spec.seed)
        u = rs.random_sample((n_replicas, horizon))
        roles = np.zeros((n_replicas, horizon), np.int8)
        k = u < spec.kill
        w = ~k & (u < spec.kill + spec.wedge)
        f = ~k & ~w & (u < spec.kill + spec.wedge + spec.flaky)
        s = (~k & ~w & ~f
             & (u < spec.kill + spec.wedge + spec.flaky + spec.slow))
        roles[k], roles[w], roles[f], roles[s] = KILL, WEDGE, FLAKY, SLOW
        return cls(roles, wedge_s=spec.wedge_s, slow_mult=spec.slow_mult)

    @classmethod
    def scripted(cls, n_replicas: int, kills: dict | None = None,
                 wedges: dict | None = None, flaky: dict | None = None,
                 slow: dict | None = None, horizon: int | None = None,
                 wedge_s: float = 0.25,
                 slow_mult: float = 3.0) -> "ChaosPlan":
        """Exact-placement construction: ``kills`` maps replica ->
        the dispatch index it dies on; ``wedges``/``flaky``/``slow``
        map replica -> an iterable of dispatch indices. The bench's
        chaos leg uses this to kill specific replicas mid-stream on
        every run — no rate sampling, pure schedule."""
        cells = []
        for role, spec_map, single in ((KILL, kills, True),
                                       (WEDGE, wedges, False),
                                       (FLAKY, flaky, False),
                                       (SLOW, slow, False)):
            for rep, where in (spec_map or {}).items():
                rep = int(rep)
                if not 0 <= rep < n_replicas:
                    raise ValueError(
                        f"replica {rep} out of range for a "
                        f"{n_replicas}-replica plan")
                idxs = [where] if single else list(where)
                for i in idxs:
                    i = int(i)
                    if i < 0:
                        raise ValueError(
                            f"dispatch index {i} must be >= 0")
                    cells.append((rep, i, role))
        top = max((i for _, i, _ in cells), default=-1)
        horizon = (top + 1 if horizon is None else int(horizon))
        horizon = max(1, horizon)
        roles = np.zeros((n_replicas, horizon), np.int8)
        for rep, i, role in cells:
            if i >= horizon:
                raise ValueError(
                    f"dispatch index {i} outside the horizon {horizon}")
            if roles[rep, i] != CLEAN:
                raise ValueError(
                    f"cell (replica {rep}, dispatch {i}) assigned two "
                    f"roles ({_ROLE_NAMES[int(roles[rep, i])]} and "
                    f"{_ROLE_NAMES[role]}) — chaos roles are mutually "
                    "exclusive per cell")
            roles[rep, i] = role
        return cls(roles, wedge_s=wedge_s, slow_mult=slow_mult)

    def role(self, replica: int, dispatch: int) -> int:
        """The role code of one dispatch (CLEAN past the horizon)."""
        if dispatch >= self.horizon:
            return CLEAN
        return int(self.roles[replica, dispatch])

    def kill_at(self, replica: int) -> int | None:
        """The dispatch index ``replica`` dies on, or None — plan
        facts, available before anything runs (the determinism tests
        pin the observed kill against this)."""
        hits = np.flatnonzero(self.roles[replica] == KILL)
        return int(hits[0]) if hits.size else None

    def kills_planned(self) -> dict[int, int]:
        """``{replica: first kill dispatch}`` over the whole plan."""
        out = {}
        for r in range(self.n_replicas):
            k = self.kill_at(r)
            if k is not None:
                out[r] = k
        return out


#: Offered-load curve shapes the :class:`LoadSpec` grammar names.
LOAD_SHAPES = ("diurnal", "flash", "overload")


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """Seeded offered-load shape for the serving plane — the LOAD twin
    of :class:`ChaosSpec`: chaos scripts how replicas fail,
    a load spec scripts how traffic arrives, under the same
    determinism contract (same spec ⇒ bitwise-identical arrival
    schedule, so the overload bench and the control-plane tests replay
    the exact same flash crowd every run).

    Shapes (``rate(t)`` in requests/second over ``[0, duration_s)``):

    - **diurnal**: one smooth day-cycle, ``base`` at the edges rising
      to ``peak`` mid-window (``base + (peak-base) * (1-cos)/2``).
    - **flash**: ``base`` everywhere except a step flash crowd at
      ``peak`` over ``[at, at+width)`` (fractions of the duration) —
      the scale-up-or-melt scenario the autoscaler exists for.
    - **overload**: ramp from ``base`` to ``peak`` by ``at`` and HOLD
      — sustained overload, the class-aware-shedding scenario (no
      fleet size saves you; something must shed, least-critical
      first).

    Spec string syntax (mirrors the ``ChaosSpec`` grammar)::

        shape=flash,base=200,peak=1600,duration=6,at=0.35,width=0.25,seed=17
    """

    shape: str = "flash"
    base_rps: float = 100.0
    peak_rps: float = 1000.0
    duration_s: float = 10.0
    at: float = 0.4      # flash start / overload ramp end (fraction)
    width: float = 0.2   # flash length (fraction of the duration)
    seed: int = 0

    def __post_init__(self):
        if self.shape not in LOAD_SHAPES:
            raise ValueError(f"load shape must be one of {LOAD_SHAPES}, "
                             f"got {self.shape!r}")
        if not (np.isfinite(self.base_rps) and self.base_rps > 0):
            raise ValueError(f"base_rps={self.base_rps} must be a "
                             "positive rate")
        if not (np.isfinite(self.peak_rps)
                and self.peak_rps >= self.base_rps):
            raise ValueError(f"peak_rps={self.peak_rps} must be >= "
                             f"base_rps={self.base_rps}")
        if not (np.isfinite(self.duration_s) and self.duration_s > 0):
            raise ValueError(f"duration_s={self.duration_s} must be "
                             "positive")
        if not 0.0 <= self.at <= 1.0:
            raise ValueError(f"at={self.at} must be a fraction of the "
                             "duration in [0, 1]")
        if self.shape == "flash" and not (
                0.0 < self.width and self.at + self.width <= 1.0):
            raise ValueError(
                f"flash window at={self.at} width={self.width} must "
                "satisfy 0 < width and at + width <= 1")

    @classmethod
    def parse(cls, text: str) -> "LoadSpec":
        """Parse the spec syntax (class docstring). Unknown keys and
        malformed values raise ``ValueError`` naming the token — the
        ``ChaosSpec.parse`` contract on the load axis."""
        kw: dict = {}
        keys = {"shape": str, "base": float, "peak": float,
                "duration": float, "at": float, "width": float,
                "seed": int}
        field = {"base": "base_rps", "peak": "peak_rps",
                 "duration": "duration_s"}
        for token in text.split(","):
            token = token.strip()
            if not token:
                continue
            if "=" not in token:
                raise ValueError(
                    f"load spec token {token!r} is not key=value "
                    "(expected e.g. 'shape=flash,base=200,peak=1600,"
                    "duration=6,seed=17')")
            key, val = token.split("=", 1)
            key = key.strip().lower()
            conv = keys.get(key)
            if conv is None:
                raise ValueError(
                    f"unknown load spec key {key!r} (expected "
                    f"{'/'.join(keys)})")
            try:
                kw[field.get(key, key)] = conv(val)
            except ValueError as e:
                raise ValueError(
                    f"load spec token {token!r}: {e}") from None
        return cls(**kw)

    def rate(self, t: float) -> float:
        """Offered load (requests/s) at ``t`` seconds into the window;
        0 outside it."""
        d = self.duration_s
        if t < 0 or t >= d:
            return 0.0
        if self.shape == "diurnal":
            return self.base_rps + (self.peak_rps - self.base_rps) \
                * 0.5 * (1.0 - np.cos(2.0 * np.pi * t / d))
        if self.shape == "flash":
            lo = self.at * d
            hi = lo + self.width * d  # lo + width*d, not (at+width)*d:
            # the factored form keeps round fractions exact in float
            return self.peak_rps if lo <= t < hi else self.base_rps
        ramp_end = self.at * d
        if t < ramp_end:
            return self.base_rps + (self.peak_rps - self.base_rps) \
                * (t / ramp_end)
        return self.peak_rps

    def offsets(self) -> np.ndarray:
        """Seeded arrival offsets (seconds from stream start, sorted):
        a non-homogeneous Poisson draw of the rate curve by standard
        thinning — candidates at the peak rate, each kept with
        probability ``rate(t)/peak``. Deterministic in the spec: the
        same seed always yields the identical schedule (the pin
        ``tests/test_control.py`` holds), so paired fleet runs replay
        ONE flash crowd, not statistically-similar ones."""
        rs = np.random.RandomState(self.seed)
        out = []
        t = 0.0
        peak = self.peak_rps
        while True:
            t += rs.exponential(1.0 / peak)
            if t >= self.duration_s:
                break
            if rs.random_sample() * peak <= self.rate(t):
                out.append(t)
        return np.asarray(out, dtype=np.float64)


#: Network-chaos role codes (int8) for the transport layer.
#: NET_CLEAN must be 0 so a zero-initialized matrix is the clean plan.
NET_CLEAN, NET_PARTITION, NET_REFUSE, NET_LAG = 0, 1, 2, 3

_NET_ROLE_NAMES = {NET_CLEAN: "clean", NET_PARTITION: "partition",
                   NET_REFUSE: "refuse", NET_LAG: "lag"}


@dataclasses.dataclass(frozen=True)
class NetChaosSpec:
    """Seeded NETWORK fault rates for the cross-process pod — the
    transport-layer twin of :class:`ChaosSpec`: where the
    in-process plan scripts how REPLICAS fail, this scripts how the
    WIRE fails, under the same determinism contract (same spec ⇒
    bitwise-identical schedule). Injected at the
    ``serving.transport.SocketTransport`` dispatch boundary, per
    ``(host, dispatch)`` cell:

    - **partition**: the route blackholes — the client hangs for
      ``partition_s`` (bounded by its remaining deadline budget) and
      times out; the held connection is dropped, exactly what a
      partitioned route does to an established TCP stream.
    - **refuse**: the connect (or the exchange) is refused
      immediately — the worker port answers RST, the fast failure.
    - **lag**: the hop runs, ``lag_s`` late — cross-rack latency the
      health plane's EWMA must learn to route around.
    - **kill_host**: scripted (never sampled) SIGKILL of a worker
      PROCESS at its K-th dispatch, via the transport's ``kill_cb``
      hook — the one network fault that is also a host fault, placed
      exactly so the pod bench kills the same worker mid-stream every
      run.
    - **restart_during_announce**: scripted mid-announce rejoin race
      — host H is down when version announce S starts and
      comes back WHILE the announce is still walking the pod, the
      exact window where a resync from a not-yet-announced peer
      re-opens the version gap. Consumed by the scenario oracle (the
      announce is an event, not a dispatch, so it cannot live in the
      per-dispatch ``roles`` matrix).
    - **forge_sync**: a byzantine sync peer — host PEER
      answers rejoin ``sync`` frames with FORGED weights under claimed
      VERSION (self-consistent fingerprint and all), the serving-plane
      twin of the Blanchard-style training-side byzantine client. A
      pod whose sync protocol trusts "newest version wins" adopts it;
      the epoch-fenced, fingerprint-quorum protocol must not.

    Spec string syntax (mirrors the ``ChaosSpec`` grammar; MS values
    are milliseconds)::

        partition=0.02:250,refuse=0.05,lag=0.1:20,kill_host=1@12,seed=7
                  ^rate ^stall_ms      ^rate ^ms   ^host ^dispatch
        restart_during_announce=0@1,forge_sync=2@120
                                ^host ^announce    ^peer ^version

    ``kill_host``, ``restart_during_announce`` and ``forge_sync`` may
    repeat (one token per victim/peer).
    """

    partition: float = 0.0
    partition_s: float = 0.25
    refuse: float = 0.0
    lag: float = 0.0
    lag_s: float = 0.02
    kill_host: tuple = ()
    restart_during_announce: tuple = ()
    forge_sync: tuple = ()
    seed: int = 0

    def __post_init__(self):
        for name in ("partition", "refuse", "lag"):
            r = getattr(self, name)
            if not 0.0 <= r <= 1.0:
                raise ValueError(
                    f"net chaos rate {name}={r} must be in [0, 1]")
        total = self.partition + self.refuse + self.lag
        if total > 1.0:
            raise ValueError(
                "net chaos rates must sum to <= 1 (a dispatch is at "
                "most one of partition/refuse/lag), got "
                f"partition+refuse+lag={total}")
        if not (np.isfinite(self.partition_s) and self.partition_s > 0):
            raise ValueError(
                f"partition_s={self.partition_s} must be a positive "
                "stall (seconds the partitioned dispatch hangs)")
        if not (np.isfinite(self.lag_s) and self.lag_s >= 0):
            raise ValueError(
                f"lag_s={self.lag_s} must be a non-negative added "
                "latency")
        # normalize + validate the kill schedule: ((host, dispatch)...)
        kills = tuple((int(h), int(k)) for h, k in self.kill_host)
        for h, k in kills:
            if h < 0 or k < 0:
                raise ValueError(
                    f"kill_host {h}@{k}: host and dispatch must be "
                    ">= 0")
        if len({h for h, _ in kills}) != len(kills):
            raise ValueError(
                "kill_host names one kill per host (a process dies "
                "once)")
        object.__setattr__(self, "kill_host", kills)
        # normalize + validate the announce-race schedule: ((host,
        # announce_ordinal)...) — one race per host, like kills
        races = tuple((int(h), int(s))
                      for h, s in self.restart_during_announce)
        for h, s in races:
            if h < 0 or s < 0:
                raise ValueError(
                    f"restart_during_announce {h}@{s}: host and "
                    "announce ordinal must be >= 0")
        if len({h for h, _ in races}) != len(races):
            raise ValueError(
                "restart_during_announce names one race per host (a "
                "host rejoins mid-announce once)")
        object.__setattr__(self, "restart_during_announce", races)
        # normalize + validate the byzantine peers: ((host, version)..)
        forges = tuple((int(h), int(v)) for h, v in self.forge_sync)
        for h, v in forges:
            if h < 0:
                raise ValueError(
                    f"forge_sync {h}@{v}: peer index must be >= 0")
            if v < 1:
                raise ValueError(
                    f"forge_sync {h}@{v}: the forged version must be "
                    ">= 1 (a forge claiming v0 is indistinguishable "
                    "from a fresh worker and tests nothing)")
        if len({h for h, _ in forges}) != len(forges):
            raise ValueError(
                "forge_sync names one forged version per peer")
        object.__setattr__(self, "forge_sync", forges)

    @classmethod
    def parse(cls, text: str) -> "NetChaosSpec":
        """Parse the spec syntax (class docstring). Unknown keys and
        malformed values raise ``ValueError`` naming the token — the
        ``ChaosSpec.parse`` contract on the network axis."""
        kw: dict = {"kill_host": [], "restart_during_announce": [],
                    "forge_sync": []}
        for token in text.split(","):
            token = token.strip()
            if not token:
                continue
            if "=" not in token:
                raise ValueError(
                    f"net chaos spec token {token!r} is not key=value "
                    "(expected e.g. 'partition=0.02:250,refuse=0.05,"
                    "kill_host=1@12,seed=7')")
            key, val = token.split("=", 1)
            key = key.strip().lower()
            try:
                if key == "partition":
                    rate, _, ms = val.partition(":")
                    kw["partition"] = float(rate)
                    if ms:
                        kw["partition_s"] = float(ms) / 1e3
                elif key == "lag":
                    rate, _, ms = val.partition(":")
                    kw["lag"] = float(rate)
                    if ms:
                        kw["lag_s"] = float(ms) / 1e3
                elif key == "refuse":
                    kw["refuse"] = float(val)
                elif key == "seed":
                    kw["seed"] = int(val)
                elif key == "kill_host":
                    host, sep, disp = val.partition("@")
                    if not sep:
                        raise ValueError(
                            "expected HOST@DISPATCH (e.g. 1@12)")
                    kw["kill_host"].append((int(host), int(disp)))
                elif key == "restart_during_announce":
                    host, sep, ann = val.partition("@")
                    if not sep:
                        raise ValueError(
                            "expected HOST@ANNOUNCE (e.g. 0@1)")
                    kw["restart_during_announce"].append(
                        (int(host), int(ann)))
                elif key == "forge_sync":
                    peer, sep, ver = val.partition("@")
                    if not sep:
                        raise ValueError(
                            "expected PEER@VERSION (e.g. 2@120)")
                    kw["forge_sync"].append((int(peer), int(ver)))
                else:
                    raise ValueError(
                        f"unknown net chaos spec key {key!r} (expected "
                        "partition/refuse/lag/kill_host/"
                        "restart_during_announce/forge_sync/seed)")
            except ValueError as e:
                if "unknown net chaos spec key" in str(e):
                    raise
                raise ValueError(
                    f"net chaos spec token {token!r}: {e}") from None
        kw["kill_host"] = tuple(kw["kill_host"])
        kw["restart_during_announce"] = tuple(
            kw["restart_during_announce"])
        kw["forge_sync"] = tuple(kw["forge_sync"])
        return cls(**kw)


class NetChaosPlan:
    """Dense per-``(host, dispatch)`` network fault schedule — the
    :class:`ChaosPlan` construction on the transport axis. ``roles``
    is ``(n_hosts, horizon)`` int8 of :data:`NET_CLEAN`/
    :data:`NET_PARTITION`/:data:`NET_REFUSE`/:data:`NET_LAG` codes;
    ``kills`` maps host -> the dispatch index its worker process is
    SIGKILLed at (always scripted — a sampled process death would
    break the paired-run determinism the pod bench pins). Same spec ⇒
    identical plan, bitwise. Dispatches past the horizon are clean."""

    def __init__(self, roles, partition_s: float = 0.25,
                 lag_s: float = 0.02, kills: dict | None = None,
                 announce_restarts: dict | None = None,
                 forges: dict | None = None):
        roles = np.asarray(roles, np.int8)
        if roles.ndim != 2:
            raise ValueError(
                f"NetChaosPlan roles must be (n_hosts, horizon), got "
                f"shape {roles.shape}")
        if roles.size and (roles.min() < NET_CLEAN
                           or roles.max() > NET_LAG):
            raise ValueError(
                f"NetChaosPlan roles must be codes in [{NET_CLEAN}, "
                f"{NET_LAG}], got range "
                f"[{roles.min()}, {roles.max()}]")
        if not (np.isfinite(partition_s) and partition_s > 0):
            raise ValueError(
                f"partition_s={partition_s} must be positive")
        if not (np.isfinite(lag_s) and lag_s >= 0):
            raise ValueError(f"lag_s={lag_s} must be >= 0")
        self.roles = roles
        self.partition_s = float(partition_s)
        self.lag_s = float(lag_s)
        self.n_hosts, self.horizon = roles.shape
        self.kills = {int(h): int(k)
                      for h, k in (kills or {}).items()}
        for h, k in self.kills.items():
            if not 0 <= h < self.n_hosts:
                raise ValueError(
                    f"kill_host {h} out of range for a "
                    f"{self.n_hosts}-host plan")
            if k < 0:
                raise ValueError(
                    f"kill_host {h}@{k}: dispatch index must be >= 0 "
                    "(the transport fires at k >= kill_at, so a "
                    "negative index would kill on the FIRST dispatch)")
        self.announce_restarts = {int(h): int(s) for h, s in
                                  (announce_restarts or {}).items()}
        for h, s in self.announce_restarts.items():
            if not 0 <= h < self.n_hosts:
                raise ValueError(
                    f"restart_during_announce host {h} out of range "
                    f"for a {self.n_hosts}-host plan")
            if s < 0:
                raise ValueError(
                    f"restart_during_announce {h}@{s}: announce "
                    "ordinal must be >= 0")
        self.forges = {int(h): int(v)
                       for h, v in (forges or {}).items()}
        for h, v in self.forges.items():
            if not 0 <= h < self.n_hosts:
                raise ValueError(
                    f"forge_sync peer {h} out of range for a "
                    f"{self.n_hosts}-host plan")
            if v < 1:
                raise ValueError(
                    f"forge_sync {h}@{v}: forged version must be >= 1")

    @classmethod
    def build(cls, spec: NetChaosSpec, n_hosts: int,
              horizon: int = 4096) -> "NetChaosPlan":
        """Expand a spec over the full horizon: one uniform draw per
        cell assigns at most one role (partition wins over refuse over
        lag), kills taken verbatim from the spec's scripted list."""
        if n_hosts < 1 or horizon < 1:
            raise ValueError(
                f"need n_hosts >= 1 and horizon >= 1, got "
                f"({n_hosts}, {horizon})")
        rs = np.random.RandomState(spec.seed)
        u = rs.random_sample((n_hosts, horizon))
        roles = np.zeros((n_hosts, horizon), np.int8)
        p = u < spec.partition
        r = ~p & (u < spec.partition + spec.refuse)
        lg = ~p & ~r & (u < spec.partition + spec.refuse + spec.lag)
        roles[p], roles[r], roles[lg] = (NET_PARTITION, NET_REFUSE,
                                         NET_LAG)
        return cls(roles, partition_s=spec.partition_s,
                   lag_s=spec.lag_s, kills=dict(spec.kill_host),
                   announce_restarts=dict(spec.restart_during_announce),
                   forges=dict(spec.forge_sync))

    @classmethod
    def scripted(cls, n_hosts: int, partitions: dict | None = None,
                 refuses: dict | None = None, lags: dict | None = None,
                 kills: dict | None = None, horizon: int | None = None,
                 partition_s: float = 0.25,
                 lag_s: float = 0.02,
                 announce_restarts: dict | None = None,
                 forges: dict | None = None) -> "NetChaosPlan":
        """Exact-placement construction (the pod bench's spelling):
        ``partitions``/``refuses``/``lags`` map host -> an iterable of
        dispatch indices; ``kills`` maps host -> the single dispatch
        its process dies at; ``announce_restarts`` maps host -> the
        announce ordinal it rejoins mid-flight at; ``forges`` maps
        peer -> the version its sync replies forge."""
        cells = []
        for role, spec_map in ((NET_PARTITION, partitions),
                               (NET_REFUSE, refuses), (NET_LAG, lags)):
            for host, where in (spec_map or {}).items():
                host = int(host)
                if not 0 <= host < n_hosts:
                    raise ValueError(
                        f"host {host} out of range for a "
                        f"{n_hosts}-host plan")
                for i in where:
                    i = int(i)
                    if i < 0:
                        raise ValueError(
                            f"dispatch index {i} must be >= 0")
                    cells.append((host, i, role))
        top = max((i for _, i, _ in cells), default=-1)
        horizon = (top + 1 if horizon is None else int(horizon))
        horizon = max(1, horizon)
        roles = np.zeros((n_hosts, horizon), np.int8)
        for host, i, role in cells:
            if i >= horizon:
                raise ValueError(
                    f"dispatch index {i} outside the horizon {horizon}")
            if roles[host, i] != NET_CLEAN:
                raise ValueError(
                    f"cell (host {host}, dispatch {i}) assigned two "
                    f"roles ({_NET_ROLE_NAMES[int(roles[host, i])]} "
                    f"and {_NET_ROLE_NAMES[role]}) — net chaos roles "
                    "are mutually exclusive per cell")
            roles[host, i] = role
        return cls(roles, partition_s=partition_s, lag_s=lag_s,
                   kills=kills, announce_restarts=announce_restarts,
                   forges=forges)

    def role(self, host: int, dispatch: int) -> int:
        """The role code of one dispatch (clean past the horizon)."""
        if dispatch >= self.horizon:
            return NET_CLEAN
        return int(self.roles[host, dispatch])

    def kill_at(self, host: int) -> int | None:
        """The dispatch index ``host``'s worker is SIGKILLed at, or
        None — plan facts, known before anything runs."""
        return self.kills.get(int(host))

    def announce_restart_at(self, host: int) -> int | None:
        """The announce ordinal ``host`` rejoins mid-flight at, or
        None (plan facts — the scenario oracle consumes this at its
        swap events)."""
        return self.announce_restarts.get(int(host))

    def forge_at(self, host: int) -> int | None:
        """The version ``host``'s sync replies forge, or None for an
        honest peer."""
        return self.forges.get(int(host))

    def counts(self) -> dict:
        """Planned fault totals over the whole horizon — what the pod
        bench records beside what actually FIRED."""
        return {
            "partition": int(np.sum(self.roles == NET_PARTITION)),
            "refuse": int(np.sum(self.roles == NET_REFUSE)),
            "lag": int(np.sum(self.roles == NET_LAG)),
            "kills": len(self.kills),
            "announce_restarts": len(self.announce_restarts),
            "forges": len(self.forges),
        }


def resolve_net_chaos(chaos, n_hosts: int,
                      horizon: int = 4096) -> NetChaosPlan | None:
    """Normalize the transport's ``chaos=`` argument: None (clean), a
    spec string, a :class:`NetChaosSpec`, or a prebuilt
    :class:`NetChaosPlan` (shape-checked against this pod) — the
    :func:`resolve_chaos_plan` contract on the network axis."""
    if chaos is None:
        return None
    if isinstance(chaos, str):
        chaos = NetChaosSpec.parse(chaos)
    if isinstance(chaos, NetChaosSpec):
        return NetChaosPlan.build(chaos, n_hosts, horizon)
    if isinstance(chaos, NetChaosPlan):
        if chaos.n_hosts < n_hosts:
            raise ValueError(
                f"NetChaosPlan covers {chaos.n_hosts} hosts but this "
                f"pod has {n_hosts}; rebuild the plan")
        return chaos
    raise TypeError(
        f"net chaos must be None, a spec string, a NetChaosSpec or a "
        f"NetChaosPlan, got {type(chaos).__name__}")


def resolve_chaos_plan(chaos, n_replicas: int,
                       horizon: int = 4096) -> ChaosPlan | None:
    """Normalize the ``chaos=`` argument the replica set accepts: None
    (clean — dispatches run bit-identically to a fleet built without
    this module), a spec string, a :class:`ChaosSpec`, or a prebuilt
    :class:`ChaosPlan` (shape-checked against this fleet)."""
    if chaos is None:
        return None
    if isinstance(chaos, str):
        chaos = ChaosSpec.parse(chaos)
    if isinstance(chaos, ChaosSpec):
        return ChaosPlan.build(chaos, n_replicas, horizon)
    if isinstance(chaos, ChaosPlan):
        if chaos.n_replicas != n_replicas:
            raise ValueError(
                f"ChaosPlan is for {chaos.n_replicas} replicas but "
                f"this fleet has {n_replicas}; rebuild the plan")
        return chaos
    raise TypeError(
        f"chaos must be None, a spec string, a ChaosSpec or a "
        f"ChaosPlan, got {type(chaos).__name__}")

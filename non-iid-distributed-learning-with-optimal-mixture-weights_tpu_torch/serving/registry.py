"""Versioned model registry: the train->serve handoff, in process.

A copy of the JAX package's ``serving/registry.py`` on this package's
``utils.checkpoint`` (the pickle layout). Training produces a new global
model every round (``python -m fedamw_tpu_torch.exp``'s round loop;
``--publish_every N`` checkpoints one every N rounds) and the
serving stack must absorb those updates under live traffic. This module
is the middle of that loop: a thread-safe store of immutable
``(version, params, rff, round, metadata)`` entries, fed either from
checkpoint directories (``publish_checkpoint`` — the cross-process
path: training writes, serving watches) or from live result dicts
(``publish`` — the in-process path: a driver that trains and serves in
one process).

Versions are monotonically increasing integers assigned at publish —
identity, not quality: which version *serves* is the rollout
controller's decision (``serving/rollout.py``), gated by parity and an
error budget. The registry only answers "what exists, how old is it":
``staleness_rounds(v)`` is how many training rounds the newest
published entry is ahead of ``v`` — the staleness dimension
``ServeMetrics`` and request spans report, so an operator can see not
just *which* model answered but *how far behind training* it was.

Params/rff are stored exactly as handed in (host arrays); placing them
on device is the engine's job at ``install_weights`` time, so the
registry itself never touches an accelerator and can be fed from a
checkpoint-watching thread.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
import time
from typing import Any, Iterator


@dataclasses.dataclass(frozen=True)
class ModelVersion:
    """One immutable published model."""

    version: int
    params: Any
    rff: tuple | None
    round_idx: int | None
    source: str
    metadata: dict
    published_at: float  # time.time() — wall-clock, operator-facing

    @property
    def eval_acc(self) -> float | None:
        """Training-side evaluation accuracy recorded at publish (the
        parity gate's reference: serving the same inputs must
        reproduce it — ``engine_acc == evaluate_acc``). None when the
        publisher recorded none; the gate then has nothing to check
        against and reports the candidate 'unchecked'."""
        v = self.metadata.get("eval_acc")
        return None if v is None else float(v)


class ModelRegistry:
    """Thread-safe in-process version store (see module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[int, ModelVersion] = {}
        self._next = 1

    # -- publishing ---------------------------------------------------
    def publish(self, params, rff=None, round_idx: int | None = None,
                metadata: dict | None = None,
                source: str = "publish") -> int:
        """Register one model; returns its assigned version number.

        ``metadata['eval_acc']`` (training's evaluation accuracy on its
        own test set) is what arms the rollout parity gate — publishers
        that have it should record it.
        """
        meta = dict(metadata) if metadata else {}
        with self._lock:
            v = self._next
            self._next += 1
            self._entries[v] = ModelVersion(
                version=v, params=params, rff=rff,
                round_idx=None if round_idx is None else int(round_idx),
                source=source, metadata=meta, published_at=time.time())
        return v

    def publish_checkpoint(self, path: str,
                           metadata: dict | None = None) -> int:
        """Publish from a ``save_checkpoint`` directory (the pickle
        layout; an orbax one is refused) — the cross-process feed. The checkpoint's own markers
        (RFF draw, round index, feature dtype, a persisted 'eval_acc')
        land in the entry; explicit ``metadata`` wins on conflict.
        Damaged checkpoints surface as ``CheckpointError`` naming the
        path (never a half-published entry)."""
        from ..utils.checkpoint import CheckpointError, load_checkpoint

        state = load_checkpoint(path)
        if "params" not in state:
            raise CheckpointError(
                path, "state has no 'params' entry (not a "
                f"save_checkpoint layout?); found keys {sorted(state)!r}")
        rff = None
        if "rff_W" in state and "rff_b" in state:
            rff = (state["rff_W"], state["rff_b"])
        meta = {}
        if "feature_dtype" in state:
            meta["feature_dtype"] = str(state["feature_dtype"])
        if state.get("eval_acc") is not None:
            meta["eval_acc"] = float(state["eval_acc"])
        if metadata:
            meta.update(metadata)
        return self.publish(
            state["params"], rff=rff, round_idx=state.get("round"),
            metadata=meta, source=f"checkpoint:{os.path.abspath(path)}")

    # -- lookup -------------------------------------------------------
    def get(self, version: int) -> ModelVersion:
        with self._lock:
            try:
                return self._entries[version]
            except KeyError:
                raise KeyError(
                    f"version {version} not in registry (have "
                    f"{sorted(self._entries)})") from None

    def latest(self) -> ModelVersion | None:
        with self._lock:
            if not self._entries:
                return None
            return self._entries[max(self._entries)]

    def versions(self) -> list[int]:
        with self._lock:
            return sorted(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, version: int) -> bool:
        with self._lock:
            return version in self._entries

    def __iter__(self) -> Iterator[ModelVersion]:
        with self._lock:
            snap = [self._entries[v] for v in sorted(self._entries)]
        return iter(snap)

    def staleness_rounds(self, version: int) -> int:
        """Training rounds the newest published entry is ahead of
        ``version`` — 0 when ``version`` IS the newest, when the
        version is unknown to this registry, and when either side
        carries no round index (unknown staleness must not masquerade
        as a large one; publishers that want the dimension must stamp
        ``round_idx``, as ``exp.py --publish_every`` and
        ``publish_checkpoint`` do)."""
        with self._lock:
            entry = self._entries.get(version)
            if entry is None or not self._entries:
                return 0
            newest = self._entries[max(self._entries)]
        if entry.round_idx is not None and newest.round_idx is not None:
            return max(0, int(newest.round_idx) - int(entry.round_idx))
        return 0

    # -- retention ----------------------------------------------------
    def withdraw(self, version: int) -> bool:
        """Unpublish one entry — a gate-REJECTED candidate. A rejected
        publish left in place keeps counting toward every other
        version's ``staleness_rounds``, reading as "the service is
        behind" when the only newer model is one that must never
        serve. Returns whether anything was removed."""
        with self._lock:
            return self._entries.pop(int(version), None) is not None

    def prune(self, keep: int, protect=()) -> list[int]:
        """Drop the oldest entries down to ``keep``, never dropping a
        protected version (the live/candidate set a controller pins).
        Returns the versions removed. Bounds a long-lived publisher's
        memory the same way the rotating trace writer bounds spans."""
        if keep < 0:
            raise ValueError(f"keep must be >= 0, got {keep}")
        protected = set(protect)
        removed = []
        with self._lock:
            candidates = [v for v in sorted(self._entries)
                          if v not in protected]
            excess = len(self._entries) - int(keep)
            for v in candidates[:max(0, excess)]:
                del self._entries[v]
                removed.append(v)
        return removed


#: Checkpoint-directory names a watcher publishes: the ``vNNNN``
#: entries ``exp.py --publish_every`` writes (any digit count — v0100
#: and v100000 both match; the number orders ingestion).
_VERSION_DIR = re.compile(r"^v(\d+)$")


class CheckpointWatcher:
    """Daemon thread that polls a checkpoint directory and publishes
    new ``vNNNN`` entries into a :class:`ModelRegistry` — the
    cross-process half of the train->serve loop. Training writes
    checkpoints (``python -m fedamw_tpu_torch.exp --save_models DIR
    --publish_every N``);
    serving runs a watcher over ``DIR/{dataset}_{algo}_repeatT`` and
    every boundary's model appears in the registry without any
    explicit ``publish_checkpoint`` call.

    Semantics:

    - entries are ingested in **round order** (the numeric ``vNNNN``
      suffix), so staleness accounting stays monotone;
    - a directory that fails to load (a checkpoint mid-write, a
      truncated file) **stops the poll** — it is retried next poll
      (only marked seen once ``publish_checkpoint`` succeeds) and
      LATER rounds wait behind it, because publishing them first
      would hand the recovered earlier round a higher registry
      version and regress ``latest()`` by a round; the failure is
      counted in ``errors`` (never raised into the daemon, which
      must outlive transient filesystem states);
    - the poll interval is **bounded below** (0.01 s): a zero/negative
      interval would busy-spin a core against the filesystem;
    - ``stop()`` is a **clean shutdown**: it wakes the sleeper, joins
      the thread, and is idempotent; the watcher is also a context
      manager (``with CheckpointWatcher(...) as w:``).

    ``on_publish(version, path)`` runs after each successful publish
    (e.g. to stage a rollout candidate); its exceptions are counted in
    ``errors`` rather than killing the watcher.

    ``artifact_dir`` (the cold-start plane, ``serving/artifacts.py``):
    when set, every successfully published ``vNNNN`` checkpoint also
    gets its bucket ladder exported to ``artifact_dir/vNNNN`` — the
    publisher-side half of fast replica scale-out, so a new replica can
    ``ServingEngine.from_artifact`` the newest round. The export runs
    on the watcher thread (bounded by ``artifact_buckets``, default the
    engine ladder) with an engine built on ``device`` (the card when
    None; not in the JAX signature); an export failure counts in
    ``errors``, but the PUBLISH stands — a registry entry must never be
    withheld because the optional fast-start artifact failed.
    Successful exports are listed in ``artifacts`` as ``(dirname,
    artifact_path)``. ``artifact_keep=N`` bounds the export directory
    like ``ModelRegistry.prune`` bounds the registry: after each export
    the oldest artifact dirs beyond N are deleted
    (``artifacts.prune_artifacts``), the just-exported entry always
    kept and ``artifact_protect()`` (an optional zero-arg callable
    returning version numbers / dirnames) pinning the live/candidate
    set a rollout controller is serving; removals land in
    ``artifacts_pruned``. ``artifact_keep=0`` is refused at
    construction, and a raising ``artifact_protect`` counts in
    ``errors`` without undoing the export.
    """

    def __init__(self, registry: ModelRegistry, watch_dir: str,
                 poll_interval_s: float = 1.0, metadata: dict | None = None,
                 on_publish=None, artifact_dir: str | None = None,
                 artifact_buckets=None, artifact_keep: int | None = None,
                 artifact_protect=None, device=None):
        if poll_interval_s < 0.01:
            raise ValueError(
                f"poll_interval_s={poll_interval_s} must be >= 0.01 "
                "(an unbounded poll would busy-spin against the "
                "filesystem)")
        self.registry = registry
        self.watch_dir = str(watch_dir)
        self.poll_interval_s = float(poll_interval_s)
        self.metadata = dict(metadata) if metadata else None
        self.on_publish = on_publish
        self._seen: set[str] = set()
        self._lock = threading.Lock()
        # serializes whole poll bodies (daemon vs synchronous
        # poll_once callers): two concurrent scans would both see the
        # same entry as unseen and double-publish it — the registry
        # assigns a fresh version per publish, no dedup downstream
        self._poll_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.artifact_dir = (None if artifact_dir is None
                             else str(artifact_dir))
        self.artifact_buckets = (None if artifact_buckets is None
                                 else tuple(int(b)
                                            for b in artifact_buckets))
        if artifact_keep is not None and int(artifact_keep) < 1:
            # 0 would delete every export including the one that just
            # landed — a misconfiguration, not a retention policy
            raise ValueError(
                f"artifact_keep={artifact_keep} must be >= 1 (the "
                "just-exported artifact must survive its own prune)")
        self.artifact_keep = (None if artifact_keep is None
                              else int(artifact_keep))
        self.artifact_protect = artifact_protect
        self.device = device
        self.artifacts_pruned: list[str] = []  # dirnames removed
        self.published: list[tuple[str, int]] = []  # (dirname, version)
        self.artifacts: list[tuple[str, str]] = []  # (dirname, art path)
        self.errors = 0
        self.polls = 0

    # -- one poll (also usable synchronously, e.g. in tests) ----------
    def poll_once(self) -> list[int]:
        """Scan the directory once; publish every unseen ``vNNNN``
        entry in round order. Returns the versions published. Safe to
        call while the daemon runs (polls are serialized)."""
        with self._poll_lock:
            # serializing whole poll bodies (I/O included) IS this lock's
            # purpose; only the daemon and synchronous callers contend
            return self._poll_once()

    def _poll_once(self) -> list[int]:
        with self._lock:
            self.polls += 1
        try:
            names = os.listdir(self.watch_dir)
        except OSError:
            # the directory may not exist yet (training starts later);
            # that is a normal startup state, not an error
            return []
        entries = []
        for name in names:
            m = _VERSION_DIR.match(name)
            if m and name not in self._seen:
                entries.append((int(m.group(1)), name))
        out = []
        for _, name in sorted(entries):
            path = os.path.join(self.watch_dir, name)
            if not os.path.isdir(path):
                continue
            try:
                v = self.registry.publish_checkpoint(
                    path, metadata=self.metadata)
            except Exception:
                # mid-write / damaged: retry next poll, never mark
                # seen — and STOP here: publishing later rounds now
                # would give this round a higher registry version when
                # it recovers, regressing latest() by a round
                with self._lock:
                    self.errors += 1
                break
            self._seen.add(name)
            with self._lock:
                self.published.append((name, v))
            out.append(v)
            if self.artifact_dir is not None:
                self._export_artifact(name, path, v)
            if self.on_publish is not None:
                try:
                    self.on_publish(v, path)
                except Exception:
                    with self._lock:
                        self.errors += 1
        return out

    def _export_artifact(self, name: str, path: str, version: int) -> None:
        """Export one published checkpoint's ladder beside it (the
        optional cold-start feed — see class docstring). Failures
        count in ``errors`` and never unwind the publish."""
        try:
            # lazy: the registry stays importable without the engine
            # and export machinery unless artifact publishing is on
            from .artifacts import export_ladder
            from .engine import ServingEngine

            kw = {}
            if self.artifact_buckets is not None:
                kw["buckets"] = self.artifact_buckets
            engine = ServingEngine.load(path, device=self.device, **kw)
            out_dir = os.path.join(self.artifact_dir, name)
            export_ladder(engine, out_dir, model_version=version,
                          round_idx=self.registry.get(version).round_idx)
        except Exception:
            with self._lock:
                self.errors += 1
            return
        with self._lock:
            self.artifacts.append((name, out_dir))
        self._prune_artifacts(name)

    def _prune_artifacts(self, just_exported: str) -> None:
        """Retention beside the registry's ``prune``: after each
        successful export, drop the oldest artifact dirs down to
        ``artifact_keep``. The just-exported entry is always protected
        (a keep=1 watcher holds exactly the newest ladder), plus
        whatever ``artifact_protect()`` names — the caller's hook for
        pinning the LIVE and CANDIDATE versions. Failures (a protect
        callable raising, a racing delete) count into ``errors`` and
        never unwind the publish/export."""
        if self.artifact_keep is None:
            return
        from .artifacts import prune_artifacts

        try:
            protect: list = [just_exported]
            if self.artifact_protect is not None:
                extra = self.artifact_protect()
                if isinstance(extra, (str, int)):
                    # a bare "v0004" must protect ONE name, not
                    # iterate per character into nothing
                    extra = (extra,)
                protect.extend(extra)
            removed = prune_artifacts(self.artifact_dir,
                                      self.artifact_keep, protect)
        except Exception:
            with self._lock:
                self.errors += 1
            return
        if removed:
            with self._lock:
                self.artifacts_pruned.extend(removed)

    # -- lifecycle ----------------------------------------------------
    def _run(self) -> None:
        # poll immediately (existing checkpoints are servable NOW),
        # then on the bounded interval until stopped; Event.wait is
        # the sleeper AND the wakeup, so stop() never waits out a full
        # interval
        self.poll_once()
        while not self._stop.wait(self.poll_interval_s):
            self.poll_once()

    def start(self) -> "CheckpointWatcher":
        if self._thread is not None:
            raise RuntimeError("watcher already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="ckpt-watcher", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 10.0) -> None:
        """Clean shutdown: wake the sleeper, join, idempotent."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=timeout_s)
        if self._thread.is_alive():  # pragma: no cover - join timeout
            raise RuntimeError("checkpoint watcher did not stop in "
                               f"{timeout_s}s")
        self._thread = None

    def __enter__(self) -> "CheckpointWatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

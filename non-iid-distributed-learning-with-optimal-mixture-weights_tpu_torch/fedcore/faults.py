"""Deterministic fault injection for the round loop.

The port of the JAX package's ``fedcore/faults.py``. Clients drop out,
straggle, report garbage or lie about their work; this module simulates
all four deterministically:

- a :class:`FaultSpec` (parsed from the driver's ``--faults`` string) is
  expanded once, on the host, into a :class:`FaultPlan`: dense
  ``(rounds, num_clients)`` mask and multiplier arrays drawn from
  ``numpy.random.RandomState(spec.seed)``, so the same spec builds the
  JAX package's plan array for array;
- the round loop copies the run's plan rows to the device once, before
  its first round (:meth:`FaultPlan.rows`), and reads one row per round;
- :func:`inject_fault_row` applies one round's row to the stacked client
  updates in transit: after local training, before aggregation.

Fault kinds (one per ``(round, client)`` cell at most, from one uniform
draw; drop wins over straggle over corrupt over lie):

- **dropped**: the report never arrives; the client leaves the round's
  present set and its weight is renormalized over the survivors
  (``aggregate.participation_weights``);
- **straggling**: the client's update (its delta from the incoming global
  weights) is scaled by ``straggle_frac`` in ``(0, 1]``;
- **corrupted**: ``nan``/``inf`` (every coordinate poisoned; the
  non-finite quarantine of ``fedcore.robust`` catches it), ``sign`` (the
  update negated) or ``scale`` (the update times ``corrupt_scale``);
- **lying**: the update is honest and bitwise untouched, but the client
  reports ``lie_frac`` as its work fraction: the FedNova tau inflation
  that ``fedcore.robust.trust_bounded_work_frac`` clamps.

Spec syntax (``--faults``)::

    drop=0.1,straggle=0.2:0.5,corrupt=0.05:nan,lie=0.1:0.01,seed=7
         ^rate          ^rate ^frac        ^mode[:scale] ^rate ^claim

Clean clients pass through bitwise: the injection is an outer ``where``
on the faulty cells only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_CORRUPT_MODES = ("nan", "inf", "sign", "scale")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Rates and shapes of the faults to inject, and the plan's seed."""

    drop: float = 0.0
    straggle: float = 0.0
    straggle_frac: float = 0.5
    corrupt: float = 0.0
    corrupt_mode: str = "nan"
    corrupt_scale: float = 10.0
    lie: float = 0.0
    lie_frac: float = 0.01
    seed: int = 0

    def __post_init__(self):
        for name in ("drop", "straggle", "corrupt", "lie"):
            r = getattr(self, name)
            if not 0.0 <= r <= 1.0:
                raise ValueError(
                    f"fault rate {name}={r} must be in [0, 1]")
        total = self.drop + self.straggle + self.corrupt + self.lie
        if total > 1.0:
            raise ValueError(
                f"fault rates must sum to <= 1 (a client is at most one "
                f"of dropped/straggling/corrupted/lying per round), got "
                f"drop+straggle+corrupt+lie={total}")
        if not 0.0 < self.straggle_frac <= 1.0:
            raise ValueError(
                f"straggle_frac={self.straggle_frac} must be in (0, 1] "
                "(the fraction of the local update that survives)")
        if not 0.0 < self.lie_frac <= 1.0:
            raise ValueError(
                f"lie_frac={self.lie_frac} must be in (0, 1] (the work "
                "fraction the lying client CLAIMS; its actual work is "
                "always full)")
        if self.corrupt_mode not in _CORRUPT_MODES:
            raise ValueError(
                f"corrupt_mode={self.corrupt_mode!r}; expected one of "
                f"{_CORRUPT_MODES}")
        if not np.isfinite(self.corrupt_scale):
            raise ValueError(
                f"corrupt_scale={self.corrupt_scale} must be finite "
                "(use corrupt_mode='nan'/'inf' for non-finite poison)")

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        """Parse the spec syntax (module docstring). Unknown keys and
        malformed values raise ``ValueError`` naming the token, with the
        JAX package's messages."""
        kw: dict = {}
        for token in text.split(","):
            token = token.strip()
            if not token:
                continue
            if "=" not in token:
                raise ValueError(
                    f"fault spec token {token!r} is not key=value "
                    "(expected e.g. 'drop=0.1,corrupt=0.05:nan,seed=7')")
            key, val = token.split("=", 1)
            key = key.strip().lower()
            if key not in ("drop", "straggle", "corrupt", "lie", "seed"):
                raise ValueError(
                    f"unknown fault spec key {key!r} (expected "
                    "drop/straggle/corrupt/lie/seed)")
            try:
                if key == "drop":
                    kw["drop"] = float(val)
                elif key in ("straggle", "lie"):
                    rate, _, frac = val.partition(":")
                    kw[key] = float(rate)
                    if frac:
                        kw[f"{key}_frac"] = float(frac)
                elif key == "corrupt":
                    rate, _, rest = val.partition(":")
                    kw["corrupt"] = float(rate)
                    if rest:
                        mode, _, scale = rest.partition(":")
                        kw["corrupt_mode"] = mode.strip().lower()
                        if scale:
                            kw["corrupt_scale"] = float(scale)
                else:
                    kw["seed"] = int(val)
            except ValueError as e:
                raise ValueError(
                    f"fault spec token {token!r}: {e}") from None
        return cls(**kw)


class FaultPlan:
    """Dense per-``(round, client)`` fault schedule, host float32 arrays
    of shape ``(rounds, num_clients)``: the 0/1 role masks ``drop``,
    ``straggle``, ``corrupt`` and ``lie`` (mutually exclusive), the delta
    multiplier ``scale`` (1 on clean cells), the 0/1 full-poison mask
    ``poison`` and its NaN/Inf ``fill`` (0 elsewhere), and ``report``, the
    work fraction each client reports: derived from the straggle cells
    when not given, ``lie_frac`` on lying cells."""

    def __init__(self, drop, straggle, corrupt, scale, poison, fill,
                 report=None, lie=None):
        arrs = [np.asarray(a, np.float32)
                for a in (drop, straggle, corrupt, scale, poison, fill)]
        shape = arrs[0].shape
        if len(shape) != 2 or any(a.shape != shape for a in arrs):
            raise ValueError(
                f"FaultPlan arrays must share one (rounds, num_clients) "
                f"shape, got {[a.shape for a in arrs]}")
        self.drop, self.straggle, self.corrupt = arrs[:3]
        self.scale, self.poison, self.fill = arrs[3:]
        self.rounds, self.num_clients = shape
        for name, a in (("report", report), ("lie", lie)):
            if a is not None and np.asarray(a).shape != shape:
                raise ValueError(
                    f"FaultPlan {name} must match the "
                    f"(rounds, num_clients) shape {shape}, got "
                    f"{np.asarray(a).shape}")
        self.lie = (np.zeros(shape, np.float32) if lie is None
                    else np.asarray(lie, np.float32))
        if report is None:
            if self.lie.any():
                # a lie mask without the claimed fractions would build a
                # clean plan while fault_counts still counted the liars
                raise ValueError(
                    "FaultPlan with a nonzero lie mask needs an "
                    "explicit report array carrying the claimed work "
                    "fractions (FaultPlan.build derives it from "
                    "lie_frac)")
            # straggling cells report the work they did, everyone else
            # full work (a corrupt cell's scale is not work done)
            report = np.where(self.straggle > 0, self.scale,
                              np.float32(1.0))
        self.report = np.asarray(report, np.float32)

    @classmethod
    def build(cls, spec: FaultSpec, rounds: int,
              num_clients: int) -> "FaultPlan":
        """Expand a spec over the whole horizon: one uniform draw per
        cell assigns at most one role."""
        rs = np.random.RandomState(spec.seed)
        u = rs.random_sample((rounds, num_clients))
        drop = u < spec.drop
        straggle = ~drop & (u < spec.drop + spec.straggle)
        corrupt = (~drop & ~straggle
                   & (u < spec.drop + spec.straggle + spec.corrupt))
        lie = (~drop & ~straggle & ~corrupt
               & (u < spec.drop + spec.straggle + spec.corrupt
                  + spec.lie))
        scale = np.ones((rounds, num_clients), np.float32)
        scale[straggle] = spec.straggle_frac
        poison = np.zeros_like(scale)
        fill = np.zeros_like(scale)
        if spec.corrupt_mode == "sign":
            scale[corrupt] = -1.0
        elif spec.corrupt_mode == "scale":
            scale[corrupt] = spec.corrupt_scale
        else:
            poison[corrupt] = 1.0
            fill[corrupt] = (np.nan if spec.corrupt_mode == "nan"
                             else np.inf)
        # a lying cell's work is honest (scale stays 1); only its
        # reported fraction is false
        report = np.where(straggle, np.float32(spec.straggle_frac),
                          np.float32(1.0))
        report[lie] = spec.lie_frac
        return cls(drop, straggle, corrupt, scale, poison, fill,
                   report=report, lie=lie)

    def rows(self, start: int, stop: int, device) -> tuple:
        """``(drop, scale, poison, fill, tau_frac)`` for rounds ``[start,
        stop)`` as ``(stop - start, num_clients)`` float32 tensors on
        ``device``: one copy each, made before the first round, so a round
        reads its row with no host transfer. ``tau_frac`` is the reported
        work fraction (``report``). Sliced from the whole horizon, so a
        split run replays the same faults."""
        sl, device = slice(start, stop), torch.device(device)
        out = []
        for a in (self.drop, self.scale, self.poison, self.fill,
                  self.report):
            t = torch.from_numpy(np.ascontiguousarray(a[sl]))
            # to the card from pinned memory, queued: a pageable copy
            # would synchronise the host with the device
            out.append(t.pin_memory().to(device, non_blocking=True)
                       if device.type == "cuda" else t.to(device))
        return tuple(out)


def resolve_fault_plan(faults, rounds: int, num_clients: int):
    """The ``faults=`` argument of the round loop: None (clean), a spec
    string, a :class:`FaultSpec`, or a :class:`FaultPlan` (checked
    against this run's shape)."""
    if faults is None:
        return None
    if isinstance(faults, str):
        faults = FaultSpec.parse(faults)
    if isinstance(faults, FaultSpec):
        return FaultPlan.build(faults, rounds, num_clients)
    if isinstance(faults, FaultPlan):
        if (faults.rounds, faults.num_clients) != (rounds, num_clients):
            raise ValueError(
                f"FaultPlan is ({faults.rounds}, {faults.num_clients}) "
                f"but this run is ({rounds}, {num_clients}) "
                "(rounds, clients); rebuild the plan for this horizon")
        return faults
    raise TypeError(
        f"faults must be None, a spec string, a FaultSpec or a "
        f"FaultPlan, got {type(faults).__name__}")


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-client ``(J,)`` vector shaped to broadcast against ``(J,
    ...)`` leaves."""
    return v.reshape(v.shape + (1,) * (ndim - 1))


def inject_fault_row(params: dict, stacked: dict, losses: torch.Tensor,
                     scale_t, poison_t, fill_t):
    """Apply one plan row to a round's reported updates.

    Faulty cells become ``global + scale * (update - global)``, or the
    poison fill on every coordinate; clean cells pass through bitwise via
    the outer ``where`` (re-deriving ``g + (s - g)`` would move them by a
    rounding). A poisoned client's loss is poisoned too.
    """
    faithful = (scale_t == 1.0) & (poison_t == 0.0)
    out = {}
    for k, s in stacked.items():
        g = params[k]
        d = torch.where(_bcast(poison_t, s.dim()) > 0,
                        _bcast(fill_t, s.dim()),
                        (s - g) * _bcast(scale_t, s.dim()))
        out[k] = torch.where(_bcast(faithful, s.dim()), s, g + d)
    return out, torch.where(poison_t > 0, fill_t, losses)

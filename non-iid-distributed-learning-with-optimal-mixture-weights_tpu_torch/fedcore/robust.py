"""Update sanitization and robust aggregation for faulty rounds.

The port of the JAX package's ``fedcore/robust.py``, under its names and
with its semantics:

- :func:`sanitize_updates`: the non-finite quarantine (a client whose
  update or loss holds NaN/Inf is replaced by the incoming global weights
  and a zero loss, and flagged 0);
- :func:`clip_update_norms`: per-client delta norm clipping;
- :func:`zscore_quarantine`: the one-sided median/MAD z-test on the delta
  norms (``quarantine:Z``, ``quarantine:auto``);
- :func:`coordinatewise_median`, :func:`coordinatewise_trimmed_mean`,
  :func:`krum_select`/:func:`krum_aggregate` and
  :func:`geometric_median`: the Byzantine-robust reductions, unweighted
  over the present clients;
- the cross-round reputation plane (``rep[:decay[:floor]]``):
  :func:`directional_scores`, :func:`trust_bounded_work_frac`,
  :func:`reputation_update`, and ``quarantine:auto``'s threshold basis
  :func:`trimmed_clean_basis`.

Counts that live on the device. The present set changes every round and
its size is a device scalar (``sum(present)``). Every order statistic
takes its ranks from that scalar through tensor arithmetic and
``torch.gather``/``index_select``, never through ``.item()``, ``int()``
or ``nonzero()``: the round loop queues rounds without a host
synchronisation, and none of these functions adds one. Absent entries
sort to ``+inf`` (the medians) or ``-inf`` (the quantile and the clean
basis), so the empty-present cases give the JAX package's values.

The krum Gram ``x @ x.T`` is taken in full fp32 (:func:`full_fp32`):
a TF32 product would round the ~1e-4 squared distances the selection
compares.

``robust_agg`` spec syntax (the driver's ``--robust_agg``): ``"mean"``
(default), ``"median"``, ``"trim:K"``, ``"krum"``, ``"mkrum:M"``,
``"geomed[:T]"``, ``"clip:R"``, ``"quarantine:Z"``, ``"quarantine:auto"``,
``"rep[:decay[:floor]]"``, or ``+``-joined combinations such as
``"clip:5+trim:1"`` or ``"rep:0.9+quarantine:auto"``.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from .aggregate import full_fp32, weighted_average

# geomed's default smoothed-Weiszfeld iteration count
GEOMED_ITERS_DEFAULT = 8

# -- reputation (rep token) defaults ----------------------------------
# EWMA decay: equilibrium memory ~1/(1-decay) rounds
REP_DECAY_DEFAULT = 0.9
# hard-gate floor: a client whose reputation falls below it leaves the
# present mask (0.0 = soft down-weighting only)
REP_FLOOR_DEFAULT = 0.2
# z evidence reference when the spec carries `rep` without a quarantine
# token: only beyond-threshold z erodes reputation
Z_EVIDENCE_REF = 3.0
# directional-evidence reference: robust sigmas below the cohort's own
# cosine median before evidence erodes
DIR_Z_REF = 2.0
# a reported work fraction is bumped up only when the observed delta
# norm implies more than FRAC_MARGIN x the claimed work
FRAC_MARGIN = 2.0
# a krum/mkrum-deselected candidate keeps this fraction of its evidence
KRUM_DESEL_EROSION = 0.5

# -- quarantine:auto threshold estimator ------------------------------
# threshold = clip(Z_AUTO_MARGIN * m, Z_AUTO_MIN, Z_AUTO_MAX), m an EWMA
# (rate Z_AUTO_BETA) of the rise-capped top of the clean z scores,
# starting at Z_AUTO_INIT (the hand-tuned Z=5 operating point)
Z_AUTO_INIT = 10.0 / 3.0
Z_AUTO_MARGIN = 1.5
Z_AUTO_MIN = 3.0
Z_AUTO_MAX = 20.0
Z_AUTO_BETA = 0.1
Z_AUTO_Q = 1.0  # the quantile of the clean basis (1 = the clean max)
Z_AUTO_TRIM_GAP = 1.5  # cap: basis <= gap * second-largest clean z

# set (the test suite does) to check every parse_robust_spec call against
# the canonical round trip: parse(canonical(parse(s))) == parse(s)
SPEC_ROUNDTRIP_ENV = "FEDAMW_SPEC_ROUNDTRIP_CHECK"


@dataclasses.dataclass(frozen=True)
class RobustSpec:
    """Parsed ``robust_agg`` spec: the aggregator, an optional norm clip,
    an optional z-score quarantine threshold (fixed or auto-tuned) and
    optional cross-round reputation."""

    agg: str = "mean"           # mean | median | trim | krum | mkrum | geomed
    trim: int = 0               # k, for agg == "trim"
    mkrum_m: int = 0            # M, for agg == "mkrum" (krum is M=1)
    geomed_iters: int = 0       # Weiszfeld iterations, for agg == "geomed"
    clip: float | None = None   # max delta L2 norm, or None
    zscore: float | None = None  # quarantine z threshold, or None
    zscore_auto: bool = False   # quarantine:auto (threshold from state)
    rep_decay: float | None = None  # reputation EWMA decay, or None (off)
    rep_floor: float = 0.0      # hard-gate floor, for rep_decay set

    def canonical(self) -> str:
        """One spelling per spec: parsing it gives this spec back, and it
        is a fixed point."""
        parts = []
        if self.clip is not None:
            parts.append(f"clip:{self.clip}")
        if self.zscore_auto:
            parts.append("quarantine:auto")
        elif self.zscore is not None:
            parts.append(f"quarantine:{self.zscore}")
        if self.rep_decay is not None:
            parts.append(f"rep:{self.rep_decay}:{self.rep_floor}")
        if self.agg == "trim":
            parts.append(f"trim:{self.trim}")
        elif self.agg == "mkrum":
            parts.append(f"mkrum:{self.mkrum_m}")
        elif self.agg == "geomed":
            parts.append(f"geomed:{self.geomed_iters}")
        elif self.agg != "mean":
            parts.append(self.agg)
        return "+".join(parts) or "mean"

    @property
    def is_default(self) -> bool:
        return (self.agg == "mean" and self.clip is None
                and self.zscore is None and not self.zscore_auto
                and self.rep_decay is None)

    @property
    def stateful(self) -> bool:
        """True when the spec carries state across rounds (the reputation
        vector and/or the auto-threshold estimate)."""
        return self.zscore_auto or self.rep_decay is not None

    @property
    def select_m(self) -> int | None:
        """Krum-family selection size (1 for krum, M for mkrum), None for
        the other aggregators."""
        if self.agg == "krum":
            return 1
        if self.agg == "mkrum":
            return self.mkrum_m
        return None


def _parse_pos_int(spec, token, what: str) -> int:
    _, _, raw = token.partition(":")
    try:
        val = int(raw)
    except ValueError:
        val = -1
    if val < 1:
        raise ValueError(
            f"robust_agg={spec!r}: {what} needs a positive integer, "
            f"got {token!r}")
    return val


def _parse_pos_float(spec, token, what: str, default: float) -> float:
    _, _, raw = token.partition(":")
    try:
        val = float(raw) if raw else default
    except ValueError:
        val = -1.0
    # `not (val > 0)` so NaN fails too
    if not (val > 0) or math.isinf(val):
        raise ValueError(
            f"robust_agg={spec!r}: {what} must be a positive finite "
            f"number, got {token!r}")
    return val


def parse_robust_spec(spec) -> RobustSpec:
    """Parse and validate a ``robust_agg`` spec (string or RobustSpec),
    with the JAX package's error messages. With :data:`SPEC_ROUNDTRIP_ENV`
    set, every accepted spelling is also checked against the canonical
    round trip."""
    out = _parse_robust_spec(spec)
    if os.environ.get(SPEC_ROUNDTRIP_ENV):
        again = _parse_robust_spec(out.canonical())
        if again != out or again.canonical() != out.canonical():
            raise AssertionError(
                f"RobustSpec canonical round-trip broken for "
                f"{spec!r}: parsed {out}, canonical "
                f"{out.canonical()!r} re-parses to {again}")
    return out


def _parse_rep_token(spec, token):
    """``rep[:decay[:floor]]`` -> (decay, floor), validated."""
    fields = token.split(":")
    if len(fields) > 3:
        raise ValueError(
            f"robust_agg={spec!r}: rep takes at most decay and floor "
            f"('rep[:decay[:floor]]'), got {token!r}")
    try:
        decay = float(fields[1]) if len(fields) > 1 else REP_DECAY_DEFAULT
    except ValueError:
        decay = math.nan
    try:
        floor = float(fields[2]) if len(fields) > 2 else REP_FLOOR_DEFAULT
    except ValueError:
        floor = math.nan
    if not (0.0 < decay < 1.0):
        raise ValueError(
            f"robust_agg={spec!r}: the rep decay must be in (0, 1), "
            f"got {token!r}")
    if not (0.0 <= floor < 1.0):
        raise ValueError(
            f"robust_agg={spec!r}: the rep floor must be in [0, 1), "
            f"got {token!r}")
    return decay, floor


def _parse_robust_spec(spec) -> RobustSpec:
    if isinstance(spec, RobustSpec):
        return spec
    agg, trim, mkrum_m, geomed_iters = "mean", 0, 0, 0
    clip = zscore = rep_decay = None
    zscore_auto, rep_floor = False, 0.0
    agg_set = False
    for token in str(spec).split("+"):
        token = token.strip().lower()
        if not token:
            continue
        head = token.split(":", 1)[0]
        if head in ("mean", "median", "trim", "krum", "mkrum", "geomed"):
            if agg_set:
                raise ValueError(
                    f"robust_agg={spec!r}: at most one aggregator "
                    "(mean/median/trim:K/krum/mkrum:M/geomed[:T]) "
                    "per spec")
            agg_set = True
            agg = head
            if head == "trim":
                trim = _parse_pos_int(spec, token, "trim")
            elif head == "mkrum":
                mkrum_m = _parse_pos_int(spec, token, "mkrum")
            elif head == "geomed":
                geomed_iters = (_parse_pos_int(spec, token, "geomed")
                                if ":" in token else GEOMED_ITERS_DEFAULT)
            elif ":" in token:
                raise ValueError(
                    f"robust_agg={spec!r}: {head!r} takes no argument "
                    f"(got {token!r}; multi-Krum is 'mkrum:M')")
        elif head == "clip":
            if clip is not None:
                raise ValueError(
                    f"robust_agg={spec!r}: at most one clip radius "
                    "per spec")
            clip = _parse_pos_float(spec, token, "the clip radius", 1.0)
        elif head == "quarantine":
            if zscore is not None or zscore_auto:
                raise ValueError(
                    f"robust_agg={spec!r}: at most one quarantine "
                    "threshold per spec")
            if token.partition(":")[2].strip() == "auto":
                zscore_auto = True
            else:
                zscore = _parse_pos_float(
                    spec, token, "the quarantine z threshold", 3.0)
        elif head == "rep":
            if rep_decay is not None:
                raise ValueError(
                    f"robust_agg={spec!r}: at most one rep token "
                    "per spec")
            rep_decay, rep_floor = _parse_rep_token(spec, token)
        else:
            raise ValueError(
                f"robust_agg={spec!r}: unknown token {token!r} "
                "(expected mean, median, trim:K, krum, mkrum:M, "
                "geomed[:T], clip:R, quarantine:Z|auto, "
                "rep[:decay[:floor]], or '+'-joined combinations)")
    return RobustSpec(agg=agg, trim=trim, mkrum_m=mkrum_m,
                      geomed_iters=geomed_iters, clip=clip,
                      zscore=zscore, zscore_auto=zscore_auto,
                      rep_decay=rep_decay, rep_floor=rep_floor)


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (ndim - 1))


def _leaves(tree: dict) -> list:
    """A parameter dict's leaves in the JAX package's tree order (sorted
    keys)."""
    return [tree[k] for k in sorted(tree)]


def _count(present: torch.Tensor) -> torch.Tensor:
    """The present count as an int64 device scalar."""
    return torch.sum(present).to(torch.int64)


def _at(s: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``s[i]`` along dim 0 for a device scalar ``i``, without reading
    ``i`` on the host."""
    return s.index_select(0, i.reshape(1))[0]


def sanitize_updates(params: dict, stacked: dict, losses: torch.Tensor):
    """The non-finite quarantine. Returns ``(stacked_clean, losses_clean,
    ok)``: ``ok`` the ``(J,)`` 0/1 float mask of clients whose every leaf
    and loss are finite; quarantined entries take the incoming global
    weights and a zero loss."""
    ok = torch.isfinite(losses)
    for leaf in _leaves(stacked):
        ok = ok & torch.isfinite(leaf).flatten(1).all(1)
    clean = {k: torch.where(_bcast(ok, s.dim()), s, params[k])
             for k, s in stacked.items()}
    return clean, torch.where(ok, losses, 0.0), ok.to(torch.float32)


def client_delta_norms(params: dict, stacked: dict) -> torch.Tensor:
    """Global (all-leaf) L2 norm of each client's update delta, ``(J,)``.
    ``params`` broadcasts against the stacked client axis."""
    total = None
    for k in sorted(stacked):
        s = stacked[k]
        sq = torch.sum(torch.square(s - params[k]).reshape(s.shape[0], -1),
                       dim=1)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_update_norms(params: dict, stacked: dict, max_norm: float) -> dict:
    """Rescale every client delta longer than ``max_norm`` down to it
    (``min(1, R/norm)`` is exactly 1 for the others)."""
    norms = client_delta_norms(params, stacked)
    scale = torch.clamp(max_norm / torch.clamp(norms, min=1e-30), max=1.0)
    return {k: params[k] + _bcast(scale, s.dim()) * (s - params[k])
            for k, s in stacked.items()}


def _masked_vector_median(v: torch.Tensor,
                          present: torch.Tensor) -> torch.Tensor:
    """Median of a ``(J,)`` vector over the present entries (absent sort
    to ``+inf``; ``inf`` with none present)."""
    n = _count(present)
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), min=0)
    s = torch.sort(torch.where(present > 0, v, math.inf)).values
    return 0.5 * (_at(s, lo) + _at(s, hi))


def _masked_vector_quantile(v: torch.Tensor, present: torch.Tensor,
                            q: float) -> torch.Tensor:
    """Empirical ``q``-quantile of a ``(J,)`` vector over the present
    entries (``q=1`` the masked max). Absent entries sort to ``-inf``, so
    the present ones are the top of the ascending sort; ``-inf`` with none
    present (callers gate on the count)."""
    J = v.shape[0]
    n = _count(present)
    k = torch.minimum(torch.clamp(torch.ceil(q * n).to(torch.int64), min=1),
                      torch.clamp(n, min=1))
    idx = torch.clamp(J - n + k - 1, 0, J - 1)
    s = torch.sort(torch.where(present > 0, v, -math.inf)).values
    return _at(s, idx)


def trimmed_clean_basis(z: torch.Tensor, clean: torch.Tensor,
                        prev) -> torch.Tensor:
    """``quarantine:auto``'s per-round threshold basis: the largest clean
    z, rise-capped at the larger of :data:`Z_AUTO_TRIM_GAP` times the
    second-largest clean z and the carried estimate ``prev``. The raw max
    with fewer than two clean entries; ``-inf`` with none."""
    top = _masked_vector_quantile(z, clean, Z_AUTO_Q)
    J = z.shape[0]
    n = _count(clean)
    s = torch.sort(torch.where(clean > 0, z, -math.inf)).values
    second = s[min(max(J - 2, 0), J - 1)]
    # the carried estimate (a device scalar) or a host number, which stays
    # a host scalar: no copy to the device
    cap = torch.maximum(Z_AUTO_TRIM_GAP * second,
                        torch.as_tensor(prev, dtype=torch.float32))
    return torch.where(n >= 2, torch.minimum(top, cap), top)


def zscore_quarantine(params, stacked, present: torch.Tensor, z_max,
                      work_frac: torch.Tensor | None = None,
                      norms: torch.Tensor | None = None,
                      score_mask: torch.Tensor | None = None):
    """The one-sided robust z-test on delta norms: ``z = max(norm -
    median, 0) / (1.4826 * MAD)`` over the present clients' norms, each
    norm first divided by the client's reported work fraction
    (``work_frac``) when given. ``score_mask`` widens the scored set past
    ``present`` (the statistics always come from ``present``); ``norms``
    shares already-computed norms; ``z_max`` may be a device scalar.
    Returns ``(ok, z)``: ``ok`` 1 where ``z <= z_max``; ``z`` 0 on clients
    not scored. A spread below ``1e-6 * median`` scores everyone 0."""
    if norms is None:
        norms = client_delta_norms(params, stacked)
    if work_frac is not None:
        norms = norms / torch.clamp(work_frac, 1e-6, 1.0)
    med = _masked_vector_median(norms, present)
    dev = torch.abs(norms - med)
    mad = _masked_vector_median(dev, present)
    spread = 1.4826 * mad
    floor = 1e-6 * med + 1e-30
    scored = present if score_mask is None else score_mask
    z = (scored * torch.clamp(norms - med, min=0.0)
         / torch.maximum(spread, floor))
    ok = torch.where(z <= z_max, 1.0, 0.0)
    return ok, z


def directional_scores(params, stacked, present: torch.Tensor):
    """Cosine of each client's update delta to the coordinate-wise median
    delta over the present clients, ``(J,)``: a norm-preserving sign flip
    lands near -1. Degenerate rounds give non-finite or zero cosines,
    which :func:`reputation_update` maps to zero evidence."""
    x = _flat_deltas(params, stacked)
    med = coordinatewise_median({"x": x}, present)["x"]
    with full_fp32():
        dot = x @ med
    nx = torch.sqrt(torch.sum(torch.square(x), dim=1))
    nm = torch.sqrt(torch.sum(torch.square(med)))
    return dot / torch.clamp(nx * nm, min=1e-30)


def trust_bounded_work_frac(norms: torch.Tensor,
                            reported_frac: torch.Tensor,
                            present: torch.Tensor, rep: torch.Tensor):
    """Clamp the self-reported work fraction by reputation (the claim is
    pulled toward the cohort median claim as reputation drops) and by the
    observed delta norms (a claim is bumped to ``norm / (FRAC_MARGIN *
    median(norm / claim))`` when the norm implies more work). Returns
    ``(trusted, n_clamped)``: absent clients keep their report;
    ``n_clamped`` counts present clients whose claim moved by more than
    1e-3."""
    med_frac = _masked_vector_median(reported_frac, present)
    trusted = med_frac + rep * (reported_frac - med_frac)
    eq = norms / torch.clamp(reported_frac, 1e-6, 1.0)
    med_eq = _masked_vector_median(eq, present)
    implied = norms / torch.clamp(FRAC_MARGIN * med_eq, min=1e-30)
    trusted = torch.maximum(trusted, torch.clamp(implied, max=1.0))
    trusted = torch.clamp(trusted, 1e-6, 1.0)
    trusted = torch.where(present > 0, trusted, reported_frac)
    n_clamped = torch.sum(
        present * (torch.abs(trusted - reported_frac) > 1e-3))
    return trusted, n_clamped


def reputation_update(rep: torch.Tensor, reported: torch.Tensor,
                      scoreable: torch.Tensor, dir_cos: torch.Tensor,
                      present: torch.Tensor, z: torch.Tensor | None, z_ref,
                      decay: float, sel: torch.Tensor | None = None,
                      sel_cand: torch.Tensor | None = None):
    """One EWMA step ``rep' = decay * rep + (1 - decay) * evidence`` on
    every reporting client (the others keep theirs). Evidence is the
    product of the directional channel (the cosine's lower-tail robust z
    against the present cohort, beyond :data:`DIR_Z_REF`), the norm
    channel (``exp(-max(z - z_ref, 0))``) and, with ``sel``/``sel_cand``,
    the previous round's krum verdict (a deselected candidate keeps
    :data:`KRUM_DESEL_EROSION`), masked by ``scoreable``; non-finite
    cosines count as maximally deviant and non-finite evidence as 0."""
    cos = torch.where(torch.isfinite(dir_cos), dir_cos, -1.0)
    med = _masked_vector_median(cos, present)
    mad = _masked_vector_median(torch.abs(cos - med), present)
    spread = torch.clamp(1.4826 * mad, min=1e-6)
    dz = torch.clamp(med - cos, min=0.0) / spread
    d_ev = torch.exp(-torch.clamp(dz - DIR_Z_REF, min=0.0))
    z_ev = (torch.exp(-torch.clamp(z - z_ref, min=0.0)) if z is not None
            else torch.ones_like(rep))
    ev = d_ev * z_ev * scoreable
    if sel is not None:
        ev = ev * (1.0 - KRUM_DESEL_EROSION * sel_cand * (1.0 - sel))
    ev = torch.where(torch.isfinite(ev), ev, 0.0)
    return torch.where(reported > 0, decay * rep + (1.0 - decay) * ev, rep)


def _flat_deltas(params: dict, stacked: dict) -> torch.Tensor:
    """Per-client update deltas as a ``(J, P)`` matrix. The Gram
    expansion of the pairwise distances does not cancel the shared global
    weights in float32, so they are subtracted first."""
    return torch.cat([(stacked[k] - params[k]).reshape(
        stacked[k].shape[0], -1) for k in sorted(stacked)], dim=1)


def _masked_mean(stacked: dict, present: torch.Tensor) -> dict:
    """Unweighted mean over the present clients."""
    return weighted_average(
        stacked, present / torch.clamp(torch.sum(present), min=1.0))


def krum_select(params, stacked, present: torch.Tensor, m: int):
    """Multi-Krum selection mask (Blanchard et al., 2017): the ``m``
    best-scored present clients, a client's score being the summed
    squared delta distance to its ``q = n - f - 2`` closest present peers,
    ``f = (n - 3) // 2``. With fewer than 3 present clients every present
    client is selected. Ties at the boundary go to the lowest client index
    (a stable argsort). Returns the ``(J,)`` 0/1 float mask."""
    x = _flat_deltas(params, stacked)
    J = x.shape[0]
    sq = torch.sum(torch.square(x), dim=1)
    with full_fp32():
        gram = x @ x.T
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * gram, min=0.0)
    pb = present > 0
    peer = (pb[:, None] & pb[None, :]
            & ~torch.eye(J, dtype=torch.bool, device=x.device))
    d2 = torch.where(peer, d2, math.inf)
    n = _count(present)
    f = torch.clamp(torch.div(n - 3, 2, rounding_mode="floor"), min=0)
    q = torch.clamp(n - f - 2, 1, max(J - 1, 1))
    dsort = torch.sort(d2, dim=1).values
    idx = torch.arange(J, device=x.device)
    score = torch.sum(torch.where(idx[None, :] < q, dsort, 0.0), dim=1)
    sel_count = torch.clamp(n, max=m)
    order = torch.argsort(score, stable=True)
    selected = torch.zeros(J, dtype=torch.float32, device=x.device).scatter(
        0, order, (idx < sel_count).to(torch.float32))
    return torch.where(n >= 3, selected, present)


def krum_aggregate(params, stacked, present: torch.Tensor, m: int):
    """Unweighted mean of the ``m`` Krum-selected clients. Returns
    ``(aggregate, selected)``."""
    selected = krum_select(params, stacked, present, m)
    return _masked_mean(stacked, selected), selected


def geometric_median(stacked: dict, present: torch.Tensor, iters: int,
                     eps: float = 1e-8):
    """Smoothed Weiszfeld geometric median over the present clients (RFA,
    Pillutla et al., 2022), unweighted, ``iters`` steps from the masked
    mean. Returns ``(median, residual)``, the residual the L2 distance
    between the last two iterates."""
    v = _masked_mean(stacked, present)

    def step(v):
        dist = client_delta_norms(v, stacked)
        w = present / torch.sqrt(torch.square(dist) + eps * eps)
        return weighted_average(
            stacked, w / torch.clamp(torch.sum(w), min=1e-30))

    for _ in range(max(iters - 1, 0)):
        v = step(v)
    v_last = step(v)
    residual = client_delta_norms(
        v, {k: a[None] for k, a in v_last.items()})[0]
    return v_last, residual


def coordinatewise_median(stacked: dict, present: torch.Tensor) -> dict:
    """Per-coordinate median over the present clients (Yin et al.,
    2018); absent clients sort to ``+inf`` (``inf`` with none present)."""
    n = _count(present)
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), min=0)
    out = {}
    for k, x in stacked.items():
        s = torch.sort(torch.where(_bcast(present, x.dim()) > 0, x,
                                   math.inf), dim=0).values
        out[k] = 0.5 * (_at(s, lo) + _at(s, hi))
    return out


def coordinatewise_trimmed_mean(stacked: dict, present: torch.Tensor,
                                k: int) -> dict:
    """Per-coordinate mean with the ``k`` smallest and largest present
    reports dropped (Yin et al., 2018); the masked mean when ``2k + 1``
    clients are not present."""
    n = _count(present)
    first = next(iter(stacked.values()))
    idx = torch.arange(first.shape[0], device=first.device)
    keep = (idx >= k) & (idx < n - k)
    denom = torch.clamp(n - 2 * k, min=1).to(torch.float32)
    n_f = torch.clamp(n, min=1).to(torch.float32)
    out = {}
    for key, x in stacked.items():
        pb = _bcast(present, x.dim()) > 0
        s = torch.sort(torch.where(pb, x, math.inf), dim=0).values
        trimmed = torch.sum(torch.where(_bcast(keep, x.dim()), s, 0.0),
                            dim=0) / denom
        masked_mean = torch.sum(torch.where(pb, x, 0.0), dim=0) / n_f
        out[key] = torch.where(n > 2 * k, trimmed, masked_mean)
    return out


def make_robust_aggregator(spec: RobustSpec):
    """``aggregate(params, stacked, weights, present) -> (dict, aux)`` for
    the spec. ``mean`` is the weighted average with the caller's weights;
    the order-statistic and distance aggregators use the 0/1 ``present``
    mask and ignore the weights. ``aux`` carries krum's
    ``krum_selected`` mask or geomed's ``geomed_residual``."""
    if spec.agg == "median":
        return lambda params, stacked, w, present: (
            coordinatewise_median(stacked, present), {})
    if spec.agg == "trim":
        k = spec.trim
        return lambda params, stacked, w, present: (
            coordinatewise_trimmed_mean(stacked, present, k), {})
    if spec.agg in ("krum", "mkrum"):
        m = spec.select_m

        def agg_krum(params, stacked, w, present):
            out, selected = krum_aggregate(params, stacked, present, m)
            return out, {"krum_selected": selected}

        return agg_krum
    if spec.agg == "geomed":
        iters = spec.geomed_iters

        def agg_geomed(params, stacked, w, present):
            out, residual = geometric_median(stacked, present, iters)
            return out, {"geomed_residual": residual}

        return agg_geomed
    return lambda params, stacked, w, present: (
        weighted_average(stacked, w), {})

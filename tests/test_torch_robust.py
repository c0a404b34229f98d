"""The port's defenses (``fedamw_tpu_torch.fedcore.robust``) against the
JAX package's ``fedcore/robust.py``, function by function, on the CPU.

Every function runs on the same seeded numpy inputs in both packages:
stacked client weights around a global one, under present masks with
absent clients, a single client, two clients and none present, with
non-finite reports, ``n <= 2k`` for the trimmed mean, ``n < 3`` for krum
and exactly tied krum scores (integer deltas, so both Gram products are
exact). Floats are held to 1e-5 relative and 1e-6 absolute, infinities
and NaNs in the same places; masks and counts exactly. The spec grammar
is held message for message, and ``canonical`` must round-trip.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedamw_tpu.fedcore import robust as jr
from fedamw_tpu_torch.fedcore import robust as tr

TOL = dict(rtol=1e-5, atol=1e-6)
J, C, D = 7, 3, 5
PRESENT = {
    "all": np.ones(J, np.float32),
    "some": np.array([1, 0, 1, 1, 0, 1, 1], np.float32),
    "two": np.array([0, 1, 0, 0, 1, 0, 0], np.float32),
    "one": np.array([0, 0, 0, 1, 0, 0, 0], np.float32),
    "none": np.zeros(J, np.float32),
}


def _inputs(seed=0, outlier=True):
    rng = np.random.RandomState(seed)
    g = rng.randn(C, D).astype(np.float32)
    s = (g[None] + 0.05 * rng.randn(J, C, D)).astype(np.float32)
    if outlier:
        s[2] = g + 2.0 * (s[2] - g) + 0.5     # a large update
    return g, s


def _t(x):
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    if isinstance(x, dict):
        return {k: _j(v) for k, v in x.items()}
    return jnp.asarray(x)


def _close(got, want, **tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], **tol)
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **(tol or TOL))


def _both(name, *args, **kw):
    """``name`` of each package on the same inputs (numpy -> each)."""
    t = getattr(tr, name)(*[_t(a) if isinstance(a, (np.ndarray, dict))
                            else a for a in args],
                          **{k: _t(v) if isinstance(v, (np.ndarray, dict))
                             else v for k, v in kw.items()})
    j = getattr(jr, name)(*[_j(a) if isinstance(a, (np.ndarray, dict))
                            else a for a in args],
                          **{k: _j(v) if isinstance(v, (np.ndarray, dict))
                             else v for k, v in kw.items()})
    return t, j


# -- the spec grammar -------------------------------------------------------

SPECS = ["mean", "median", "trim:2", "krum", "mkrum:3", "geomed", "geomed:4",
         "clip:5", "clip", "quarantine:3", "quarantine", "quarantine:auto",
         "rep", "rep:0.5", "rep:0.5:0.1", "clip:5+trim:1",
         "quarantine:3+mkrum:6", "rep:0.9+quarantine:auto",
         "rep:0.5:0.1+quarantine:auto+mkrum:4", " MEDIAN + clip:2.5 ", ""]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parses_and_round_trips_as_in_jax(spec):
    t, j = tr.parse_robust_spec(spec), jr.parse_robust_spec(spec)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.canonical() == j.canonical()
    assert (t.is_default, t.stateful, t.select_m) == (
        j.is_default, j.stateful, j.select_m)
    again = tr.parse_robust_spec(t.canonical())
    assert again == t and again.canonical() == t.canonical()
    assert tr.parse_robust_spec(t) is t


BAD = ["bogus", "median+mean", "trim", "trim:0", "mkrum:x", "krum:2",
       "geomed:0", "clip:0", "clip:nan", "clip:inf", "clip:1+clip:2",
       "quarantine:-1", "quarantine:3+quarantine:auto", "rep:1",
       "rep:0", "rep:0.5:1", "rep:0.9:abc", "rep:0.5:0.1:3", "rep+rep"]


@pytest.mark.parametrize("spec", BAD)
def test_spec_errors_are_the_jax_errors(spec):
    with pytest.raises(ValueError) as jerr:
        jr.parse_robust_spec(spec)
    with pytest.raises(ValueError) as terr:
        tr.parse_robust_spec(spec)
    assert str(terr.value) == str(jerr.value)


def test_constants_are_the_jax_constants():
    for name in ("GEOMED_ITERS_DEFAULT", "REP_DECAY_DEFAULT",
                 "REP_FLOOR_DEFAULT", "Z_EVIDENCE_REF", "DIR_Z_REF",
                 "FRAC_MARGIN", "KRUM_DESEL_EROSION", "Z_AUTO_INIT",
                 "Z_AUTO_MARGIN", "Z_AUTO_MIN", "Z_AUTO_MAX", "Z_AUTO_BETA",
                 "Z_AUTO_Q", "Z_AUTO_TRIM_GAP", "SPEC_ROUNDTRIP_ENV"):
        assert getattr(tr, name) == getattr(jr, name), name


# -- sanitize, norms, clip --------------------------------------------------


@pytest.mark.parametrize("poison", ["none", "nan_w", "inf_w", "nan_loss"])
def test_sanitize_updates_matches_jax(poison):
    g, s = _inputs()
    losses = np.random.RandomState(1).rand(J).astype(np.float32)
    if poison == "nan_w":
        s[4, 1, 2] = np.nan
    elif poison == "inf_w":
        s[0] = np.inf
    elif poison == "nan_loss":
        losses[5] = np.nan
    (ts, tl, tok), (js, jl, jok) = _both("sanitize_updates", {"w": g},
                                         {"w": s}, losses)
    _close(ts, js)
    _close(tl, jl)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.dtype == torch.float32


def test_delta_norms_and_flat_deltas_match_jax():
    g, s = _inputs()
    _close(*_both("client_delta_norms", {"w": g}, {"w": s}))
    _close(*_both("_flat_deltas", {"w": g}, {"w": s}))


@pytest.mark.parametrize("radius", [0.05, 0.5, 100.0])
def test_clip_update_norms_matches_jax(radius):
    g, s = _inputs()
    t, j = _both("clip_update_norms", {"w": g}, {"w": s}, radius)
    _close(t, j)
    if radius == 100.0:   # nobody clipped: min(1, R/norm) is exactly 1
        np.testing.assert_allclose(t["w"].numpy(), s, rtol=0, atol=1e-6)


# -- order statistics with a device count ----------------------------------


@pytest.mark.parametrize("present", sorted(PRESENT))
def test_masked_vector_median_and_quantiles_match_jax(present):
    v = np.random.RandomState(2).randn(J).astype(np.float32)
    m = PRESENT[present]
    _close(*_both("_masked_vector_median", v, m))
    for q in (1.0, 0.5, 0.3):
        _close(*_both("_masked_vector_quantile", v, m, q))


@pytest.mark.parametrize("present", sorted(PRESENT))
@pytest.mark.parametrize("prev", [10.0 / 3.0, 0.5])
def test_trimmed_clean_basis_matches_jax(present, prev):
    z = np.abs(np.random.RandomState(3).randn(J)).astype(np.float32) * 3
    z[5] = 9.0
    m = PRESENT[present]
    _close(*_both("trimmed_clean_basis", z, m, prev))
    # the carried estimate as a device scalar
    t = tr.trimmed_clean_basis(_t(z), _t(m), torch.tensor(prev,
                                                          dtype=torch.float32))
    _close(t, jr.trimmed_clean_basis(_j(z), _j(m), prev))


@pytest.mark.parametrize("present", sorted(PRESENT))
@pytest.mark.parametrize("variant", ["plain", "work_frac", "score_mask",
                                     "traced_zmax"])
def test_zscore_quarantine_matches_jax(present, variant):
    g, s = _inputs()
    m = PRESENT[present]
    kw = {}
    z_max = 3.0
    if variant == "work_frac":
        kw["work_frac"] = np.array([1, 0.5, 1, 0.25, 1, 1, 0.01], np.float32)
    elif variant == "score_mask":
        kw["score_mask"] = np.ones(J, np.float32)
        kw["norms"] = np.array(jr.client_delta_norms({"w": g}, {"w": s}))
    (tok, tz), (jok, jz) = _both("zscore_quarantine", {"w": g}, {"w": s}, m,
                                 z_max, **kw)
    if variant == "traced_zmax":
        tok, tz = tr.zscore_quarantine(_t({"w": g}), _t({"w": s}), _t(m),
                                       torch.tensor(3.0))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    _close(tz, jz)


def test_identical_updates_score_zero():
    g, _ = _inputs()
    s = np.repeat((g + 0.1)[None], J, 0)
    (tok, tz), (jok, jz) = _both("zscore_quarantine", {"w": g}, {"w": s},
                                 PRESENT["all"], 3.0)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    assert not tz.any() and bool(tok.all())


# -- the reputation plane ----------------------------------------------------


@pytest.mark.parametrize("present", sorted(PRESENT))
def test_directional_scores_match_jax(present):
    g, s = _inputs()
    s[4] = g - (s[4] - g)   # a sign flip
    t, j = _both("directional_scores", {"w": g}, {"w": s}, PRESENT[present])
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("present", sorted(PRESENT))
def test_trust_bounded_work_frac_matches_jax(present):
    rng = np.random.RandomState(4)
    norms = (1 + 0.05 * rng.randn(J)).astype(np.float32)
    norms[3] = 0.25
    claim = np.ones(J, np.float32)
    claim[3] = 0.25         # an honest straggler
    claim[5] = 0.01         # a liar doing full work
    rep = rng.rand(J).astype(np.float32)
    (tt, tn), (jt, jn) = _both("trust_bounded_work_frac", norms, claim,
                               PRESENT[present], rep)
    _close(tt, jt)
    assert float(tn) == float(jn)


@pytest.mark.parametrize("present", sorted(PRESENT))
@pytest.mark.parametrize("channels", ["dir", "dir+z", "dir+z+krum"])
def test_reputation_update_matches_jax(present, channels):
    rng = np.random.RandomState(5)
    rep = rng.rand(J).astype(np.float32)
    m = PRESENT[present]
    reported = np.maximum(m, np.eye(J, dtype=np.float32)[6])
    scoreable = reported.copy()
    scoreable[6] = 0.0      # a non-finite reporter earns no evidence
    cos = rng.uniform(-1, 1, J).astype(np.float32)
    cos[1] = np.nan
    kw = {}
    z = None
    if "z" in channels:
        z = np.abs(rng.randn(J)).astype(np.float32) * 4
    if "krum" in channels:
        kw = dict(sel=np.array([1, 0, 1, 0, 1, 1, 0], np.float32),
                  sel_cand=m)
    t, j = _both("reputation_update", rep, reported, scoreable, cos, m, z,
                 3.0, 0.5, **kw)
    _close(t, j)


# -- the robust reductions --------------------------------------------------


@pytest.mark.parametrize("present", sorted(PRESENT))
def test_coordinatewise_median_matches_jax(present):
    _, s = _inputs()
    _close(*_both("coordinatewise_median", {"w": s}, PRESENT[present]))


@pytest.mark.parametrize("present", sorted(PRESENT))
@pytest.mark.parametrize("k", [1, 2, 3])
def test_coordinatewise_trimmed_mean_matches_jax(present, k):
    """``n <= 2k`` falls back to the masked mean in both."""
    _, s = _inputs()
    _close(*_both("coordinatewise_trimmed_mean", {"w": s},
                  PRESENT[present], k))


@pytest.mark.parametrize("present", sorted(PRESENT))
@pytest.mark.parametrize("m", [1, 3, 10])
def test_krum_select_matches_jax(present, m):
    """Below 3 present clients every present client is selected."""
    g, s = _inputs()
    t, j = _both("krum_select", {"w": g}, {"w": s}, PRESENT[present], m)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    (ta, tsel), (ja, jsel) = _both("krum_aggregate", {"w": g}, {"w": s},
                                   PRESENT[present], m)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    _close(ta, ja)


@pytest.mark.parametrize("m", [1, 2, 4])
def test_krum_ties_go_to_the_lowest_index_as_in_jax(m):
    """Integer deltas from zero weights: both Gram products are exact, so
    clients 1, 3 and 5 (identical) tie exactly; the stable argsort keeps
    the lowest index first."""
    g = np.zeros((1, 4), np.float32)
    base = np.array([1, 2, 0, 1], np.float32)
    s = np.stack([base + d for d in (
        [0, 0, 0, 0], [1, 0, 0, 0], [5, 5, 5, 5], [1, 0, 0, 0],
        [0, 1, 0, 0], [1, 0, 0, 0], [-4, 3, 0, 2])]).astype(np.float32)
    s = s[:, None, :]
    t, j = _both("krum_select", {"w": g}, {"w": s}, PRESENT["all"], m)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if m == 1:
        assert t.numpy().tolist() == [0, 1, 0, 0, 0, 0, 0]


@pytest.mark.parametrize("present", ["all", "some", "two", "one"])
@pytest.mark.parametrize("iters", [1, 4, 8])
def test_geometric_median_matches_jax(present, iters):
    _, s = _inputs()
    (tv, tres), (jv, jres) = _both("geometric_median", {"w": s},
                                   PRESENT[present], iters)
    _close(tv, jv)
    np.testing.assert_allclose(float(tres), float(jres), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("spec", ["mean", "median", "trim:1", "krum",
                                  "mkrum:3", "geomed:3"])
@pytest.mark.parametrize("present", ["all", "some"])
def test_make_robust_aggregator_matches_jax(spec, present):
    g, s = _inputs()
    m = PRESENT[present]
    w = (m / m.sum()).astype(np.float32)
    t_agg = tr.make_robust_aggregator(tr.parse_robust_spec(spec))
    j_agg = jr.make_robust_aggregator(jr.parse_robust_spec(spec))
    tv, taux = t_agg(_t({"w": g}), _t({"w": s}), _t(w), _t(m))
    jv, jaux = j_agg(_j({"w": g}), _j({"w": s}), _j(w), _j(m))
    _close(tv, jv, rtol=1e-5, atol=1e-5)
    assert set(taux) == set(jaux)
    for k in jaux:
        _close(taux[k], jaux[k], rtol=1e-4, atol=1e-6)

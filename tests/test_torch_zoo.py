"""The model zoo of the port against the JAX package, on the CPU.

``models.get_model``'s names, ``mlp_model`` at any depth and
``conv_model`` (``models/conv.py``): the parameters come from the JAX
package's ``init`` (through ``convert.params_from_jax``, with the zero
biases replaced by draws so that they count), the inputs from a numpy
seed, and ``apply`` must agree to 1e-5 absolute and relative (the same
float32 arithmetic in another summation order). The conv sides are 8
(``digits``), 28 (MNIST) and 7: an even side pads (0, 1) under XLA's
"SAME" rule at stride 2, an odd one (1, 1). ``jax.random`` cannot be
reproduced in torch, so the port's own ``init`` is held to the JAX one
by shapes, keys and bounds, and statistically.

Also the pieces of the client round and of FedAMW that see the zoo: the
route rule (``route.kernel_route``), the autograd epoch against the
hand-derived plain epoch of the linear model (prox, ridge, empty
batches, the zero subgradient at the anchor), the step and whole-epoch
gathers, ``vmap`` over a conv against a loop over the clients, the
validation logits in row blocks (``aggregate.client_logits``, sized by
each model's ``row_activations``) against the JAX package's, and the
evaluator on a conv over a 10,000-row test set.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedamw_tpu.fedcore.aggregate import client_logits as jclient_logits
from fedamw_tpu.fedcore.evaluate import make_evaluator as jmake_evaluator
from fedamw_tpu.models import conv_model as jconv_model
from fedamw_tpu.models import get_model as jget_model
from fedamw_tpu.models import mlp_model as jmlp_model
from fedamw_tpu_torch import models
from fedamw_tpu_torch.convert import params_from_jax
from fedamw_tpu_torch.fedcore import client as tclient
from fedamw_tpu_torch.fedcore import route as troute
from fedamw_tpu_torch.fedcore import (
    client_epoch_plain,
    client_logits,
    make_evaluator,
)
from fedamw_tpu_torch.models import conv_model, get_model, mlp_model
from fedamw_tpu_torch.models.conv import same_padding
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
# (name, feature dimension, classes): the MLPs on digits' and covtype's
# widths, each conv at the sides 8, 28 and 7
APPLY_CASES = [("mlp16", 64, 10), ("mlp32x16", 54, 7), ("mlp64", 54, 7)] + [
    (name, side * side, 10) for name in ("conv4", "conv4x8", "conv8x16")
    for side in (8, 28, 7)]
ZOO_NAMES = ("linear", "mlp", "mlp128", "mlp128x64", "conv", "conv4",
             "conv4x8")


def _jax_params(name, d, C, seed=0):
    """The JAX package's init, with every zero bias replaced by a draw."""
    p = jget_model(name).init(jax.random.PRNGKey(seed), d, C)
    r = np.random.RandomState(seed + 1)
    return {k: (r.uniform(-0.5, 0.5, np.shape(v)).astype(np.float32)
                if k.startswith(("b", "cb")) else np.asarray(v))
            for k, v in p.items()}


def _x(n, d, seed=0):
    return np.random.RandomState(seed).rand(n, d).astype(np.float32)


@pytest.mark.parametrize("name,d,C", APPLY_CASES)
def test_apply_matches_jax(name, d, C):
    pj = _jax_params(name, d, C)
    x = _x(9, d)
    want = np.asarray(jget_model(name).apply(
        {k: jnp.asarray(v) for k, v in pj.items()}, jnp.asarray(x)))
    got = get_model(name).apply(params_from_jax(pj), torch.from_numpy(x))
    assert tuple(got.shape) == (9, C)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("side", [2, 3, 4, 7, 8, 14, 15, 28])
@pytest.mark.parametrize("kernel", [1, 3, 5])
def test_same_padding_is_xlas(side, kernel):
    want = jax.lax.padtype_to_pads((side,), (kernel,), (2,), "SAME")[0]
    assert same_padding(side, kernel) == tuple(want)


def test_even_sides_pad_after_only():
    """The two cases a symmetric ``padding=1`` would get wrong or right."""
    assert same_padding(28, 3) == same_padding(14, 3) == (0, 1)
    assert same_padding(8, 3) == (0, 1)
    assert same_padding(7, 3) == (1, 1)


@pytest.mark.parametrize("name", ZOO_NAMES)
def test_get_model_names_match_jax(name):
    d, C = 64, 10
    jm, tm = jget_model(name), get_model(name)
    assert tm.name == jm.name
    pj = jm.init(jax.random.PRNGKey(0), d, C)
    pt = tm.init(torch.Generator().manual_seed(0), d, C)
    assert list(pt) == list(pj)
    assert {k: tuple(v.shape) for k, v in pt.items()} == {
        k: tuple(np.shape(v)) for k, v in pj.items()}
    assert all(v.dtype == torch.float32 for v in pt.values())


def test_get_model_keyword_defaults_match_jax():
    assert get_model("mlp", hidden=(8, 4)).name == jget_model(
        "mlp", hidden=(8, 4)).name == "mlp8x4"
    assert get_model("conv", channels=(2,), kernel=5).name == jget_model(
        "conv", channels=(2,), kernel=5).name == "conv2"
    assert get_model("mlp").name == "mlp64"
    assert get_model("conv").name == "conv8x16"


@pytest.mark.parametrize("name", ["resnet", "gpt", ""])
def test_unknown_model_is_the_same_error(name):
    with pytest.raises(ValueError) as jerr:
        jget_model(name)
    with pytest.raises(ValueError) as terr:
        get_model(name)
    assert str(terr.value) == str(jerr.value) == f"unknown model: {name}"


@pytest.mark.parametrize("build,arg", [
    ("mlp", ()), ("mlp", (4, 0)), ("conv", ()), ("conv", (0,)),
    ("conv", -3)])
def test_bad_widths_are_the_same_error(build, arg):
    jfn, tfn = {"mlp": (jmlp_model, mlp_model),
                "conv": (jconv_model, conv_model)}[build]
    with pytest.raises(ValueError) as jerr:
        jfn(arg)
    with pytest.raises(ValueError) as terr:
        tfn(arg)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("d", [50, 63, 2000])
def test_conv_refuses_a_non_square_input(d):
    with pytest.raises(ValueError) as jerr:
        jconv_model().init(jax.random.PRNGKey(0), d, 10)
    with pytest.raises(ValueError) as terr:
        conv_model().init(torch.Generator().manual_seed(0), d, 10)
    assert str(terr.value) == str(jerr.value)
    assert "not a perfect square" in str(terr.value)


@pytest.mark.parametrize("channels,side", [((4,), 28), ((4, 8), 28),
                                          ((8, 16), 7), ((8, 16, 4), 9),
                                          ((2, 2, 2, 2), 8)])
def test_conv_head_fan_in_is_ceil_halved_per_layer(channels, side):
    h = side
    for _ in channels:
        h = math.ceil(h / 2)
    pt = conv_model(channels).init(torch.Generator().manual_seed(0),
                                   side * side, 3)
    pj = jconv_model(channels).init(jax.random.PRNGKey(0), side * side, 3)
    assert tuple(pt["w"].shape) == np.shape(pj["w"]) == (
        3, h * h * channels[-1])
    x = _x(2, side * side)
    assert tuple(conv_model(channels).apply(pt, torch.from_numpy(x)).shape) \
        == (2, 3)


def _bounds(name, d, C):
    """The uniform init's bound of every weight leaf, by the JAX rules:
    xavier over (fan_out, fan_in), over the receptive field for HWIO."""
    out = {}
    for k, v in get_model(name).init(torch.Generator().manual_seed(0), d,
                                     C).items():
        if v.dim() == 2:
            out[k] = math.sqrt(6.0 / sum(v.shape))
        elif v.dim() == 4:
            kh, kw, ci, co = v.shape
            out[k] = math.sqrt(6.0 / (kh * kw * (ci + co)))
    return out


@pytest.mark.parametrize("name,d,C", [("mlp64", 54, 7), ("mlp128x64", 784,
                                                         10),
                                      ("conv8x16", 784, 10)])
def test_init_is_the_jax_distribution(name, d, C):
    """Each weight leaf is U(-b, b) with the JAX package's bound b: inside
    it, reaching near it, mean ~0 and variance ~b^2/3 (within 6 standard
    errors over the leaf's entries); biases are zeros; two seeds draw
    differently, one seed repeats."""
    tm = get_model(name)
    pt = tm.init(torch.Generator().manual_seed(5), d, C)
    pj = jget_model(name).init(jax.random.PRNGKey(5), d, C)
    bounds = _bounds(name, d, C)
    for k, v in pt.items():
        if k not in bounds:
            assert torch.count_nonzero(v) == 0, k
            assert not np.any(np.asarray(pj[k])), k
            continue
        b, n = bounds[k], v.numel()
        jv = np.asarray(pj[k])
        assert float(v.abs().max()) <= b and float(np.abs(jv).max()) <= b
        assert float(v.abs().max()) > b * (1 - 20.0 / n)
        var = b * b / 3.0
        assert abs(float(v.mean())) < 6 * math.sqrt(var / n), k
        # the variance of U^2 is 4 b^4 / 45
        assert abs(float(v.var()) - var) < 6 * math.sqrt(4 * b ** 4 / 45 / n)
    again = tm.init(torch.Generator().manual_seed(5), d, C)
    other = tm.init(torch.Generator().manual_seed(6), d, C)
    assert all(torch.equal(pt[k], again[k]) for k in pt)
    assert not all(torch.equal(pt[k], other[k]) for k in bounds)


@pytest.mark.parametrize("name,d", [("conv4x8", 64), ("conv8x16", 784),
                                    ("mlp32x16", 54)])
def test_a_bfloat16_x_is_widened(name, d):
    """A bfloat16 feature matrix (``feature_dtype``) gives the float32
    forward of the widened rows, as the JAX package's ``astype`` (conv)
    and type promotion (matmul) do."""
    pj = _jax_params(name, d, 10)
    xb = torch.from_numpy(_x(6, d)).to(torch.bfloat16)
    wide = xb.to(torch.float32).numpy()
    want = np.asarray(jget_model(name).apply(
        {k: jnp.asarray(v) for k, v in pj.items()},
        jnp.asarray(wide).astype(jnp.bfloat16)))
    got = get_model(name).apply(params_from_jax(pj), xb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_models_all_names_the_jax_exports():
    import fedamw_tpu.models as jmodels

    assert sorted(models.__all__) == sorted(jmodels.__all__)


# -- the client round's route and its autograd epoch ------------------------


def test_kernel_route_is_the_linear_structure():
    w = torch.zeros(3, 4)
    assert troute.kernel_route({"w": w})
    assert troute.kernel_route({"k": w})
    assert not troute.kernel_route({"w": torch.zeros(2, 3, 4)})
    assert not troute.kernel_route({"w": w, "b": torch.zeros(3)})
    assert not troute.kernel_route({"w1": w, "w2": w})
    assert not troute.kernel_route(w)
    for name in ("mlp16", "conv4"):
        assert not troute.kernel_route(get_model(name).init(
            torch.Generator().manual_seed(0), 64, 10))
    assert troute.kernel_route(get_model("linear").init(
        torch.Generator().manual_seed(0), 64, 10))


def _epoch_inputs(task, J=3, S=4, B=5, D=6, C=4, seed=0, n=40):
    """Random epoch inputs in ``client_epoch``'s layout, with one client
    whose second step has no valid row and one with no valid row at all."""
    r = np.random.RandomState(seed)
    X = torch.from_numpy(r.randn(n, D).astype(np.float32))
    y = (torch.from_numpy(r.randint(0, C, n).astype(np.int32))
         if task == "classification"
         else torch.from_numpy(r.randn(n).astype(np.float32)))
    rows = torch.from_numpy(r.randint(0, n, (J, S, B)).astype(np.int32))
    valid = torch.from_numpy((r.rand(J, S, B) < 0.7).astype(np.float32))
    valid[0, 1] = 0.0
    valid[2] = 0.0
    anchor = torch.from_numpy(r.randn(C if task == "classification" else 1,
                                      D).astype(np.float32)) * 0.3
    return X, y, rows, valid, anchor


@pytest.mark.parametrize("task", ["classification", "regression"])
@pytest.mark.parametrize("mu,lam", [(0.0, 0.0), (0.05, 0.01)])
def test_autograd_epoch_is_the_hand_derived_epoch(task, mu, lam):
    """On the linear model the autograd route's epoch equals the plain
    version of kernel 1 (the hand-derived gradient): the prox anchor, the
    ridge term, the zero subgradient at the anchor on the first step, no
    update on an empty batch, and the epoch's metrics."""
    X, y, rows, valid, anchor = _epoch_inputs(task)
    J = rows.shape[0]
    W = anchor.expand((J,) + tuple(anchor.shape)).contiguous()
    lr = 0.3
    wp, mp = client_epoch_plain(W, anchor, X, y, rows, valid, lr, mu, lam,
                                task)
    epoch = tclient.make_autograd_epoch(get_model("linear").apply, task)
    P, ma = epoch({"w": W}, {"w": anchor}, X, y, rows, valid, lr, mu, lam)
    np.testing.assert_allclose(P["w"].numpy(), wp.numpy(), **TOL)
    np.testing.assert_allclose(ma.numpy(), mp.numpy(), **TOL)
    # the client with no valid row kept its weights exactly
    assert torch.equal(P["w"][2], W[2])
    assert float(ma[2].abs().sum()) == 0.0


def test_autograd_epoch_gathers_by_step_or_by_epoch_alike(monkeypatch):
    X, y, rows, valid, _ = _epoch_inputs("classification", D=16)
    m = get_model("conv4")
    p = m.init(torch.Generator().manual_seed(1), 16, 4)
    P = {k: v.expand((3,) + tuple(v.shape)).contiguous()
         for k, v in p.items()}
    epoch = tclient.make_autograd_epoch(m.apply, "classification")
    whole = epoch(P, p, X, y, rows, valid, 0.2, 0.01, 0.01)
    monkeypatch.setattr(troute, "EPOCH_GATHER_BYTES_LIMIT", 0)
    step = epoch(P, p, X, y, rows, valid, 0.2, 0.01, 0.01)
    for k in P:
        torch.testing.assert_close(step[0][k], whole[0][k], rtol=0, atol=0)
    torch.testing.assert_close(step[1], whole[1], rtol=0, atol=0)


def test_vmap_over_a_conv_is_the_loop_over_clients():
    """``vmap`` turns the clients' convolutions into one grouped
    convolution; each client's forward and gradient are its own."""
    m = get_model("conv4x8")
    g = torch.Generator().manual_seed(3)
    stacked = {k: torch.stack([m.init(g, 64, 10)[k] for _ in range(4)])
               for k in m.init(g, 64, 10)}
    x = torch.from_numpy(_x(4 * 5, 64)).reshape(4, 5, 64)
    y = torch.from_numpy(np.random.RandomState(0).randint(0, 10, (4, 5)))

    def loss(p, xb, yb):
        return torch.nn.functional.cross_entropy(m.apply(p, xb), yb.long())

    grads = torch.func.vmap(torch.func.grad(loss))(stacked, x, y)
    for j in range(4):
        pj = {k: v[j] for k, v in stacked.items()}
        gj = torch.func.grad(loss)(pj, x[j], y[j])
        for k in pj:
            np.testing.assert_allclose(grads[k][j].numpy(), gj[k].numpy(),
                                       **TOL, err_msg=k)


# -- FedAMW's validation logits and the evaluator ---------------------------


@functools.lru_cache(maxsize=None)
def _jax_logits(name, d, Jn=5, n=23, C=7):
    """Stacked parameters of ``Jn`` clients, ``n`` rows and the JAX
    package's ``(n, Jn, C)`` logits of them."""
    per = [_jax_params(name, d, C, seed=s) for s in range(Jn)]
    stacked = {k: np.stack([p[k] for p in per]) for k in per[0]}
    x = _x(n, d, seed=4)
    want = np.asarray(jclient_logits(
        jget_model(name).apply, {k: jnp.asarray(v) for k, v in
                                 stacked.items()}, jnp.asarray(x)))
    return stacked, x, want


@pytest.mark.parametrize("name,d", [("mlp32x16", 54), ("conv4x8", 64),
                                    ("conv8x16", 49)])
@pytest.mark.parametrize("limit", [None, 4096, 1])
def test_client_logits_match_jax_in_any_blocks(name, d, limit, monkeypatch):
    """The ``(n, J, C)`` logits of every client, mapped over row blocks
    under the byte bound, equal the JAX package's one ``vmap`` (a bound
    of 1 byte is one row a block)."""
    if limit is not None:
        monkeypatch.setattr(troute, "EPOCH_GATHER_BYTES_LIMIT", limit)
    stacked, x, want = _jax_logits(name, d)
    m = get_model(name)
    got = client_logits(m.apply, params_from_jax(stacked),
                        torch.from_numpy(x), m.row_activations(d, 7))
    assert got.shape == want.shape == (23, 5, 7)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_client_logits_of_the_linear_model_are_one_product(monkeypatch):
    monkeypatch.setattr(troute, "EPOCH_GATHER_BYTES_LIMIT", 1)
    w = torch.from_numpy(np.random.RandomState(0).randn(4, 3, 6).astype(
        np.float32))
    x = torch.from_numpy(_x(10, 6))
    got = client_logits(get_model("linear").apply, {"w": w}, x)
    torch.testing.assert_close(got, torch.einsum("nd,jcd->njc", x, w))


# (name, d, C, floats a row keeps: each layer's output, then the logits)
ROW_ACTIVATIONS = [("linear", 784, 10, 10), ("mlp64", 54, 7, 64 + 7),
                   ("mlp64x32", 784, 10, 64 + 32 + 10),
                   ("conv8x16", 784, 10, 14 * 14 * 8 + 7 * 7 * 16 + 10),
                   ("conv4x8", 64, 10, 4 * 4 * 4 + 2 * 2 * 8 + 10),
                   ("conv8x16", 49, 7, 4 * 4 * 8 + 2 * 2 * 16 + 7)]


@pytest.mark.parametrize("name,d,C,want", ROW_ACTIVATIONS)
def test_row_activations_count_each_layer_and_the_logits(name, d, C, want):
    assert get_model(name).row_activations(d, C) == want


def test_client_logits_of_a_zoo_model_need_row_floats():
    stacked, x, _ = _jax_logits("mlp32x16", 54)
    with pytest.raises(ValueError, match="row_floats"):
        client_logits(get_model("mlp32x16").apply, params_from_jax(stacked),
                      torch.from_numpy(x))


def test_evaluator_on_a_conv_over_ten_thousand_rows():
    """The evaluator's one forward of a conv8x16 over a 10,000-row MNIST-
    shaped test set, against the JAX package's."""
    pj = _jax_params("conv8x16", 784, 10)
    x = _x(10000, 784, seed=2)
    y = np.random.RandomState(2).randint(0, 10, 10000).astype(np.int32)
    jl, ja = jmake_evaluator(jget_model("conv8x16").apply, "classification")(
        {k: jnp.asarray(v) for k, v in pj.items()}, jnp.asarray(x),
        jnp.asarray(y))
    tl, ta = make_evaluator(get_model("conv8x16").apply, "classification")(
        params_from_jax(pj), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)

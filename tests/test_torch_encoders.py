"""The port's encoders against the JAX package, on the CPU.

Same seeded numpy inputs through both.  Features agree within rtol 1e-5 /
atol 1e-6 (ndtri and mean differ in the last bits across the two
frameworks); symbols are equal except where the reference's feature lies
within 1e-6 of a breakpoint; distances over the same symbols agree within
rtol 1e-5; and the port's own distances lower-bound the Euclidean
distance."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import make_technique as ref_make_technique  # noqa: E402
from repro.core import znormalize as ref_znormalize  # noqa: E402
from repro.core.breakpoints import (  # noqa: E402
    gaussian_breakpoints as ref_gauss, uniform_breakpoints as ref_uniform)
from repro.data import synthetic as ref_synthetic  # noqa: E402

from repro_torch.core import (  # noqa: E402
    from_reference, make_technique, rep_from_numpy, znormalize)
from repro_torch.core.breakpoints import (  # noqa: E402
    discretize, gaussian_breakpoints, uniform_breakpoints)
from repro_torch.core.paa import paa  # noqa: E402
from repro_torch.core.ssax import season_strength  # noqa: E402
from repro_torch.core.tsax import trend_strength  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

T, W, L, N = 480, 24, 10, 256
TECHS = ("sax", "ssax", "tsax", "stsax")
BREAKPOINTS = {"sax": ("breakpoints",), "ssax": ("b_seas", "b_res"),
               "tsax": ("b_tr", "b_res"),
               "stsax": ("b_tr", "b_seas", "b_res")}


@pytest.fixture(scope="module")
def corpora():
    return {"season": synthetic.season_dataset(N, T, L, 0.7, seed=3),
            "trend": synthetic.trend_dataset(N, T, 0.6, seed=5)}


def _pair(tech):
    enc = ref_make_technique(tech, T=T, W=W, L=L, r2_season=0.7)
    return enc, from_reference(type(enc).__name__, dataclasses.asdict(enc))


def _features(enc, x, port: bool):
    """Each encoder's real-valued features, as a tuple."""
    if type(enc).__name__ == "SAX":
        if port:
            return (paa(x, enc.W),)
        from repro.core.paa import paa as ref_paa
        return (ref_paa(x, enc.W),)
    f = enc.features(x)
    return f if isinstance(f, tuple) else (f,)


def _leaves(r):
    return r if isinstance(r, tuple) else (r,)


def test_synthetic_data_identical_to_reference(corpora):
    np.testing.assert_array_equal(
        corpora["season"], ref_synthetic.season_dataset(N, T, L, 0.7, seed=3))
    np.testing.assert_array_equal(
        corpora["trend"], ref_synthetic.trend_dataset(N, T, 0.6, seed=5))
    big = synthetic.season_corpus(N, T, L, 0.7, seed=3, chunk=100)
    np.testing.assert_array_equal(
        big[:100], ref_synthetic.season_dataset(100, T, L, 0.7, seed=3))
    np.testing.assert_array_equal(
        big[100:200], ref_synthetic.season_dataset(100, T, L, 0.7, seed=4))


@pytest.mark.parametrize("A,sd", [(4, 1.0), (64, 1.0), (32, 0.5477),
                                  (1024, 1.0)])
def test_gaussian_breakpoints_match_reference(A, sd):
    got = gaussian_breakpoints(A, sd)
    assert got.dtype == torch.float32 and got.shape == (A - 1,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_gauss(A, sd)),
                               rtol=1e-5, atol=1e-6)


def test_uniform_breakpoints_and_discretize_right_side():
    got = uniform_breakpoints(16, -0.0036, 0.0036)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref_uniform(16, -0.0036, 0.0036)),
                               rtol=1e-5, atol=1e-9)
    bp = torch.tensor([-1.0, 0.0, 1.0])
    vals = torch.tensor([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0])
    # a value ON a breakpoint belongs to the upper symbol (side="right")
    assert discretize(vals, bp).tolist() == [0, 1, 1, 2, 2, 3, 3]
    assert discretize(vals, bp).dtype == torch.int32


def test_znormalize_and_strengths_match_reference(corpora):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(8, T)) * 3 + 1).astype(np.float32)
    np.testing.assert_allclose(znormalize(torch.from_numpy(x)).numpy(),
                               np.asarray(ref_znormalize(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    from repro.core import season_strength as ref_ss
    from repro.core import trend_strength as ref_ts
    xs = corpora["season"]
    np.testing.assert_allclose(
        season_strength(torch.from_numpy(xs), L).numpy(),
        np.asarray(ref_ss(jnp.asarray(xs), L)), rtol=1e-4, atol=1e-5)
    xt = corpora["trend"]
    np.testing.assert_allclose(trend_strength(torch.from_numpy(xt)).numpy(),
                               np.asarray(ref_ts(jnp.asarray(xt))),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tech", TECHS)
def test_make_technique_matches_reference(tech):
    ref_enc, port_enc = _pair(tech)
    assert port_enc == make_technique(tech, T=T, W=W, L=L, r2_season=0.7)
    for name in BREAKPOINTS[tech]:
        np.testing.assert_allclose(getattr(port_enc, name).numpy(),
                                   np.asarray(getattr(ref_enc, name)),
                                   rtol=1e-5, atol=1e-6)
    assert port_enc.bits == pytest.approx(float(ref_enc.bits))


@pytest.mark.parametrize("data", ["season", "trend"])
@pytest.mark.parametrize("tech", TECHS)
def test_features_and_symbols_match_reference(corpora, tech, data):
    X = corpora[data]
    ref_enc, port_enc = _pair(tech)
    xt = torch.from_numpy(X)
    ref_f = [np.asarray(f) for f in _features(ref_enc, jnp.asarray(X), False)]
    port_f = [f.numpy() for f in _features(port_enc, xt, True)]
    for a, b in zip(port_f, ref_f):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    ref_syms = [np.asarray(s) for s in _leaves(ref_enc.encode(jnp.asarray(X)))]
    port_syms = [s.numpy() for s in _leaves(port_enc.encode(xt))]
    # the features each symbol leaf discretizes, and its breakpoints
    bps = [np.asarray(getattr(ref_enc, n)) for n in BREAKPOINTS[tech]]
    for got, want, feat, bp in zip(port_syms, ref_syms, ref_f, bps):
        assert got.dtype == np.int32 and got.shape == want.shape
        near = np.min(np.abs(feat[..., None] - bp), axis=-1) < 1e-6
        assert (got == want)[~near].all()
        assert (got != want).mean() < 1e-3


@pytest.mark.parametrize("data", ["season", "trend"])
@pytest.mark.parametrize("tech", TECHS)
def test_pairwise_distance_matches_reference(corpora, tech, data):
    """Over the reference's own symbols, so only the distance differs."""
    X = corpora[data]
    ref_enc, port_enc = _pair(tech)
    ref_rep = ref_enc.encode(jnp.asarray(X))
    q_ref = jax.tree_util.tree_map(lambda a: a[:6], ref_rep)
    want = np.asarray(ref_enc.pairwise_distance(q_ref, ref_rep))
    rep = rep_from_numpy(jax.tree_util.tree_map(np.asarray, ref_rep), "cpu")
    q = rep_from_numpy(jax.tree_util.tree_map(np.asarray, q_ref), "cpu")
    got = port_enc.pairwise_distance(q, rep).numpy()
    assert got.shape == (6, N) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("data", ["season", "trend"])
@pytest.mark.parametrize("tech", TECHS)
def test_port_distances_lower_bound_euclidean(corpora, tech, data):
    X = corpora[data]
    enc = make_technique(tech, T=T, W=W, L=L, r2_season=0.7)
    xt = torch.from_numpy(X)
    rep = enc.encode(xt)
    q = tuple(r[:8] for r in rep) if isinstance(rep, tuple) else rep[:8]
    lb = enc.pairwise_distance(q, rep).numpy()
    ed = torch.cdist(xt[:8].double(), xt.double()).numpy()
    assert (lb <= ed * (1 + 1e-5) + 1e-5).all()
    assert (lb > 0).mean() > 0.5          # a bound, not a trivial zero

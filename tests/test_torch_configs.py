"""The port's configs, dataset surrogates and SAX extensions against the
JAX package, on the CPU.

Configs are plain dataclasses and must be equal field by field, with
equal parameter counts, reduced variants, shape cells and paper tables.
The surrogates are numpy and must be bitwise equal.  The extensions'
symbols must be equal and their raw features equal within 1e-6 (a
segment's std sums in another order); their distances agree within
rtol = atol = 1e-5 (the breakpoints' ndtri differs in the last bits) and
lower-bound the Euclidean distance (ESAX, SAX_SD, TD-SAX
at trend weight 0)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.configs import paper as ref_paper  # noqa: E402
from repro.core import extensions as ref_ext  # noqa: E402
from repro.data import datasets as ref_datasets  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import paper  # noqa: E402
from repro_torch.core import extensions as ext  # noqa: E402
from repro_torch.data import economy_like, metering_like  # noqa: E402

EXT_T, EXT_W, EXT_A = 240, 24, 16


def test_registry_is_the_reference_registry():
    assert configs.ARCHITECTURES == ref_configs.ARCHITECTURES
    assert set(configs.SHAPES) == set(ref_configs.SHAPES)
    for name, spec in configs.SHAPES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            ref_configs.SHAPES[name])
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ref_configs.ARCHITECTURES)
def test_config_equals_reference_field_by_field(arch):
    cfg, ref = configs.get_config(arch), ref_configs.get_config(arch)
    assert [f.name for f in dataclasses.fields(cfg)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_counts() == ref.param_counts()
    for prop in ("pattern_repeats", "q_dim", "kv_dim", "padded_vocab",
                 "d_ff_e", "dt_rank", "d_inner", "n_rwkv_heads",
                 "is_enc_dec", "is_sub_quadratic"):
        assert getattr(cfg, prop) == getattr(ref, prop), prop
    small, ref_small = configs.reduced(cfg), ref_configs.reduced(ref)
    assert dataclasses.asdict(small) == dataclasses.asdict(ref_small)
    assert small.param_counts() == ref_small.param_counts()
    over = dict(d_model=96, n_heads=4, head_dim=24)
    assert dataclasses.asdict(configs.reduced(cfg, **over)) == \
        dataclasses.asdict(ref_configs.reduced(ref, **over))
    for shape in configs.SHAPES:
        got, want = configs.shape_for(cfg, shape), \
            ref_configs.shape_for(ref, shape)
        assert (got is None) == (want is None)
        if got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_paper_tables_equal():
    names = [n for n in vars(ref_paper) if n.isupper()]
    assert names and names == [n for n in vars(paper) if n.isupper()]
    for n in names:
        assert getattr(paper, n) == getattr(ref_paper, n), n


@pytest.mark.parametrize("make,ref_make,kw", [
    (metering_like, ref_datasets.metering_like, dict(n=48, days=6, seed=3)),
    (economy_like, ref_datasets.economy_like, dict(n=48, T=300, seed=4)),
])
def test_surrogates_bitwise(make, ref_make, kw):
    got, want = make(**kw), ref_make(**kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def ext_data():
    return economy_like(n=64, T=EXT_T, seed=5).astype(np.float32)


@pytest.mark.parametrize("name", ["ESAX", "SAXSD", "TDSAX"])
def test_extension_encodings_and_distances(name, ext_data):
    enc = getattr(ext, name)(T=EXT_T, W=EXT_W, A=EXT_A)
    ref = getattr(ref_ext, name)(T=EXT_T, W=EXT_W, A=EXT_A)
    assert enc.bits == ref.bits
    got = enc.encode(torch.as_tensor(ext_data))
    want = ref.encode(jnp.asarray(ext_data))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype.kind == "i":
            assert np.array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)
    qa = tuple(t[:8, None] for t in got)
    qb = tuple(t[None, :] for t in got)
    ra = tuple(np.asarray(t)[:8, None] for t in want)
    rb = tuple(np.asarray(t)[None, :] for t in want)
    dists = [("distance", enc.distance(qa, qb),
              ref.distance(tuple(map(jnp.asarray, ra)),
                           tuple(map(jnp.asarray, rb))))]
    if name == "ESAX":
        dists.append(("distance_maxfeat", enc.distance_maxfeat(qa, qb),
                      ref.distance_maxfeat(tuple(map(jnp.asarray, ra)),
                                           tuple(map(jnp.asarray, rb)))))
    for what, d, d_ref in dists:
        assert d.shape == (8, ext_data.shape[0]), what
        np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-5,
                                   atol=1e-5, err_msg=what)


@pytest.mark.parametrize("name,kw", [("ESAX", {}), ("SAXSD", {}),
                                     ("TDSAX", {"trend_weight": 0.0})])
def test_extension_distance_lower_bounds_euclid(name, kw, ext_data):
    enc = getattr(ext, name)(T=EXT_T, W=EXT_W, A=EXT_A, **kw)
    x = torch.as_tensor(ext_data)
    rep = enc.encode(x)
    d = enc.distance(tuple(t[:8, None] for t in rep),
                     tuple(t[None, :] for t in rep))
    ed = torch.cdist(x[:8].double(), x.double())
    assert bool((d.double() <= ed + 1e-5).all())

"""The port's ``SymbolicStore`` on the CPU (T=480, W=24, L=10, N=200).

Within the port: chunked ``append`` equals a one-shot store bitwise for
several chunkings, ``rep_view(epoch=)`` is a prefix equal to a store
frozen at that epoch, and ``store_raw=False`` keeps no raw rows.
Against the JAX package's store: symbols are equal except where the
reference's feature lies within 1e-6 of a breakpoint."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import from_reference, make_technique  # noqa: E402
from repro_torch.core.matching import MEDIA  # noqa: E402
from repro_torch.data.synthetic import season_dataset  # noqa: E402
from repro_torch.store import (  # noqa: E402
    CorpusEpoch, SymbolicStore, epoch_rows, rep_leaves)

T, W, L, N = 480, 24, 10, 200
TECHS = ("sax", "ssax", "tsax", "stsax")
BREAKPOINTS = {"sax": ("breakpoints",), "ssax": ("b_seas", "b_res"),
               "tsax": ("b_tr", "b_res"),
               "stsax": ("b_tr", "b_seas", "b_res")}


@pytest.fixture(scope="module")
def X():
    return season_dataset(N, T, L, 0.7, seed=21)


def _enc(tech):
    return make_technique(tech, T=T, W=W, L=L, r2_season=0.7)


def _chunked(enc, X, chunks, **kwargs):
    store = SymbolicStore(enc, device="cpu", **kwargs)
    lo = 0
    for c in chunks:
        ids = store.append(X[lo:lo + c])
        np.testing.assert_array_equal(ids, np.arange(lo, lo + c))
        lo += c
    return store


@pytest.mark.parametrize("chunks", [(1, 99, 100), (64, 64, 72), (7, 193)])
@pytest.mark.parametrize("tech", TECHS)
def test_chunked_append_equals_oneshot(X, tech, chunks):
    enc = _enc(tech)
    one = SymbolicStore.from_rows(enc, X, device="cpu")
    inc = _chunked(enc, X, chunks)
    assert inc.n == len(inc) == one.n == N
    assert inc.version == len(chunks) and one.version == 1
    for a, b in zip(rep_leaves(inc.rep_view()), rep_leaves(one.rep_view())):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(inc.data, X)
    # a precomputed representation is taken as is
    pre = SymbolicStore(enc, device="cpu")
    pre.append(X[:10], rep=one.rep_view(epoch=10))
    for a, b in zip(rep_leaves(pre.rep_view()),
                    rep_leaves(one.rep_view(epoch=10))):
        np.testing.assert_array_equal(a, b)


def test_rep_view_epoch_is_a_frozen_prefix(X):
    enc = _enc("ssax")
    store = SymbolicStore(enc, device="cpu")
    store.append(X[:50])
    ep = store.current_epoch()
    assert ep == CorpusEpoch(epoch=1, n_rows=50) and epoch_rows(ep) == 50
    store.append(X[50:130])
    store.append(X[130:])
    assert [e.n_rows for e in store.epoch_ledger] == [0, 50, 130, N]
    frozen = SymbolicStore.from_rows(enc, X[:50], device="cpu")
    for pinned in (ep, 50):
        for a, b in zip(store.rep_view(epoch=pinned), frozen.rep_view()):
            np.testing.assert_array_equal(a, b)
    assert store.rep_view(epoch=10 ** 6)[0].shape[0] == N
    assert epoch_rows(None) is None


def test_representation_only_store(X):
    enc = _enc("sax")
    store = SymbolicStore(enc, store_raw=False, device="cpu")
    store.append(X[:3])
    assert store.n == 3 and store.data.shape == (0, T)
    with pytest.raises(TypeError):
        store.fetch([0])
    # the index and snapshots derive from raw rows, which it discarded
    for call in (store.build_index, lambda: store.save("never-written")):
        with pytest.raises(TypeError, match="store_raw"):
            call()
    with pytest.raises(FileNotFoundError):
        SymbolicStore.open("never-written", device="cpu")


def test_raw_store_protocol_is_delegated(X):
    enc = _enc("sax")
    store = SymbolicStore.from_rows(enc, X[:20], media="hdd", device="cpu")
    assert store.media == "hdd"
    out = store.fetch([3, 3, 1])
    np.testing.assert_array_equal(out, X[[3, 3, 1]])
    assert store.accesses == 2 and store.fetches == 1
    assert store.modeled_io_seconds() == pytest.approx(
        MEDIA["hdd"][0] + 2 * T * 4 / MEDIA["hdd"][1])
    store.reset_counters()
    assert store.accesses == store.fetches == 0
    with pytest.raises(ValueError):
        SymbolicStore(enc, media="tape", device="cpu")
    with pytest.raises(ValueError):
        store.append(np.zeros((2, T + 1), np.float32))
    assert store.append(np.zeros((0, T), np.float32)).size == 0


@pytest.mark.parametrize("tech", TECHS)
def test_symbols_match_reference_store(X, tech):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import make_technique as ref_make_technique
    from repro.core.paa import paa as ref_paa
    from repro.store import SymbolicStore as RefStore
    ref_enc = ref_make_technique(tech, T=T, W=W, L=L, r2_season=0.7)
    enc = from_reference(type(ref_enc).__name__, dataclasses.asdict(ref_enc))
    want = rep_leaves(RefStore.from_rows(ref_enc, X).rep_view())
    got = rep_leaves(_chunked(enc, X, (1, 99, 100)).rep_view())
    feats = ((ref_paa(jnp.asarray(X), W),) if tech == "sax"
             else ref_enc.features(jnp.asarray(X)))
    bps = [np.asarray(getattr(ref_enc, n)) for n in BREAKPOINTS[tech]]
    for g, w, f, bp in zip(got, want, feats, bps):
        assert g.shape == w.shape
        near = np.min(np.abs(np.asarray(f)[..., None] - bp), axis=-1) < 1e-6
        assert (g == w)[~near].all()

"""The port's subsequence path (``repro_torch.subseq``) on the CPU, M=120
windows over 10 x 610 rows, as ``tests/test_subseq.py`` holds the JAX
package's.

Within the port, bitwise: the exact window top-k equals a brute force
over every window z-normalized by ``znorm_windows`` (which is
batch-invariant), incremental window encoding equals one-shot, and the
K2/K3 sweep gives the same answer as the plain one.  Against the JAX
package's ``SubseqEngine``: window ids are equal and distances agree
within rtol 1e-5 (the frameworks' z-normalizations differ in the last
bits), with and without non-overlap suppression.  The card test
(skipped without one) holds the engine on the card to a K1 brute force
bitwise."""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import SAX, SSAX, STSAX, TSAX  # noqa: E402
from repro_torch.core.normalize import znormalize  # noqa: E402
from repro_torch.data.synthetic import season_dataset  # noqa: E402
from repro_torch.kernels import KERNELS, ops  # noqa: E402
from repro_torch.launch.match import (  # noqa: E402
    greedy_nonoverlap, window_distances)
from repro_torch.store import SymbolicStore  # noqa: E402
from repro_torch.subseq import (  # noqa: E402
    SubseqEngine, WindowView, znorm_windows)

M = 120        # window length (the encoders' T)
TECHS = ("sax", "ssax", "tsax", "stsax")
FIELDS = {
    "sax": dict(T=M, W=12, A=16),
    "ssax": dict(T=M, W=12, L=10, A_seas=8, A_res=16, r2_season=0.5),
    "tsax": dict(T=M, W=12, A_tr=16, A_res=16, r2_trend=0.3),
    "stsax": dict(T=M, W=12, L=10, A_tr=8, A_seas=8, A_res=16,
                  r2_trend=0.2, r2_season=0.4),
}
CLASSES = {"sax": SAX, "ssax": SSAX, "tsax": TSAX, "stsax": STSAX}


def _enc(tech):
    return CLASSES[tech](**FIELDS[tech])


@pytest.fixture(scope="module")
def corpus():
    # T deliberately ragged: not a multiple of the strides below
    X = season_dataset(n=10, T=610, L=10, strength=0.7, seed=5)
    rng = np.random.default_rng(0)
    Q = np.stack([X[0, 37:37 + M],
                  X[3, 250:250 + M] + 0.1 * rng.normal(size=M)
                  .astype(np.float32),
                  rng.normal(size=M).astype(np.float32)])
    return X, Q


@pytest.fixture(scope="module")
def reference(corpus):
    """The JAX package's engines and answers, computed once per case."""
    pytest.importorskip("jax")
    from repro import core as ref_core
    from repro.subseq import SubseqEngine as RefEngine
    from repro.subseq import WindowView as RefView
    X, Q = corpus
    cache = {}

    def get(tech, stride):
        if (tech, stride) not in cache:
            enc = getattr(ref_core, type(_enc(tech)).__name__)(**FIELDS[tech])
            eng = RefEngine(RefView(enc, X, stride=stride), verify="numpy")
            cache[tech, stride] = (eng.topk(Q, k=5),
                                   eng.topk(Q, k=5, exclusion=M // 2))
        return cache[tech, stride]
    return get


def _engine(X, tech, stride, **kwargs):
    view = WindowView(_enc(tech), X, stride=stride, device="cpu")
    return SubseqEngine(view, verify=kwargs.pop("verify", "numpy"),
                        **kwargs)


def _bruteforce_windows(X, stride):
    W = np.lib.stride_tricks.sliding_window_view(
        X, M, axis=1)[:, ::stride].reshape(-1, M)
    return znorm_windows(W)


def _bruteforce_topk(Wz, zq, k):
    idx, dist = [], []
    for q in zq:
        d = np.sqrt(np.sum(np.square(Wz - q[None]), -1))
        o = np.argsort(d, kind="stable")[:k]
        idx.append(o)
        dist.append(d[o].astype(np.float64))
    return np.asarray(idx, np.int64), np.asarray(dist)


@pytest.mark.parametrize("stride", [1, 7])
@pytest.mark.parametrize("tech", TECHS)
def test_topk_bitwise_equals_port_bruteforce(corpus, tech, stride):
    X, Q = corpus
    eng = _engine(X, tech, stride)
    res = eng.topk(Q, k=5)
    want_i, want_d = _bruteforce_topk(_bruteforce_windows(X, stride),
                                      eng.normalize_queries(Q), 5)
    np.testing.assert_array_equal(res.window_ids, want_i)
    np.testing.assert_array_equal(res.distances, want_d)
    nw = eng.view.windows_per_row
    np.testing.assert_array_equal(res.rows, want_i // nw)
    np.testing.assert_array_equal(res.starts, (want_i % nw) * stride)


@pytest.mark.parametrize("stride", [1, 7])
@pytest.mark.parametrize("tech", TECHS)
def test_topk_matches_reference(corpus, reference, tech, stride):
    X, Q = corpus
    want, _ = reference(tech, stride)
    res = _engine(X, tech, stride).topk(Q, k=5)
    np.testing.assert_array_equal(res.window_ids, want.window_ids)
    np.testing.assert_allclose(res.distances, want.distances, rtol=1e-5)
    np.testing.assert_array_equal(res.starts, want.starts)


@pytest.mark.parametrize("stride", [1, 7])
@pytest.mark.parametrize("tech", TECHS)
def test_exclusion_matches_reference(corpus, reference, tech, stride):
    X, Q = corpus
    _, want = reference(tech, stride)
    res = _engine(X, tech, stride).topk(Q, k=5, exclusion=M // 2)
    np.testing.assert_array_equal(res.window_ids, want.window_ids)
    np.testing.assert_allclose(res.distances, want.distances, rtol=1e-5)
    np.testing.assert_array_equal(res.raw_accesses, want.raw_accesses)


@pytest.mark.parametrize("stride", [1, 7])
@pytest.mark.parametrize("tech", TECHS)
def test_make_pairwise_matches_plain_sweep(corpus, tech, stride):
    X, Q = corpus
    plain = _engine(X, tech, stride)
    swept = SubseqEngine(plain.view, verify="numpy",
                         pairwise=ops.make_pairwise(plain.encoder))
    zq = plain.normalize_queries(Q)
    np.testing.assert_allclose(swept.repr_distances(zq),
                               plain.repr_distances(zq), rtol=1e-5,
                               atol=1e-5)
    for kw in ({}, {"exclusion": M // 2}):
        a, b = plain.topk(Q, k=5, **kw), swept.topk(Q, k=5, **kw)
        np.testing.assert_array_equal(a.window_ids, b.window_ids)
        np.testing.assert_array_equal(a.distances, b.distances)


def test_znorm_windows_is_batch_invariant():
    """A window's z-normalized bits do not depend on the batch it sits
    in, nor on whether it arrives as a strided view."""
    rng = np.random.default_rng(3)
    W = (rng.normal(size=(4096, 240)) * 3 + 7).astype(np.float32)
    full = znorm_windows(W)
    for b in (1, 7, 33, 256, 841, 4096):
        for lo in (0, 1000 % (4097 - b)):
            np.testing.assert_array_equal(znorm_windows(W[lo:lo + b]),
                                          full[lo:lo + b])
    row = (rng.normal(size=3600).cumsum()).astype(np.float32)
    view = np.lib.stride_tricks.sliding_window_view(row, 240)[::4]
    whole = znorm_windows(np.ascontiguousarray(view))
    for lo, hi in ((0, 57), (57, 114), (800, 841), (0, 841)):
        np.testing.assert_array_equal(znorm_windows(view[lo:hi]),
                                      whole[lo:hi])
    unfold = torch.from_numpy(row).unfold(0, 240, 4)       # strided view
    np.testing.assert_array_equal(znormalize(unfold).numpy(), whole)


def test_windowview_incremental_equals_oneshot(corpus):
    X, _ = corpus
    enc = _enc("ssax")
    one = WindowView(enc, X, stride=3, device="cpu")
    for chunks, ec in [((3, 4, 3), 4096), ((5, 5), 57), ((10,), 11)]:
        inc = WindowView(enc, stride=3, encode_chunk=ec, device="cpu")
        ofs = 0
        for c in chunks:
            ids = inc.append(X[ofs:ofs + c])
            assert ids[0] == ofs * inc.windows_per_row
            ofs += c
        assert inc.n == one.n
        for a, b in zip(inc.rep_view(), one.rep_view()):
            np.testing.assert_array_equal(a, b)


def test_windowview_append_and_epoch(corpus):
    X, Q = corpus
    view = WindowView(_enc("sax"), X[:6], stride=2, device="cpu")
    eng = SubseqEngine(view, verify="numpy")
    ep = view.current_epoch()
    before = eng.topk(Q[:1], k=3)                  # warms the rep cache
    new_ids = view.append(X[6:])
    assert new_ids[0] == 6 * view.windows_per_row
    assert view.current_epoch().n_rows == view.n > ep.n_rows
    res = eng.topk(Q[:1], k=3)
    want_i, want_d = _bruteforce_topk(_bruteforce_windows(X, 2),
                                      eng.normalize_queries(Q[:1]), 3)
    np.testing.assert_array_equal(res.window_ids, want_i)
    np.testing.assert_array_equal(res.distances, want_d)
    pinned = eng.topk(Q[:1], k=3, epoch=ep)
    np.testing.assert_array_equal(pinned.window_ids, before.window_ids)
    np.testing.assert_array_equal(pinned.distances, before.distances)


def test_windowview_over_symbolic_store_source(corpus):
    X, Q = corpus
    whole = SAX(T=610, W=61, A=16)             # whole-series encoder
    store = SymbolicStore.from_rows(whole, X[:8], media="hdd", device="cpu")
    view = WindowView(_enc("sax"), store, stride=2, device="cpu")
    assert view.n == 8 * view.windows_per_row
    store.append(X[8:])                        # out-of-band ingest
    assert view.sync() == 2 * view.windows_per_row
    eng = SubseqEngine(view, verify="numpy")
    res = eng.topk(Q[:1], k=2)
    want_i, _ = _bruteforce_topk(_bruteforce_windows(X, 2),
                                 eng.normalize_queries(Q[:1]), 2)
    np.testing.assert_array_equal(res.window_ids, want_i)
    assert store.accesses > 0                  # billed on the source


def test_window_fetch_bills_dedup_rows(corpus):
    X, _ = corpus
    view = WindowView(_enc("sax"), X, stride=1, device="cpu")
    nw = view.windows_per_row
    view.reset()
    # four windows from row 0, two from row 2 -> 2 row reads, 1 seek
    out = view.fetch([0, 1, 5, nw - 1, 2 * nw, 2 * nw + 3])
    assert out.shape == (6, M)
    assert view.accesses == 2 and view.fetches == 1
    np.testing.assert_array_equal(out[0], znorm_windows(X[0, :M][None])[0])
    assert view.modeled_io_seconds(2, 1) == \
        view.source.modeled_io_seconds(2, 1)
    view.fetch([3, nw - 7, 2 * nw + 1])            # warm rows: no billing
    assert view.accesses == 2 and view.fetches == 1
    view.fetch([0, 4 * nw])                        # one cold row
    assert view.accesses == 3 and view.fetches == 2
    view.reset_counters()                          # buffer stays warm
    view.fetch([0])
    assert view.accesses == 0 and view.fetches == 0
    view.reset()                                   # buffer dropped
    view.fetch([0])
    assert view.accesses == 1 and view.fetches == 1
    assert view.fetch([]).shape == (0, M)


def test_window_fetch_row_buffer_bound(corpus):
    X, _ = corpus
    view = WindowView(_enc("sax"), X, stride=1, cache_rows=0, device="cpu")
    nw = view.windows_per_row
    view.reset()
    view.fetch([0, 1])
    view.fetch([2, 3])
    assert view.accesses == 2 and view.fetches == 2    # cold each round
    fifo = WindowView(_enc("sax"), X, stride=1, cache_rows=2, device="cpu")
    fifo.reset()
    fifo.fetch([0, nw, 2 * nw])        # rows 0, 1, 2: row 0 is evicted
    fifo.fetch([nw + 1, 2 * nw + 1])   # rows 1, 2 are warm
    assert fifo.accesses == 3
    fifo.fetch([1])                    # row 0 is cold again
    assert fifo.accesses == 4


def test_exclusion_never_verifies_a_window_twice(corpus):
    X, Q = corpus
    eng = _engine(X, "sax", 1, batch_size=64)
    counts = Counter()
    orig = eng.view.fetch
    eng.view.fetch = lambda wids: (counts.update(
        np.asarray(wids, np.int64).tolist()) or orig(wids))
    res = eng.topk(Q[:1], k=6, exclusion=M // 2)   # several widenings
    eng.view.fetch = orig
    assert counts and max(counts.values()) == 1
    Wz = _bruteforce_windows(X, 1)
    d = np.sqrt(np.sum(np.square(Wz - eng.normalize_queries(Q[:1])), -1))
    order = np.argsort(d, kind="stable")
    want = greedy_nonoverlap(order, eng.view.windows_per_row, 1, 6, M // 2)
    np.testing.assert_array_equal(res.window_ids[0], want)
    rows, starts = res.rows[0], res.starts[0]
    for a in range(6):
        for b in range(a + 1, 6):
            assert rows[a] != rows[b] or abs(starts[a] - starts[b]) >= M // 2


@pytest.mark.parametrize("verify", ["kernel", "host"])
def test_kernel_verify_equals_window_distances(corpus, verify):
    """Verification through K1 (its plain version here) equals the
    launcher's K1 brute force over every window, bitwise."""
    X, Q = corpus
    eng = _engine(X, "ssax", 7, verify=verify)
    res = eng.topk(Q, k=4)
    d = window_distances(X, M, 7, eng.normalize_queries(Q), "cpu")
    want = np.argsort(d, axis=1, kind="stable")[:, :4]
    np.testing.assert_array_equal(res.window_ids, want)
    np.testing.assert_array_equal(
        res.distances, np.take_along_axis(d, want, 1).astype(np.float64))


@pytest.mark.parametrize("excl", [0, M // 2])
def test_kernel_verify_one_call_per_round(corpus, excl):
    """Windows: every verification round is one verifier call (one K1
    launch on the card); a round whose rows all sit in the row buffer
    bills no fetch, so store_fetches <= rounds, with equality when the
    buffer is off."""
    X, Q = corpus
    for cache_rows in (1024, 0):
        view = WindowView(_enc("ssax"), X, stride=3, cache_rows=cache_rows,
                          device="cpu")
        eng = SubseqEngine(view, verify="kernel", batch_size=16)
        calls = []
        inner = eng.verifier
        eng.verifier = lambda *a: calls.append(1) or inner(*a)
        res = eng.topk(Q, k=4, exclusion=excl)
        assert res.rounds == len(calls) > 0
        assert res.store_fetches <= res.rounds
        if cache_rows == 0:
            assert res.store_fetches == res.rounds


def test_scan_topk_agrees_with_engine(corpus):
    X, Q = corpus
    eng = _engine(X, "sax", 2)
    exact = eng.topk(Q, k=3)
    for chunk in (2.5e8, 1.0):                 # one chunk, one row each
        scan = eng.scan_topk(Q, k=3, chunk_bytes=chunk)
        np.testing.assert_array_equal(scan.window_ids, exact.window_ids)
        np.testing.assert_allclose(scan.distances, exact.distances,
                                   rtol=1e-3, atol=1e-3)
        assert scan.store_accesses == eng.view.n_rows
        assert (scan.raw_accesses == eng.view.n).all()


def test_unported_paths_raise(corpus):
    """The sharded window sweep (``mesh=``, ``verify="device"``, ROADMAP
    item 8) is ported: it answers bitwise as the unsharded engine, and
    device verification without a mesh, or a query of the wrong length,
    still raises."""
    X, Q = corpus
    from repro_torch.core.distributed import make_mesh
    eng = _engine(X, "sax", 7, verify="host")
    want = eng.topk(Q, k=1, use_index=False)
    assert want.window_ids.shape == (3, 1)
    mesh = make_mesh(2, device="cpu")
    for kw in ({"mesh": mesh}, {"mesh": mesh, "verify": "device"}):
        got = SubseqEngine(eng.view, **{"verify": "host", **kw}).topk(
            Q, k=1)
        np.testing.assert_array_equal(got.window_ids, want.window_ids)
        np.testing.assert_array_equal(got.distances, want.distances)
    with pytest.raises(ValueError, match="mesh"):
        SubseqEngine(eng.view, verify="device")
    with pytest.raises(ValueError):
        eng.topk(np.zeros((1, M + 1), np.float32))


@pytest.mark.parametrize("excl", [0, 120])
def test_launcher_subseq_dryrun_on_cpu(capsys, excl):
    from repro_torch.launch.match import main
    main(["--subseq", "--dryrun", "--device", "cpu", "--exclusion",
          str(excl)])
    out = capsys.readouterr().out
    assert ": 4/4 query frontiers == brute force" in out
    assert "query of appended row -> row 12 " in out


def test_subseq_on_card_equals_kernel_bruteforce(corpus):
    """On the card every kernel of the path launches, and the exact
    answer equals a K1 brute force over every window bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.launch.match import make_subseq_engine
    X, Q = corpus
    before = {n: k.launches for n, k in KERNELS.items()}
    view, eng = make_subseq_engine("ssax", X, m=M, stride=3, L=10,
                                   device="cuda")
    res = eng.topk(Q, k=5)
    n_k1 = KERNELS["euclid"].launches - before["euclid"]
    scan = eng.scan_topk(Q, k=5)
    after = {n: k.launches for n, k in KERNELS.items()}
    for name in KERNELS:
        if name != "sax_dist":
            assert after[name] > before[name], name
    # one gathered K1 launch per verification round; with the row buffer
    # off, every round is one fetch
    assert n_k1 == res.rounds > 0 and res.store_fetches <= res.rounds
    _, cold = make_subseq_engine("ssax", X, m=M, stride=3, L=10,
                                 device="cuda")
    cold.view.cache_rows = 0
    n0 = KERNELS["euclid"].launches
    again = cold.topk(Q, k=5)
    assert KERNELS["euclid"].launches - n0 == again.rounds \
        == again.store_fetches
    d = window_distances(X, M, 3, eng.normalize_queries(Q), "cuda")
    want = np.argsort(d, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(res.window_ids, want)
    np.testing.assert_array_equal(
        res.distances, np.take_along_axis(d, want, 1).astype(np.float64))
    np.testing.assert_allclose(scan.distances ** 2, res.distances ** 2,
                               rtol=1e-3, atol=1e-3)

"""The port's matrix-profile self-join (``repro_torch.profile``) on the
CPU, following the reference's ``tests/test_selfjoin.py``.

Within the port, bitwise: every route's profile (the linear host
matrix, the split-tree index, the device-ordered stream on
``make_mesh(1|2|4, device="cpu")`` with ``verify="device"``) equals the
brute-force ``scan_profile`` of its verification family (numpy, or K1's
plain version for "host" / "device"), for all four encoders; motifs and
discords, pure functions of the profile, follow.  The device route moves
no row and no candidate order to the host.  Against the reference
(``repro.profile``, numpy family): neighbours, motif and discord ids and
``trivial_ids`` are equal, distances within rtol 1e-5; the
``selfjoin.*`` metric names are the same.  On a card, the device route
equals the K1 ``scan_profile`` bitwise."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import make_technique  # noqa: E402
from repro_torch.core.distributed import make_mesh  # noqa: E402
from repro_torch.data.synthetic import season_dataset  # noqa: E402
from repro_torch.obs import MetricsRegistry, check_trace  # noqa: E402
from repro_torch.profile import (  # noqa: E402
    MatrixProfile, SelfJoinEngine, topk_discords, topk_motifs)
from repro_torch.subseq import WindowView  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
L = 10
TECHS = ("sax", "ssax", "tsax", "stsax")
TECH_KW = {"sax": {}, "ssax": {"r2_season": 0.7}, "tsax": {"r2_trend": 0.3},
           "stsax": {"r2_season": 0.5}}
M, STRIDE, ROWS, T = 60, 6, 5, 300      # 41 windows per row, 205 in all


def _enc(tech, m=M):
    return make_technique(tech, T=m, W=m // L, L=L, **TECH_KW[tech])


def _corpus(seed, n=ROWS, t=T):
    """The reference test's three corpus kinds (random walk, season,
    trend), by seed."""
    rng = np.random.default_rng(seed)
    kind = seed % 3
    if kind == 0:
        x = np.cumsum(rng.normal(size=(n, t)), axis=1)
    elif kind == 1:
        mask = rng.normal(size=(n, L))
        x = np.tile(mask, (1, t // L + 1))[:, :t] \
            + 0.3 * rng.normal(size=(n, t))
    else:
        x = (np.linspace(0, 3, t)[None] * rng.normal(size=(n, 1))
             + 0.5 * rng.normal(size=(n, t)))
    return x.astype(np.float32)


def _view(tech, D, m=M, stride=STRIDE, index=False):
    view = WindowView(_enc(tech, m), D, stride=stride, media="ssd",
                      device="cpu")
    if index:
        view.build_index(leaf_fill=16)
    return view


def _same(a: MatrixProfile, b: MatrixProfile):
    return (np.array_equal(a.distances, b.distances)
            and np.array_equal(a.neighbors, b.neighbors))


def _plant(n=ROWS, t=T, m=M, seed=13):
    """Corpus with a near-identical snippet in rows 0 and 1 (the motif)
    and a one-off burst in row 2 (the discord), as the reference's."""
    rng = np.random.default_rng(seed)
    D = np.asarray(season_dataset(n, t, L, strength=0.6,
                                  per_series_strength=True, seed=seed),
                   np.float64).copy()
    o = (t - m) // 2
    snip = np.sin(np.linspace(0, 6 * np.pi, m)) * 2.0
    D[0, o:o + m] = snip + 0.01 * rng.normal(size=m)
    D[1, o:o + m] = snip + 0.01 * rng.normal(size=m)
    D[2, o:o + m] += 6.0 * np.hanning(m)
    return D.astype(np.float32), o


@pytest.fixture(scope="module")
def reference():
    """The reference's self-join over the same corpus and encoder
    (numpy family), by (tech, seed)."""
    pytest.importorskip("jax")
    from repro.core import make_technique as ref_make
    from repro.profile import SelfJoinEngine as RefEngine
    from repro.subseq import WindowView as RefView

    def build(tech, D):
        enc = ref_make(tech, T=M, W=M // L, L=L, **TECH_KW[tech])
        view = RefView(enc, D, stride=STRIDE, media="ssd")
        return view, RefEngine(view, verify="numpy", batch_size=64)
    return build


# ---------------------------------------------------------------------------
# exactness within the port and against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tech", TECHS)
@pytest.mark.parametrize("index", [False, True])
def test_profile_bitwise_equals_scan_profile(tech, index):
    """Linear and indexed routes, numpy family: profile, motifs and
    discords equal the brute-force profile exactly, and prune."""
    view = _view(tech, _corpus(3), index=index)
    eng = SelfJoinEngine(view, verify="numpy", batch_size=64)
    prof = eng.profile()
    assert prof.source == ("index" if index else "linear")
    oracle = eng.scan_profile()
    assert _same(prof, oracle), tech
    assert topk_motifs(prof, view.locate, 3) == \
        topk_motifs(oracle, view.locate, 3)
    assert topk_discords(prof, view.locate, 3) == \
        topk_discords(oracle, view.locate, 3)
    assert prof.raw_accesses.mean() <= oracle.raw_accesses.mean()
    assert prof.rounds > 0


@pytest.mark.parametrize("tech", TECHS)
def test_profile_equals_the_reference(tech, reference):
    """Port profile == reference profile: neighbours (and so motif and
    discord ids) equal, distances within rtol 1e-5."""
    D = _corpus(4)
    view = _view(tech, D)
    eng = SelfJoinEngine(view, verify="numpy", batch_size=64)
    prof = eng.profile()
    rview, reng = reference(tech, D)
    want = reng.profile()
    assert prof.n == want.n
    np.testing.assert_array_equal(prof.neighbors, want.neighbors)
    np.testing.assert_allclose(prof.distances, want.distances, rtol=1e-5)
    np.testing.assert_array_equal(prof.raw_accesses, want.raw_accesses)
    for k in (1, 3):
        got_m = topk_motifs(prof, view.locate, k)
        want_m = topk_motifs(want, rview.locate, k)
        assert [g[:2] for g in got_m] == [w[:2] for w in want_m]
        np.testing.assert_allclose([g[2] for g in got_m],
                                   [w[2] for w in want_m], rtol=1e-5)
        got_d = topk_discords(prof, view.locate, k)
        want_d = topk_discords(want, rview.locate, k)
        assert [g[0] for g in got_d] == [w[0] for w in want_d]
        np.testing.assert_allclose([g[1] for g in got_d],
                                   [w[1] for w in want_d], rtol=1e-5)
    for wid in (0, 40, 41, 100, prof.n - 1):
        np.testing.assert_array_equal(eng.trivial_ids(wid),
                                      reng.trivial_ids(wid))


@pytest.mark.parametrize("tech", ["ssax", "stsax"])
def test_kernel_family_matches_its_own_scan(tech):
    """The K1 family ("host": K1's plain version on the CPU) is another
    reduction than numpy: it equals its own ``scan_profile`` bitwise,
    on the linear and the indexed route."""
    for index in (False, True):
        view = _view(tech, _corpus(4, n=4, t=240), index=index)
        eng = SelfJoinEngine(view, verify="host", batch_size=64)
        assert _same(eng.profile(), eng.scan_profile()), (tech, index)


@pytest.mark.parametrize("seed,excl,stride", [(0, 1, 4), (1, 15, 7),
                                              (2, 30, 11), (5, 60, 4)])
def test_neighbours_outside_the_trivial_zone(seed, excl, stride):
    """Any exclusion and stride: profile == scan, and no neighbour lies
    in its window's trivial zone."""
    tech = TECHS[seed % 4]
    t = M + stride * (4 + seed) + seed
    view = _view(tech, _corpus(seed, n=3, t=t), stride=stride,
                 index=bool(seed % 2))
    eng = SelfJoinEngine(view, verify="numpy", exclusion=excl,
                         batch_size=32)
    prof = eng.profile()
    assert _same(prof, eng.scan_profile()), (tech, seed, excl)
    for w in range(prof.n):
        nb = prof.neighbors[w]
        if nb >= 0:
            assert nb not in eng.trivial_ids(w)
            assert np.isfinite(prof.distances[w])
        else:
            assert prof.distances[w] == np.inf


# ---------------------------------------------------------------------------
# geometry, validation, motifs, the cache
# ---------------------------------------------------------------------------

def test_trivial_zone_geometry():
    view = _view("sax", _corpus(0, n=3, t=240))
    eng = SelfJoinEngine(view, exclusion=20)
    nw = view.windows_per_row
    for wid in [0, 1, nw - 1, nw, 2 * nw + 3, view.n - 1]:
        ids = eng.trivial_ids(wid)
        assert wid in ids
        assert np.all(ids // nw == wid // nw)
        starts = (ids % nw) * view.stride
        s0 = (wid % nw) * view.stride
        assert np.all(np.abs(starts - s0) < eng.exclusion)
        lo, hi = ids.min(), ids.max()
        if lo % nw > 0:
            assert abs((lo - 1) % nw - wid % nw) * view.stride \
                >= eng.exclusion
        if hi % nw < nw - 1:
            assert abs((hi + 1) % nw - wid % nw) * view.stride \
                >= eng.exclusion


def test_exclusion_validation():
    view = _view("sax", _corpus(0, n=2, t=120), m=40, stride=4)
    assert SelfJoinEngine(view).exclusion == max(1, 40 // 4)
    assert SelfJoinEngine(view).verify_mode == "auto"
    with pytest.raises(ValueError, match="exclusion"):
        SelfJoinEngine(view, exclusion=0)
    with pytest.raises(ValueError, match="index"):
        SelfJoinEngine(view).profile(use_index=True)
    with pytest.raises(ValueError, match="mesh"):
        SelfJoinEngine(view, verify="device")


def test_motifs_and_discords_recover_planted_patterns():
    D, o = _plant()
    view = _view("ssax", D)
    eng = SelfJoinEngine(view, verify="numpy")
    a, b, d = eng.topk_motifs(3)[0]
    rows, starts = view.locate(np.asarray([a, b], np.int64))
    assert sorted(rows.tolist()) == [0, 1]
    assert all(abs(int(s) - o) <= 2 * view.stride for s in starts)
    assert d < 1.0
    r_disc, _ = view.locate(np.asarray([eng.topk_discords(3)[0][0]],
                                       np.int64))
    assert int(r_disc[0]) == 2


def test_motif_discord_non_overlap_and_order():
    view = _view("tsax", _corpus(7))
    eng = SelfJoinEngine(view, verify="numpy")
    prof = eng.profile()
    motifs = topk_motifs(prof, view.locate, 6)
    discords = topk_discords(prof, view.locate, 6)
    assert [d for *_, d in motifs] == sorted(d for *_, d in motifs)
    assert [d for _, d in discords] == \
        sorted((d for _, d in discords), reverse=True)
    assert all(np.isfinite(d) for *_, d in motifs)
    assert all(np.isfinite(d) for _, d in discords)

    def no_overlap(wids):
        rows, starts = view.locate(np.asarray(wids, np.int64))
        for i in range(len(wids)):
            for j in range(i + 1, len(wids)):
                assert not (rows[i] == rows[j]
                            and abs(int(starts[i]) - int(starts[j]))
                            < prof.exclusion), (wids[i], wids[j])
    no_overlap([w for pair in motifs for w in pair[:2]])
    no_overlap([w for w, _ in discords])


def test_profile_cache_and_refresh():
    view = _view("sax", _corpus(1, n=3, t=240))
    eng = SelfJoinEngine(view, verify="numpy")
    p1 = eng.profile()
    assert eng.profile() is p1                       # a cache hit is free
    assert eng.profile(refresh=True) is not p1       # forced recompute
    p3 = eng.profile(explain=True)                   # EXPLAIN re-measures
    assert p3 is not p1 and p3.trace is not None
    assert _same(p1, p3)
    view.append(_corpus(9, n=1, t=240))              # an append invalidates
    p4 = eng.profile()
    assert p4 is not p3 and p4.n == view.n > p3.n
    assert _same(p4, eng.scan_profile())


# ---------------------------------------------------------------------------
# the device-ordered stream route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tech", TECHS)
@pytest.mark.parametrize("S", [1, 2, 4])
def test_device_stream_bitwise_and_zero_host_transfers(tech, S):
    """The stream route with ``verify="device"`` on S virtual shards
    equals the K1-family ``scan_profile`` bitwise, ordering candidates
    and verifying windows without a host matrix or a host row."""
    view = _view(tech, season_dataset(4, 240, L, 0.7,
                                      per_series_strength=True, seed=21))
    oracle = SelfJoinEngine(view, verify="host").scan_profile()
    reg = MetricsRegistry()
    eng = SelfJoinEngine(view, verify="device", mesh=make_mesh(S, "cpu"),
                         batch_size=64, metrics=reg)
    prof = eng.profile(explain=True)
    assert prof.source == "stream"
    assert _same(prof, oracle), (tech, S)
    assert check_trace(prof.trace, device=True) == []
    assert prof.trace.get("host_order_bytes") == 0
    assert prof.trace.get("rows_to_host") == 0
    c = reg.snapshot()["counters"]
    assert c["selfjoin.rows_to_host"] == 0
    assert c["selfjoin.host_order_bytes"] == 0
    # the mask is id arithmetic on the sweep's device
    mask = eng._mask_fn(np.arange(3, dtype=np.int64))(
        torch.arange(view.n))
    assert isinstance(mask, torch.Tensor) and mask.shape == (3, view.n)
    for i in range(3):
        np.testing.assert_array_equal(np.nonzero(mask[i].numpy())[0],
                                      eng.trivial_ids(i))


def test_stream_route_with_host_verification():
    """A mesh with ``verify="host"``: device order, host fetches, the
    same bits as the K1-family scan."""
    view = _view("ssax", _corpus(2, n=4, t=240))
    eng = SelfJoinEngine(view, verify="host", mesh=make_mesh(2, "cpu"))
    prof = eng.profile()
    assert prof.source == "stream"
    assert _same(prof, eng.scan_profile())


# ---------------------------------------------------------------------------
# metrics against the reference, the launcher, the card
# ---------------------------------------------------------------------------

def test_metric_names_equal_the_reference(reference):
    pytest.importorskip("jax")
    from repro.obs import MetricsRegistry as RefRegistry
    from repro.profile import SelfJoinEngine as RefEngine
    D = _corpus(4, n=3, t=240)
    reg = MetricsRegistry()
    SelfJoinEngine(_view("ssax", D), verify="numpy", metrics=reg).profile()
    rview, _ = reference("ssax", D)
    rreg = RefRegistry()
    RefEngine(rview, verify="numpy", metrics=rreg).profile()
    got, want = reg.snapshot(), rreg.snapshot()
    for kind in ("counters", "gauges", "histograms"):
        assert sorted(got[kind]) == sorted(want[kind]), kind
    for name in ("selfjoin.queries", "selfjoin.windows_verified",
                 "selfjoin.rows_fetched", "selfjoin.seeks"):
        assert got["counters"][name] == want["counters"][name], name


def test_launcher_selfjoin_dryrun_on_cpu():
    """``python -m repro_torch.launch.match --selfjoin --dryrun --device
    cpu`` exits 0 with its bit-identity line and the planted answers."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.match", "--selfjoin",
         "--dryrun", "--device", "cpu"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "bitwise == oracle yes" in out.stdout
    assert "planted motif recovered: yes" in out.stdout
    assert "planted discord recovered: yes" in out.stdout


def test_selfjoin_on_card_equals_k1_scan():
    """On the card: the device stream route (K2 sweep, K1 verification)
    equals the K1 ``scan_profile`` bitwise, K1 launches equal rounds,
    and no row reaches the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.ops import make_pairwise
    enc = _enc("ssax")
    D = season_dataset(6, 300, L, 0.7, per_series_strength=True, seed=5)
    view = WindowView(enc, D, stride=STRIDE, device="cuda")
    eng = SelfJoinEngine(view, verify="device", mesh=make_mesh(4),
                         pairwise=make_pairwise(enc))
    k1 = KERNELS["euclid"]
    before = k1.launches
    prof = eng.profile(explain=True)
    assert k1.launches - before == prof.rounds
    assert check_trace(prof.trace, device=True) == []
    assert _same(prof, eng.scan_profile())

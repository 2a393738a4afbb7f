"""The port's kernels: each plain PyTorch version against the JAX
package's oracle and its interpret-mode Pallas kernel (CPU), and each
CUDA kernel against its plain version (skipped without a card).

Tolerances are the JAX package's own (tests/test_kernels.py): sax 1e-5,
ssax 1e-4, paa 1e-5 (bf16 2e-2), euclid 1e-4 (bf16 5e-2), windowed
euclid 1e-3, rtol = atol.
They cover summation order, which differs between the frameworks and
between the kernels and their plain versions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import KERNELS, ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

RNG = np.random.default_rng(7)
TOL = {"sax": 1e-5, "ssax": 1e-4, "paa": 1e-5, "paa_bf16": 2e-2,
       "euclid": 1e-4, "euclid_bf16": 5e-2, "windowed": 1e-3}
# (Q, N, T, m, stride) of the reference's tests/test_kernels.py: one
# query, stride > 1 with a ragged tail, ragged everything, one window
# per row, more rows than the TPU kernel's row block
WINDOWED_SHAPES = [(1, 4, 256, 64, 1), (3, 5, 300, 32, 3),
                   (2, 9, 1111, 64, 7), (2, 2, 100, 100, 1),
                   (4, 24, 960, 120, 5)]


@pytest.fixture(scope="module")
def jref():
    """The JAX package's oracles and Pallas kernels (interpret mode)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref
    from repro.kernels.euclid import euclid_pallas
    from repro.kernels.paa import paa_pallas
    from repro.kernels.sax_dist import sax_dist_pallas
    from repro.kernels.ssax_dist import ssax_dist_pallas
    from repro.kernels.windowed_euclid import windowed_euclid_pallas

    class R:
        pass
    r = R()
    r.jnp, r.ref = jnp, jax_ref
    r.euclid, r.paa, r.sax, r.ssax = (euclid_pallas, paa_pallas,
                                      sax_dist_pallas, ssax_dist_pallas)
    r.windowed = windowed_euclid_pallas
    return r


@pytest.fixture
def cuda():
    """The card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _sax_inputs(N, W, A):
    return (RNG.integers(0, A, size=(N, W)).astype(np.int32),
            (RNG.normal(size=(W, A)) ** 2).astype(np.float32))


def _ssax_inputs(N, L, W, As, Ar):
    return (RNG.integers(0, As, size=(N, L)).astype(np.int32),
            RNG.integers(0, Ar, size=(N, W)).astype(np.int32),
            *(RNG.normal(size=s).astype(np.float32)
              for s in ((L, As), (L, As), (W, Ar), (W, Ar))))


def _znorm_queries(Q, m):
    q = RNG.normal(size=(Q, m)).astype(np.float32)
    return (q - q.mean(-1, keepdims=True)) / q.std(-1, keepdims=True)


# -- plain versions against the JAX package (CPU) ---------------------------

@pytest.mark.parametrize("N,W,A", [(256, 8, 4), (512, 48, 64),
                                   (256, 32, 1024), (300, 16, 32)])
def test_sax_dist_plain_matches_reference(jref, N, W, A):
    syms, table = _sax_inputs(N, W, A)
    got = ops.sax_dist(torch.from_numpy(syms), torch.from_numpy(table))
    _close(got, jref.ref.sax_dist_ref(jref.jnp.asarray(syms),
                                      jref.jnp.asarray(table)), TOL["sax"])
    if N % 256 == 0:
        _close(got, jref.sax(jref.jnp.asarray(syms), jref.jnp.asarray(table),
                             interpret=True), TOL["sax"])


@pytest.mark.parametrize("N,L,W,As,Ar", [(128, 8, 16, 16, 8),
                                         (128, 10, 48, 64, 32),
                                         (384, 10, 24, 16, 32)])
def test_ssax_dist_plain_matches_reference(jref, N, L, W, As, Ar):
    args = _ssax_inputs(N, L, W, As, Ar)
    got = ops.ssax_dist(*map(torch.from_numpy, args))
    jargs = [jref.jnp.asarray(a) for a in args]
    _close(got, jref.ref.ssax_dist_ref(*jargs), TOL["ssax"])
    _close(got, jref.ssax(*jargs, interpret=True), TOL["ssax"])


def _ssax_batch_inputs(Q, N, L, W, As, Ar):
    return (RNG.integers(0, As, size=(N, L)).astype(np.int32),
            RNG.integers(0, Ar, size=(N, W)).astype(np.int32),
            *(RNG.normal(size=s).astype(np.float32)
              for s in ((Q, L, As), (Q, L, As), (Q, W, Ar), (Q, W, Ar))))


# (Q, N, L, W, A_seas, A_res): ragged N (not a multiple of 128) and
# ragged W (not a multiple of the kernel's 16-term chunk)
SSAX_BATCH_SHAPES = [(1, 100, 10, 17, 16, 32), (3, 256, 8, 24, 16, 8),
                     (8, 100, 10, 48, 16, 32)]


@pytest.mark.parametrize("Q,N,L,W,As,Ar", SSAX_BATCH_SHAPES)
def test_ssax_dist_batch_plain_matches_reference(jref, Q, N, L, W, As, Ar):
    """Each row of the batched sweep against the reference's Pallas
    kernel (interpret mode) and oracle on that query's tables."""
    seas, res, t1, t2, u1, u2 = _ssax_batch_inputs(Q, N, L, W, As, Ar)
    got = ops.ssax_dist_batch(*map(torch.from_numpy,
                                   (seas, res, t1, t2, u1, u2)))
    assert got.shape == (Q, N) and got.dtype == torch.float32
    js, jr = jref.jnp.asarray(seas), jref.jnp.asarray(res)
    for q in range(Q):
        tabs = [jref.jnp.asarray(a[q]) for a in (t1, t2, u1, u2)]
        _close(got[q], jref.ssax(js, jr, *tabs, interpret=True),
               TOL["ssax"])
        _close(got[q], jref.ref.ssax_dist_ref(js, jr, *tabs), TOL["ssax"])


@pytest.mark.parametrize("Q,N,L,W,As,Ar", SSAX_BATCH_SHAPES)
def test_ssax_dist_batch_plain_equals_single_query(Q, N, L, W, As, Ar):
    args = [torch.from_numpy(a) for a in _ssax_batch_inputs(Q, N, L, W, As,
                                                            Ar)]
    got = ops.ssax_dist_batch(*args)
    for q in range(Q):
        assert torch.equal(got[q], ops.ssax_dist(
            *args[:2], *(t[q] for t in args[2:])))


@pytest.mark.parametrize("Q,L,W,As,Ar", [(1, 10, 48, 16, 32),
                                         (8, 10, 24, 16, 32),
                                         (5, 3, 17, 4, 1024)])
def test_make_ssax_query_tables_batch_equals_stacked(Q, L, W, As, Ar):
    """The (Q, L)/(Q, W) form gives each query's tables bitwise,
    the clamped infinities of the outer breakpoints included."""
    from repro_torch.core.breakpoints import gaussian_breakpoints
    bs, br = gaussian_breakpoints(As, 0.8), gaussian_breakpoints(Ar, 0.6)
    qs = torch.from_numpy(RNG.integers(0, As, size=(Q, L)).astype(np.int32))
    qr = torch.from_numpy(RNG.integers(0, Ar, size=(Q, W)).astype(np.int32))
    qs[0, 0], qr[0, 0] = 0, Ar - 1              # an infinite bound each
    batch = ops.make_ssax_query_tables(qs, qr, bs, br)
    for got, shape in zip(batch, ((Q, L, As), (Q, L, As), (Q, W, Ar),
                                  (Q, W, Ar))):
        assert got.shape == shape and got.is_contiguous()
        assert torch.isfinite(got).all()
    for q in range(Q):
        for got, want in zip(batch, ops.make_ssax_query_tables(
                qs[q], qr[q], bs, br)):
            assert torch.equal(got[q], want)


def test_ssax_dist_batch_rejects_bad_shapes():
    seas, res = (torch.zeros(4, 3, dtype=torch.int32),
                 torch.zeros(4, 5, dtype=torch.int32))
    t, u = torch.zeros(2, 3, 4), torch.zeros(2, 5, 4)
    assert ops.ssax_dist_batch(seas, res, t, t, u, u).shape == (2, 4)
    for bad in ((t, t, u[:1], u[:1]),                 # Q disagrees
                (t[:, :2], t[:, :2], u, u),           # L disagrees
                (t, t, u[:, :4], u[:, :4]),           # W disagrees
                (t[0], t[0], u[0], u[0])):            # not batched
        with pytest.raises(ValueError):
            ops.ssax_dist_batch(seas, res, *bad)


@pytest.mark.parametrize("N,T,W", [(128, 512, 32), (256, 960, 48),
                                   (128, 480, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paa_plain_matches_reference(jref, N, T, W, dtype):
    x = RNG.normal(size=(N, T)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jref.jnp.asarray(x, getattr(jref.jnp, dtype))
    got = ops.paa_segments(xt, W)
    assert got.dtype == torch.float32 and got.shape == (N, W)
    tol = TOL["paa" if dtype == "float32" else "paa_bf16"]
    _close(got, jref.ref.paa_ref(xj.astype(jref.jnp.float32), W), tol)
    _close(got, jref.paa(xj, W, interpret=True), tol)


@pytest.mark.parametrize("N,T", [(128, 512), (256, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_euclid_plain_matches_reference(jref, N, T, dtype):
    x = RNG.normal(size=(N, T)).astype(np.float32)
    q = RNG.normal(size=(T,)).astype(np.float32)
    jd = getattr(jref.jnp, dtype)
    got = ops.euclid_batch(torch.from_numpy(x).to(getattr(torch, dtype)),
                           torch.from_numpy(q).to(getattr(torch, dtype)))
    tol = TOL["euclid" if dtype == "float32" else "euclid_bf16"]
    xj, qj = jref.jnp.asarray(x, jd), jref.jnp.asarray(q, jd)
    _close(got, jref.ref.euclid_ref(xj.astype(jref.jnp.float32),
                                    qj.astype(jref.jnp.float32)), tol)
    _close(got, jref.euclid(xj, qj, interpret=True), tol)


@pytest.mark.parametrize("Q,N,T", [(2, 37, 480), (9, 1, 17), (5, 300, 1000)])
def test_euclid_query_batch_ragged_matches_reference(jref, Q, N, T):
    x = RNG.normal(size=(N, T)).astype(np.float32)
    q = RNG.normal(size=(Q, T)).astype(np.float32)
    got = ops.euclid_batch(torch.from_numpy(x), torch.from_numpy(q))
    assert got.shape == (Q, N)
    _close(got, jref.euclid(jref.jnp.asarray(x), jref.jnp.asarray(q),
                            interpret=True), TOL["euclid"])


def _gather_inputs(U, Qa, B, T):
    rows = RNG.normal(size=(U, T)).astype(np.float32)
    q = RNG.normal(size=(Qa, T)).astype(np.float32)
    return rows, q, RNG.integers(0, U, size=(Qa, B)).astype(np.int64)


@pytest.mark.parametrize("U,Qa,B,T", [(2048, 8, 256, 96), (50, 3, 17, 961),
                                      (1, 1, 1, 5), (300, 2, 64, 240)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_euclid_gather_plain_equals_per_query_batch(U, Qa, B, T, dtype):
    """The gathered entry's plain version is, bitwise, one euclid_batch
    per query over that query's gathered rows."""
    rows, q, g = _gather_inputs(U, Qa, B, T)
    dt = getattr(torch, dtype)
    rt, qt = torch.from_numpy(rows).to(dt), torch.from_numpy(q).to(dt)
    got = ops.euclid_gather(rt, qt, g)
    assert got.dtype == torch.float32 and got.shape == (Qa, B)
    want = torch.stack([ops.euclid_batch(rt[torch.from_numpy(g[a])], qt[a])
                        for a in range(Qa)])
    assert torch.equal(got, want)
    assert torch.equal(ops.euclid_gather(rt, qt, torch.from_numpy(g)), got)


@pytest.mark.parametrize("U,Qa,B,T", [(600, 4, 256, 480), (37, 3, 5, 97)])
def test_euclid_gather_plain_matches_reference_verifier(jref, U, Qa, B, T):
    """sqrt of the gathered plain version against the reference's
    ``kernel_verifier`` (its Pallas euclid kernel in interpret mode)."""
    from repro.core.engine import kernel_verifier as ref_verifier
    rows, q, g = _gather_inputs(U, Qa, B, T)
    got = np.sqrt(np.maximum(ops.euclid_gather(
        torch.from_numpy(rows), torch.from_numpy(q), g).numpy(), 0.0))
    _close(got, ref_verifier(rows, q, g), 1e-3)


@pytest.mark.parametrize("bad,err", [
    (np.zeros((2, 4), np.int64), ValueError),          # Qa mismatch
    (np.zeros((3,), np.int64), ValueError),            # not 2-D
    (np.zeros((3, 4), np.int32), TypeError),           # not int64
    (np.full((3, 4), 10, np.int64), ValueError),       # past the rows
    (np.full((3, 4), -1, np.int64), ValueError),       # negative
    ([[0, 1]] * 3, TypeError),                         # not an array
])
def test_euclid_gather_rejects_bad_gather(bad, err):
    rows, q = torch.zeros(10, 8), torch.zeros(3, 8)
    with pytest.raises(err):
        ops.euclid_gather(rows, q, bad)


@pytest.mark.parametrize("Q,N,T,m,stride", WINDOWED_SHAPES)
def test_windowed_euclid_plain_matches_reference(jref, Q, N, T, m, stride):
    x = RNG.normal(size=(N, T)).astype(np.float32)
    q = _znorm_queries(Q, m)
    got = ops.windowed_euclid(torch.from_numpy(x), torch.from_numpy(q),
                              stride)
    assert got.shape == (Q, N, (T - m) // stride + 1)
    xj, qj = jref.jnp.asarray(x), jref.jnp.asarray(q)
    _close(got, jref.ref.windowed_euclid_ref(xj, qj, stride), TOL["windowed"])
    _close(got, jref.windowed(xj, qj, stride=stride, interpret=True),
           TOL["windowed"])


def test_windowed_euclid_plain_constant_window(jref):
    """A zero-variance window z-normalizes to the zero vector, so its
    distance is sum(q^2), as in the reference."""
    x = np.ones((1, 64), np.float32)
    q = _znorm_queries(1, 16)
    got = ops.windowed_euclid(torch.from_numpy(x), torch.from_numpy(q))
    _close(got, np.full(got.shape, np.sum(q ** 2)), TOL["windowed"])
    _close(got, jref.windowed(jref.jnp.asarray(x), jref.jnp.asarray(q),
                              interpret=True), TOL["windowed"])


def test_windowed_euclid_single_query_and_routes(jref):
    x = torch.from_numpy(RNG.normal(size=(3, 50)).astype(np.float32))
    q = torch.from_numpy(_znorm_queries(2, 10))
    both = ops.windowed_euclid(x, q, stride=4)
    one = ops.windowed_euclid(x, q[1], stride=4)
    assert one.shape == (3, 11) and torch.equal(one, both[1])
    # the FFT route answers: the reference's FFT path and the
    # accumulation within the documented FFT tolerance
    from repro.kernels.fft_dot import windowed_euclid_fft
    from repro_torch.kernels.fft_dot import fft_tolerance
    fft = ops.windowed_euclid(x, q, stride=4, method="fft")
    assert fft.shape == both.shape
    np.testing.assert_allclose(
        fft.numpy(), np.asarray(windowed_euclid_fft(x.numpy(), q.numpy(),
                                                    stride=4)),
        **fft_tolerance(10))
    np.testing.assert_allclose(fft.numpy(), both.numpy(),
                               **fft_tolerance(10))
    with pytest.raises(ValueError):
        ops.windowed_euclid(x, q, method="mass")
    with pytest.raises(ValueError):
        ops.windowed_euclid(x, torch.zeros(2, 51))      # m > T
    with pytest.raises(ValueError):
        ops.windowed_euclid(x, q, stride=0)


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(4, 10)
    with pytest.raises(ValueError):
        ops.paa_segments(x, 3)                       # W does not divide T
    with pytest.raises(ValueError):
        ops.euclid_batch(x, torch.zeros(2, 9))       # T mismatch
    with pytest.raises(ValueError):
        ops.sax_dist(torch.zeros(4, 5, dtype=torch.int32), torch.zeros(4, 8))
    with pytest.raises(ValueError):
        ops.ssax_dist(*(torch.zeros(4, 3, dtype=torch.int32),) * 2,
                      *(torch.zeros(2, 4),) * 4)      # L mismatch


def test_cpu_tensors_never_launch():
    before = {n: k.launches for n, k in KERNELS.items()}
    ops.euclid_batch(torch.zeros(3, 8), torch.zeros(8))
    ops.euclid_gather(torch.zeros(3, 8), torch.zeros(2, 8),
                      np.zeros((2, 4), np.int64))
    ops.paa_segments(torch.zeros(3, 8), 4)
    ops.windowed_euclid(torch.zeros(3, 8), torch.zeros(4))
    assert {n: k.launches for n, k in KERNELS.items()} == before


# -- CUDA kernels against their plain versions (on the card) ---------------

@pytest.mark.parametrize("N,W,A", [(1 << 16, 48, 64), (300, 16, 32),
                                   (1000, 96, 1024), (7, 8, 4)])
def test_sax_dist_kernel_matches_plain(cuda, N, W, A):
    s, t = (torch.from_numpy(a).to(cuda) for a in _sax_inputs(N, W, A))
    n0 = KERNELS["sax_dist"].launches
    got = ops.sax_dist(s, t)
    torch.cuda.synchronize()
    assert KERNELS["sax_dist"].launches == n0 + 1
    _close(got.cpu(), ref.sax_dist_ref(s, t).cpu(), TOL["sax"])


@pytest.mark.parametrize("N,L,W,As,Ar", [(1 << 16, 10, 48, 16, 32),
                                         (300, 8, 16, 16, 8),
                                         (1000, 10, 96, 64, 1024),
                                         (5, 3, 17, 4, 4)])
def test_ssax_dist_kernel_matches_plain(cuda, N, L, W, As, Ar):
    args = [torch.from_numpy(a).to(cuda)
            for a in _ssax_inputs(N, L, W, As, Ar)]
    n0 = KERNELS["ssax_dist"].launches
    got = ops.ssax_dist(*args)
    torch.cuda.synchronize()
    assert KERNELS["ssax_dist"].launches == n0 + 1
    _close(got.cpu(), ref.ssax_dist_ref(*args).cpu(), TOL["ssax"])


def test_ssax_dist_kernel_takes_clamped_infinite_tables(cuda):
    """The query tables carry -3.4e38/4 where the breakpoints are
    infinite; the kernel's max form must give the plain version's sum."""
    from repro_torch.core.breakpoints import gaussian_breakpoints
    L, W, As, Ar, N = 10, 48, 16, 32, 4096
    bs, br = gaussian_breakpoints(As, 0.8), gaussian_breakpoints(Ar, 0.6)
    seas = torch.from_numpy(RNG.integers(0, As, size=(N, L)).astype(np.int32))
    res = torch.from_numpy(RNG.integers(0, Ar, size=(N, W)).astype(np.int32))
    tabs = ops.make_ssax_query_tables(seas[0], res[0], bs, br)
    args = [a.to(cuda) for a in (seas, res, *tabs)]
    _close(ops.ssax_dist(*args).cpu(), ref.ssax_dist_ref(*args).cpu(),
           TOL["ssax"])


# (Q, N, L, W, A_seas, A_res): the main path's and the subsequence path's
# shapes at Q = 8, the one-query shape, ragged N and W, one query's
# tables beyond shared memory (read through L2), rows of 452 words,
# the longest the kernel takes (odd strides 51 + 401 <= 453)
@pytest.mark.parametrize("Q,N,L,W,As,Ar", [
    (8, 1 << 16, 10, 48, 16, 32), (8, 50_000, 10, 24, 16, 32),
    (1, 1 << 16, 10, 48, 16, 32), (3, 300, 8, 17, 16, 8),
    (2, 1000, 10, 96, 64, 1024), (3, 257, 50, 401, 4, 4)])
def test_ssax_dist_batch_kernel_matches_plain(cuda, Q, N, L, W, As, Ar):
    args = [torch.from_numpy(a).to(cuda)
            for a in _ssax_batch_inputs(Q, N, L, W, As, Ar)]
    n0 = KERNELS["ssax_dist"].launches
    got = ops.ssax_dist_batch(*args)
    torch.cuda.synchronize()
    assert KERNELS["ssax_dist"].launches == n0 + 1
    _close(got.cpu(), ref.ssax_dist_batch_ref(*args).cpu(), TOL["ssax"])


@pytest.mark.parametrize("Q", [8, 64])
@pytest.mark.parametrize("N,W", [(5000, 48), (777, 24)])
def test_ssax_dist_batch_kernel_rows_equal_single_launches(cuda, Q, N, W):
    """Every row of a batched launch equals that query's Q = 1 launch
    bitwise; Q = 64 at these alphabets is 870 KB of tables at W = 48,
    beyond shared memory, so it goes in groups, and is held to the plain
    version too."""
    L, As, Ar = 10, 16, 32
    args = [torch.from_numpy(a).to(cuda)
            for a in _ssax_batch_inputs(Q, N, L, W, As, Ar)]
    got = ops.ssax_dist_batch(*args)
    for q in range(Q):
        assert torch.equal(got[q], ops.ssax_dist(
            *args[:2], *(t[q].contiguous() for t in args[2:]))), q
    _close(got.cpu(), ref.ssax_dist_batch_ref(*args).cpu(), TOL["ssax"])


def test_ssax_dist_batch_kernel_takes_clamped_infinite_tables(cuda):
    """The batched tables carry -3.4e38/4 where the breakpoints are
    infinite; every query's sum must be the plain version's."""
    from repro_torch.core.breakpoints import gaussian_breakpoints
    Q, L, W, As, Ar, N = 8, 10, 48, 16, 32, 4096
    bs, br = gaussian_breakpoints(As, 0.8), gaussian_breakpoints(Ar, 0.6)
    seas = torch.from_numpy(RNG.integers(0, As, size=(N, L)).astype(np.int32))
    res = torch.from_numpy(RNG.integers(0, Ar, size=(N, W)).astype(np.int32))
    tabs = ops.make_ssax_query_tables(seas[:Q], res[:Q], bs, br)
    args = [a.to(cuda) for a in (seas, res, *tabs)]
    _close(ops.ssax_dist_batch(*args).cpu(),
           ref.ssax_dist_batch_ref(*args).cpu(), TOL["ssax"])


def test_ssax_dist_batch_kernel_clamps_malformed_symbols(cuda):
    """A symbol outside its alphabet reads the nearest table column, as
    if it had been clamped into the alphabet first."""
    Q, N, L, W, As, Ar = 3, 1000, 10, 48, 16, 32
    seas, res, *tabs = [torch.from_numpy(a).to(cuda) for a in
                        _ssax_batch_inputs(Q, N, L, W, As, Ar)]
    bad_s, bad_r = seas.clone(), res.clone()
    bad_s[::7, 3] = -5
    bad_s[1::7, 0] = As + 9
    bad_r[::5, 17] = Ar
    bad_r[2::5, 40] = -1
    got = ops.ssax_dist_batch(bad_s, bad_r, *tabs)
    want = ops.ssax_dist_batch(bad_s.clamp(0, As - 1),
                               bad_r.clamp(0, Ar - 1), *tabs)
    assert torch.equal(got, want)


@pytest.mark.parametrize("N,T,W", [(4096, 960, 48), (300, 480, 24),
                                   (129, 1920, 96), (3, 20, 20)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paa_kernel_matches_plain(cuda, N, T, W, dtype):
    x = torch.from_numpy(RNG.normal(size=(N, T)).astype(np.float32)).to(
        cuda, getattr(torch, dtype))
    n0 = KERNELS["paa"].launches
    got = ops.paa_segments(x, W)
    torch.cuda.synchronize()
    assert KERNELS["paa"].launches == n0 + 1
    tol = TOL["paa" if dtype == "float32" else "paa_bf16"]
    _close(got.cpu(), ref.paa_ref(x, W).cpu(), tol)


@pytest.mark.parametrize("Q,N,T", [(1, 256, 960), (8, 4096, 960),
                                   (3, 37, 961), (2, 1, 17)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_euclid_kernel_matches_plain(cuda, Q, N, T, dtype):
    dt = getattr(torch, dtype)
    x = torch.from_numpy(RNG.normal(size=(N, T)).astype(np.float32)).to(
        cuda, dt)
    q = torch.from_numpy(RNG.normal(size=(Q, T)).astype(np.float32)).to(
        cuda, dt)
    n0 = KERNELS["euclid"].launches
    got = ops.euclid_batch(x, q)
    torch.cuda.synchronize()
    assert KERNELS["euclid"].launches == n0 + 1
    want = torch.stack([ref.euclid_ref(x, qi) for qi in q])
    tol = TOL["euclid" if dtype == "float32" else "euclid_bf16"]
    _close(got.cpu(), want.cpu(), tol)


def test_euclid_kernel_reduction_order_fixed(cuda):
    """A (query, row) distance is bit-identical whatever batch it is
    computed in and through either entry: alone, in a verification
    batch, gathered from a round's union of rows (any Qa, B and U), or
    in a corpus sweep."""
    x = torch.from_numpy(RNG.normal(size=(2000, 960)).astype(
        np.float32)).to(cuda)
    q = torch.from_numpy(RNG.normal(size=(8, 960)).astype(
        np.float32)).to(cuda)
    full = ops.euclid_batch(x, q).cpu()
    rows = torch.tensor([5, 1999, 0, 777])
    part = ops.euclid_batch(x[rows].contiguous(), q[3:4].contiguous()).cpu()
    assert torch.equal(part[0], full[3, rows])
    one = ops.euclid_batch(x[1999:].contiguous(), q[7]).cpu()
    assert torch.equal(one[0], full[7, 1999])
    for qa, b, u in ((8, 256, 2000), (3, 7, 40), (1, 1, 1), (5, 600, 900)):
        union = torch.from_numpy(RNG.choice(2000, size=u, replace=False))
        qi = torch.from_numpy(RNG.choice(8, size=qa, replace=False))
        g = RNG.integers(0, u, size=(qa, b)).astype(np.int64)
        got = ops.euclid_gather(x[union.to(cuda)].contiguous(),
                                q[qi.to(cuda)].contiguous(), g).cpu()
        want = full[qi[:, None], union[torch.from_numpy(g)]]
        assert torch.equal(got, want), (qa, b, u)


@pytest.mark.parametrize("T", [960, 240, 961, 12_292])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_euclid_gather_kernel_equals_all_pairs(cuda, T, dtype):
    """One gathered launch per round: bitwise the all-pairs kernel on
    the gathered rows, and its plain version within tolerance.  At
    T = 12,292 an f32 query takes more than 48 KB of shared memory."""
    rows, q, g = _gather_inputs(2048, 8, 256, T)
    dt = getattr(torch, dtype)
    rt = torch.from_numpy(rows).to(cuda, dt)
    qt = torch.from_numpy(q).to(cuda, dt)
    n0 = KERNELS["euclid"].launches
    got = ops.euclid_gather(rt, qt, g)
    torch.cuda.synchronize()
    assert KERNELS["euclid"].launches == n0 + 1
    gt = torch.from_numpy(g).to(cuda)
    assert torch.equal(got, ops.euclid_gather(rt, qt, gt))
    every = ops.euclid_batch(rt, qt)
    assert torch.equal(got, torch.gather(every, 1, gt))
    tol = TOL["euclid" if dtype == "float32" else "euclid_bf16"]
    _close(got.cpu(), ref.euclid_gather_ref(rt, qt, gt).cpu(), tol)


@pytest.mark.parametrize("Q,N,T,m,stride",
                         WINDOWED_SHAPES + [(8, 64, 3600, 240, 4),
                                            (9, 3, 5000, 1000, 33)])
def test_windowed_euclid_kernel_matches_plain(cuda, Q, N, T, m, stride):
    x = torch.from_numpy(RNG.normal(size=(N, T)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(_znorm_queries(Q, m)).to(cuda)
    n0 = KERNELS["windowed_euclid"].launches
    got = ops.windowed_euclid(x, q, stride)
    torch.cuda.synchronize()
    assert KERNELS["windowed_euclid"].launches == n0 + 1
    _close(got.cpu(), ref.windowed_euclid_ref(x, q, stride).cpu(),
           TOL["windowed"])


@pytest.mark.parametrize("Q,N,T,m,stride",
                         [(8, 64, 3600, 240, 1), (8, 64, 3600, 240, 3),
                          (8, 64, 3600, 240, 7), (8, 38, 3600, 240, 4),
                          (3, 5, 240, 240, 1), (3, 5, 240, 240, 4),
                          (2, 3, 300, 20, 33)])
def test_windowed_euclid_kernel_strides_and_chunk(cuda, Q, N, T, m, stride):
    """K5 at strides 1, 3, 4 and 7, at scan_topk's 38-row chunk, at m = T
    and with a stride beyond m: the phase-major slab and the windows per
    thread that the shape picks agree with the plain version."""
    x = torch.from_numpy(RNG.normal(size=(N, T)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(_znorm_queries(Q, m)).to(cuda)
    _close(ops.windowed_euclid(x, q, stride).cpu(),
           ref.windowed_euclid_ref(x, q, stride).cpu(), TOL["windowed"])


@pytest.mark.parametrize("stride", [4, 3, 1])
def test_windowed_euclid_kernel_scan_shape_rows_slice(cuda, stride):
    """One launch over the whole scan corpus (2,048 x 3,600, m = 240, 8
    queries), as the smoke run times it; its first 64 rows against the
    plain version on those rows (a row's windows depend on that row
    alone)."""
    x = torch.from_numpy(RNG.normal(size=(2048, 3600)).astype(
        np.float32)).to(cuda)
    q = torch.from_numpy(_znorm_queries(8, 240)).to(cuda)
    got = ops.windowed_euclid(x, q, stride)[:, :64]
    _close(got.cpu(), ref.windowed_euclid_ref(x[:64], q, stride).cpu(),
           TOL["windowed"])


@pytest.mark.parametrize("stride", [1, 3, 7])
def test_windowed_euclid_kernel_offset_and_constant_rows_any_stride(
        cuda, stride):
    x = torch.from_numpy(RNG.normal(size=(16, 3600)).astype(
        np.float32)).to(cuda)
    q = torch.from_numpy(_znorm_queries(8, 240)).to(cuda)
    off = x + 1000.0
    _close(ops.windowed_euclid(off, q, stride).cpu(),
           ref.windowed_euclid_ref(off, q, stride).cpu(), TOL["windowed"])
    const = torch.full((2, 1000), 2.5, device=cuda)
    got = ops.windowed_euclid(const, q, stride).cpu()
    want = q.square().sum(-1).cpu()[:, None, None].expand_as(got)
    _close(got, want, TOL["windowed"])


def test_windowed_euclid_kernel_offset_and_constant_rows(cuda):
    """Rows offset by 1000 do not cancel (two-pass window statistics),
    and a constant window gives exactly sum(q^2)."""
    x = torch.from_numpy(RNG.normal(size=(16, 3600)).astype(
        np.float32)).to(cuda)
    q = torch.from_numpy(_znorm_queries(8, 240)).to(cuda)
    off = x + 1000.0
    _close(ops.windowed_euclid(off, q, 4).cpu(),
           ref.windowed_euclid_ref(off, q, 4).cpu(), TOL["windowed"])
    const = torch.full((2, 1000), 2.5, device=cuda)
    got = ops.windowed_euclid(const, q, 4).cpu()
    want = q.square().sum(-1).cpu()[:, None, None].expand_as(got)
    _close(got, want, TOL["windowed"])


def test_kernels_reject_wrong_dtypes_on_card(cuda):
    with pytest.raises(TypeError):
        ops.euclid_batch(torch.zeros(4, 8, device=cuda, dtype=torch.float64),
                         torch.zeros(8, device=cuda, dtype=torch.float64))
    with pytest.raises(TypeError):
        ops.sax_dist(torch.zeros(4, 8, device=cuda, dtype=torch.int64),
                     torch.zeros(8, 4, device=cuda))
    with pytest.raises(TypeError):
        ops.euclid_gather(torch.zeros(4, 8, device=cuda,
                                      dtype=torch.float64),
                          torch.zeros(1, 8, device=cuda,
                                      dtype=torch.float64),
                          np.zeros((1, 2), np.int64))
    with pytest.raises(ValueError):
        ops.euclid_gather(torch.zeros(4, 8, device=cuda),
                          torch.zeros(1, 8, device=cuda),
                          torch.full((1, 2), 4, device=cuda))
    with pytest.raises(ValueError):       # a query beyond shared memory
        ops.euclid_batch(torch.zeros(2, 58_113, device=cuda),
                         torch.zeros(58_113, device=cuda))
    with pytest.raises(TypeError):
        ops.windowed_euclid(torch.zeros(4, 8, device=cuda,
                                        dtype=torch.float64),
                            torch.zeros(4, device=cuda, dtype=torch.float64))
    with pytest.raises(TypeError):
        ops.ssax_dist_batch(*(torch.zeros(4, 3, device=cuda,
                                          dtype=torch.int64),) * 2,
                            *(torch.zeros(2, 3, 4, device=cuda),) * 4)
    with pytest.raises(ValueError):       # L + W beyond the staged rows
        ops.ssax_dist_batch(torch.zeros(4, 10, device=cuda,
                                        dtype=torch.int32),
                            torch.zeros(4, 444, device=cuda,
                                        dtype=torch.int32),
                            *(torch.zeros(2, 10, 4, device=cuda),) * 2,
                            *(torch.zeros(2, 444, 4, device=cuda),) * 2)


def test_launch_counter_loses_no_count_across_threads(monkeypatch):
    """``CudaKernel.launch`` counts under a lock: 16 threads launching a
    stubbed entry point at once lose no count, and a failed launch
    raises and counts nothing.  The stub stands in for the C entry and
    the stream lookup, so this runs without a card."""
    import contextlib
    import threading
    import types
    from repro_torch.kernels._lib import CudaKernel
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=None))
    k = CudaKernel("stub", "repro_stub", [], more={"repro_fail": []})
    k._fns["repro_stub"] = lambda stream: 0
    k._fns["repro_fail"] = lambda stream: 700
    n_threads, per = 16, 2000
    start = threading.Barrier(n_threads)
    dev = torch.device("cuda")

    def run():
        start.wait()
        for _ in range(per):
            k.launch(dev)

    threads = [threading.Thread(target=run) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert k.launches == n_threads * per
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        k.launch(dev, symbol="repro_fail")
    assert k.launches == n_threads * per

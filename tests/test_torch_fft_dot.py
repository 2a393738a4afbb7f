"""The port's FFT sliding dot product (``repro_torch.kernels.fft_dot``)
on the CPU, held against the JAX package's ``kernels.fft_dot`` and
against the accumulation paths.

The FFT path is not bitwise: dot products agree with the explicit-window
oracle (``ref.sliding_dot_ref``), the m-step accumulation and the
reference's jax functions within ``fft_tolerance(m)`` (its atol widened
by the operand scale, as the reference's property tests do), and squared
distances agree with K5's plain version and the reference's FFT path
within ``fft_tolerance(m)`` itself.  The accumulation twin stays within
rtol 1e-5 of the oracle.  Cases are drawn from numpy seeds over the
reference property tests' ranges (m, stride, ragged T, scale, offset);
the one-query-against-batch FFT result is compared within the contract,
not bitwise.  On a card, the FFT path is held against K5 the same way."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import KERNELS, ops, ref  # noqa: E402
from repro_torch.kernels.fft_dot import (  # noqa: E402
    FFT_ATOL_PER_M, FFT_RTOL, fft_tolerance, sliding_dot_accum,
    sliding_dot_fft, windowed_euclid_fft)

# (m, stride, extra samples past the window grid, rows, queries, scale,
# offset, seed)
CASES = [(8, 1, 0, 1, 1, 1.0, 0.0, 0), (24, 2, 5, 3, 2, 7.0, 3.0, 1),
         (33, 5, 17, 4, 3, 1.0, 3.0, 2), (64, 3, 9, 2, 1, 7.0, 0.0, 3),
         (240, 4, 120, 3, 2, 1.0, 0.0, 4), (240, 1, 0, 2, 3, 7.0, 3.0, 5)]


def _case(m, stride, extra, n, q_n, scale, shift, seed):
    rng = np.random.default_rng(seed)
    T = m + 2 * stride + extra
    x = (scale * rng.normal(size=(n, T)) + shift).astype(np.float32)
    q = rng.normal(size=(q_n, m)).astype(np.float32)
    q = (q - q.mean(1, keepdims=True)) \
        / np.maximum(q.std(1, keepdims=True), 1e-6)
    return x, q


def _dot_tol(m, x):
    scale = max(1.0, float(np.abs(x).max()))
    tol = fft_tolerance(m)
    return dict(rtol=tol["rtol"], atol=tol["atol"] * scale)


@pytest.fixture(scope="module")
def jfft():
    pytest.importorskip("jax")
    from repro.kernels import fft_dot
    return fft_dot


def test_tolerance_contract_is_the_reference_s(jfft):
    assert (FFT_RTOL, FFT_ATOL_PER_M) == (jfft.FFT_RTOL, jfft.FFT_ATOL_PER_M)
    for m in (8, 240, 1000):
        assert fft_tolerance(m) == jfft.fft_tolerance(m)


@pytest.mark.parametrize("case", CASES)
def test_sliding_dot_paths_agree_with_oracle_and_reference(case, jfft):
    x, q = _case(*case)
    m, stride = case[0], case[1]
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    d_fft = sliding_dot_fft(xt, qt, stride).numpy()
    d_acc = sliding_dot_accum(xt, qt, stride).numpy()
    d_ref = ref.sliding_dot_ref(xt, qt, stride).numpy()
    assert d_fft.shape == d_acc.shape == d_ref.shape
    assert d_fft.dtype == np.float32
    tol = _dot_tol(m, x)
    np.testing.assert_allclose(d_fft, d_ref, **tol)
    np.testing.assert_allclose(d_fft, d_acc, **tol)
    scale = max(1.0, float(np.abs(x).max()))
    np.testing.assert_allclose(d_acc, d_ref, rtol=1e-5,
                               atol=1e-4 * scale * m)
    # against the reference's own jax functions
    np.testing.assert_allclose(
        d_fft, np.asarray(jfft.sliding_dot_fft(x, q, stride=stride)), **tol)
    np.testing.assert_allclose(
        d_acc, np.asarray(jfft.sliding_dot_accum(x, q, stride=stride)),
        rtol=1e-5, atol=1e-4 * scale * m)


@pytest.mark.parametrize("case", CASES)
def test_fft_distance_within_contract(case, jfft):
    """The full expansion: the FFT path against K5's plain version, the
    accumulation route of ``ops.windowed_euclid`` and the reference's
    FFT path, within ``fft_tolerance(m)``."""
    x, q = _case(*case)
    m, stride = case[0], case[1]
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    d_fft = windowed_euclid_fft(xt, qt, stride).numpy()
    tol = fft_tolerance(m)
    np.testing.assert_allclose(
        d_fft, ref.windowed_euclid_ref(xt, qt, stride).numpy(), **tol)
    np.testing.assert_allclose(
        d_fft, ops.windowed_euclid(xt, qt, stride=stride).numpy(), **tol)
    np.testing.assert_allclose(
        d_fft, np.asarray(jfft.windowed_euclid_fft(x, q, stride=stride)),
        **tol)
    assert (d_fft >= 0).all()


@pytest.mark.parametrize("case", CASES[:4])
def test_ops_method_dispatch(case):
    """``ops.windowed_euclid(method="fft")`` is the FFT path; 1-D
    queries keep the (N, S) shape; ``ops.sliding_dot`` dispatches both
    dot formulations (the one-query FFT result is held within the
    contract, not bitwise)."""
    x, q = _case(*case)
    m, stride = case[0], case[1]
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    d_fft = ops.windowed_euclid(xt, qt, stride=stride, method="fft")
    assert torch.equal(d_fft, windowed_euclid_fft(xt, qt, stride))
    one = ops.windowed_euclid(xt, qt[0], stride=stride, method="fft")
    assert one.shape == d_fft.shape[1:]
    np.testing.assert_allclose(one.numpy(), d_fft[0].numpy(),
                               **fft_tolerance(m))
    s_fft = ops.sliding_dot(xt, qt, stride=stride)
    s_acc = ops.sliding_dot(xt, qt, stride=stride, method="accum")
    assert torch.equal(s_fft, sliding_dot_fft(xt, qt, stride))
    assert torch.equal(s_acc, sliding_dot_accum(xt, qt, stride))
    assert ops.sliding_dot(xt, qt[0], stride=stride).shape == \
        s_fft.shape[1:]


def test_unknown_method_raises():
    x, q = torch.zeros(2, 50), torch.zeros(1, 10)
    with pytest.raises(ValueError, match="method"):
        ops.windowed_euclid(x, q, method="nope")
    with pytest.raises(ValueError, match="method"):
        ops.sliding_dot(x, q, method="nope")
    with pytest.raises(ValueError):
        sliding_dot_fft(x, torch.zeros(1, 51))           # m > T
    with pytest.raises(ValueError):
        windowed_euclid_fft(x, q, stride=0)


def test_zero_variance_windows_follow_kernel_convention(jfft):
    """Constant windows z-normalize to zero: the FFT expansion gives the
    kernel's d2 = sum(q^2) there, as the reference's does."""
    x = np.ones((2, 60), np.float32)
    x[1, 30:] = np.linspace(0, 1, 30)
    q = np.random.default_rng(0).normal(size=(2, 12)).astype(np.float32)
    q = (q - q.mean(1, keepdims=True)) / q.std(1, keepdims=True)
    d_fft = windowed_euclid_fft(x, q, stride=1).numpy()
    q_ss = np.sum(q * q, axis=1)
    np.testing.assert_allclose(
        d_fft[:, 0, :], np.broadcast_to(q_ss[:, None], d_fft[:, 0].shape),
        rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        d_fft, ref.windowed_euclid_ref(torch.from_numpy(x),
                                       torch.from_numpy(q), 1).numpy(),
        **fft_tolerance(12))
    np.testing.assert_allclose(
        d_fft, np.asarray(jfft.windowed_euclid_fft(x, q, stride=1)),
        **fft_tolerance(12))


def test_numpy_inputs_land_on_the_cpu():
    x, q = _case(*CASES[1])
    out = windowed_euclid_fft(x, q, stride=2)
    assert out.device.type == "cpu" and out.dtype == torch.float32


@pytest.mark.parametrize("stride", [4, 1])
def test_fft_on_card_agrees_with_k5(stride):
    """On the card the FFT path (cuFFT) agrees with K5 within the
    contract, and makes no K5 launch itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 runs only there")
    x, q = _case(240, stride, 360, 16, 4, 1.0, 0.0, 9)
    xt, qt = torch.from_numpy(x).cuda(), torch.from_numpy(q).cuda()
    k5 = KERNELS["windowed_euclid"]
    before = k5.launches
    fft = ops.windowed_euclid(xt, qt, stride=stride, method="fft")
    assert k5.launches == before and fft.device.type == "cuda"
    acc = ops.windowed_euclid(xt, qt, stride=stride)
    assert k5.launches == before + 1
    np.testing.assert_allclose(fft.cpu().numpy(), acc.cpu().numpy(),
                               **fft_tolerance(240))

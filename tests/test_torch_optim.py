"""The port's optimizer substrate (``repro_torch.optim``) against the JAX
package's, from the same numpy state.

* AdamW: one update with f32 and with bf16 moments within rtol 1e-6 /
  atol 1e-9 (f32; the global norm's sum and ``b ** t`` round apart by
  an ulp or so) and one bf16 ulp (bf16 moments); decoupled decay only on
  leaves with ndim >= 2; the clip as ``test_optim_substrate.py`` specs it.
* The cosine schedule at its corners within 1 f32 ulp of 1.0 (rtol 2e-7).
* int8 quantize / dequantize, ``compress_grads`` and error feedback
  bitwise (both libraries divide, round half to even and multiply in
  f32); the ``compress_rel_err`` metric, a sum in another order, within
  rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro.optim.schedule import cosine_schedule as ref_cosine

from repro_torch.models.transformer import tree_leaves_with_path, tree_map
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, global_norm)
from repro_torch.optim import compression as comp

RTOL, ATOL = 1e-6, 1e-9
SHAPES = {"w": (16, 24), "stack": (3, 8, 8), "b": (24,), "scale": (5,)}


def numpy_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def to_torch(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def to_jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def as_np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_tree_close(got, want, rtol=RTOL, atol=ATOL):
    w = {k: v for k, v in want.items()}
    for path, g in tree_leaves_with_path(got):
        key = path[2:-2]
        np.testing.assert_allclose(as_np(g), as_np(w[key]), rtol=rtol,
                                   atol=atol, err_msg=path)


@pytest.mark.parametrize("step", [0, 7])
@pytest.mark.parametrize("lr_scale", [1.0, 0.37])
def test_adamw_f32_matches_reference(step, lr_scale):
    p, g = numpy_tree(0), numpy_tree(1, scale=0.05)
    m, v = numpy_tree(2, 0.01), tree_map(np.abs, numpy_tree(3, 1e-4))
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1)
    ref_cfg = ref_adamw.AdamWConfig(lr=1e-2, weight_decay=0.1)
    got_p, got_o, got_m = adamw_update(
        cfg, to_torch(p), to_torch(g), {"m": to_torch(m), "v": to_torch(v)},
        torch.tensor(step, dtype=torch.int32),
        lr_scale=torch.tensor(lr_scale))
    want_p, want_o, want_m = ref_adamw.adamw_update(
        ref_cfg, to_jax(p), to_jax(g), {"m": to_jax(m), "v": to_jax(v)},
        jnp.asarray(step, jnp.int32), lr_scale=jnp.float32(lr_scale))
    assert_tree_close(got_p, want_p)
    assert_tree_close(got_o["m"], want_o["m"])
    assert_tree_close(got_o["v"], want_o["v"])
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=RTOL)
    for k in p:
        assert got_p[k].dtype == torch.float32


def test_adamw_bf16_moments_match_reference():
    """bf16 moments are up-cast each step and stored back in bf16: the
    port's within one bf16 ulp of the reference's, params in f32."""
    p, g = numpy_tree(4), numpy_tree(5, scale=0.5)
    cfg, ref_cfg = AdamWConfig(lr=1e-3), ref_adamw.AdamWConfig(lr=1e-3)
    opt = adamw_init(to_torch(p), dtype=torch.bfloat16)
    ref_opt = ref_adamw.adamw_init(to_jax(p), dtype=jnp.bfloat16)
    params, ref_params = to_torch(p), to_jax(p)
    for step in range(3):
        params, opt, _ = adamw_update(cfg, params, to_torch(g), opt,
                                      torch.tensor(step, dtype=torch.int32))
        ref_params, ref_opt, _ = ref_adamw.adamw_update(
            ref_cfg, ref_params, to_jax(g), ref_opt,
            jnp.asarray(step, jnp.int32))
    for k in ("m", "v"):
        for _, leaf in tree_leaves_with_path(opt[k]):
            assert leaf.dtype == torch.bfloat16
        assert_tree_close(opt[k], ref_opt[k], rtol=2 ** -7, atol=0)
    assert_tree_close(params, ref_params, rtol=1e-5, atol=1e-7)


def test_decay_only_on_matrices():
    """With zero gradients the update is the decoupled decay alone: it
    shrinks the ndim >= 2 leaves by lr * wd * p and leaves vectors as
    they are."""
    p = to_torch(numpy_tree(6))
    zeros = tree_map(torch.zeros_like, p)
    cfg = AdamWConfig(lr=0.5, weight_decay=0.1)
    new, _, _ = adamw_update(cfg, p, zeros, adamw_init(p), 0)
    for k in ("w", "stack"):
        torch.testing.assert_close(new[k], p[k] - 0.5 * 0.1 * p[k],
                                   rtol=1e-6, atol=0)
    for k in ("b", "scale"):
        assert torch.equal(new[k], p[k])


def test_grad_clip_limits_global_norm():
    """``test_optim_substrate.py``'s spec: a gradient of norm 200 reports
    200 and updates with the clipped gradient, as the reference."""
    params = {"w": torch.ones(4)}
    grads = {"w": 100.0 * torch.ones(4)}
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    new, opt, metrics = adamw_update(cfg, params, grads, adamw_init(params),
                                     torch.zeros((), dtype=torch.int32))
    assert float(metrics["grad_norm"]) == 200.0
    ref_cfg = ref_adamw.AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    ref_p = {"w": jnp.ones((4,))}
    want, ref_opt, _ = ref_adamw.adamw_update(
        ref_cfg, ref_p, {"w": 100.0 * jnp.ones((4,))},
        ref_adamw.adamw_init(ref_p), jnp.zeros((), jnp.int32))
    np.testing.assert_array_equal(opt["m"]["w"].numpy(),
                                  np.asarray(ref_opt["m"]["w"]))
    np.testing.assert_allclose(new["w"].numpy(), np.asarray(want["w"]),
                               rtol=RTOL)
    # m after one step = (1 - b1) * g * clip: the clipped gradient's norm
    assert abs(float(opt["m"]["w"].norm()) / (1 - cfg.b1) - 1.0) < 1e-5


def test_global_norm_matches_reference():
    g = numpy_tree(7)
    np.testing.assert_allclose(float(global_norm(to_torch(g))),
                               float(ref_adamw.global_norm(to_jax(g))),
                               rtol=RTOL)


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0]), "b": torch.tensor([[2.0, 2.0]])}
    target = {"w": torch.tensor([1.0, 1.0]), "b": torch.zeros((1, 2))}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    for i in range(300):
        grads = {k: 2 * (params[k] - target[k]) for k in params}
        params, opt, _ = adamw_update(cfg, params, grads, opt, i)
    loss = sum(float(((params[k] - target[k]) ** 2).sum()) for k in params)
    assert loss < 1e-3


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 5), (3, 3)])
def test_cosine_schedule_matches_reference(warmup, total):
    steps = sorted({0, 1, max(warmup - 1, 0), warmup, warmup + 1,
                    (warmup + total) // 2, total - 1, total, total + 5})
    for s in steps:
        for arg in (s, torch.tensor(s, dtype=torch.int32)):
            got = cosine_schedule(arg, warmup=warmup, total=total)
            assert got.dtype == torch.float32 and got.ndim == 0
            want = ref_cosine(jnp.asarray(s, jnp.int32), warmup=warmup,
                              total=total)
            np.testing.assert_allclose(float(got), float(want), rtol=2e-7,
                                       atol=0, err_msg=f"step {s}")


def test_cosine_schedule_shape():
    s = lambda t: float(cosine_schedule(t, warmup=10, total=100))
    assert s(0) == 0.0
    assert abs(s(10) - 1.0) < 1e-5
    assert s(50) < 1.0
    assert abs(s(100) - 0.1) < 1e-2


@pytest.mark.parametrize("shape", [(256, 64), (7, 300), (3, 5, 17), (1000,)])
def test_quant_int8_bitwise(shape):
    rng = np.random.default_rng(sum(shape))
    g = rng.standard_normal(shape).astype(np.float32)
    g.reshape(-1)[:3] = 0.0
    q, scale, shp, pad = comp._quant_int8(torch.from_numpy(g))
    rq, rscale, rshp, rpad = ref_comp._quant_int8(jnp.asarray(g))
    assert (shp, pad) == (tuple(rshp), rpad)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(rscale))
    np.testing.assert_array_equal(
        comp._dequant_int8(q, scale, shp, pad).numpy(),
        np.asarray(ref_comp._dequant_int8(rq, rscale, rshp, rpad)))
    np.testing.assert_array_equal(
        comp.quantize_dequantize(torch.from_numpy(g)).numpy(),
        np.asarray(ref_comp.quantize_dequantize(jnp.asarray(g))))


def test_quant_int8_rounds_half_to_even():
    """A block of max 127 has scale 1: x.5 values round to the even
    integer in both libraries."""
    g = np.zeros(256, np.float32)
    g[:6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    q, _, _, _ = comp._quant_int8(torch.from_numpy(g))
    assert q.reshape(-1)[:6].tolist() == [127, 0, 2, 2, 0, -2]
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(ref_comp._quant_int8(jnp.asarray(g))[0]))


def test_compress_grads_matches_reference():
    g = numpy_tree(8)
    got, metrics = comp.compress_grads(to_torch(g))
    want, ref_metrics = ref_comp.compress_grads(to_jax(g))
    assert_tree_close(got, want, rtol=0, atol=0)
    for k in ("b", "scale"):                  # ndim < 2 stays exact
        np.testing.assert_array_equal(got[k].numpy(), g[k])
    np.testing.assert_allclose(float(metrics["compress_rel_err"]),
                               float(ref_metrics["compress_rel_err"]),
                               rtol=1e-5)
    assert 0 < float(metrics["compress_rel_err"]) < 0.01
    same, none = comp.compress_grads(to_torch(g), method="none")
    assert none == {} and all(torch.equal(same[k], torch.from_numpy(g[k]))
                              for k in g)
    with pytest.raises(ValueError):
        comp.compress_grads(to_torch(g), method="fp4")


def test_compress_grads_vectors_only():
    """No leaf to compress: the error metric is 0, as the reference's."""
    g = {"b": torch.ones(32)}
    out, metrics = comp.compress_grads(g)
    _, ref_metrics = ref_comp.compress_grads({"b": jnp.ones((32,))})
    assert torch.equal(out["b"], g["b"])
    assert float(metrics["compress_rel_err"]) == \
        float(ref_metrics["compress_rel_err"]) == 0.0


def test_error_feedback_matches_reference():
    g = numpy_tree(9)
    ef = comp.init_error_feedback(to_torch(g))
    ref_ef = ref_comp.init_error_feedback(to_jax(g))
    assert_tree_close(ef, ref_ef, rtol=0, atol=0)
    for i in range(5):
        gi = numpy_tree(10 + i)
        out, ef = comp.error_feedback_update(to_torch(gi), ef)
        ref_out, ref_ef = ref_comp.error_feedback_update(to_jax(gi), ref_ef)
        assert_tree_close(out, ref_out, rtol=0, atol=0)
        assert_tree_close(ef, ref_ef, rtol=0, atol=0)


def test_error_feedback_reduces_bias():
    rng = np.random.default_rng(1)
    g_true = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    ef = comp.init_error_feedback({"w": g_true})["w"]
    applied = torch.zeros_like(g_true)
    for _ in range(20):
        out, ef_new = comp.error_feedback_update({"w": g_true}, {"w": ef})
        applied = applied + out["w"]
        ef = ef_new["w"]
    target = 20 * g_true
    assert float((applied - target).norm() / target.norm()) < 1e-3

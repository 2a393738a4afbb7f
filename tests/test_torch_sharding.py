"""The port's sharding rules and abstract state against the JAX
package's, and its group-local MoE dispatch, on the CPU.

* ``param_pspecs``, ``train_state_pspecs`` and ``decode_specs``' cache
  and token pspecs equal the reference's entry for entry, for all ten
  architectures at their published widths on the (16, 16) and (2, 16,
  16) production meshes, with and without the optimized-serve overrides
  and ``seq_sharded``.  The reference's rules read only a mesh's
  ``axis_names`` and ``shape``, so it gets a stand-in with those two.
* ``abstract_train_state`` has the reference's shapes and dtypes, f32
  and the bf16 low-memory form.
* The grouped MoE (``moe_groups = 4``) equals the reference's, forward
  and aux terms, within rtol 1e-5 in f32, on weights carried across by
  ``params_from_reference``; and the port's grouped dispatch equals its
  ungrouped one at capacity factor 64 within the reference's rtol 2e-2 /
  atol 2e-3.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as RefP  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.launch.inputs import decode_specs as ref_decode_specs  # noqa
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.sharding.specs import ShardingRules as RefRules  # noqa: E402
from repro.train.state import abstract_train_state as ref_abstract  # noqa
from repro.train.state import train_state_pspecs as ref_state_ps  # noqa

from repro_torch.configs import ARCHITECTURES, SHAPES, get_config  # noqa
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.launch.dryrun import OPTIMIZED_SERVE  # noqa: E402
from repro_torch.launch.inputs import decode_specs  # noqa: E402
from repro_torch.launch.mesh import MeshSpec, make_production_mesh  # noqa
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    RunConfig, param_logical_dims, param_pspecs, tree_leaves_with_path)
from repro_torch.sharding import (  # noqa: E402
    PartitionSpec, ShardingRules, constrain, placements, spec_placements)
from repro_torch.train.state import (  # noqa: E402
    abstract_train_state, train_state_pspecs)

from test_torch_models import CHUNKS, make_batch, ref_weights, to_jax  # noqa

SERVE = {k: v for k, v in OPTIMIZED_SERVE["rules_overrides"].items()
         if k != "moe_groups"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stand_in(mesh: MeshSpec):
    return types.SimpleNamespace(axis_names=mesh.axis_names, shape=mesh.shape)


def rule_pairs(multi_pod: bool):
    """(label, reference rules, port rules) for one production mesh."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    for seq in (False, True):
        for label, over in (("default", {}), ("serve", SERVE)):
            yield (f"{label}-seq{int(seq)}",
                   RefRules.for_mesh(_stand_in(mesh),
                                     seq_sharded=seq).with_overrides(**over),
                   ShardingRules.for_mesh(mesh,
                                          seq_sharded=seq).with_overrides(
                                              **over))


def ref_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefP))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def port_specs(tree) -> dict:
    return {p: tuple(s) for p, s in tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["1pod", "2pod"])
@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_param_and_state_pspecs_equal_reference(arch, multi_pod):
    for label, ref_rules, rules in rule_pairs(multi_pod):
        want = ref_specs(ref_state_ps(ref_get_config(arch), ref_rules))
        got = port_specs(train_state_pspecs(get_config(arch), rules))
        assert got == want, label
        assert port_specs(param_pspecs(get_config(arch), rules)) == \
            ref_specs(ref_T.param_pspecs(ref_get_config(arch), ref_rules))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["1pod", "2pod"])
@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_decode_pspecs_equal_reference(arch, multi_pod):
    for label, ref_rules, rules in rule_pairs(multi_pod):
        for shape in ("decode_32k", "long_500k"):
            (_, _), (ref_cache, ref_tok) = ref_decode_specs(
                ref_get_config(arch), REF_SHAPES[shape], ref_rules)
            (cache, tok), (cache_ps, tok_ps) = decode_specs(
                get_config(arch), SHAPES[shape], rules)
            assert port_specs(cache_ps) == ref_specs(ref_cache), \
                (label, shape)
            assert tuple(tok_ps) == tuple(ref_tok)
            assert {a.device.type for _, a in
                    tree_leaves_with_path(cache)} == {"meta"}


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_param_logical_dims_equal_reference(arch):
    want = {jax.tree_util.keystr(p): d for p, d in
            jax.tree_util.tree_flatten_with_path(
                ref_T.param_logical_dims(ref_get_config(arch)),
                is_leaf=lambda x: isinstance(x, tuple))[0]}
    got = dict(tree_leaves_with_path(param_logical_dims(get_config(arch)),
                                     is_leaf=lambda x: isinstance(x, tuple)))
    assert got == want


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_abstract_train_state_equals_reference(arch):
    for kw, ref_kw in (({}, {}),
                       (dict(opt_dtype=torch.bfloat16,
                             param_dtype=torch.bfloat16),
                        dict(opt_dtype=jnp.bfloat16,
                             param_dtype=jnp.bfloat16))):
        want = {jax.tree_util.keystr(p): (tuple(s.shape), str(s.dtype))
                for p, s in jax.tree_util.tree_flatten_with_path(
                    ref_abstract(ref_get_config(arch), **ref_kw))[0]}
        st = abstract_train_state(get_config(arch), **kw)
        got = {p: (tuple(a.shape), str(a.dtype).removeprefix("torch."))
               for p, a in tree_leaves_with_path(st)}
        assert got == want
        assert {a.device.type for _, a in tree_leaves_with_path(st)} == \
            {"meta"}


def test_placements_follow_the_pspec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    rules = ShardingRules.for_mesh(mesh)
    # embed (vocab, d): vocab over model, d over (pod, data)
    assert rules.pspec(("vocab", "d"), (151_936, 1024)) == \
        PartitionSpec("model", ("pod", "data"))
    assert placements(rules, ("vocab", "d"), (151_936, 1024)) == \
        (Shard(1), Shard(1), Shard(0))
    assert placements(rules, ("vec",), (7,)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        spec_placements(mesh, PartitionSpec(("data", "pod")))
    x = torch.zeros(3)
    assert constrain(x, rules, ("vec",)) is x


class _Rules:
    """A rules stand-in that asks for group-local dispatch and shards
    nothing (the reference's test's ``FakeRules``)."""
    mesh = None
    moe_groups = 4

    def pspec(self, dims, shape):
        return RefP()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-1.5-large-398b",
                                  "llama4-scout-17b-a16e"])
def test_grouped_moe_matches_reference(arch):
    """The whole model with ``moe_groups = 4``: hidden states and the MoE's
    aux terms against the reference's, f32."""
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)),
                                  compute_dtype="float32")
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype="float32")
    ref_model = ref_build_model(ref_cfg, _Rules(),
                                rc=ref_T.RunConfig(**CHUNKS))
    model = build_model(cfg, _Rules(), rc=RunConfig(**CHUNKS), device="cpu")
    tree = ref_weights(ref_cfg)
    params = model.params_from_reference(tree)
    batch = make_batch(cfg, B=4)
    h, aux = model.hidden_states(params, batch)
    ref_h, ref_aux = ref_model.hidden_states(jax.tree.map(jnp.asarray, tree),
                                             to_jax(batch))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), rtol=1e-5,
                               atol=1e-5)
    for name in ref_aux:
        np.testing.assert_allclose(float(aux[name]), float(ref_aux[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    # the MoE alone, on the first MoE block's weights
    i = next(i for i, sp in enumerate(cfg.pattern) if sp.moe)
    w = {k: v[0] for k, v in tree["blocks"][i]["mlp"].items()}
    x = np.random.default_rng(3).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    got_aux, want_aux = {}, {}
    got = moe.moe_mlp({k: torch.as_tensor(v) for k, v in w.items()},
                      torch.as_tensor(x), cfg, rules=_Rules(), aux=got_aux)
    want = ref_moe.moe_mlp({k: jnp.asarray(v) for k, v in w.items()},
                           jnp.asarray(x), ref_cfg, _Rules(), aux=want_aux)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    for name in want_aux:
        np.testing.assert_allclose(float(got_aux[name]),
                                   float(want_aux[name]), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_grouped_dispatch_matches_ungrouped():
    """At a generous capacity no token is dropped either way, so the
    group-local dispatch equals the ungrouped one."""
    cfg = dataclasses.replace(reduced(get_config("olmoe-1b-7b")),
                              compute_dtype="float32", capacity_factor=64.0)
    rng = np.random.default_rng(7)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_e
    p = {"router": rng.standard_normal((d, E)) * 0.02,
         "w_gate": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    p = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in p.items()}
    x = torch.as_tensor(rng.standard_normal((4, 16, d)), dtype=torch.float32)
    aux0, aux1 = {}, {}
    y0 = moe.moe_mlp(p, x, cfg, aux=aux0)
    y1 = moe.moe_mlp(p, x, cfg, rules=_Rules(), aux=aux1)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=2e-2, atol=2e-3)
    assert float(aux0["dropped_frac"]) == float(aux1["dropped_frac"]) == 0.0
    np.testing.assert_allclose(float(aux1["load_balance"]),
                               float(aux0["load_balance"]), rtol=1e-6)

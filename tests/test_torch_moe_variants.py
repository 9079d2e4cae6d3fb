"""The PyTorch port's remaining MoE pieces against the JAX package: the
Sinkhorn and group-limited routers, shared experts, the MoE layer with each
router and every expert bank (float under both dispatch modes, int8, fp8,
MX fp4 and fp8), a DBRX-shaped Mixtral, the DBRX config, the MoE config
validator and token shuffling."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from neuronx_distributed_tpu.models import mixtral as jm
from neuronx_distributed_tpu.modules.moe import model as jmodel
from neuronx_distributed_tpu.modules.moe import routing as jrouting
from neuronx_distributed_tpu.modules.moe import token_shuffling as jshuf
from neuronx_distributed_tpu.modules.moe import validate_moe_config as jval
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.quantization import mx_layers as jmxl
from neuronx_distributed_tpu.quantization import quantization_layers as jql
from neuronx_distributed_tpu.quantization import quantization_utils as jqu
from neuronx_distributed_tpu_torch.config import (configure_model,
                                                  neuronx_distributed_config)
from neuronx_distributed_tpu_torch.models import mixtral as tm
from neuronx_distributed_tpu_torch.models.convert import (load_jax_params,
                                                          params_from_jax)
from neuronx_distributed_tpu_torch.modules.moe import model as tmodel
from neuronx_distributed_tpu_torch.modules.moe import routing as trouting
from neuronx_distributed_tpu_torch.modules.moe import token_shuffling as tshuf
from neuronx_distributed_tpu_torch.modules.moe import validate_moe_config \
    as tval


@pytest.fixture(autouse=True)
def _mesh():
    ps.initialize_model_parallel()
    yield
    ps.destroy_model_parallel()


def _t(a):
    """A numpy or JAX array as torch, fp8 crossing as its bytes."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _rel(got, ref):
    ref = np.asarray(ref, np.float32)
    return (np.abs(got.detach().float().numpy() - ref).max()
            / max(np.abs(ref).max(), 1e-30))


ROUTERS = [
    ("top_k", dict(top_k=2), 4),
    ("sinkhorn", dict(), 4),
    ("sinkhorn", dict(), 16),
    ("group_limited", dict(top_k=2, num_groups=2, topk_groups=1), 4),
    ("group_limited", dict(top_k=2, num_groups=4, topk_groups=1), 8),
    ("group_limited", dict(top_k=4, num_groups=4, topk_groups=2), 16),
]


@pytest.mark.parametrize("kind,kw,e", ROUTERS)
def test_routers_match_jax(kind, kw, e):
    """Indices equal JAX's; gates and both aux losses within 1e-6. A
    group-limited token's experts come from its allowed groups only."""
    rng = np.random.RandomState(e + len(kw))
    h, t = 16, 48
    x = rng.randn(t, h).astype(np.float32)
    kernel = rng.randn(h, e).astype(np.float32)
    jcls, tcls = jmodel.ROUTERS[kind], tmodel.ROUTERS[kind]
    gates, idx, aux = jcls(num_experts=e, dtype=jnp.float32, **kw).apply(
        {"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x))
    router = tcls(h, e, **kw)
    with torch.no_grad():
        router.kernel.copy_(torch.from_numpy(kernel))
        tg, ti, taux = router(torch.from_numpy(x))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))
    np.testing.assert_allclose(tg.numpy(), np.asarray(gates), atol=1e-6)
    for name in ("load_balance_loss", "z_loss"):
        np.testing.assert_allclose(taux[name].item(), float(aux[name]),
                                   rtol=1e-6, atol=1e-6)
    if kind == "group_limited":
        per = e // kw["num_groups"]
        assert all(len(set(r)) <= kw["topk_groups"]
                   for r in (ti // per).tolist())


@pytest.mark.parametrize("kw,match", [
    (dict(num_experts=8, top_k=3, num_groups=4, topk_groups=1), "exceeds"),
    (dict(num_experts=6, top_k=2, num_groups=4, topk_groups=1),
     "num_groups"),
])
def test_group_limited_router_raises_as_jax(kw, match):
    x = jnp.zeros((4, 8))
    e = kw.pop("num_experts")
    with pytest.raises(ValueError, match=match):
        jrouting.GroupLimitedRouter(num_experts=e, **kw).init(
            jax.random.key(0), x)
    with pytest.raises(ValueError, match=match):
        trouting.GroupLimitedRouter(8, e, **kw)


def test_shared_experts_match_jax():
    rng = np.random.RandomState(3)
    h, i = 16, 24
    x = rng.randn(10, h).astype(np.float32)
    params = {"gate_up_kernel": rng.randn(h, 2, i).astype(np.float32) * .3,
              "down": {"kernel": rng.randn(i, h).astype(np.float32) * .3}}
    ref = jmodel.SharedExperts(hidden_size=h, intermediate_size=i,
                               dtype=jnp.float32).apply(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x))
    mod = tmodel.SharedExperts(h, i, dtype=torch.float32)
    mod.load_state_dict({"gate_up_kernel": _t(params["gate_up_kernel"]),
                         "down.kernel": _t(params["down"]["kernel"])})
    assert _rel(mod(torch.from_numpy(x)), ref) <= 1e-5


def _moe_params(rng, e, h, i, shared):
    params = {"router": {"kernel": rng.randn(h, e).astype(np.float32)},
              "experts": {"gate_up": rng.randn(e, h, 2, i).astype(
                  np.float32) * 0.2,
                          "down": rng.randn(e, i, h).astype(np.float32) * .2}}
    if shared:
        params["shared"] = {
            "gate_up_kernel": rng.randn(h, 2, shared).astype(
                np.float32) * 0.2,
            "down": {"kernel": rng.randn(shared, h).astype(np.float32) * .2}}
    return params


def _quantize_bank(impl, experts):
    if impl in ("int8", "fp8"):
        return jql.quantize_expert_params(
            experts, jqu.QuantizedDtype.INT8 if impl == "int8"
            else jqu.QuantizedDtype.FP8E4M3)
    return jmxl.mx_pack_expert_params(experts, impl[3:])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = _t(v)
    return out


MOE_CASES = [(router, mode, impl, shared)
             for router in ("top_k", "sinkhorn", "group_limited")
             for mode, impl in (("capacity", "float"), ("blockwise", "float"),
                                ("capacity", "int8"), ("capacity", "fp8"),
                                ("capacity", "mx_fp4"), ("capacity", "mx_fp8"))
             for shared in (0, 32)
             if shared == 0 or impl in ("float", "int8")]


@pytest.mark.parametrize("router,mode,impl,shared", MOE_CASES)
def test_moe_layer_matches_jax(router, mode, impl, shared):
    """The MoE layer over ``[B, S, H]`` with each router, both dispatch
    modes of the float bank and each quantized bank, with and without
    shared experts: output within 1e-5 relative, aux losses and the
    dropped fraction as JAX's."""
    rng = np.random.RandomState(MOE_CASES.index((router, mode, impl,
                                                 shared)))
    e, h, i = 4, 64, 32
    x = rng.randn(2, 6, h).astype(np.float32)
    params = _moe_params(rng, e, h, i, shared)
    if impl != "float":
        params["experts"] = _quantize_bank(impl, params["experts"])
    kw = dict(top_k=2, dispatch_mode=mode, block_size=4)
    ref, raux = jmodel.MoE(
        num_experts=e, hidden_size=h, intermediate_size=i, expert_impl=impl,
        router_type=router, shared_expert_intermediate=shared,
        dtype=jnp.float32, param_dtype=jnp.float32, **kw).apply(
            {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x))
    moe = tmodel.MoE(e, h, i, expert_impl=impl, router_type=router,
                     shared_expert_intermediate=shared, dtype=torch.float32,
                     **kw)
    moe.load_state_dict(_flat(params))
    with torch.no_grad():
        got, aux = moe(torch.from_numpy(x))
    assert got.shape == x.shape
    assert _rel(got, ref) <= 1e-5
    for name in ("load_balance_loss", "z_loss", "dropped_fraction"):
        np.testing.assert_allclose(aux[name].item(), float(raux[name]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("impl", ["int8", "mx_fp4"])
def test_quantized_banks_refuse_blockwise_as_jax(impl):
    x = jnp.zeros((1, 4, 16))
    with pytest.raises(ValueError, match="capacity"):
        jmodel.MoE(num_experts=4, hidden_size=16, intermediate_size=32,
                   dispatch_mode="blockwise", expert_impl=impl).init(
            jax.random.key(0), x)
    with pytest.raises(ValueError, match="capacity"):
        tmodel.MoE(4, 16, 32, dispatch_mode="blockwise", expert_impl=impl)
    with pytest.raises(ValueError, match="expert_impl"):
        tmodel.MoE(4, 16, 32, expert_impl="int4")


@pytest.mark.parametrize("mode", ["capacity", "blockwise"])
def test_dbrx_shaped_mixtral_matches_jax(mode):
    """DBRX's routing (16 experts, top-4) at tiny widths: logits and the
    summed aux losses without a cache, as the JAX model."""
    kw = dict(vocab_size=256, hidden_size=64, intermediate_size=64,
              num_layers=1, num_heads=4, num_kv_heads=2, max_seq_len=64,
              capacity_factor=4.0, moe_dispatch=mode, moe_block_size=8)
    jcfg = dataclasses.replace(jm.DBRX, dtype=jnp.float32,
                               param_dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tm.DBRX, dtype=torch.float32,
                               param_dtype=torch.float32, **kw)
    assert tcfg.num_experts == 16 and tcfg.top_k == 4
    tree = meta.unbox(jm.MixtralForCausalLM(jcfg).init(
        jax.random.key(1), jnp.zeros((1, 8), jnp.int32)))
    ids = np.random.RandomState(2).randint(0, 256, (2, 12)).astype(np.int32)
    ref_logits, ref_aux = jm.MixtralForCausalLM(jcfg).apply(
        tree, jnp.asarray(ids))
    model = load_jax_params(tm.MixtralForCausalLM(tcfg, device="cpu"),
                            jax.tree.map(np.asarray, tree))
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(ids))
    assert _rel(logits, ref_logits) <= 1e-5
    np.testing.assert_allclose(aux.numpy(), np.asarray(ref_aux), rtol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(router_type="sinkhorn", shared_expert_intermediate=48),
    dict(router_type="group_limited", weight_quant="mxfp4",
         shared_expert_intermediate=32),
])
def test_mixtral_variants_round_trip_the_bridge(kw):
    """A JAX Mixtral tree with shared experts or quantized experts crosses
    the bridge whole (strict load) and gives JAX's logits."""
    from neuronx_distributed_tpu.quantization import serving as jserving

    jcfg = jm.tiny_moe_config(dtype=jnp.float32, param_dtype=jnp.float32,
                              **kw)
    tcfg = tm.tiny_moe_config(dtype=torch.float32, param_dtype=torch.float32,
                              **kw)
    float_cfg = dataclasses.replace(jcfg, weight_quant=None)
    tree = meta.unbox(jm.MixtralForCausalLM(float_cfg).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    if jcfg.weight_quant:
        tree = jserving.quantize_params_for_serving(jcfg, tree)
    ids = np.random.RandomState(3).randint(0, 256, (1, 10)).astype(np.int32)
    ref, _ = jm.MixtralForCausalLM(jcfg).apply(tree, jnp.asarray(ids))
    model = tm.build_model(tcfg, params_from_jax(
        tcfg, jax.tree.map(np.asarray, tree)), "cpu")
    got, _ = model(torch.from_numpy(ids))
    assert _rel(got, ref) <= 1e-5


def test_dbrx_fields_equal_jax():
    jd, td = dataclasses.asdict(jm.DBRX), dataclasses.asdict(tm.DBRX)
    shared = set(jd) & set(td) - {"dtype", "param_dtype"}
    assert {k: td[k] for k in shared} == {k: jd[k] for k in shared}
    for k in ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
              "num_heads", "num_kv_heads", "rope_theta", "max_seq_len",
              "num_experts", "top_k", "moe_expert_impl", "router_type",
              "shared_expert_intermediate", "weight_quant"):
        assert k in shared, k


VALIDATOR_CASES = [
    (dict(top_k=9), "top_k"),
    (dict(num_experts=0, top_k=0), "num_experts"),
    (dict(moe_dispatch="nope"), "moe_dispatch"),
    (dict(router_type="bogus"), "router_type"),
    (dict(capacity_factor=-1.0), "capacity_factor"),
    (dict(moe_sentinel_empty=True), "sentinel_empty"),
    (dict(moe_dispatch="blockwise", moe_block_size=0), "moe_block_size"),
    (dict(hidden_size=48, moe_expert_impl="mx_fp4"), "MX"),
    (dict(intermediate_size=100, moe_expert_impl="mx_fp8"), "MX"),
    (dict(moe_expert_impl="int4"), "moe_expert_impl"),
]


@pytest.mark.parametrize("kw,match", VALIDATOR_CASES)
def test_validator_raises_where_jax_raises(kw, match):
    """Each bad config raises in JAX's validator and in the port's (a few
    already as the port's config is made); ``configure_model`` runs the
    validator as JAX's does."""
    with pytest.raises(ValueError, match=match):
        jval(jm.tiny_moe_config(**kw))
    with pytest.raises(ValueError, match=match):
        tval(tm.tiny_moe_config(**kw))
    with pytest.raises(ValueError, match=match):
        configure_model(neuronx_distributed_config(), tm.tiny_moe_config(**kw))


_WIRED = dataclasses.make_dataclass("Wired", [
    ("num_experts", int, 4), ("top_k", int, 2),
    ("moe_dispatch", str, "blockwise"), ("moe_block_size", int, 8),
    ("moe_ep_wire_dtype", str, "fp32"), ("moe_overlap_dispatch", object, None)])


@pytest.mark.parametrize("kw,match,with_parallel", [
    (dict(moe_ep_wire_dtype="int4"), "moe_ep_wire_dtype", False),
    (dict(moe_dispatch="capacity", moe_ep_wire_dtype="int8"), "blockwise",
     False),
    (dict(moe_dispatch="capacity", moe_overlap_dispatch=True), "blockwise",
     False),
    (dict(moe_overlap_dispatch="yes"), "moe_overlap_dispatch", False),
    (dict(moe_overlap_dispatch=True), "expert_parallel_size", True),
])
def test_validator_holds_the_ep_fields_as_jax(kw, match, with_parallel):
    """A config with the EP wire and overlap fields (the port's
    ``MixtralConfig`` has them since expert parallelism) is held as JAX
    holds its own: the pinned overlap needs more than one expert-parallel
    rank."""
    import neuronx_distributed_tpu as nxd

    jkw = dict(kw, moe_block_size=8)
    jkw.setdefault("moe_dispatch", "blockwise")
    with pytest.raises(ValueError, match=match):
        jval(jm.tiny_moe_config(**jkw), nxd.neuronx_distributed_config(
            init_mesh=False) if with_parallel else None)
    with pytest.raises(ValueError, match=match):
        tval(_WIRED(**kw), neuronx_distributed_config()
             if with_parallel else None)
    assert tval(_WIRED(moe_ep_wire_dtype="int8")).moe_ep_wire_dtype == "int8"


def test_validator_passes_good_configs_as_jax():
    for kw in (dict(), dict(moe_dispatch="blockwise", moe_block_size=8),
               dict(router_type="sinkhorn", moe_expert_impl="mx_fp4"),
               dict(moe_dispatch="blockwise", capacity_factor=3.0)):
        cfg = tm.tiny_moe_config(**kw)
        assert tval(cfg) is cfg
        jval(jm.tiny_moe_config(**kw))
        # configure_model carries the config's tp_size (1), as JAX's does
        assert configure_model(neuronx_distributed_config(), cfg) == \
            dataclasses.replace(cfg, remat=False, tp_size=1)
    llama_like = dataclasses.make_dataclass("C", [("hidden_size", int)])(8)
    assert tval(llama_like) is llama_like


def test_token_shuffle_uses_the_permutation_as_jax():
    """Given JAX's permutation the port's shuffle gives JAX's output, and
    unshuffle inverts it (a shuffle axis of size 1)."""
    x = np.random.RandomState(4).randn(16, 3).astype(np.float32)
    jx, jperm = jshuf.token_shuffle(jnp.asarray(x), jax.random.key(0))
    perm = torch.from_numpy(np.asarray(jperm).astype(np.int64))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(xt[perm].numpy(), np.asarray(jx))
    back = tshuf.token_unshuffle(torch.from_numpy(np.array(jx)), perm)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        np.asarray(jshuf.token_unshuffle(jx, jperm)), back.numpy())


def test_token_shuffle_is_fixed_per_seed_and_step():
    """One seed and step give one permutation (a replayed step shuffles the
    same way, and the generator passed in is left as it was); another step,
    or no step, gives another; every shuffle inverts."""
    x = torch.arange(64.0).reshape(32, 2)
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    a, pa = tshuf.token_shuffle(x, gen, step=5)
    assert torch.equal(gen.get_state(), state)
    b, pb = tshuf.token_shuffle(x, torch.Generator().manual_seed(7), step=5)
    assert torch.equal(pa, pb) and torch.equal(a, b)
    _, pc = tshuf.token_shuffle(x, gen, step=6)
    _, pn = tshuf.token_shuffle(x, gen)
    assert not torch.equal(pa, pc) and not torch.equal(pa, pn)
    for y, p in ((a, pa), (x[pc], pc)):
        assert torch.equal(tshuf.token_unshuffle(y, p), x)
    assert sorted(pa.tolist()) == list(range(32))

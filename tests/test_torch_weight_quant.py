"""The PyTorch port's weight-quantized serving tiers against the JAX
package: the serving converter on the converted tree bit for bit per tier,
the quantized tiny Llama's cached forward, the JAX tier tolerances against
float, the engine's greedy ids beside the JAX engine's, Mixtral's
quantized experts, the weight bridge's fp8 leaves, the layer-by-layer
initialiser, and the configs' refusals where JAX refuses."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from neuronx_distributed_tpu.inference import engine as je
from neuronx_distributed_tpu.inference.kv_cache import init_kv_cache
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.models import mixtral as jm
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.quantization import serving as jserving
from neuronx_distributed_tpu_torch.inference import engine as te
from neuronx_distributed_tpu_torch.inference import kv_cache as tkv
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models import mixtral as tm
from neuronx_distributed_tpu_torch.models.convert import params_from_jax
from neuronx_distributed_tpu_torch.quantization import serving as tserving

FORMATS = tl.WEIGHT_QUANT_FORMATS
# the JAX test's tier tolerances against float (tests/test_weight_quant.py)
_TIER_TOL = {"int8": 0.5, "fp8": 1.0, "mxfp8": 1.5, "mxfp4": 8.0}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


@pytest.fixture(scope="module")
def llama_models():
    """The JAX test's tiny fp32 Llama as JAX params and as the port's state
    dict."""
    ps.initialize_model_parallel()
    try:
        jcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32)
        tree = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    finally:
        ps.destroy_model_parallel()
    tcfg = tl.tiny_config(dtype=torch.float32, param_dtype=torch.float32)
    return jcfg, tree, tcfg, params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                                tree))


def _quantized(llama_models, fmt):
    jcfg, tree, tcfg, sd = llama_models
    jq = dataclasses.replace(jcfg, weight_quant=fmt)
    tq = dataclasses.replace(tcfg, weight_quant=fmt)
    return jq, jserving.quantize_params_for_serving(jq, tree), tq, sd


@pytest.mark.parametrize("fmt", FORMATS)
def test_serving_converter_is_jax_bit_for_bit(llama_models, fmt):
    """The port's converter on the converted float tree equals JAX's
    converted tree carried across, name for name and bit for bit; a
    quantized dict passes through as the same object."""
    jq, jtree, tq, sd = _quantized(llama_models, fmt)
    ref = params_from_jax(tq, jax.tree.map(np.asarray, jtree))
    got = tserving.quantize_params_for_serving(tq, sd)
    assert set(got) == set(ref)
    for name in ref:
        assert got[name].dtype == ref[name].dtype, name
        assert torch.equal(_bits(got[name]), _bits(ref[name])), name
    assert tserving.params_are_quantized(got)
    assert not tserving.params_are_quantized(sd)
    assert tserving.quantize_params_for_serving(tq, got) is got
    with pytest.raises(ValueError, match="weight_quant"):
        tserving.quantize_params_for_serving(llama_models[2], sd)


def _cached_logits(llama_models, fmt):
    """The JAX and port quantized tiny Llama's cached forward over one
    16-token prompt (fp32), and JAX's float logits."""
    jcfg, tree, tcfg, sd = llama_models
    ids = np.random.RandomState(0).randint(0, 256, (1, 16)).astype(np.int32)
    pos = np.arange(16, dtype=np.int32)[None]

    def jax_run(cfg, params):
        cache = init_kv_cache(cfg.num_layers, 1, 32, cfg.num_kv_heads,
                              cfg.head_dim_, dtype=jnp.float32)
        logits, _ = jl.llama_forward_with_cache(
            cfg, params, jnp.asarray(ids), jnp.asarray(pos), cache)
        return np.asarray(logits, np.float32)

    jq, jtree, tq, _ = _quantized(llama_models, fmt)
    model = tl.build_model(tq, tserving.quantize_params_for_serving(tq, sd),
                           "cpu")
    cache = tkv.init_kv_cache(tq.num_layers, 1, 32, tq.num_kv_heads,
                              tq.head_dim_, dtype=torch.float32,
                              device="cpu")
    got, _ = tl.llama_forward_with_cache(model, torch.from_numpy(ids),
                                         torch.from_numpy(pos), cache)
    return got.numpy(), jax_run(jq, jtree), jax_run(jcfg, tree)


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantized_forward_matches_jax_and_its_tier_tolerance(llama_models,
                                                              fmt):
    """Within 1e-4 x max|logit| of JAX's quantized forward; against the
    float forward, the JAX test's tier tolerance and, for int8, a greedy
    argmax share of at least 0.8."""
    got, ref, flt = _cached_logits(llama_models, fmt)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    assert np.all(np.isfinite(got))
    assert np.abs(got - flt).max() < _TIER_TOL[fmt]
    if fmt == "int8":
        assert np.mean(got.argmax(-1) == flt.argmax(-1)) >= 0.8


def _ecfg(mod, **kw):
    base = dict(block_size=4, num_blocks=16, max_slots=2,
                max_blocks_per_seq=8, token_budget=8)
    base.update(kw)
    return mod.EngineConfig(**base)


@pytest.mark.parametrize("fmt", ["int8", "mxfp8"])
def test_engine_serves_the_tier_like_jax(llama_models, fmt):
    """Handed the float weights, both engines quantize at construction;
    their greedy ids are identical, and the port's step has one shape."""
    jcfg, tree, tcfg, sd = llama_models
    prompt = np.random.RandomState(1).randint(0, 256, (7,)).tolist()
    ps.initialize_model_parallel()
    try:
        jeng = je.ServingEngine(jcfg, tree, _ecfg(je, weight_quant=fmt,
                                                  kv_dtype=jnp.float32))
        jeng.submit(prompt, max_new_tokens=8, uid="a")
        ref = jeng.run()["a"]
    finally:
        ps.destroy_model_parallel()
    eng = te.ServingEngine(tcfg, sd, _ecfg(te, weight_quant=fmt),
                           device="cpu")
    assert eng.model_cfg.weight_quant == fmt
    assert tserving.params_are_quantized(eng.model.state_dict())
    eng.submit(prompt, max_new_tokens=8, uid="a")
    res = eng.run()["a"]
    assert res.status == ref.status == "completed"
    assert res.tokens == list(ref.tokens) and len(res.tokens) == 8
    assert eng.compile_count() == 1


def test_engine_takes_a_quantized_dict_and_refuses_unknown_tiers(
        llama_models):
    _, _, tcfg, sd = llama_models
    qcfg = dataclasses.replace(tcfg, weight_quant="int8")
    qsd = tserving.quantize_params_for_serving(qcfg, sd)
    eng = te.ServingEngine(tcfg, qsd, _ecfg(te, weight_quant="int8"),
                           device="cpu")
    for name, t in eng.model.state_dict().items():
        if name in qsd:
            assert torch.equal(_bits(t), _bits(qsd[name])), name
    with pytest.raises(ValueError, match="int4"):
        te.ServingEngine(tcfg, sd, _ecfg(te, weight_quant="int4"),
                         device="cpu")
    # the int8 pool and the int8 weights are independent
    eng = te.ServingEngine(tcfg, sd, _ecfg(te, weight_quant="int8",
                                           quantized=True), device="cpu")
    eng.submit(list(range(1, 8)), 4, uid="a")
    assert eng.run()["a"].status == "completed"


def test_engine_weight_quant_defaults_to_the_card(llama_models):
    _, _, tcfg, sd = llama_models
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        te.ServingEngine(tcfg, sd, _ecfg(te, weight_quant="int8"))


def test_mixtral_engine_serves_quantized_experts():
    """The tiny Mixtral at int8: the experts follow the tier, the engine
    completes with one step shape and gives the JAX engine's greedy ids;
    quantized experts need capacity dispatch."""
    ps.initialize_model_parallel()
    try:
        jcfg = jm.tiny_moe_config(dtype=jnp.float32, param_dtype=jnp.float32)
        tree = meta.unbox(jm.MixtralForCausalLM(jcfg).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
        jeng = je.ServingEngine(jcfg, tree, _ecfg(
            je, weight_quant="int8", kv_dtype=jnp.float32))
        jeng.submit(list(range(1, 8)), max_new_tokens=4, uid="a")
        ref = jeng.run()["a"]
    finally:
        ps.destroy_model_parallel()
    tcfg = tm.tiny_moe_config(dtype=torch.float32, param_dtype=torch.float32)
    assert dataclasses.replace(tcfg, weight_quant="int8").moe_expert_impl_ \
        == "int8"
    assert dataclasses.replace(
        tcfg, weight_quant="mxfp4").moe_expert_impl_ == "mx_fp4"
    sd = params_from_jax(tcfg, jax.tree.map(np.asarray, tree))
    eng = te.ServingEngine(tcfg, sd, _ecfg(te, weight_quant="int8"),
                           device="cpu")
    assert "layers.0.moe.experts.gate_up_q" in eng.model.state_dict()
    eng.submit(list(range(1, 8)), 4, uid="a")
    res = eng.run()["a"]
    assert res.status == "completed" and res.tokens == list(ref.tokens)
    assert eng.compile_count() == 1
    for mod in (tm, jm):
        with pytest.raises(ValueError, match="capacity"):
            mod.tiny_moe_config(weight_quant="int8", moe_dispatch="blockwise")


def test_bridge_carries_quantized_leaves_as_their_bytes(llama_models):
    """A JAX tree of fp8 (``ml_dtypes``) leaves crosses as the same bytes
    viewed as ``torch.float8_e4m3fn`` (the bridge imports no ``ml_dtypes``:
    ``tests/test_torch_engine.py::test_port_imports_nothing_of_jax``)."""
    jq, jtree, tq, _ = _quantized(llama_models, "fp8")
    np_tree = jax.tree.map(np.asarray, jtree)
    sd = params_from_jax(tq, np_tree)
    q = np_tree["params"]["model"]["layers"]["layer"]["attn"]["qkv"][
        "q_kernel_q"]
    got = sd["layers.1.attn.qkv.q_kernel_q"]
    assert got.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  q[1].view(np.uint8))
    assert sd["lm_head.kernel_q"].dtype == torch.float8_e4m3fn


@pytest.mark.parametrize("family,fmt", [(tl, "mxfp4"), (tm, "int8"),
                                        (tm, "mxfp8")])
def test_init_state_dict_quantizes_layer_by_layer(family, fmt):
    """Random weights for a quantized config are the float config's
    weights (same draws) quantized: layer by layer equals all at once."""
    cfg = (tl.tiny_config() if family is tl else tm.tiny_moe_config())
    qcfg = dataclasses.replace(cfg, weight_quant=fmt)
    got = family.init_state_dict(qcfg, seed=3, device="cpu")
    ref = tserving.quantize_params_for_serving(
        qcfg, family.init_state_dict(cfg, seed=3, device="cpu"))
    assert list(got) == list(ref)
    for name in ref:
        assert torch.equal(_bits(got[name]), _bits(ref[name])), name
    family.build_model(qcfg, got, "cpu")           # loads strictly


@pytest.mark.parametrize("kw,match", [
    (dict(weight_quant="int4"), "weight_quant must be one of"),
    (dict(weight_quant="int8", tie_embeddings=True), "tie_embeddings"),
    (dict(weight_quant="fp8", loss_chunk=8), "loss_chunk"),
    (dict(weight_quant="mxfp4", hidden_size=48, num_heads=4,
          num_kv_heads=2), "block-scaled"),
    (dict(weight_quant="mxfp8", intermediate_size=100), "intermediate_size"),
    (dict(weight_quant="mxfp4", head_dim=20), "num_heads"),
])
def test_config_raises_where_jax_raises(kw, match):
    with pytest.raises(ValueError, match=match):
        jl.tiny_config(**kw)
    with pytest.raises(ValueError, match=match):
        tl.tiny_config(**kw)


def test_config_accepts_what_jax_accepts_and_lacks_later_fields():
    for fmt in FORMATS:
        assert tl.tiny_config(weight_quant=fmt).weight_quant == fmt
        jl.tiny_config(weight_quant=fmt)
    # LoRA with weight_quant raises JAX's ValueError; so does sequence
    # parallelism in the port (the quantized layers have no sequence entry)
    from neuronx_distributed_tpu.lora import LoraConfig as JLoraConfig
    from neuronx_distributed_tpu_torch.lora import LoraConfig

    for cfg_fn, lora in ((jl.tiny_config, JLoraConfig()),
                         (tl.tiny_config, LoraConfig())):
        with pytest.raises(ValueError, match="incompatible with LoRA"):
            cfg_fn(weight_quant="int8", lora=lora)
    with pytest.raises(ValueError, match="sequence_parallel"):
        tl.tiny_config(weight_quant="int8", sequence_parallel=True)

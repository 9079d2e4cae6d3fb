"""The PyTorch port's Llama paged forward against the JAX package: the
building blocks (RMSNorm, rope, GQA expansion), the weight bridge, and one
packed serving step on the paged pool (logits and the pool afterwards)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from neuronx_distributed_tpu.inference import paging as jpg
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.modules import attention as jattn
from neuronx_distributed_tpu.modules.norms import RMSNorm as JRMSNorm
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu_torch.inference import paging as tpg
from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models.convert import (load_jax_params,
                                                          params_from_jax)
from neuronx_distributed_tpu_torch.modules import attention as tattn
from neuronx_distributed_tpu_torch.modules.norms import RMSNorm


@pytest.fixture(scope="module")
def models():
    """One tiny fp32 Llama in both packages, the same weights."""
    ps.initialize_model_parallel()
    try:
        jcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                              num_layers=2)
        params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    finally:
        ps.destroy_model_parallel()
    tcfg = tl.tiny_config(dtype=torch.float32, num_layers=2)
    model = load_jax_params(tl.LlamaForCausalLM(tcfg, device="cpu"),
                            jax.tree.map(np.asarray, params))
    return jcfg, params, tcfg, model


def test_rmsnorm_matches_jax():
    x = np.random.RandomState(0).randn(2, 3, 16).astype(np.float32)
    scale = np.random.RandomState(1).rand(16).astype(np.float32) + 0.5
    ref = JRMSNorm(eps=1e-5, dtype=jnp.float32).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    norm = RMSNorm(16, eps=1e-5, dtype=torch.float32)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        got = norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("use_scaled", [False, True])
def test_rope_and_rotary_match_jax(use_scaled):
    jc, js = jattn.precompute_rope(32, 64, 500000.0, use_scaled=use_scaled)
    tc, ts = tattn.precompute_rope(32, 64, 500000.0, use_scaled=use_scaled)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    rng = np.random.RandomState(2)
    x = rng.randn(1, 5, 4, 32).astype(np.float32)
    pos = rng.randint(0, 64, (1, 5)).astype(np.int32)
    ref = jattn.apply_rotary(jnp.asarray(x), jc, js, jnp.asarray(pos))
    got = tattn.apply_rotary(torch.from_numpy(x), tc, ts,
                             torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        tattn.repeat_kv(torch.from_numpy(x), 3).numpy(),
        np.asarray(jattn.repeat_kv(jnp.asarray(x), 3)))


def test_bridge_round_trips_every_param(models):
    jcfg, params, tcfg, model = models
    sd = params_from_jax(tcfg, jax.tree.map(np.asarray, params))
    assert set(sd) == set(model.state_dict())
    layers = params["params"]["model"]["layers"]["layer"]
    np.testing.assert_array_equal(
        model.layers[1].mlp.gate_up_kernel.detach().numpy(),
        np.asarray(layers["mlp"]["gate_up_kernel"][1]))
    np.testing.assert_array_equal(
        model.layers[0].attn.qkv.k_kernel.detach().numpy(),
        np.asarray(layers["attn"]["qkv"]["k_kernel"][0]))


def _packed_steps(bs=4):
    """Two packed steps over two slots with scrambled block tables: step 1
    prefills slot 0 (5 tokens) and slot 1 (2 tokens) with pad rows; step 2
    decodes both and continues nothing else."""
    tables = np.full((3, 4), -1, np.int32)
    tables[0, :2] = [5, 2]
    tables[1, :2] = [7, 0]
    rng = np.random.RandomState(7)
    t1 = dict(tok=rng.randint(0, 256, 10),
              pos=[0, 1, 2, 3, 4, 0, 1] + [PAD_POSITION] * 3,
              slot=[0] * 5 + [1] * 2 + [3] * 3)
    t2 = dict(tok=rng.randint(0, 256, 10),
              pos=[5, 2] + [PAD_POSITION] * 8,
              slot=[0, 1] + [3] * 8)
    return tables, [t1, t2]


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_forward_matches_jax(models, quantized):
    jcfg, params, tcfg, model = models
    nl, kv, d = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim_
    tables, steps = _packed_steps()
    if quantized:
        jc = jpg.init_quantized_paged_kv_cache(nl, 8, 4, kv, d, 3, 4)
        tc = tpg.init_quantized_paged_kv_cache(nl, 8, 4, kv, d, 3, 4,
                                               device="cpu")
    else:
        jc = jpg.init_paged_kv_cache(nl, 8, 4, kv, d, 3, 4,
                                     dtype=jnp.float32)
        tc = tpg.init_paged_kv_cache(nl, 8, 4, kv, d, 3, 4,
                                     dtype=torch.float32, device="cpu")
    jc = jc.replace(block_tables=jnp.asarray(tables))
    tc.block_tables.copy_(torch.from_numpy(tables))
    for st in steps:
        tok = np.asarray(st["tok"], np.int32)[None]
        pos = np.asarray(st["pos"], np.int32)[None]
        slot = np.asarray(st["slot"], np.int32)
        ref, jc = jl.llama_forward_with_cache(
            jcfg, params, jnp.asarray(tok), jnp.asarray(pos), jc,
            slot_ids=jnp.asarray(slot))
        got, tc = tl.llama_forward_with_cache(
            model, torch.from_numpy(tok), torch.from_numpy(pos), tc,
            torch.from_numpy(slot))
        real = pos[0] < PAD_POSITION
        ref = np.asarray(ref)[0][real]
        np.testing.assert_allclose(got[0].numpy()[real], ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    if quantized:
        # codes may differ by one step where fp32 K/V straddle a rounding
        # tie; the dequantized pools agree to within one quantization step
        for name in ("k", "v"):
            deq_t = (getattr(tc, name).float()
                     * getattr(tc, name + "_scale")[..., None]).numpy()
            deq_j = np.asarray(getattr(jc, name), np.float32) * np.asarray(
                getattr(jc, name + "_scale"))[..., None]
            step = np.asarray(getattr(jc, name + "_scale"))[..., None]
            assert (np.abs(deq_t - deq_j) <= step * 1.001 + 1e-6).all()
    else:
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v),
                                   rtol=1e-5, atol=1e-5)

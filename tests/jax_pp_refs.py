"""JAX references of the port's pipeline tests: the JAX package's pipeline
grad functions on the conftest's virtual CPU mesh, and the helpers that
put the port ranks' shards back together. Imported by the test processes
only (the ranks import ``tests/torch_pp_ranks.py``)."""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.models import llama_pipeline as jlpp
from neuronx_distributed_tpu.models import mixtral as jmx
from neuronx_distributed_tpu.models import mixtral_pipeline as jmpp
from neuronx_distributed_tpu.parallel import mesh as jmesh
from neuronx_distributed_tpu.trainer import trainer as jtr
from neuronx_distributed_tpu_torch.models import convert
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models import llama_pipeline as tlpp
from neuronx_distributed_tpu_torch.models import mixtral as tmx


def batch(seed, b, s, vocab=256, ignore_rows=0):
    """``{"input_ids", "labels"}`` of ``b`` rows; the first
    ``ignore_rows`` rows ignore their first four labels."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s + 1)).astype(np.int32)
    labels = ids[:, 1:].copy()
    labels[:ignore_rows, :4] = -100
    return {"input_ids": ids[:, :-1], "labels": labels}


def jax_layout(tp, pp, sp, devices=4, **kw):
    return nxd.neuronx_distributed_config(
        tensor_parallel_size=tp, pipeline_parallel_size=pp,
        sequence_parallel=sp, devices=jax.devices()[:devices],
        mixed_precision_config=nxd.MixedPrecisionConfig(
            compute_dtype="float32"), **kw)


def port_cfg(case):
    if case.get("moe"):
        return tmx.tiny_moe_config(dtype=torch.float32, num_layers=case["L"],
                                   use_flash_attention=True, **case["moe"])
    return tl.tiny_config(dtype=torch.float32, num_layers=case["L"],
                          use_flash_attention=True,
                          tie_embeddings=case.get("tie", False),
                          **case.get("extra", {}))


def jax_pipeline(case, b):
    """JAX's pipeline grad function of ``case`` at its layout on 4 (or
    ``case["devices"]``) devices: ``(port state dict of the weights, loss,
    port-named grads)``; interleaved weights and grads in canonical
    order."""
    tp, pp, sp = case["tp"], case["pp"], case.get("sp", False)
    cfg = jax_layout(tp, pp, sp, case.get("devices", 4))
    try:
        if case.get("moe"):
            jcfg = nxd.configure_model(cfg, jmx.tiny_moe_config(
                dtype=jnp.float32, param_dtype=jnp.float32,
                num_layers=case["L"], **case["moe"]))
            model = jmx.MixtralForCausalLM(jcfg)
        else:
            jcfg = nxd.configure_model(cfg, jl.tiny_config(
                dtype=jnp.float32, param_dtype=jnp.float32,
                num_layers=case["L"], tie_embeddings=case.get("tie", False),
                **case.get("extra", {})))
            model = jl.LlamaForCausalLM(jcfg)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        pm, params = jtr.initialize_parallel_model(
            cfg, model, jax.random.key(case.get("seed", 1)),
            jb["input_ids"], logical_axis_rules=jlpp.PIPELINE_LOGICAL_RULES)
        host = jlpp.unpad_pipeline_params(jax.tree.map(np.asarray, params),
                                          jcfg)
        C = case.get("chunks", 1)
        run = (jlpp.interleave_pipeline_params(host, jcfg, pp, C) if C > 1
               else host)
        if case.get("moe"):
            gf = (jmpp.make_moe_pipeline_grad_fn(jcfg, case["M"],
                                                 pm.param_specs)
                  if case["schedule"] == "gpipe" else
                  jmpp.make_moe_1f1b_grad_fn(jcfg, case["M"],
                                             pm.param_specs, num_chunks=C))
        else:
            gf = jlpp.make_pipeline_grad_fn(
                jcfg, case["M"], pm.param_specs, schedule=case["schedule"],
                num_chunks=C, vocab_pp=case.get("vocab_pp", False))
        loss, grads = jax.jit(gf)(run, jb)
        grads = jax.tree.map(np.asarray, grads)
        if case.get("eval"):
            case["jax_eval"] = float(jax.jit(jlpp.make_pipeline_eval_fn(
                jcfg, case["M"], pm.param_specs))(run, jb))
        if C > 1:
            grads = jlpp.deinterleave_pipeline_params(grads, jcfg, pp, C)
        pcfg = port_cfg(case)
        return (convert.params_from_jax(pcfg, host), float(loss),
                convert.params_from_jax(pcfg, grads))
    finally:
        jmesh.destroy_model_parallel()


def gather_grads(outs, name, case):
    """The whole tensor of each grad from the ranks' shards (data rank 0;
    along the dim the shards differ from the whole, in (pp, tp) order),
    canonical names for interleaved runs, and which names each stage
    held."""
    per_rank = []
    for o in outs:
        g = o[name]["grads"]
        if case.get("chunks", 1) > 1:
            g = tlpp.deinterleave_pipeline_params(
                g, dataclasses.replace(port_cfg(case)), case["pp"],
                case["chunks"])
        per_rank.append((o[name]["coords"], g))
    return per_rank


def whole(per_rank, pname, full_shape):
    held = [(c, g[pname]) for c, g in per_rank
            if pname in g and c["dp"] == 0]
    if tuple(held[0][1].shape) == tuple(full_shape):
        return held[0][1]
    d = next(i for i, (a, b) in enumerate(zip(held[0][1].shape, full_shape))
             if a != b)
    held.sort(key=lambda x: (x[0]["pp"], x[0]["tp"]))
    if held[0][1].shape[d] * len(held) != full_shape[d]:
        pp0 = held[0][0]["pp"]
        held = [x for x in held if x[0]["pp"] == pp0]
    return torch.cat([t for _, t in held], d)


def assert_grads_match(per_rank, want, rel=1e-4):
    """Every gradient, by name, within ``rel`` x its max |g| of JAX's."""
    for pname, w in want.items():
        got = whole(per_rank, pname, w.shape)
        scale = max(float(w.abs().max()), 1e-30)
        err = float((got.double() - w.double()).abs().max()) / scale
        assert err <= rel, (pname, err)

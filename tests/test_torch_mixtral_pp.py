"""The port's pipeline-parallel Mixtral (``models/mixtral_pipeline.py``)
against the JAX package's ``make_moe_pipeline_grad_fn`` (GPipe) and
``make_moe_1f1b_grad_fn`` (C=1 and C=2) under ``jax.jit`` on the virtual
CPU mesh, at pp=2 x tp=2 with sequence parallelism, with blockwise
(the grouped-GLU kernels K5/K7/K8 as their plain versions on the CPU) and
capacity dispatch. The loss is the global cross-entropy plus the router's
aux over the microbatches; limits: the loss within 1e-5 relative, every
gradient by name within 1e-4 x its max |g|. Attention dropout raises, as
in JAX."""

import pytest
import torch

from neuronx_distributed_tpu.models import mixtral as jmx
from neuronx_distributed_tpu.models import mixtral_pipeline as jmpp
from neuronx_distributed_tpu_torch.models import llama_pipeline as tlpp
from neuronx_distributed_tpu_torch.models import mixtral as tmx
from neuronx_distributed_tpu_torch.models import mixtral_pipeline as tmpp
from neuronx_distributed_tpu_torch.utils.cpu_mesh import run_ranks

import jax_pp_refs as refs
import torch_pp_ranks

BLOCK = dict(moe_dispatch="blockwise", moe_block_size=16)
CAP = dict(moe_dispatch="capacity")
CASES = {
    "gpipe_blockwise": dict(L=2, schedule="gpipe", M=2, moe=BLOCK),
    "1f1b_blockwise": dict(L=2, schedule="1f1b", M=4, moe=BLOCK),
    "interleaved_blockwise": dict(L=4, schedule="interleaved", chunks=2,
                                  M=4, moe=BLOCK),
    "gpipe_capacity": dict(L=2, schedule="gpipe", M=2, moe=CAP),
    "1f1b_capacity": dict(L=2, schedule="1f1b", M=4, moe=CAP),
    "interleaved_capacity": dict(L=4, schedule="interleaved", chunks=2,
                                 M=2, moe=CAP),
}
for _c in CASES.values():
    _c.update(tp=2, pp=2, sp=True)
BATCH = refs.batch(6, 8, 16, ignore_rows=2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jax_out, cases = {}, []
    for name, case in CASES.items():
        sd, loss, grads = refs.jax_pipeline(case, BATCH)
        jax_out[name] = (loss, grads)
        cfg = refs.port_cfg(case)
        if case.get("chunks", 1) > 1:
            sd = tlpp.interleave_pipeline_params(sd, cfg, 2, case["chunks"])
        cases.append(dict(case, name=name, cfg=cfg, sd=sd))
    store = tmp_path_factory.mktemp("mixtral_pp")
    outs = run_ranks(torch_pp_ranks.moe_grads_world, 4, backend="gloo",
                     device="cpu", store_dir=str(store),
                     args=(cases, BATCH), timeout=600)
    return jax_out, outs


@pytest.mark.parametrize("name", list(CASES))
def test_loss_with_aux_and_grads_equal_jax(world, name):
    jax_out, outs = world
    want_loss, want_grads = jax_out[name]
    for o in outs:
        assert o["jax_modules"] == []
        assert abs(o[name]["loss"] - want_loss) <= 1e-5 * abs(want_loss)
    refs.assert_grads_match(refs.gather_grads(outs, name, CASES[name]),
                            want_grads)


def test_attention_dropout_raises_as_jax():
    for make in ("make_moe_pipeline_grad_fn", "make_moe_1f1b_grad_fn"):
        with pytest.raises(ValueError) as want:
            getattr(jmpp, make)(jmx.tiny_moe_config(attention_dropout=0.1),
                                2, None)
        with pytest.raises(ValueError) as got:
            getattr(tmpp, make)(tmx.tiny_moe_config(attention_dropout=0.1),
                                2, None)
        assert str(got.value) == str(want.value)

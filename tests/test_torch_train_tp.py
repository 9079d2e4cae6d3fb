"""The slice as a whole: the port's Llama train step across gloo ranks on
the CPU (tensor parallel with sequence parallelism, data parallel, ZeRO-1)
against the JAX package's GSPMD ``make_train_step`` at the same
``tensor_parallel_size`` on a 4-device mesh, from the same weights
(``params_from_jax``) and global batches, through the public path:
``neuronx_distributed_config`` -> ``configure_model`` ->
``initialize_parallel_model`` -> ``initialize_parallel_optimizer`` ->
``make_train_step``. Also the sharding tables against JAX's (partition
specs, ZeRO-1's dims), every parameter's synchronised gradient against
``jax.grad`` (the guard against a norm's gradient reduced twice or not at
all under sequence parallelism), and what stays refused across ranks.

Tolerances are ``tests/test_torch_train.py``'s for tp=1: the loss before
any update within 1e-6 relative, later losses 1e-4, grad norms 1e-3,
gradients 1e-4 x max|g|, updated parameters 1e-3 x max|p|."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn
from flax.core import meta

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import mesh as jmesh
from neuronx_distributed_tpu.trainer import optimizer as jopt
from neuronx_distributed_tpu.trainer import trainer as jtr
from neuronx_distributed_tpu_torch.config import mesh_factorization
from neuronx_distributed_tpu_torch.models import convert
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.trainer import optimizer as topt
from neuronx_distributed_tpu_torch.utils.cpu_mesh import run_ranks

import torch_ranks

VOCAB = 256


def _batches(seed, n, b=4, s=16):
    """Global batches whose first half of rows (data rank 0's) ignore more
    labels than the second, so the ranks count different tokens."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, VOCAB, (b, s + 1)).astype(np.int32)
        labels = ids[:, 1:].copy()
        labels[:b // 2, :5] = -100
        labels[b // 2:, :1] = -100
        out.append({"input_ids": ids[:, :-1], "labels": labels})
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


class GspmdRun:
    """The JAX GSPMD train step at ``tp`` on ``devices`` CPU devices (so
    dp = devices / tp), with ZeRO-1 when asked; its initial params as
    numpy arrays, and the port's config of the same model."""

    def __init__(self, tp, devices=4, zero1=True, sp=True, lr=1e-3,
                 grad_accum_steps=1, layers=2):
        ocfg = nxd.OptimizerConfig(zero_one_enabled=zero1)
        cfg = nxd.neuronx_distributed_config(
            tensor_parallel_size=tp, sequence_parallel=sp,
            optimizer_config=ocfg, devices=jax.devices()[:devices],
            mixed_precision_config=nxd.MixedPrecisionConfig(
                compute_dtype="float32"))
        try:
            self.jcfg = nxd.configure_model(cfg, jl.tiny_config(
                dtype=jnp.float32, param_dtype=jnp.float32,
                num_layers=layers, use_flash_attention=True))
            pm, params = jtr.initialize_parallel_model(
                cfg, jl.LlamaForCausalLM(self.jcfg), jax.random.key(0),
                jnp.zeros((4, 16), jnp.int32))
            tx, self.state, sh = jtr.initialize_parallel_optimizer(
                pm, params, learning_rate=lr)
            self.step_fn = jtr.make_train_step(
                pm, tx, sh, donate=False, grad_accum_steps=grad_accum_steps)
            self.params = jax.tree.map(np.array, params)
        finally:
            jmesh.destroy_model_parallel()
        self.tcfg = tl.tiny_config(dtype=torch.float32, num_layers=layers,
                                   use_flash_attention=True)

    def step(self, batch):
        self.state, m = self.step_fn(self.state, {
            k: jnp.asarray(v) for k, v in batch.items()})
        return {k: float(v) for k, v in m.items()}

    def final(self):
        return convert.params_from_jax(
            self.tcfg, jax.tree.map(np.asarray, self.state.params))


def _ranks(tmp_path, fn, world, *args):
    return run_ranks(fn, world, backend="gloo", device="cpu",
                     store_dir=str(tmp_path), args=args, timeout=240)


def _check_against_gspmd(run, outs, tp, batches, zero1):
    """Every rank reports JAX's loss and grad norm at every step; the tp
    shards of data rank 0, gathered, equal JAX's updated params; under
    ZeRO-1 each moment holds this data rank's slice."""
    want = [run.step(b) for b in batches]
    for r, out in enumerate(outs):
        assert out["jax_modules"] == [], out["jax_modules"]
        for i, ((loss, norm), jm) in enumerate(zip(out["metrics"], want)):
            np.testing.assert_allclose(loss, jm["loss"],
                                       rtol=1e-6 if i == 0 else 1e-4,
                                       err_msg=f"rank {r} step {i} loss")
            np.testing.assert_allclose(norm, jm["grad_norm"], rtol=1e-3,
                                       err_msg=f"rank {r} step {i} norm")
    first = [o for o in outs if o["coords"]["dp"] == 0]
    first.sort(key=lambda o: o["coords"]["tp"])
    got = convert.gather_state_dict(dataclasses.replace(run.tcfg, tp_size=tp),
                                    [o["params"] for o in first])
    ref = run.final()
    start = convert.params_from_jax(run.tcfg, run.params)
    assert set(got) == set(ref)
    for name, p in got.items():
        w = ref[name].numpy()
        np.testing.assert_allclose(p.numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=name)
        assert not torch.equal(p, start[name]), f"{name} did not move"
    # the data ranks end with equal parameters
    for o in outs:
        twin = next(f for f in first if f["coords"]["tp"] == o["coords"]["tp"])
        for name, p in o["params"].items():
            assert torch.equal(p, twin["params"][name]), name
    if zero1:
        n_data = len(outs) // tp
        shapes = [tuple(p.shape) for p in first[0]["params"].values()]
        halved = [s for s, m in zip(shapes, first[0]["moments"]) if s != m]
        assert halved and all(
            np.prod(m) * n_data == np.prod(s)
            for s, m in zip(shapes, first[0]["moments"]) if s != m)


def test_world4_tp2_dp2_sequence_parallel_zero1_matches_jax_gspmd(tmp_path):
    """The slice: 4 ranks, tp=2 x dp=2, ``sequence_parallel`` and ZeRO-1,
    two fp32 steps against JAX's GSPMD step at tp=2 on 4 devices."""
    run = GspmdRun(tp=2)
    batches = _batches(3, 2)
    sd = convert.params_from_jax(run.tcfg, run.params)
    outs = _ranks(tmp_path, torch_ranks.train_steps, 4, run.tcfg, sd,
                  [_torch_batch(b) for b in batches], 1e-3, 2, True, True)
    _check_against_gspmd(run, outs, 2, batches, zero1=True)


def test_world4_tp4_matches_jax_gspmd(tmp_path):
    """tp=4 x dp=1 with ``sequence_parallel``: one query head a rank, and
    fewer kv heads (2) than ranks, so each rank slices its kv head from
    the replicated kv kernels."""
    run = GspmdRun(tp=4, zero1=False)
    batches = _batches(4, 2)
    sd = convert.params_from_jax(run.tcfg, run.params)
    outs = _ranks(tmp_path, torch_ranks.train_steps, 4, run.tcfg, sd,
                  [_torch_batch(b) for b in batches], 1e-3, 4, False, True)
    _check_against_gspmd(run, outs, 4, batches, zero1=False)


def test_grad_accumulation_at_dp2_matches_jax_gspmd(tmp_path):
    """``grad_accum_steps=2`` at tp=2 x dp=2 without ZeRO-1 (gradients
    all-reduced): each rank takes its rows of each microbatch, as JAX
    shards each microbatch over dp."""
    run = GspmdRun(tp=2, zero1=False, sp=False, grad_accum_steps=2)
    batches = _batches(5, 2, b=8)
    sd = convert.params_from_jax(run.tcfg, run.params)
    outs = _ranks(tmp_path, torch_ranks.train_steps, 4, run.tcfg, sd,
                  [_torch_batch(b) for b in batches], 1e-3, 2, False, False,
                  2)
    _check_against_gspmd(run, outs, 2, batches, zero1=False)


VARIANTS = {"remat_save_attention": dict(remat=True,
                                         remat_policy="save_attention"),
            "loss_chunk": dict(loss_chunk=4),
            "tie_embeddings": dict(tie_embeddings=True)}


@pytest.fixture(scope="module")
def variant_runs(tmp_path_factory):
    """Remat, the chunked loss and the tied head at tp=2 x dp=2 with SP and
    ZeRO-1 (one world runs the three in turn), and the port's tp=1 step
    (held to JAX by ``tests/test_torch_train.py`` and
    ``tests/test_torch_fused_loss_remat.py``) on the same weights."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import (
        ActivationCheckpointConfig, MixedPrecisionConfig, configure_model,
        neuronx_distributed_config)

    batches = [_torch_batch(b) for b in _batches(8, 2)]
    cfgs = [tl.tiny_config(dtype=torch.float32, num_layers=2,
                           use_flash_attention=True, **kw)
            for kw in VARIANTS.values()]
    sds = [tl.init_state_dict(c, seed=3, device="cpu") for c in cfgs]
    ranks = _ranks(tmp_path_factory.mktemp("variants"),
                   torch_ranks.train_variants, 4, cfgs, sds, batches, 1e-3,
                   2)
    ref = []
    for cfg, sd in zip(cfgs, sds):
        ncfg = neuronx_distributed_config(
            mixed_precision_config=MixedPrecisionConfig(
                compute_dtype="float32"),
            activation_checkpoint_config=ActivationCheckpointConfig(
                mode="full" if cfg.remat else "none"))
        pm, params = trainer.initialize_parallel_model(
            ncfg, configure_model(ncfg, cfg), state_dict=sd, device="cpu")
        tx, state = trainer.initialize_parallel_optimizer(pm, params, 1e-3)
        step = trainer.make_train_step(pm, tx)
        ref.append([(m["loss"].item(), m["grad_norm"].item())
                    for m in (step(state, b)[1] for b in batches)])
    return ranks, ref


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_remat_chunked_loss_and_tied_head_across_ranks(variant_runs,
                                                       variant):
    """Each variant's loss and grad norm on every rank equal the port's
    tp=1 step's: the first loss within 1e-6, the rest 1e-4, norms 1e-3.
    Remat re-runs the sequence gathers in the backward; the chunked loss
    reduces its softmax over the vocab shards in the forward and the
    recompute; the tied head's table gathers both its uses' gradients."""
    ranks, ref = variant_runs
    i = list(VARIANTS).index(variant)
    for r, res in enumerate(ranks):
        for j, ((loss, norm), (rl, rn)) in enumerate(zip(res[i], ref[i])):
            np.testing.assert_allclose(loss, rl, rtol=1e-6 if j == 0
                                       else 1e-4, err_msg=f"rank {r}")
            np.testing.assert_allclose(norm, rn, rtol=1e-3,
                                       err_msg=f"rank {r}")


@pytest.fixture(scope="module")
def synced(tmp_path_factory):
    """``jax.grad`` of the dense loss over one global batch, and each
    rank's synchronised gradient shards at tp=2 x dp=2 without and with
    sequence parallelism (one world)."""
    jcfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                          num_layers=2, use_flash_attention=True)
    tcfg = tl.tiny_config(dtype=torch.float32, num_layers=2,
                          use_flash_attention=True)
    model = jl.LlamaForCausalLM(jcfg)
    batch = _batches(7, 1)[0]
    params = meta.unbox(model.init(jax.random.key(1),
                                   jnp.asarray(batch["input_ids"])))
    jg = jax.grad(lambda p: model.apply(
        p, jnp.asarray(batch["input_ids"]), jnp.asarray(batch["labels"]),
        method="loss"))(params)
    want = convert.params_from_jax(tcfg, jax.tree.map(np.asarray, jg))
    sd = convert.params_from_jax(tcfg, jax.tree.map(np.asarray, params))
    outs = _ranks(tmp_path_factory.mktemp("synced"),
                  torch_ranks.synced_grads_both, 4, tcfg, sd,
                  _torch_batch(batch), 2)
    return tcfg, want, outs


@pytest.mark.parametrize("sp", [False, True])
def test_every_synchronised_gradient_matches_jax_grad(synced, sp):
    """Each parameter's gradient after ``allreduce_gradients`` (tp shards
    gathered) equals ``jax.grad`` of the dense loss over the global batch,
    the norms' included: a norm's gradient summed twice over tp, or not
    at all, fails here. The global norm over the shards equals the dense
    gradient's."""
    tcfg, want, ranks = synced
    outs = [r[sp] for r in ranks]
    assert bool(outs[0]["sp_names"]) == sp
    first = sorted((o for o in outs if o["coords"]["dp"] == 0),
                   key=lambda o: o["coords"]["tp"])
    got = convert.gather_state_dict(dataclasses.replace(tcfg, tp_size=2),
                                    [o["grads"] for o in first])
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    dense = np.sqrt(sum(float((v.double() ** 2).sum())
                        for v in want.values()))
    for o in outs:
        np.testing.assert_allclose(float(o["norm"]), dense, rtol=1e-5)


def _jax_specs_by_port_name(tp, kv):
    """JAX's ``nn.get_partition_spec`` of an unscanned tiny Llama, keyed by
    the port's names."""
    cfg = jl.tiny_config(num_kv_heads=kv, scan_layers=False, tp_size=tp)
    boxed = jax.eval_shape(lambda: jl.LlamaForCausalLM(cfg).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    specs = nn.get_partition_spec(boxed)["params"]
    out = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                name = ".".join(path + (k,))
                name = name.replace("model.", "").replace("layer_", "layers.")
                out[name] = (tuple(v), v)
    walk(specs, ())
    return out, boxed


@pytest.mark.parametrize("tp,kv", [(2, 2), (4, 2), (2, 4), (4, 4)])
def test_partition_spec_table_matches_jax(tp, kv):
    """``param_specs`` (which dim of each parameter shards over tp) equals
    JAX's partition specs of the same model, kv kernels replicated where
    tp exceeds the kv heads."""
    jspecs, _ = _jax_specs_by_port_name(tp, kv)
    tcfg = tl.tiny_config(num_kv_heads=kv, tp_size=tp)
    got = convert.param_specs(tcfg)
    assert set(got) == set(jspecs)
    for name, spec in got.items():
        want = jspecs[name][0]
        want = want + (None,) * (len(spec) - len(want))
        assert spec == want, (name, spec, want)


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_round_trip_and_params_from_jax_by_coords(tp):
    """Each rank's shards of a whole dict have the local model's shapes;
    gathering them gives the whole dict back bit for bit; ``params_from_jax``
    with a rank's coords gives the same shards."""
    jcfg = jl.tiny_config(param_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, meta.unbox(jl.LlamaForCausalLM(
        jcfg).init(jax.random.key(2), jnp.zeros((1, 8), jnp.int32))))
    tcfg = tl.tiny_config(tp_size=tp)
    whole = convert.params_from_jax(tl.tiny_config(), params)
    shards = [convert.shard_state_dict(tcfg, whole, {"tp": r})
              for r in range(tp)]
    local = tl.LlamaForCausalLM(tcfg, device="meta").state_dict()
    for r, shard in enumerate(shards):
        assert {k: v.shape for k, v in shard.items()} == {
            k: v.shape for k, v in local.items()}
        by_coords = convert.params_from_jax(tcfg, params, {"tp": r})
        assert all(torch.equal(by_coords[k], v) for k, v in shard.items())
    back = convert.gather_state_dict(tcfg, shards)
    assert all(torch.equal(back[k], v) for k, v in whole.items())


def test_zero1_dims_match_jax_zero1_state_specs():
    """The dims ZeRO-1 shards the moments along at tp=2 x dp=2 equal JAX's
    ``zero1_state_specs`` on the 4-device mesh."""
    tp = 2
    jspecs, boxed = _jax_specs_by_port_name(tp, 2)
    nxd.neuronx_distributed_config(tensor_parallel_size=tp,
                                   devices=jax.devices()[:4])
    try:
        shapes = jax.tree.map(lambda a: tuple(a.shape), meta.unbox(boxed))
        pspecs = nn.get_partition_spec(boxed)
        ext = jopt.zero1_state_specs({"mu": pspecs}, pspecs, shapes)["mu"]
    finally:
        jmesh.destroy_model_parallel()
    flat_ext = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                name = ".".join(path + (k,))
                flat_ext[name.replace("params.", "", 1).replace(
                    "model.", "").replace("layer_", "layers.")] = v
    walk(ext, ())
    tcfg = tl.tiny_config(tp_size=tp)
    full = {n: tuple(t.shape) for n, t in tl.LlamaForCausalLM(
        tl.tiny_config(), device="meta").state_dict().items()}
    got = topt.zero1_state_specs(convert.param_specs(tcfg), full,
                                 mesh_factorization(4, tp))
    for name, spec in got.items():
        want = tuple(flat_ext[name])
        want = want + (None,) * (len(spec) - len(want))
        assert spec == want, (name, spec, want)


def test_what_stays_out_across_ranks_raises(tmp_path):
    """The other model families across ranks, serving a Llama or a
    Mixtral at tp > 1 or a Mixtral at ep > 1, a quantized expert bank at
    tp > 1 and a model config whose tp_size is not the ranks' raise; so do
    LoRA and weight quantization at tp > 1 in the config, Mixtral's
    included. (The ``Trainer`` loop, checkpoints, ``integrity_every``,
    dropout, Mixtral and the Sinkhorn router across ranks run:
    ``tests/test_torch_trainer_loop_tp.py``,
    ``tests/test_torch_mixtral_tp.py``, ``tests/test_torch_mixtral_ep.py``.)"""
    tcfg = tl.tiny_config(dtype=torch.float32, num_layers=1)
    out = _ranks(tmp_path, torch_ranks.refusals_across_ranks, 2, tcfg,
                 str(tmp_path / "ckpt"))
    for r in out:
        assert all("later slice" in msg for name, msg in r.items()
                   if name not in ("gpt_neox", "tp_size",
                                   "quantized_bank")), r
        assert "across ranks" in r["gpt_neox"] and "later" in r["gpt_neox"]
        assert "not sharded by the port" in r["quantized_bank"]
        assert "differs from the ranks' tensor-parallel size" in r["tp_size"]
    from neuronx_distributed_tpu_torch.lora import LoraConfig
    from neuronx_distributed_tpu_torch.models import mixtral as tm

    tp = 2
    with pytest.raises(ValueError, match="lora at tp_size=2"):
        tl.tiny_config(tp_size=tp, lora=LoraConfig())
    with pytest.raises(ValueError, match="weight_quant at tp_size=2"):
        tl.tiny_config(tp_size=tp, weight_quant="int8")
    with pytest.raises(ValueError, match="weight_quant at tp_size=2"):
        tm.tiny_moe_config(tp_size=tp, weight_quant="int8")

"""The PyTorch port's ModelBuilder / NxDModel against the JAX package's
(``neuronx_distributed_tpu/inference/model_builder.py``), mirroring the
builder tests of tests/test_inference.py: the buckets, the router and its
padding, the serving workers, the state specs and initializers, and
bundles that serve from a fresh process.

The port's bundle names each function by import path where the reference
packs a StableHLO export; it is loaded in a subprocess that refuses
``jax``, ``flax``, ``optax`` and ``neuronx_distributed_tpu``, as
tests/test_torch_engine.py runs the port."""

import functools
import json
import os
import subprocess
import sys
import textwrap
import types
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from neuronx_distributed_tpu.inference import engine as je
from neuronx_distributed_tpu.inference import model_builder as jmb
from neuronx_distributed_tpu.inference.generation import generate as jgenerate
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu_torch.inference import engine as te
from neuronx_distributed_tpu_torch.inference import model_builder as mb
from neuronx_distributed_tpu_torch.inference.kv_cache import (KVCache,
                                                              init_kv_cache)
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(num_layers, seed):
    ps.initialize_model_parallel()
    try:
        cfg = jl.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32,
                             num_layers=num_layers)
        params = meta.unbox(jl.LlamaForCausalLM(cfg).init(
            jax.random.key(seed), jnp.zeros((2, 16), jnp.int32)))
    finally:
        ps.destroy_model_parallel()
    tcfg = tl.tiny_config(dtype=torch.float32, num_layers=num_layers)
    return cfg, params, tcfg, params_from_jax(
        tcfg, jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def models():
    """tests/test_inference.py's tiny model (2 layers) and a 1-layer
    draft, each as JAX params and the port's state dict."""
    return _jax_model(2, 0), _jax_model(1, 30)


def _logits_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_generate_buckets_match_jax():
    for lo, hi in ((128, 128), (256, 128), (128, 1024), (128, 513),
                   (128, 510), (1, 7), (3, 100), (16, 4096), (100, 101)):
        assert mb.generate_buckets(lo, hi) == jmb.generate_buckets(lo, hi)
    from neuronx_distributed_tpu_torch.inference import generate_buckets

    assert generate_buckets(128, 1024) == [128, 256, 512, 1024]


def _ce_pair(models):
    """The same context-encoding function in both packages (full-sequence
    logits, no cache), over the same weights."""
    (jcfg, params, tcfg, sd), _ = models
    jmodel = jl.LlamaForCausalLM(jcfg)
    tmodel = tl.build_model(tcfg, sd, "cpu")

    def jce(ids):
        return jmodel.apply(params, ids)

    def tce(ids):
        return tmodel(ids.long())

    return jce, tce


def test_router_choice_and_padding_match_jax(models):
    """The larger bucket registered first; the router picks the tightest
    fitting bucket in both packages, ``pad_inputs`` zero-pads as JAX does
    (the logits equal JAX's on the padded ids), and a ragged call without
    it raises JAX's message."""
    jce, tce = _ce_pair(models)
    jm = (jmb.ModelBuilder()
          .add("ce", jce, [(jnp.zeros((2, 16), jnp.int32),),
                           (jnp.zeros((2, 8), jnp.int32),)])
          .trace().compile())
    tm = (mb.ModelBuilder()
          .add("ce", tce, [(torch.zeros((2, 16), dtype=torch.int32),),
                           (torch.zeros((2, 8), dtype=torch.int32),)])
          .trace().compile())
    assert tm.keys() == jm.keys() == ["ce"]
    ids = np.random.RandomState(8).randint(0, 256, (2, 5)).astype(np.int32)
    for shape in ((2, 5), (2, 8), (2, 9), (2, 16)):
        probe = np.zeros(shape, np.int32)
        ja = jm.router("ce", (jnp.asarray(probe),))
        ta = tm.router("ce", (torch.from_numpy(probe),))
        assert [x.shape for x in ta.leaves] == [
            tuple(x.shape) for x in jax.tree_util.tree_leaves(ja.bucket)]
    with pytest.raises(KeyError) as tk:
        tm.router("ce", (torch.zeros((2, 17), dtype=torch.int32),))
    with pytest.raises(KeyError) as jk:
        jm.router("ce", (jnp.zeros((2, 17), jnp.int32),))
    assert str(tk.value) == str(jk.value)
    got = tm.forward("ce", torch.from_numpy(ids), pad_inputs=True)
    want = jm.forward("ce", jnp.asarray(ids), pad_inputs=True)
    assert tuple(got.shape) == (2, 8, 256)
    _logits_close(got, want)
    padded = torch.nn.functional.pad(torch.from_numpy(ids), (0, 3))
    assert torch.equal(got, tce(padded))
    with pytest.raises(ValueError) as te_:
        tm.forward("ce", torch.from_numpy(ids))
    with pytest.raises(ValueError) as je_:
        jm.forward("ce", jnp.asarray(ids))
    assert str(te_.value) == str(je_.value)
    assert "pad_inputs" in str(te_.value)
    with pytest.raises(KeyError):
        tm.forward("nope", torch.from_numpy(ids))


def test_forward_binds_params_and_state_and_copies_the_rest(models):
    """A call passing the captured tensors runs on them in place; other
    tensors are copied into the bound ones; the state comes back updated
    in place and every other output is a copy."""
    (_, _, tcfg, sd), _ = models
    b, s = 2, 8
    fn = functools.partial(mb.cached_step, model_cfg=tcfg)
    cache0 = init_kv_cache(tcfg.num_layers, b, 16, tcfg.num_kv_heads,
                           tcfg.head_dim_, dtype=torch.float32, device="cpu")
    z = torch.zeros((b, s), dtype=torch.int32)
    m = mb.ModelBuilder().add("ce", fn, [(sd, z, z, cache0)]).trace()
    m = m.compile()
    prog = m._artifacts[("ce", 0)].compiled
    bound = [x for x, is_b in zip(prog.buffers, prog.bound) if is_b]
    assert any(x is cache0.k for x in bound)
    assert any(x is sd["embed.embedding"] for x in bound)
    ids = torch.arange(b * s, dtype=torch.int32).reshape(b, s)
    pos = torch.arange(s, dtype=torch.int32).expand(b, s).contiguous()
    logits, cache = m.forward("ce", sd, ids, pos, cache0)
    assert cache.k is cache0.k and int(cache.index) == s
    assert int(cache0.index) == 0
    again, _ = m.forward("ce", sd, ids, pos, cache0)
    assert again is not logits and torch.equal(again, logits)
    fresh = init_kv_cache(tcfg.num_layers, b, 16, tcfg.num_kv_heads,
                          tcfg.head_dim_, dtype=torch.float32, device="cpu")
    other, c2 = m.forward("ce", sd, ids, pos, fresh)
    assert torch.equal(other, logits) and c2.k is cache0.k
    with torch.no_grad():
        eager, _ = fn(sd, ids, pos, mb._canonical(fresh))
    assert torch.equal(eager, logits)


def test_register_serving_workers_match_jax(models):
    """JAX's disaggregated workers: the same keys and cache shapes, and
    the logits of a prefill step and a decode step over the same pool
    within 1e-4 x max|logit|."""
    (jcfg, params, tcfg, sd), _ = models
    jecfg = je.EngineConfig(block_size=4, num_blocks=16, max_slots=2,
                            max_blocks_per_seq=8, token_budget=8,
                            kv_dtype=jnp.float32, disaggregated=True)
    tecfg = te.EngineConfig(block_size=4, num_blocks=16, max_slots=2,
                            max_blocks_per_seq=8, token_budget=8,
                            disaggregated=True)
    ps.initialize_model_parallel()
    jm = jmb.register_serving_workers(jmb.ModelBuilder(), jcfg, jecfg,
                                      params).trace().compile()
    tm = mb.register_serving_workers(mb.ModelBuilder(), tcfg, tecfg, sd,
                                     device="cpu").trace().compile()
    assert tm.keys() == jm.keys() == ["chunked_prefill", "token_decode"]
    for key in tm.keys():
        jcache = jm._artifacts[(key, 0)].bucket[1]
        tcache = tm._artifacts[(key, 0)].compiled.buffers
        tspec = [x.shape for x in tm._artifacts[(key, 0)].leaves]
        jspec = [tuple(x.shape) for x in jax.tree_util.tree_leaves(
            jm._artifacts[(key, 0)].bucket)]
        assert tspec[-3:] == jspec[-3:]          # tokens, positions, slots
        for name in ("k", "v", "pos", "block_tables", "lengths"):
            assert tuple(getattr(jcache, name).shape) in tspec, name
        assert len(tcache) == len(tspec)
    spec = mb.serving_state_spec(tcfg, tecfg)
    assert spec == jmb.serving_state_spec(jcfg, jecfg)
    jm.state_spec = spec
    tm.state_spec, tm.device = spec, torch.device("cpu")
    tables = np.full((2, 8), -1, np.int32)
    tables[0, :3] = [4, 9, 2]
    tables[1, :2] = [7, 1]
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, 256, (8,)).astype(np.int32)
    pos = np.arange(8, dtype=np.int32)[None]
    slots = np.zeros((8,), np.int32)
    jc = jm.init_state().replace(block_tables=jnp.asarray(tables))
    tc = tm.init_state()
    tc.block_tables.copy_(torch.from_numpy(tables))
    jl_, jc = jm.forward("chunked_prefill", params, jc,
                         jnp.asarray(prompt[None]), jnp.asarray(pos),
                         jnp.asarray(slots))
    tl_, tc = tm.forward("chunked_prefill", sd, tc,
                         torch.from_numpy(prompt[None]),
                         torch.from_numpy(pos), torch.from_numpy(slots))
    _logits_close(tl_, jl_)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    tok = np.array([[int(np.argmax(np.asarray(jl_)[0, 7])), 0]], np.int32)
    dpos = np.array([[8, mb.PAD_POSITION]], np.int32)
    dslots = np.array([0, 2], np.int32)
    jl2, _ = jm.forward("token_decode", params, jc, jnp.asarray(tok),
                        jnp.asarray(dpos), jnp.asarray(dslots))
    tl2, _ = tm.forward("token_decode", sd, tc, torch.from_numpy(tok),
                        torch.from_numpy(dpos), torch.from_numpy(dslots))
    _logits_close(tl2[:, :1], np.asarray(jl2)[:, :1])


def test_serving_state_specs_match_jax(models):
    (jcfg, _, tcfg, _), _ = models
    for kw, tkw in ((dict(kv_dtype=jnp.float32), {}),
                    (dict(kv_dtype=jnp.bfloat16),
                     dict(kv_dtype=torch.bfloat16)),
                    (dict(quantized=True), dict(quantized=True))):
        base = dict(block_size=4, num_blocks=16, max_slots=3,
                    max_blocks_per_seq=8, token_budget=8)
        assert mb.serving_state_spec(
            tcfg, te.EngineConfig(**base, **tkw)) == jmb.serving_state_spec(
            jcfg, je.EngineConfig(**base, **kw))


@pytest.mark.parametrize("spec", [
    dict(kind="paged", num_layers=2, num_blocks=8, block_size=4,
         num_kv_heads=2, head_dim=16, max_slots=3, max_blocks_per_seq=5,
         dtype="float32"),
    dict(kind="paged", num_layers=2, num_blocks=8, block_size=4,
         num_kv_heads=2, head_dim=16, max_slots=3, max_blocks_per_seq=5,
         quantized=True),
    dict(num_layers=2, batch=3, max_len=12, num_kv_heads=2, head_dim=16,
         dtype="float32")])
def test_init_state_matches_jax(spec):
    """The three kinds: every field's shape, dtype and values equal JAX's
    (the contiguous cache's index a 0-dim int32, as JAX's)."""
    jm = jmb.NxDModel({})
    jm.state_spec = spec
    tm = mb.NxDModel({}, device="cpu")
    tm.state_spec = spec
    j, t = jm.init_state(), tm.init_state()
    names = [f for f in ("k", "v", "pos", "index", "block_tables",
                         "lengths", "k_scale", "v_scale") if hasattr(j, f)]
    for name in names:
        jv, tv = np.asarray(getattr(j, name)), getattr(t, name)
        assert str(tv.dtype).replace("torch.", "") == str(jv.dtype), name
        np.testing.assert_array_equal(tv.numpy(), jv, err_msg=name)
    assert tm.init_state() is t              # one state, reset
    with pytest.raises(ValueError, match="state_spec"):
        mb.NxDModel({}, device="cpu").init_state()


def _save_generation_bundle(models, path, b=2, bucket=16, new=6):
    (_, _, tcfg, sd), _ = models
    fn = functools.partial(mb.cached_step, model_cfg=tcfg)
    cache0 = init_kv_cache(tcfg.num_layers, b, bucket + new,
                           tcfg.num_kv_heads, tcfg.head_dim_,
                           dtype=torch.float32, device="cpu")
    z = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    model = (mb.ModelBuilder()
             .add("context_encoding", fn, [(sd, z(b, bucket), z(b, bucket),
                                            cache0)])
             .add("token_generation", fn, [(sd, z(b, 1), z(b, 1), cache0)])
             .trace().compile())
    model.save(path, params=sd,
               state_spec=dict(num_layers=tcfg.num_layers, batch=b,
                               max_len=bucket + new,
                               num_kv_heads=tcfg.num_kv_heads,
                               head_dim=tcfg.head_dim_, dtype="float32"),
               generation_config={"buckets": [bucket]})
    return model


_FRESH = textwrap.dedent("""
    import sys

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                      "ml_dtypes",
                                      "neuronx_distributed_tpu"):
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    import numpy as np
    from neuronx_distributed_tpu_torch.inference import model_builder as mb
    m = mb.NxDModel.load(sys.argv[1], device="cpu")
    ids = np.array(eval(sys.argv[2]))
    fn = getattr(mb, sys.argv[3])
    toks = fn(m, ids, np.array(eval(sys.argv[4])), int(sys.argv[5]))
    print("TOKENS", toks.tolist())
""")


def _fresh_process(path, ids, plen, new, fn="bundle_generate"):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _FRESH, path, repr(np.asarray(ids).tolist()),
         fn, repr(list(plen)), str(new)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("TOKENS")][0]
    return np.array(json.loads(line[len("TOKENS "):]))


def test_bundle_serves_from_fresh_process_like_jax(models, tmp_path):
    """tests/test_inference.py's fresh-process gate: a bundle saved here
    and loaded in a process without JAX generates JAX's greedy ids."""
    (jcfg, params, _, _), _ = models
    path = str(tmp_path / "bundle.nxd")
    _save_generation_bundle(models, path)
    ids = np.asarray(jax.random.randint(jax.random.key(13), (2, 10), 0,
                                        jcfg.vocab_size))
    ps.initialize_model_parallel()
    ref = jgenerate(jcfg, params, jnp.asarray(ids), jnp.asarray([10, 7]), 6,
                    buckets=(16,))
    got = _fresh_process(path, ids, [10, 7], 6)
    np.testing.assert_array_equal(got, np.asarray(ref))
    here = mb.bundle_generate(mb.NxDModel.load(path, device="cpu"), ids,
                              np.array([10, 7]), 6)
    np.testing.assert_array_equal(here.numpy(), np.asarray(ref))


def test_speculation_bundle_matches_jax(models, tmp_path):
    """tests/test_inference.py's speculation bundle: target and draft
    prefill keys and one speculative round, loaded in a process without
    JAX, reproduce JAX's target greedy ids."""
    (jcfg, params, tcfg, sd), (_, _, dcfg, dsd) = models
    b, bucket, new, k = 2, 16, 8, 3
    slack = new * (k + 1) + k + 1

    def cache(c):
        return init_kv_cache(c.num_layers, b, bucket + slack, c.num_kv_heads,
                             c.head_dim_, dtype=torch.float32, device="cpu")

    tc0, dc0 = cache(tcfg), cache(dcfg)
    z = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    rnd = functools.partial(mb.speculation_round, model_cfg=tcfg,
                            draft_cfg=dcfg, speculation_length=k,
                            max_new_tokens=new)
    model = (mb.ModelBuilder()
             .add("context_encoding",
                  functools.partial(mb.cached_step, model_cfg=tcfg),
                  [(sd, z(b, bucket), z(b, bucket), tc0)])
             .add("draft_context_encoding",
                  functools.partial(mb.cached_step, model_cfg=dcfg),
                  [(dsd, z(b, bucket), z(b, bucket), dc0)])
             .add("speculation", rnd,
                  [(sd, dsd, tc0, dc0, z(b), z(b), z(b), z(b, new + k + 1))])
             .trace().compile())
    spec = lambda c: dict(num_layers=c.num_layers, batch=b,  # noqa: E731
                          max_len=bucket + slack,
                          num_kv_heads=c.num_kv_heads, head_dim=c.head_dim_,
                          dtype="float32")
    path = str(tmp_path / "spec_bundle.nxd")
    model.save(path, params={"target": sd, "draft": dsd},
               state_spec=spec(tcfg),
               generation_config={"buckets": [bucket],
                                  "speculation_length": k,
                                  "draft_state_spec": spec(dcfg)})
    ids = np.asarray(jax.random.randint(jax.random.key(31), (b, 10), 0,
                                        jcfg.vocab_size))
    ps.initialize_model_parallel()
    ref = jgenerate(jcfg, params, jnp.asarray(ids), jnp.asarray([10, 7]),
                    new, buckets=(bucket,))
    got = _fresh_process(path, ids, [10, 7], new,
                         "bundle_speculative_generate")
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_manifest_carries_the_references_fields(models, tmp_path):
    """The manifest has JAX's fields (``torch_version`` for
    ``jax_version``); weights are raw bytes with path, dtype and shape;
    artifacts name their functions and fingerprints."""
    path = str(tmp_path / "bundle.nxd")
    _save_generation_bundle(models, path)
    (_, _, tcfg, sd), _ = models
    with zipfile.ZipFile(path) as z:
        man = json.loads(z.read("manifest.json"))
        assert set(man) == {"version", "torch_version", "artifacts",
                            "weights", "weights_store", "mesh",
                            "state_spec", "generation_config"}
        assert man["version"] == jmb.NxDModel.FORMAT_VERSION
        assert man["weights_store"] is None and man["mesh"] is None
        w = {x["path"]: x for x in man["weights"]}
        assert set(w) == set(sd)
        emb = w["embed.embedding"]
        assert (emb["dtype"], emb["shape"]) == ("float32", [256, 64])
        raw = np.frombuffer(z.read(emb["file"]), np.float32)
        np.testing.assert_array_equal(raw.reshape(256, 64),
                                      sd["embed.embedding"].numpy())
        fn = man["artifacts"][0]["function"]
        assert fn["function"] == ("neuronx_distributed_tpu_torch.inference."
                                  "model_builder:cached_step")
        assert fn["kwargs"]["model_cfg"]["fields"]["num_layers"] == 2


def test_refusals(models, tmp_path):
    """What the port refuses: sharded weight specs, the CP workers, a
    lambda or a closure at save, packaged executables at load, and a
    function whose source changed since the bundle was saved."""
    (_, _, tcfg, sd), _ = models
    path = str(tmp_path / "bundle.nxd")
    model = _save_generation_bundle(models, path)
    with pytest.raises(NotImplementedError, match="param_specs"):
        model.save(path, params=sd, param_specs={k: None for k in sd})
    assert mb.shard_checkpoint(sd, {k: None for k in sd}) is sd
    assert mb.shard_checkpoint(sd, {k: (None, None) for k in sd}) is sd
    with pytest.raises(NotImplementedError, match="sharded"):
        mb.shard_checkpoint(sd, {k: ("tp", None) for k in sd})
    ecfg = types.SimpleNamespace(**{
        f.name: getattr(te.EngineConfig(), f.name)
        for f in te.EngineConfig.__dataclass_fields__.values()}, cp=2)
    with pytest.raises(NotImplementedError, match="cp > 1"):
        mb.register_serving_workers(mb.ModelBuilder(), tcfg, ecfg, sd,
                                    device="cpu")
    closure = (mb.ModelBuilder()
               .add("x", lambda ids: ids + 1,
                    [(torch.zeros(2, dtype=torch.int32),)])
               .trace().compile())
    assert torch.equal(closure.forward("x", torch.ones(2, dtype=torch.int32)),
                       torch.full((2,), 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="lambda or a closure"):
        closure.save(str(tmp_path / "x.nxd"))
    with pytest.raises(NotImplementedError, match="no executable"):
        mb.NxDModel.load(path, device="cpu", trust_packaged_executables=True)
    with zipfile.ZipFile(path) as z:
        items = {n: z.read(n) for n in z.namelist()}
    man = json.loads(items["manifest.json"])
    man["artifacts"][0]["fingerprint"] = "0" * 64
    items["manifest.json"] = json.dumps(man).encode()
    stale = str(tmp_path / "stale.nxd")
    with zipfile.ZipFile(stale, "w") as z:
        for n, data in items.items():
            z.writestr(n, data)
    with pytest.raises(ValueError, match="changed since the bundle"):
        mb.NxDModel.load(stale, device="cpu")
    assert mb.function_ref(functools.partial(mb.cached_step, 1)) is None
    assert mb.function_ref(mb.cached_step) == {
        "function": "neuronx_distributed_tpu_torch.inference.model_builder:"
                    "cached_step", "kwargs": {}}


def test_in_memory_compile_goes_through_the_cache(models):
    """``compile(cache=...)``: the first model captures and publishes each
    bucket; once it is freed a second build over the same tensors leases
    them."""
    from neuronx_distributed_tpu_torch.inference.aot_cache import (
        AotExecutableCache)

    (_, _, tcfg, sd), _ = models
    cache = AotExecutableCache()
    fn = functools.partial(mb.cached_step, model_cfg=tcfg)
    c0 = init_kv_cache(tcfg.num_layers, 1, 8, tcfg.num_kv_heads,
                       tcfg.head_dim_, dtype=torch.float32, device="cpu")
    c0 = mb._canonical(c0)
    z = torch.zeros((1, 4), dtype=torch.int32)

    def build():
        return (mb.ModelBuilder().add("ce", fn, [(sd, z, z, c0)])
                .trace().compile(cache=cache))

    first = build()
    assert (cache.misses, cache.hits) == (1, 0)
    del first
    second = build()
    assert (cache.misses, cache.hits) == (1, 1)
    assert isinstance(second._artifacts[("ce", 0)].compiled.buffers[-1],
                      torch.Tensor)
    assert isinstance(c0, KVCache)


_PROBE = textwrap.dedent("""
    import dataclasses
    import os

    MARK = os.environ["NXD_PROBE_MARK"]
    open(MARK + ".imported", "w").close()

    def boom(*args, **kwargs):
        open(MARK + ".called", "w").close()

    @dataclasses.dataclass
    class Probe:
        x: int = 0

        def __post_init__(self):
            open(MARK + ".called", "w").close()
""")


def _tamper(path, out, edit):
    with zipfile.ZipFile(path) as z:
        items = {n: z.read(n) for n in z.namelist()}
    man = json.loads(items["manifest.json"])
    edit(man)
    items["manifest.json"] = json.dumps(man).encode()
    with zipfile.ZipFile(out, "w") as z:
        for n, data in items.items():
            z.writestr(n, data)


def _name_function(ref):
    def edit(man):
        man["artifacts"][0]["function"]["function"] = ref
    return edit


def _name_argument(arg):
    def edit(man):
        man["artifacts"][0]["function"]["kwargs"]["model_cfg"] = arg
    return edit


def _name_weight_dtype(man):
    man["weights"][0]["dtype"] = "load"


@pytest.mark.parametrize("edit, match", [
    (_name_function("nxd_probe_mod:boom"), "not a registered"),
    (_name_function("subprocess:Popen"), "not a registered"),
    (_name_function("os:system"), "not a registered"),
    (_name_argument({"__dataclass__": "nxd_probe_mod:Probe",
                     "fields": {"x": 1}}), "model config dataclasses"),
    (_name_argument({"__dataclass__": "subprocess:Popen",
                     "fields": {"args": "true", "shell": True}}),
     "model config dataclasses"),
    (_name_argument({"__dtype__": "load"}), "not a torch dtype"),
    (_name_weight_dtype, "not a torch dtype"),
], ids=["probe_function", "popen_function", "system_function",
        "probe_dataclass", "popen_dataclass", "dtype_attribute",
        "weight_dtype_attribute"])
def test_load_runs_nothing_the_manifest_names(models, tmp_path,
                                              monkeypatch, edit, match):
    """A manifest that names a foreign callable (a function, a class for a
    JSON argument, a ``torch`` attribute that is not a dtype) is refused
    before it is imported or called: ``load`` resolves names only among
    the registered bundle functions and the model configs."""
    mark = str(tmp_path / "probe")
    (tmp_path / "nxd_probe_mod.py").write_text(_PROBE)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("NXD_PROBE_MARK", mark)
    monkeypatch.delitem(sys.modules, "nxd_probe_mod", raising=False)
    path = str(tmp_path / "bundle.nxd")
    _save_generation_bundle(models, path)
    bad = str(tmp_path / "bad.nxd")
    _tamper(path, bad, edit)
    with pytest.raises(ValueError, match=match):
        mb.NxDModel.load(bad, device="cpu")
    assert "nxd_probe_mod" not in sys.modules
    assert not os.path.exists(mark + ".imported")
    # imported by the caller, a foreign function is still not called
    import nxd_probe_mod  # noqa: F401

    with pytest.raises(ValueError, match=match):
        mb.NxDModel.load(bad, device="cpu")
    assert not os.path.exists(mark + ".called")
    assert mb.function_ref(nxd_probe_mod.boom) is None
    mb.NxDModel.load(path, device="cpu")        # the untampered bundle


def test_registered_functions_save_and_load(models, tmp_path, monkeypatch):
    """A caller's own function, registered with ``bundle_function``, is
    saved by name and found again at load; an unregistered one is not
    saved."""
    (_, _, tcfg, sd), _ = models
    monkeypatch.setattr(mb, "_BUNDLE_FUNCTIONS", dict(mb._BUNDLE_FUNCTIONS))

    def add_one(ids):
        return ids + 1

    add_one.__qualname__ = "add_one"
    x = torch.zeros(2, dtype=torch.int32)
    unregistered = (mb.ModelBuilder().add("x", add_one, [(x,)])
                    .trace().compile())
    with pytest.raises(ValueError, match="not registered"):
        unregistered.save(str(tmp_path / "u.nxd"))
    mb.bundle_function(add_one)
    model = mb.ModelBuilder().add("x", add_one, [(x,)]).trace().compile()
    path = str(tmp_path / "r.nxd")
    model.save(path)
    got = mb.NxDModel.load(path, device="cpu").forward(
        "x", torch.ones(2, dtype=torch.int32))
    assert torch.equal(got, torch.full((2,), 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="lambda or a closure"):
        mb.bundle_function(lambda ids: ids)

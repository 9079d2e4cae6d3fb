"""The port's one-box scripts against the JAX package's:
``checkpoint_converter`` for Llama, Mixtral, GPT-NeoX, BERT and ViT in
both directions, bit for bit against the JAX converters followed by
``params_from_jax``, and a CLI round trip that never unpickles;
``yaml_converter``'s dicts; ``prepare_dataset``'s packing bit for bit, and
text through the CLI (a tokenizer built here, nothing fetched) to the
``.bin`` and the port's native loader."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from neuronx_distributed_tpu.models import bert as jb
from neuronx_distributed_tpu.models import gpt_neox as jn
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.models import mixtral as jm
from neuronx_distributed_tpu.models import vit as jv
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.scripts import checkpoint_converter as jcc
from neuronx_distributed_tpu.scripts import prepare_dataset as jpd
from neuronx_distributed_tpu.scripts import yaml_converter as jyc
from neuronx_distributed_tpu_torch.models import bert as tb
from neuronx_distributed_tpu_torch.models import gpt_neox as tn
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models import mixtral as tm
from neuronx_distributed_tpu_torch.models import vit as tv
from neuronx_distributed_tpu_torch.models.convert import params_from_jax
from neuronx_distributed_tpu_torch.scripts import checkpoint_converter as tcc
from neuronx_distributed_tpu_torch.scripts import prepare_dataset as tpd
from neuronx_distributed_tpu_torch.scripts import yaml_converter as tyc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# family: (JAX module, port module, model class, config function, kwargs)
FAMILIES = {
    "llama": (jl, tl, "LlamaForCausalLM", "tiny_config", {}),
    "llama_tied": (jl, tl, "LlamaForCausalLM", "tiny_config",
                   {"tie_embeddings": True}),
    "mixtral": (jm, tm, "MixtralForCausalLM", "tiny_moe_config", {}),
    "neox": (jn, tn, "GPTNeoXForCausalLM", "tiny_neox_config", {}),
    "bert": (jb, tb, "BertForPreTraining", "tiny_bert_config",
             {"mlm_transform": True}),
    "vit": (jv, tv, "ViTForImageClassification", "tiny_vit_config", {}),
}


def _family(name):
    return name.split("_")[0]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, JAX config, port config, JAX tree, its HF state dict as fp32
    numpy arrays)."""
    jmod, tmod, cls, fn, kw = FAMILIES[request.param]
    jcfg = getattr(jmod, fn)(num_layers=2, **kw)
    tcfg = getattr(tmod, fn)(num_layers=2, **kw)
    x = (jnp.zeros((1, 3, 16, 16)) if request.param == "vit"
         else jnp.zeros((1, 8), jnp.int32))
    ps.initialize_model_parallel()
    try:
        # BERT makes its type embedding only when given token types
        args = (x, jnp.zeros_like(x)) if request.param == "bert" else (x,)
        tree = jax.tree.map(np.asarray, meta.unbox(getattr(jmod, cls)(
            jcfg).init(jax.random.key(0), *args)))
    finally:
        ps.destroy_model_parallel()
    hf = jcc._NXD2HF[_family(request.param)](tree, jcfg)
    rng = np.random.RandomState(7)    # every entry distinct and random
    hf = {k: rng.randn(*np.shape(v)).astype(np.float32) for k, v in hf.items()}
    if request.param == "bert":       # the tied aliases stay tied
        hf["cls.predictions.decoder.weight"] = hf[
            "bert.embeddings.word_embeddings.weight"]
        hf["cls.predictions.decoder.bias"] = hf["cls.predictions.bias"]
    return request.param, jcfg, tcfg, hf


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def test_hf_to_port_matches_jax_bit_for_bit(family):
    name, jcfg, tcfg, hf = family
    want = params_from_jax(tcfg, jcc._HF2NXD[_family(name)](hf, jcfg))
    got = tcc._HF2NXD[_family(name)](_torch(hf), tcfg)
    assert set(got) == set(want)
    for k, ref in want.items():
        assert got[k].dtype == ref.dtype and torch.equal(got[k], ref), k
    # the state dict is the port model's own
    _, tmod, cls, _, _ = FAMILIES[name]
    shapes = getattr(tmod, cls)(tcfg, device="meta").state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in shapes.items()}


def test_port_to_hf_matches_jax_bit_for_bit(family):
    name, jcfg, tcfg, hf = family
    tree = jcc._HF2NXD[_family(name)](hf, jcfg)
    want = jcc._NXD2HF[_family(name)](tree, jcfg)
    got = tcc._NXD2HF[_family(name)](params_from_jax(tcfg, tree), tcfg)
    assert set(got) == set(want)
    for k, ref in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref),
                                      err_msg=k)


def test_round_trip_keeps_dtype_and_bits(family):
    """HF -> port -> HF gives the input back bit for bit, in bf16 too
    (the converters keep the dtype)."""
    name, _, tcfg, hf = family
    f = _family(name)
    src = {k: v.to(torch.bfloat16) for k, v in _torch(hf).items()}
    port = tcc._HF2NXD[f](src, tcfg)
    assert all(v.dtype == torch.bfloat16 for v in port.values())
    back = tcc._NXD2HF[f](port, tcfg)
    want = {k: v for k, v in src.items()
            if not (name == "llama_tied" and k == "lm_head.weight")}
    assert set(back) == set(want)
    assert all(torch.equal(back[k], v) for k, v in want.items())


def test_cli_round_trip_never_unpickles(tmp_path, monkeypatch):
    """safetensors in, ``torch.save`` out and back on ``--device cpu``:
    the same tensors as the functions give, with ``pickle.load``/``loads``
    made to raise; a file whose pickle names a callable is refused; with
    no ``--device`` the CLI asks for the card."""
    from safetensors.torch import save_file

    jcfg = jl.tiny_config(num_layers=2)
    ps.initialize_model_parallel()
    try:
        tree = jax.tree.map(np.asarray, meta.unbox(jl.LlamaForCausalLM(
            jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))))
    finally:
        ps.destroy_model_parallel()
    hf = _torch(jcc.convert_nxd_to_hf_llama(tree, jcfg))
    src = str(tmp_path / "hf.safetensors")
    save_file(hf, src)

    def refuse(*a, **k):
        raise AssertionError("the converter unpickled")

    monkeypatch.setattr(pickle, "load", refuse)
    monkeypatch.setattr(pickle, "loads", refuse)
    args = ["--family", "llama", "--num-layers", "2", "--vocab-size", "256",
            "--hidden-size", "64", "--intermediate-size", "128",
            "--num-heads", "4", "--num-kv-heads", "2", "--device", "cpu"]
    port = str(tmp_path / "port.pt")
    tcc.main(["--input", src, "--output", port] + args)
    back = str(tmp_path / "back.pt")
    tcc.main(["--input", port, "--output", back, "--direction", "nxd2hf"]
             + args)
    monkeypatch.undo()
    tcfg = tl.tiny_config(num_layers=2)
    got = torch.load(port, weights_only=True)
    want = tcc.convert_hf_llama_to_nxd(hf, tcfg)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], v) for k, v in want.items())
    again = torch.load(back, weights_only=True)
    assert set(again) == set(hf)
    assert all(torch.equal(again[k], v) for k, v in hf.items())
    evil = str(tmp_path / "evil.pt")
    torch.save({"x": torch.ones(1), "run": os.getcwd}, evil)
    with pytest.raises(pickle.UnpicklingError):
        tcc.main(["--input", evil, "--output", str(tmp_path / "o.pt")]
                 + args)
    with pytest.raises(SystemExit, match="no config field"):
        tcc.main(["--input", src, "--output", port, "--family", "neox",
                  "--num-layers", "2", "--num-kv-heads", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcc.main(["--input", src, "--output", port] + args[:-2])


YAML_DOCS = [
    {},
    {"tensor_parallel_size": 1, "seed": 0, "sequence_parallel": False},
    {"optimizer": {"max_grad_norm": 0.5, "grad_comm_dtype": "fp32"}},
    {"optimizer": {"grad_clipping": False}, "activation_checkpoint":
        {"mode": "full", "policy": "save_attention"}},
    {"mixed_precision": {"compute_dtype": "float32"},
     "pipeline": {"num_microbatches": 1}},
    {"activation_checkpoint": {"mode": "attention"},
     "checkpoint": {}, "pipeline_parallel_size": 1},
]


@pytest.mark.parametrize("doc", YAML_DOCS)
def test_yaml_dicts_match_jax(doc):
    """The kwargs' sections equal JAX's on the fields both have (the
    reference's others at their defaults), and ``config_to_dict`` gives
    JAX's dict."""
    import dataclasses

    jkw = jyc.dict_to_config_kwargs(doc)
    tkw = tyc.dict_to_config_kwargs(doc)
    for name, value in tkw.items():
        ref = jkw[name]
        if dataclasses.is_dataclass(value):
            want = dataclasses.asdict(ref)
            got = dataclasses.asdict(value)
            assert {k: want[k] for k in got} == got
        else:
            assert value == ref
    jcfg = jyc._cfg.neuronx_distributed_config(init_mesh=False, **jkw)
    tcfg = tyc._cfg.neuronx_distributed_config(**tkw)
    assert tyc.config_to_dict(tcfg) == jyc.config_to_dict(jcfg)
    assert tyc._cfg.neuronx_distributed_config(**tyc.dict_to_config_kwargs(
        tyc.config_to_dict(tcfg))) == tcfg


@pytest.mark.parametrize("doc,match", [
    ({"context_parallel_size": 2}, "not in the port yet"),
    # expert parallelism runs (tests/test_torch_mixtral_ep.py); across
    # pipeline stages it stays out
    ({"expert_parallel_size": 2, "pipeline_parallel_size": 2},
     "not in the port yet"),
    ({"optimizer": {"grad_comm_dtype": "int8"}}, "not in the port yet"),
    ({"tp_overlap_comm": True}, "not in the port yet"),
    ({"nope": 1}, "unknown config key"),
    ({"optimizer": {"nope": 1}}, "unknown optimizer option"),
    ({"optimizer": None}, "must be a mapping"),
])
def test_yaml_refusals(doc, match):
    """JAX's errors where the reference raises them (unknown keys, a null
    section); what the port cannot run raises as its config does."""
    with pytest.raises(ValueError, match=match):
        tyc._cfg.neuronx_distributed_config(**tyc.dict_to_config_kwargs(doc))
    if match in ("unknown config key", "unknown optimizer option",
                 "must be a mapping"):
        with pytest.raises(ValueError, match=match):
            jyc.dict_to_config_kwargs(doc)


def test_yaml_pipeline_parallel_runs(tmp_path):
    """``pipeline_parallel_size`` and the ``pipeline`` section map onto the
    port's config (:class:`PipelineConfig`), and ``config_to_dict`` writes
    JAX's dict; the ranks are laid out by the caller."""
    path = tmp_path / "pp.yaml"
    path.write_text("tensor_parallel_size: 2\npipeline_parallel_size: 2\n"
                    "pipeline:\n  num_microbatches: 8\n"
                    "  schedule: interleaved\n")
    cfg = tyc.load_yaml_config(str(path))
    assert cfg.parallel.pipeline_parallel_size == 2
    assert cfg.pipeline.num_microbatches == 8
    assert cfg.pipeline.schedule == "interleaved"
    jcfg = jyc.load_yaml_config(str(path))
    assert tyc.config_to_dict(cfg) == jyc.config_to_dict(jcfg)
    assert tyc._cfg.neuronx_distributed_config(
        init_mesh=False, **tyc.dict_to_config_kwargs(
            tyc.config_to_dict(cfg))) == cfg
    with pytest.raises(ValueError, match="process group"):
        tyc.load_yaml_config(str(path), init_mesh=True)
    with pytest.raises(ValueError, match="manual_cut_points"):
        tyc.dict_to_config_kwargs(
            {"pipeline": {"manual_cut_points": ["layers.4"]}})


def test_yaml_tensor_parallel_sequence_parallel_and_zero1_run(tmp_path):
    """``tensor_parallel_size``, ``sequence_parallel`` and ZeRO-1 map onto
    the port's config (the ranks are laid out by the caller, or with
    ``init_mesh=True``), and ``config_to_dict`` writes JAX's dict."""
    path = tmp_path / "tp.yaml"
    path.write_text("tensor_parallel_size: 2\nsequence_parallel: true\n"
                    "optimizer:\n  zero_one_enabled: true\n")
    cfg = tyc.load_yaml_config(str(path))
    assert cfg.parallel.tensor_parallel_size == 2
    assert cfg.sequence_parallel and cfg.optimizer.zero_one_enabled
    jcfg = jyc.load_yaml_config(str(path))
    assert tyc.config_to_dict(cfg) == jyc.config_to_dict(jcfg)
    assert tyc._cfg.neuronx_distributed_config(
        init_mesh=False, **tyc.dict_to_config_kwargs(
            tyc.config_to_dict(cfg))) == cfg
    with pytest.raises(ValueError, match="process group"):
        tyc.load_yaml_config(str(path), init_mesh=True)


def test_load_yaml_config_and_main(tmp_path, capsys):
    path = tmp_path / "cfg.yaml"
    path.write_text("optimizer:\n  max_grad_norm: 0.25\n"
                    "activation_checkpoint:\n  mode: full\n")
    cfg = tyc.load_yaml_config(str(path))
    assert cfg.optimizer.max_grad_norm == 0.25
    assert cfg.activation_checkpoint.mode == "full"
    tyc.main([str(path)])
    assert '"max_grad_norm": 0.25' in capsys.readouterr().out


@pytest.mark.parametrize("seqlen,dtype", [(7, np.uint16), (16, np.uint32),
                                          (1, np.uint16)])
def test_pack_tokens_matches_jax(seqlen, dtype):
    rng = np.random.RandomState(seqlen)
    chunks = [rng.randint(0, 60000, rng.randint(1, 40)) for _ in range(9)]
    want = jpd.pack_tokens(iter(chunks), seqlen, np.dtype(dtype))
    got = tpd.pack_tokens(iter(chunks), seqlen, np.dtype(dtype))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for bad, match in (([np.arange(3)], "fewer than one row"),
                       ([np.array([70000] * 20)], "exceeds uint16")):
        with pytest.raises(ValueError, match=match):
            jpd.pack_tokens(iter(bad), 4, np.dtype(np.uint16))
        with pytest.raises(ValueError, match=match):
            tpd.pack_tokens(iter(bad), 4, np.dtype(np.uint16))


def _tokenizer(directory, corpus):
    """A word-level tokenizer over the corpus's words, saved as an HF
    ``PreTrainedTokenizerFast`` directory."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = sorted({w for line in corpus for w in line.split()})
    vocab = {"[UNK]": 0, "</s>": 1, **{w: i + 2 for i, w in
                                       enumerate(words)}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]",
                            eos_token="</s>").save_pretrained(directory)


def test_text_to_loader_rows_match_jax(tmp_path):
    """Text -> ``prepare_dataset`` (port and JAX, the same local
    tokenizer) -> the same ``.bin`` bytes -> the port's native loader
    reads rows of the file; a tokenizer that is not a local directory is
    refused before anything loads."""
    from neuronx_distributed_tpu_torch.data import TokenBatchLoader

    rng = np.random.RandomState(0)
    words = [f"w{i}" for i in range(50)]
    corpus = [" ".join(rng.choice(words, rng.randint(3, 30)))
              for _ in range(60)]
    text = tmp_path / "corpus.txt"
    text.write_text("\n".join(corpus[:30] + [""] + corpus[30:]) + "\n")
    tok_dir = str(tmp_path / "tok")
    _tokenizer(tok_dir, corpus)
    out = {}
    for name, mod in (("jax", jpd), ("port", tpd)):
        out[name] = str(tmp_path / f"{name}.bin")
        mod.main(["--input", str(text), "--tokenizer", tok_dir,
                  "--seqlen", "16", "--output", out[name]])
    data = np.fromfile(out["port"], np.uint16)
    np.testing.assert_array_equal(data, np.fromfile(out["jax"], np.uint16))
    assert len(data) % 17 == 0 and len(data) >= 17 * 8
    rows = data.reshape(-1, 17)
    loader = TokenBatchLoader(out["port"], batch=2, seqlen=16, seed=0,
                              dtype="uint16", nthreads=1)
    try:
        for _ in range(3):
            batch = next(iter(loader))
            ids = np.concatenate([np.asarray(batch["input_ids"]),
                                  np.asarray(batch["labels"])[:, -1:]], 1)
            for row in ids:
                assert (rows == row).all(1).any()
    finally:
        loader.close()
    with pytest.raises(SystemExit, match="not a local directory"):
        tpd.main(["--input", str(text), "--tokenizer", "org/some-model",
                  "--output", str(tmp_path / "x.bin")])


def test_scripts_import_nothing_of_jax():
    code = (
        "import sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'neuronx_distributed_tpu'):\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "from neuronx_distributed_tpu_torch.scripts import ("
        "checkpoint_converter, prepare_dataset, yaml_converter)\n"
        "from neuronx_distributed_tpu_torch.utils import ("
        "batch_utils, tensor_capture, timeline)\n"
        "from neuronx_distributed_tpu_torch import lora\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

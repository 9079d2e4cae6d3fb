"""Card-only checks of the PyTorch port: the hand-written paged-attention,
flash-attention and grouped-GLU kernels (forward and backward) against
their plain versions, the wrappers' refusals, the serving engine (Llama
and Mixtral) and train steps (Llama and Mixtral) on the card against the
same on the CPU.

This file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.) Without
a CUDA card every test here skips.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from chip_smoke import flash_rel_err
from neuronx_distributed_tpu_torch import trainer as ttr
from neuronx_distributed_tpu_torch.config import neuronx_distributed_config
from neuronx_distributed_tpu_torch.inference import engine as te
from neuronx_distributed_tpu_torch.inference.kv_cache import (PAD_POSITION,
                                                              quantize_kv)
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models import mixtral as tm
from neuronx_distributed_tpu_torch.modules.moe import blockwise as tbw
from neuronx_distributed_tpu_torch.ops import blockwise_moe as tbm
from neuronx_distributed_tpu_torch.ops import flash_attention as tfa
from neuronx_distributed_tpu_torch.ops import paged_attention as tpa

pytestmark = pytest.mark.cuda

_FLOATS = {"fp32": torch.float32, "bf16": torch.bfloat16,
           "fp16": torch.float16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(device, seed, pool, q_dtype, t=48, n=8, kv=2, d=128, nb=24, bs=16,
          maxb=5):
    """Random pools and tables: -1 entries, two tokens sharing a table,
    empty pool slots, and token 3 with no valid key at all."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(t, n, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(nb, bs, kv, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(nb, bs, kv, d).astype(np.float32))
    pool_pos = rng.randint(0, 3 * bs, (nb, bs)).astype(np.int32)
    pool_pos[rng.rand(nb, bs) < 0.1] = PAD_POSITION
    tables = rng.randint(-1, nb, (t, maxb)).astype(np.int32)
    tables[1] = tables[0]
    tables[3] = -1
    q_pos = rng.randint(bs, 3 * bs, (t,)).astype(np.int32)
    ks = vs = None
    if pool == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    else:
        k, v = k.to(_FLOATS[pool]), v.to(_FLOATS[pool])
    args = (q.to(q_dtype), k, v, torch.from_numpy(pool_pos),
            torch.from_numpy(tables), torch.from_numpy(q_pos), ks, vs)
    return tuple(None if a is None else a.to(device) for a in args)


@pytest.mark.parametrize("pool,q_name,d,bs,n,kv", [
    ("fp32", "fp32", 128, 16, 8, 2),
    ("bf16", "bf16", 128, 16, 32, 8),
    ("fp16", "fp16", 64, 16, 8, 2),
    ("int8", "fp32", 128, 16, 8, 2),
    ("int8", "bf16", 64, 32, 16, 1),
    ("bf16", "bf16", 64, 5, 4, 4),
    ("fp32", "fp32", 128, 256, 8, 8),
])
def test_kernel_matches_plain(cuda, pool, q_name, d, bs, n, kv):
    args = _case(cuda, 0, pool, _FLOATS[q_name], n=n, kv=kv, d=d, bs=bs,
                 nb=24 if bs < 256 else 6)
    before = tpa.paged_attention.launches
    got = tpa.paged_attention(*args)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    ref = tpa.paged_attention_plain(*args)
    tol = 1e-4 if q_name == "fp32" else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=tol)
    assert not got[3].any()            # no valid key: zeros


def test_kernel_wrapper_refuses_what_it_does_not_take(cuda):
    q, k, v, pp, tb, qp, _, _ = _case(cuda, 1, "bf16", torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_attention(q[..., :96].contiguous(),
                            k[..., :96].contiguous(),
                            v[..., :96].contiguous(), pp, tb, qp)
    with pytest.raises(ValueError, match="contiguous"):
        tpa.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                            k, v, pp, tb, qp)
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_attention(q, k, v, pp, tb.long(), qp)
    with pytest.raises(ValueError, match="every tensor on"):
        tpa.paged_attention(q, k, v, pp.cpu(), tb, qp)
    with pytest.raises(ValueError, match="need k_scale"):
        tpa.paged_attention(q, k.to(torch.int8), v.to(torch.int8), pp, tb, qp)


@pytest.mark.parametrize("quantized", [False, True])
def test_engine_on_card_matches_cpu(cuda, quantized):
    """The fp32 engine on the card gives the CPU engine's greedy tokens and
    counters, and launches the kernel once per layer per step."""
    cfg = tl.tiny_config(dtype=torch.float32, hidden_size=256, num_heads=4,
                         num_kv_heads=2)                     # head_dim 64
    sd = tl.init_state_dict(cfg, seed=0, std=0.02, device="cpu")
    ecfg = te.EngineConfig(block_size=4, num_blocks=16, max_slots=2,
                           max_blocks_per_seq=8, token_budget=8,
                           quantized=quantized)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (7, 4, 9)]
    out = {}
    for dev in ("cpu", cuda):
        eng = te.ServingEngine(cfg, sd, ecfg, device=dev)
        before = tpa.paged_attention.launches
        eng.submit(prompts[0], 6, uid="a")
        eng.step()
        eng.submit(prompts[1], 5, uid="b")
        eng.submit(prompts[2], 4, uid="c")
        res = eng.run()
        out[str(dev)] = ({u: r.tokens for u, r in res.items()},
                         eng.stats.steps, eng.stats.preempted,
                         eng.compile_count())
        launches = tpa.paged_attention.launches - before
        assert launches == (0 if dev == "cpu"
                            else cfg.num_layers * eng.stats.steps)
    assert out["cpu"] == out["cuda"]
    assert out["cuda"][3] == 1


def _profiler_warmup():
    """One throwaway trace: a kernel launched just after the first trace
    starts may go unrecorded while CUPTI starts up."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def _traced_kernels(fn, part, attempts=5):
    """The CUDA kernels, by the profiler's names, that contain ``part`` and
    that five calls of ``fn`` launch. ``fn`` runs once untraced first, so
    that its library is built and loaded and the card has loaded its
    kernels; each trace opens with a throwaway kernel and a short pause.

    A trace can miss launches of the ``ctypes`` libraries' kernels
    (``tools/probe_trace_loss.py``: one launch of the fp32 K5 kept both
    of its kernels in 3 traces of 20; five launches kept both in 20 of 20),
    and now and then holds none of them at all. A trace that holds no
    kernel with ``part`` in its name says nothing of the route, so it is
    taken again, up to ``attempts`` times; the first trace that holds any
    is returned whole, and the caller's checks on its names stay as they
    are (an entry that launched a wrong or a missing kernel still fails
    them, and one that launched none returns an empty list)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    _profiler_warmup()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(0.1)
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and part in e.key]
        if names:
            return names
    return names


def _step_case(device, seed, kind, t, n_rep, bs, d, kv=2):
    """bf16 q and pools on ``device`` over ``chip_smoke.packed_step``'s
    tables (up to 1024 keys a table); in the random case token 3 has no
    valid key (an all -1 table, a run of its own)."""
    from chip_smoke import packed_step

    maxb = max(1, 1024 // bs)
    nb = 9 * maxb
    pool_pos, tables, q_pos = packed_step(seed, kind, t, bs, maxb, nb, 4095)
    if kind == "random":
        tables[3] = -1
    rng = np.random.RandomState(seed + 1)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .to(device=device, dtype=torch.bfloat16)
               for shape in ((t, kv * n_rep, d), (nb, bs, kv, d),
                             (nb, bs, kv, d)))
    return (q, k, v) + tuple(torch.from_numpy(a).to(device)
                             for a in (pool_pos, tables, q_pos))


def _no_valid_key(args):
    _, _, _, pool_pos, tables, q_pos = args
    pos = pool_pos[tables.long().clamp(min=0)].flatten(1)
    ok = (q_pos[:, None] >= pos) & (tables >= 0).repeat_interleave(
        pool_pos.shape[1], 1)
    return ~ok.any(1)


K1_CASES = [
    ("random", 48, 4, 16, 128), ("random", 77, 1, 5, 64),
    ("random", 50, 2, 32, 128), ("random", 33, 8, 256, 64),
    ("prefill", 512, 4, 16, 128), ("prefill", 70, 1, 32, 64),
    ("prefill", 100, 8, 5, 128), ("prefill", 37, 2, 256, 128),
    ("prefill", 50, 3, 16, 64),
    ("decode", 512, 4, 16, 128), ("decode", 40, 8, 32, 64),
    ("decode", 21, 1, 16, 128),
    ("worker", 4, 4, 16, 128), ("worker", 3, 8, 5, 64),
    ("worker", 4, 2, 256, 128),
]


@pytest.mark.parametrize("kind,t,n_rep,bs,d", K1_CASES)
def test_paged_attention_bf16_kernel_matches_plain(cuda, kind, t, n_rep, bs,
                                                   d):
    """The bf16 tensor-core K1 against its plain version, element by
    element within 2e-2: random tables with holes, steps shaped like the
    engine's (prefill chunks whose runs straddle token tiles, decode and
    pad rows, the decode worker, where each run's table is split across
    CTAs), T not a multiple of the 64 // n_rep token tile, n_rep 1, 2, 3
    (one spare row a tile), 4 and 8, block sizes 5, 16, 32 and 256, and
    rows with no valid key, which give zeros. One launch is counted."""
    args = _step_case(cuda, t + bs + n_rep, kind, t, n_rep, bs, d)
    before = tpa.paged_attention.launches
    got = tpa.paged_attention(*args)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    ref = tpa.paged_attention_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=2e-2)
    assert not got[_no_valid_key(args)].any()


@pytest.mark.parametrize("kind,t,n_rep,bs,d", [
    ("prefill", 512, 4, 16, 128), ("worker", 4, 4, 16, 128),
    ("random", 77, 1, 5, 64), ("decode", 40, 8, 32, 64)])
def test_paged_attention_bf16_candidates_agree(cuda, kind, t, n_rep, bs, d):
    """Every split count that ``scripts/time_paged_tilings.py`` times is
    right within 2e-2 of the plain version."""
    args = _step_case(cuda, 7, kind, t, n_rep, bs, d)
    ref = tpa.paged_attention_plain(*args).float()
    for splits in (1, 2, 4, 8, 16):
        got = tpa.paged_attention_cuda(*args, splits=splits)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref, rtol=0, atol=2e-2)
        assert not got[_no_valid_key(args)].any(), splits


@pytest.mark.parametrize("kind,t", [("prefill", 512), ("worker", 4),
                                    ("random", 48)])
def test_paged_attention_bf16_is_deterministic(cuda, kind, t):
    """Each run's sums stay in one CTA, and the splits merge in a fixed
    order: two launches on the same inputs agree bit for bit."""
    args = _step_case(cuda, 3, kind, t, 4, 16, 128)
    first, second = (tpa.paged_attention(*args) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("q_name,pool,kernels", [
    ("bf16", "bf16", ("paged_attention_wgmma",)),
    ("fp32", "fp32", ("paged_attention_kernel",)),
    ("bf16", "int8", ("paged_attention_kernel",)),
])
def test_paged_attention_routes_by_dtype(cuda, q_name, pool, kernels):
    """The entry chooses K1's kernel by the types alone: bf16 q over a
    bf16 pool launches the tensor-core kernel (here split, so with its
    combine) and no CUDA-core one; fp32 and int8 pools the CUDA-core
    kernel (names as the profiler reports them)."""
    args = _case(cuda, 2, pool, _FLOATS[q_name])
    names = _traced_kernels(lambda: tpa.paged_attention(*args), "paged_")
    assert sum("paged_attention" in n for n in names) == 1, names
    for want in kernels:
        assert sum(want in n for n in names) == 1, (want, names)
    assert any("paged_combine" in n for n in names) == (pool == q_name
                                                       == "bf16"), names


@pytest.mark.parametrize("q_name,splits,same_bits", [
    ("bf16", 1, True), ("bf16", 2, False), ("fp32", None, True)])
def test_paged_attention_bits_follow_the_tables_length(cuda, q_name, splits,
                                                       same_bits):
    """The same 16 rows (positions in block 11) attend the same keys
    through a table of 16 valid blocks and through one of 24, whose last
    blocks lie past every row. Either way the output is within 2e-2 (bf16)
    or 1e-4 (fp32) of the plain version. The fp32 K1 and the bf16 K1 with
    one split only add exact zeros for the masked keys, so their bits must
    be equal; with two splits the split point follows the table's length
    (block 8 against block 12) and the bits may differ, which is why bf16
    greedy ids depend on chunking (ROADMAP §C), so that case asserts
    nothing of the bits."""
    rng = np.random.RandomState(9)
    t, n, kv, d, bs, nb = 16, 32, 8, 128, 16, 32
    dt = _FLOATS[q_name]
    q = torch.from_numpy(rng.randn(t, n, d).astype(np.float32)).to(cuda, dt)
    k, v = (torch.from_numpy(rng.randn(nb, bs, kv, d).astype(np.float32))
            .to(cuda, dt) for _ in "kv")
    pool_pos = torch.arange(nb * bs, dtype=torch.int32,
                            device=cuda).view(nb, bs)
    q_pos = torch.arange(176, 192, dtype=torch.int32, device=cuda)
    outs = []
    for valid in (16, 24):
        tables = torch.full((t, 24), -1, dtype=torch.int32, device=cuda)
        tables[:, :valid] = torch.arange(valid, dtype=torch.int32)
        args = (q, k, v, pool_pos, tables, q_pos)
        kw = {} if splits is None else dict(splits=splits)
        outs.append(tpa.paged_attention_cuda(*args, **kw))
        ref = tpa.paged_attention_plain(*args).float()
        torch.testing.assert_close(outs[-1].float(), ref, rtol=0,
                                   atol=2e-2 if dt == torch.bfloat16
                                   else 1e-4)
    torch.cuda.synchronize()
    if same_bits:
        assert torch.equal(outs[0], outs[1])


def test_paged_attention_bf16_refuses_bad_splits(cuda):
    args = _step_case(cuda, 1, "worker", 4, 4, 16, 128)
    for bad in (dict(splits=0), dict(splits=17)):
        with pytest.raises(ValueError, match="splits"):
            tpa.paged_attention_cuda(*args, **bad)


def _flash_case(device, seed, dtype, b=2, s=100, n=8, kv=2, d=64):
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            device=device, dtype=dtype)

    return t(b, s, n, d), t(b, s, kv, d), t(b, s, kv, d), t(b, s, n, d)


def _flash_all(fns, q, k, v, g, causal, p, seed):
    fwd, dq_fn, dkv_fn = fns
    out, lse = fwd(q, k, v, causal, None, p, seed)
    delta = tfa.attention_delta(g, out)
    args = (q, k, v, g, lse, delta, causal, None, p, seed)
    return (out, lse, dq_fn(*args), *dkv_fn(*args))


@pytest.mark.parametrize("name,dtype,s,n,kv,d,causal,p", [
    ("fp32", torch.float32, 100, 8, 2, 64, True, 0.0),
    ("fp32_d128_noncausal", torch.float32, 130, 4, 4, 128, False, 0.0),
    ("bf16", torch.bfloat16, 192, 8, 2, 128, True, 0.0),
    ("fp32_dropout", torch.float32, 77, 4, 1, 64, True, 0.2),
    ("bf16_dropout_noncausal", torch.bfloat16, 64, 8, 8, 128, False, 0.1),
    ("fp32_nrep4", torch.float32, 200, 8, 2, 128, True, 0.0),
    ("fp32_nrep4_dropout_noncausal", torch.float32, 200, 8, 2, 128, False,
     0.1),
])
def test_flash_kernels_match_plain(cuda, name, dtype, s, n, kv, d, causal,
                                   p):
    """K2, K3 and K4 against their plain versions on the same inputs (the
    plain backward takes the plain forward's out and lse, the kernels the
    kernel's), each launching once. fp32 inputs keep the CUDA-core K3 and
    K4 (fp32 on the tensor cores would be TF32) and meet 1e-4."""
    q, k, v, g = _flash_case(cuda, 0, dtype, s=s, n=n, kv=kv, d=d)
    counts = [f.launches for f in (tfa.flash_fwd, tfa.flash_bwd_dq,
                                   tfa.flash_bwd_dkv)]
    got = _flash_all((tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv),
                     q, k, v, g, causal, p, 1234)
    torch.cuda.synchronize()
    assert [f.launches for f in (tfa.flash_fwd, tfa.flash_bwd_dq,
                                 tfa.flash_bwd_dkv)] == [c + 1 for c in counts]
    ref = _flash_all((tfa.flash_fwd_plain, tfa.flash_bwd_dq_plain,
                      tfa.flash_bwd_dkv_plain), q, k, v, g, causal, p, 1234)
    # element by element, as chip_smoke.py holds them: fp32 differs by
    # summation order only, bf16 also by the rounding of out/dq/dk/dv
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for label, a, r in zip(("out", "lse", "dq", "dk", "dv"), got, ref):
        assert a.dtype == r.dtype and a.shape == r.shape, label
        rel = flash_rel_err(a, r)
        assert rel <= tol, (label, rel)


def test_flash_kernel_dropout_mask_is_the_plain_mask(cuda):
    """With q = k = 0 every valid score is equal, so with V = one-hot rows
    K2's output is keep / (l (1 - p)): its nonzero pattern is the kernel's
    keep mask, which must equal dropout_keep_mask bit for bit."""
    b, s, n, kv, d, p, seed = 1, 192, 4, 2, 64, 0.3, 99
    q = torch.zeros(b, s, n, d, device=cuda)
    k = torch.zeros(b, s, kv, d, device=cuda)
    q_pos = torch.arange(s, device=cuda)[:, None]
    for k0 in range(0, s, d):
        v = torch.zeros(b, s, kv, d, device=cuda)
        v[0, k0:k0 + d, :, :] = torch.eye(d, device=cuda)[:, None, :]
        out, _ = tfa.flash_fwd_cuda(q, k, v, True, None, p, seed)
        k_pos = torch.arange(k0, k0 + d, device=cuda)[None, :]
        want = tfa.dropout_keep_mask(seed, tfa.flat_bh(b, n, cuda), q_pos,
                                     k_pos, s, p) & (k_pos <= q_pos)
        got = out.permute(0, 2, 1, 3) != 0            # [B, N, S, D]
        assert torch.equal(got, want)


def test_flash_autograd_on_card_matches_cpu(cuda):
    q, k, v, g = _flash_case("cpu", 3, torch.float32, s=70, n=4, kv=2, d=64)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_(True)
                  for t in (q, k, v)]
        out = tfa.flash_attention(*leaves, dropout_p=0.1, dropout_seed=7)
        out.backward(g.to(dev).transpose(1, 2).contiguous().transpose(1, 2))
        grads[str(dev)] = [out.detach().cpu()] + [t.grad.cpu()
                                                  for t in leaves]
    for a, r in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-4)


def test_flash_wrappers_refuse_what_they_do_not_take(cuda):
    q, k, v, g = _flash_case(cuda, 1, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_fwd_cuda(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_fwd_cuda(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)
    with pytest.raises(ValueError, match="not supported"):
        tfa.flash_fwd_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="every tensor on"):
        tfa.flash_fwd_cuda(q, k.cpu(), v)


def _bwd_inputs(device, seed, dtype, s, n_rep, d, causal, p, b=1, kv=2):
    """q, k, v, g and the plain forward's lse and delta: what K3 and K4
    take, the same for the kernel and its plain version."""
    q, k, v, g = _flash_case(device, seed, dtype, b=b, s=s, n=kv * n_rep,
                             kv=kv, d=d)
    out, lse = tfa.flash_fwd_plain(q, k, v, causal, None, p, 99)
    return q, k, v, g, lse, tfa.attention_delta(g, out)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 100, 1000])
def test_flash_bwd_bf16_kernels_match_plain(cuda, s, d, n_rep, causal, p):
    """The bf16 K3 and K4 (tensor cores) against their plain versions in
    fp32 on the same bf16 inputs, element by element within 2e-2: lengths
    below, at and across the 64-row tile, one key head per 1, 4 or 8 query
    heads. Each wrapper counts one launch.

    At S=1 without dropout a softmax over one key has no gradient: ds =
    p (dp - delta) scale with delta = dp, so dq and dk are zero but for
    the rounding of that cancellation, which differs between the tensor
    cores and the plain version (exactly zero in some heads): element by
    element they would compare two roundings of zero. There they are held
    to zero within 2e-2 of the terms that cancel, scale max|dp| max|k|
    (max|q| n_rep for dk); dv = g is compared element by element."""
    args = _bwd_inputs(cuda, s + d + n_rep, torch.bfloat16, s, n_rep, d,
                       causal, p)
    kw = dict(causal=causal, dropout_p=p, seed=99)
    counts = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    dq = tfa.flash_bwd_dq(*args, **kw)
    dk, dv = tfa.flash_bwd_dkv(*args, **kw)
    torch.cuda.synchronize()
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == (
        counts[0] + 1, counts[1] + 1)
    f32 = [x.float() for x in args[:4]] + list(args[4:])
    ref_dq = tfa.flash_bwd_dq_plain(*f32, **kw)
    ref_dk, ref_dv = tfa.flash_bwd_dkv_plain(*f32, **kw)
    zero_grad = s == 1 and p == 0.0
    if zero_grad:
        q, k, v, g = f32[:4]
        dp = (g.unflatten(2, (k.shape[2], n_rep))
              * v[:, :, :, None]).sum(-1).abs().max()
        scale = d ** -0.5
        assert dq.float().abs().max() <= 2e-2 * scale * dp * k.abs().max()
        assert dk.float().abs().max() <= (2e-2 * scale * dp * n_rep
                                          * q.abs().max())
    for label, a, r in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                        ("dv", dv, ref_dv)):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape, label
        if zero_grad and label != "dv":
            continue
        rel = flash_rel_err(a, r)
        assert rel <= 2e-2, (label, rel)


@pytest.mark.parametrize("s,n_rep,d,causal,p", [
    (1000, 4, 128, True, 0.0),
    (333, 8, 64, False, 0.1),
])
def test_flash_bwd_bf16_kernels_are_deterministic(cuda, s, n_rep, d, causal,
                                                  p):
    """K3 and K4 sum each output inside one CTA in a fixed order, with no
    atomics: two launches on the same inputs agree bit for bit."""
    args = _bwd_inputs(cuda, 5, torch.bfloat16, s, n_rep, d, causal, p)
    kw = dict(causal=causal, dropout_p=p, seed=7)
    first = (tfa.flash_bwd_dq(*args, **kw), *tfa.flash_bwd_dkv(*args, **kw))
    second = (tfa.flash_bwd_dq(*args, **kw), *tfa.flash_bwd_dkv(*args, **kw))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,kernels", [
    (torch.bfloat16, ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma")),
    (torch.float32, ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")),
])
def test_flash_bwd_routes_by_dtype(cuda, dtype, kernels):
    """The entries choose the backward kernels by the input type alone: a
    bf16 input launches the tensor-core K3/K4 and nothing else, an fp32
    input the CUDA-core ones (names as the profiler reports them)."""
    args = _bwd_inputs(cuda, 2, dtype, 130, 4, 64, True, 0.0)
    names = _traced_kernels(
        lambda: (tfa.flash_bwd_dq(*args), tfa.flash_bwd_dkv(*args)),
        "flash_bwd")
    assert len(names) == 2, names
    for want in kernels:
        assert sum(want in n for n in names) == 1, (want, names)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 1000])
def test_flash_fwd_bf16_kernel_matches_plain(cuda, s, d, n_rep, causal, p):
    """The bf16 K2 (tensor cores) against its plain version on the same
    bf16 inputs, element by element: out within 2e-2 and lse within 1e-4
    (``flash_rel_err``), at lengths below, at and across the 64-row tile,
    one key head per 1, 2, 4 or 8 query heads. One launch is counted."""
    q, k, v, _ = _flash_case(cuda, s + d + n_rep, torch.bfloat16, b=1, s=s,
                             n=2 * n_rep, kv=2, d=d)
    before = tfa.flash_fwd.launches
    out, lse = tfa.flash_fwd(q, k, v, causal, None, p, 99)
    torch.cuda.synchronize()
    assert tfa.flash_fwd.launches == before + 1
    ref_out, ref_lse = tfa.flash_fwd_plain(q, k, v, causal, None, p, 99)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert flash_rel_err(out, ref_out) <= 2e-2
    assert flash_rel_err(lse, ref_lse) <= 1e-4


@pytest.mark.parametrize("s,n_rep,d,causal,p", [
    (1000, 4, 128, True, 0.0),
    (333, 8, 64, False, 0.1),
])
def test_flash_fwd_bf16_kernel_is_deterministic(cuda, s, n_rep, d, causal,
                                                p):
    """K2 sums each row inside one CTA in a fixed order: two launches on
    the same inputs agree bit for bit."""
    q, k, v, _ = _flash_case(cuda, 5, torch.bfloat16, b=1, s=s,
                             n=2 * n_rep, kv=2, d=d)
    first, second = (tfa.flash_fwd(q, k, v, causal, None, p, 7)
                     for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_fwd_bf16_dropout_mask_is_the_plain_mask(cuda):
    """As ``test_flash_kernel_dropout_mask_is_the_plain_mask``, for the
    bf16 K2: with q = k = 0 every p is exactly 1 (also in bf16), so the
    output's nonzero pattern is the kernel's keep mask."""
    b, s, n, kv, d, p, seed = 1, 192, 4, 2, 64, 0.3, 99
    q = torch.zeros(b, s, n, d, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(b, s, kv, d, device=cuda, dtype=torch.bfloat16)
    q_pos = torch.arange(s, device=cuda)[:, None]
    for k0 in range(0, s, d):
        v = torch.zeros(b, s, kv, d, device=cuda, dtype=torch.bfloat16)
        v[0, k0:k0 + d, :, :] = torch.eye(d, device=cuda)[:, None, :]
        out, _ = tfa.flash_fwd_cuda(q, k, v, True, None, p, seed)
        k_pos = torch.arange(k0, k0 + d, device=cuda)[None, :]
        want = tfa.dropout_keep_mask(seed, tfa.flat_bh(b, n, cuda), q_pos,
                                     k_pos, s, p) & (k_pos <= q_pos)
        assert torch.equal(out.permute(0, 2, 1, 3) != 0, want)


@pytest.mark.parametrize("dtype,kernel", [
    (torch.bfloat16, "flash_fwd_wgmma"),
    (torch.float32, "flash_fwd_kernel"),
])
def test_flash_fwd_routes_by_dtype(cuda, dtype, kernel):
    """The entry chooses K2 by the input type alone: bf16 launches the
    tensor-core kernel and nothing else, fp32 the CUDA-core one (names as
    the profiler reports them)."""
    q, k, v, _ = _flash_case(cuda, 2, dtype, b=1, s=130, n=8, kv=2, d=64)
    names = _traced_kernels(lambda: tfa.flash_fwd(q, k, v), "flash_fwd")
    assert len(names) == 1 and kernel in names[0], names


def test_train_step_on_card_matches_cpu(cuda):
    """Three fp32 flash-attention train steps on the card and on the CPU
    from the same weights and batch: loss, grad norm and parameters."""
    cfg = tl.tiny_config(dtype=torch.float32, hidden_size=256, num_heads=4,
                         num_kv_heads=2, use_flash_attention=True)
    sd = tl.init_state_dict(cfg, seed=0, std=0.02, device="cpu")
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 97)))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    runs = {}
    for dev in ("cpu", cuda):
        pm, params = ttr.initialize_parallel_model(
            neuronx_distributed_config(), cfg, state_dict=sd, device=dev)
        tx, state = ttr.initialize_parallel_optimizer(pm, params, 1e-3)
        step = ttr.make_train_step(pm, tx)
        before = tfa.flash_bwd_dkv.launches
        metrics = [step(state, batch)[1] for _ in range(3)]
        assert tfa.flash_bwd_dkv.launches - before == (
            0 if dev == "cpu" else 3 * cfg.num_layers)
        runs[str(dev)] = ([(float(m["loss"]), float(m["grad_norm"]))
                           for m in metrics],
                          {n: p.detach().cpu() for n, p in params.items()})
    (lc, pc), (lg, pg) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    # Adam's m / (sqrt(v) + eps) magnifies the rounding of gradients near
    # zero, so params are held to 1e-3 x max|p| (as against JAX on the CPU)
    for name, ref in pc.items():
        torch.testing.assert_close(pg[name], ref, rtol=0,
                                   atol=1e-3 * ref.abs().max().item())


def _moe_case(device, seed, dtype, t=40, k=2, e=5, h=200, i=176, bs=16,
              sentinel_empty=False):
    """Expert-sorted blocks of ``t`` tokens routed top-``k`` over ``e``
    experts, expert 1 hit by none; H and I not multiples of the kernels'
    tiles."""
    rng = np.random.RandomState(seed)
    idx = np.stack([rng.choice([x for x in range(e) if x != 1], k,
                               replace=False) for _ in range(t)])
    x = torch.from_numpy(rng.randn(t, h).astype(np.float32))
    gate_up = torch.from_numpy(rng.randn(e, h, 2, i).astype(np.float32) * .1)
    down = torch.from_numpy(rng.randn(e, i, h).astype(np.float32) * .1)
    _, src, dest, be, _, padded = tbw.compute_block_metadata(
        torch.from_numpy(idx), e, bs, sentinel_empty=sentinel_empty)
    xs = tbw.scatter_to_blocks(x, src, dest, padded)
    return (xs.to(device, dtype), gate_up.to(device, dtype),
            down.to(device, dtype), be.to(device), bs)


# bf16 forward cases beyond H=200, I=176 over 5 experts (ragged against
# every tile): "bf16_wide" at H=256, I=384 over 8 experts (whole tiles),
# "bf16_rev" with the block table reversed
_FWD_SHAPES = {"bf16_wide": dict(h=256, i=384, e=8)}


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("name,bs,sentinel_empty", [
    ("fp32", 16, False), ("bf16", 16, False), ("fp32", 80, True),
    ("bf16", 64, True), ("fp32", 64, False), ("bf16", 80, False),
    ("bf16_wide", 64, False), ("bf16_rev", 16, True),
])
def test_grouped_glu_kernels_match_plain(cuda, decode, name, bs,
                                         sentinel_empty):
    """K5 and K6 against their plain versions on the same inputs: fp32
    element by element within 1e-4 (summation order); bf16 (the
    tensor-core kernels, which round a = silu(g) u once to bf16 between
    their passes) against the plain version in fp32 on the same bf16
    inputs, rounded once, within 1e-2. Sentinel blocks give exact
    zeros."""
    dtype = _FLOATS[name[:4]]
    xs, gu, dn, be, bs = _moe_case(cuda, 0, dtype, bs=bs,
                                   sentinel_empty=sentinel_empty,
                                   **_FWD_SHAPES.get(name, {}))
    if name == "bf16_rev":
        be = be.flip(0).contiguous()
    kernel, plain = ((tbm.grouped_glu_decode, tbm.grouped_glu_decode_plain)
                     if decode else (tbm.grouped_glu, tbm.grouped_glu_plain))
    before = kernel.launches
    got = kernel(xs, gu, dn, be, bs, gu.shape[-1] // 2)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == xs.shape
    ref = plain(xs.float(), gu.float(), dn.float(), be, bs,
                gu.shape[-1] // 2).to(dtype)
    rel = flash_rel_err(got, ref)
    assert rel <= (1e-4 if dtype == torch.float32 else 1e-2), rel
    sent = torch.repeat_interleave(be >= gu.shape[0], bs)
    if sentinel_empty:
        assert sent.any()
    assert not got[sent].any()
    assert (got[~sent] != 0).any()


def test_grouped_glu_wrappers_refuse_what_they_do_not_take(cuda):
    xs, gu, dn, be, bs = _moe_case(cuda, 1, torch.bfloat16)
    for fn in (tbm.grouped_glu_cuda, tbm.grouped_glu_decode_cuda):
        with pytest.raises(ValueError, match="fp32 or bf16"):
            fn(xs.half(), gu.half(), dn.half(), be, bs, 16)
        with pytest.raises(ValueError, match="contiguous"):
            fn(xs, gu.transpose(1, 2).contiguous().transpose(1, 2), dn, be,
               bs, 16)
        with pytest.raises(ValueError, match="int32"):
            fn(xs, gu, dn, be.long(), bs, 16)
        with pytest.raises(ValueError, match="every tensor on"):
            fn(xs, gu, dn.cpu(), be, bs, 16)
    # K6 is forward-only, as in the JAX package; K5 has its backward
    with pytest.raises(RuntimeError, match="no backward.*JAX package"):
        tbm.grouped_glu_decode_cuda(xs.requires_grad_(True), gu, dn, be, bs,
                                    16)
    with torch.no_grad():
        tbm.grouped_glu_decode_cuda(xs, gu, dn, be, bs, 16)
    assert tbm.grouped_glu_cuda(xs, gu, dn, be, bs, 16).grad_fn is None


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("bs,sentinel_empty,shape", [
    (64, False, dict(h=256, i=384, e=8)), (80, True, {}), (16, False, {}),
])
def test_grouped_glu_bf16_is_deterministic(cuda, decode, bs, sentinel_empty,
                                           shape):
    """The bf16 K5 and K6 sum every output inside one CTA in a fixed
    order, with no atomics: two launches on the same inputs agree bit for
    bit."""
    xs, gu, dn, be, bs = _moe_case(cuda, 6, torch.bfloat16, bs=bs,
                                   sentinel_empty=sentinel_empty, **shape)
    fn = tbm.grouped_glu_decode_cuda if decode else tbm.grouped_glu_cuda
    first = fn(xs, gu, dn, be, bs, gu.shape[-1] // 2)
    second = fn(xs, gu, dn, be, bs, gu.shape[-1] // 2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_grouped_glu_bf16_refuses_widths_not_multiple_of_8(cuda):
    """cp.async moves 16-byte chunks, so the bf16 K5 and K6 take H and I
    multiples of 8 and raise on others; fp32 takes any width."""
    for h, i in ((204, 176), (200, 180)):
        xs, gu, dn, be, bs = _moe_case(cuda, 1, torch.bfloat16, h=h, i=i)
        for fn in (tbm.grouped_glu_cuda, tbm.grouped_glu_decode_cuda):
            with pytest.raises(ValueError, match="multiples of 8"):
                fn(xs, gu, dn, be, bs, i // 2)
            ys = fn(xs.float(), gu.float(), dn.float(), be, bs, i // 2)
            torch.cuda.synchronize()
            assert torch.isfinite(ys).all() and (ys != 0).any()


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("dtype,kernels", [
    (torch.bfloat16, ("glu_act_wgmma", "glu_down_wgmma")),
    (torch.float32, ("glu_act_kernel", "glu_down_kernel")),
])
def test_grouped_glu_routes_by_dtype(cuda, decode, dtype, kernels):
    """K5 and K6 choose their kernels by the input type alone: bf16
    launches the two tensor-core passes (K5 pairing row tiles, K6 splitting
    a tile's columns: ``<false>`` and ``<true>`` in the profiler's names),
    fp32 the two CUDA-core ones."""
    xs, gu, dn, be, bs = _moe_case(cuda, 5, dtype, sentinel_empty=decode)
    fn = tbm.grouped_glu_decode_cuda if decode else tbm.grouped_glu_cuda
    names = [n for n in _traced_kernels(
        lambda: fn(xs, gu, dn, be, bs, 88), "glu_")
        if "glu_act" in n or "glu_down" in n]
    assert len(names) == 2, names
    for want in kernels:
        assert sum(want in n for n in names) == 1, (want, names)
    if dtype == torch.bfloat16:
        split = "<true>" if decode else "<false>"
        assert all(split in n for n in names), names


@pytest.mark.parametrize("disaggregated", [False, True])
def test_mixtral_engine_on_card_matches_cpu(cuda, disaggregated):
    """A blockwise fp32 Mixtral engine on the card gives the CPU engine's
    greedy tokens; packed it launches K5 once per layer per step, and
    disaggregated K5 per prefill run and K6 per decode run."""
    cfg = tm.tiny_moe_config(dtype=torch.float32, moe_dispatch="blockwise",
                             moe_block_size=8, hidden_size=256, num_heads=4,
                             num_kv_heads=2)
    sd = tm.init_state_dict(cfg, seed=0, std=0.05, device="cpu")
    ecfg = te.EngineConfig(block_size=4, num_blocks=16, max_slots=2,
                           max_blocks_per_seq=8, token_budget=8,
                           disaggregated=disaggregated)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (7, 4, 9)]
    out = {}
    for dev in ("cpu", cuda):
        eng = te.ServingEngine(cfg, sd, ecfg, device=dev)
        k5, k6 = tbm.grouped_glu.launches, tbm.grouped_glu_decode.launches
        eng.submit(prompts[0], 6, uid="a")
        eng.step()
        eng.submit(prompts[1], 5, uid="b")
        eng.submit(prompts[2], 4, uid="c")
        res = eng.run()
        out[str(dev)] = ({u: r.tokens for u, r in res.items()},
                         eng.stats.steps, eng.worker_compile_counts())
        k5 = tbm.grouped_glu.launches - k5
        k6 = tbm.grouped_glu_decode.launches - k6
        runs = eng.worker_runs
        if dev == "cpu":
            assert k5 == k6 == 0
        elif disaggregated:
            assert (k5, k6) == (cfg.num_layers * runs["prefill"],
                                cfg.num_layers * runs["decode"])
            assert runs["decode"] > 0
        else:
            assert (k5, k6) == (cfg.num_layers * runs["packed"], 0)
    assert out["cpu"] == out["cuda"]


def _bwd_case(device, seed, dtype, no_block=None, reverse=False, **kw):
    """``_moe_case`` with a cotangent; ``no_block`` reassigns that expert's
    blocks to expert 0, so it owns none, and reverses the table (the dW
    kernel must not assume it sorted); ``reverse`` only reverses it."""
    xs, gu, dn, be, bs = _moe_case("cpu", seed, torch.float32, **kw)
    dy = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        *xs.shape).astype(np.float32))
    if no_block is not None:
        be = torch.where(be == no_block, 0, be)
    if no_block is not None or reverse:
        be = be.flip(0).contiguous()
    return ([t.to(device, dtype) for t in (xs, gu, dn)] + [be.to(device),
                                                           dy.to(device,
                                                                 dtype)],
            bs)


# bf16 cases: "bf16" at H=200, I=176 over 5 experts (ragged against every
# tile), "bf16_wide" at H=256, I=384 over 8 experts (whole tiles), and
# "bf16_rev" with the block table reversed
_BWD_SHAPES = {"bf16_wide": dict(h=256, i=384, e=8),
               "bf16_rev": dict(reverse=True)}


@pytest.mark.parametrize("entry", ["dx", "dw", "bwd"])
@pytest.mark.parametrize("name,bs,sentinel_empty,no_block", [
    ("fp32", 16, False, None), ("bf16", 16, False, None),
    ("fp32", 80, True, None), ("bf16", 64, True, None),
    ("fp32", 16, False, 3), ("bf16", 64, False, 3),
    ("bf16_wide", 64, False, None), ("bf16_rev", 16, False, None),
    ("bf16_rev", 80, True, None),
])
def test_grouped_glu_backward_kernels_match_plain(cuda, entry, name, bs,
                                                  sentinel_empty, no_block):
    """K7 (dx), K8 (dW) and the pair against the plain backward on the same
    inputs: fp32 element by element within 1e-4 (summation order); bf16
    (the tensor-core kernels, which round dg, du and a once to bf16)
    against the plain version in fp32 on the same bf16 inputs, rounded
    once, within 1e-2. Sentinel rows of dx are exact zeros; expert 1 (no
    token: a block of padding rows) or, where the table is rewritten, an
    expert that owns no block at all gets exact zeros of dW; each entry
    counts its launches."""
    dtype = _FLOATS[name[:4]]
    kw = _BWD_SHAPES.get(name, {})
    (xs, gu, dn, be, dy), bs = _bwd_case(cuda, 2, dtype, no_block, bs=bs,
                                         sentinel_empty=sentinel_empty, **kw)
    bi = gu.shape[-1] // 2
    fn = getattr(tbm, f"grouped_glu_{entry}_cuda")
    counters = (tbm.grouped_glu_dx, tbm.grouped_glu_dw, tbm.grouped_glu_bwd)
    before = [c.launches for c in counters]
    out = fn(xs, gu, dn, be, dy, bs, bi)
    torch.cuda.synchronize()
    added = [c.launches - b for c, b in zip(counters, before)]
    assert added == {"dx": [1, 0, 0], "dw": [0, 1, 0],
                     "bwd": [1, 1, 1]}[entry]
    out = {"dx": (out, None, None), "dw": (None, *out), "bwd": out}[entry]
    ref = tbm.grouped_glu_bwd_plain(xs.float(), gu.float(), dn.float(), be,
                                    dy.float(), bs, bi)
    tol = 1e-4 if name == "fp32" else 1e-2
    for got, want, like in zip(out, ref, (xs, gu, dn)):
        if got is None:
            continue
        assert got.dtype == dtype and got.shape == like.shape
        assert torch.isfinite(got).all()
        rel = flash_rel_err(got, want.to(dtype))
        assert rel <= tol, rel
    dx, dgu, ddn = out
    if dx is not None:
        sent = torch.repeat_interleave(be >= gu.shape[0], bs)
        assert sent.any() == sentinel_empty
        assert not dx[sent].any() and (dx[~sent] != 0).any()
    if dgu is not None and kw.get("reverse"):
        # reversing the table hands expert 1's padding block real rows and
        # may hand an expert a block of padding or sentinel rows: an expert
        # whose plain dW is exactly zero gets exact zeros
        for x in range(gu.shape[0]):
            if not ref[1][x].any():
                assert not dgu[x].any() and not ddn[x].any()
        assert (dgu != 0).any() and (ddn != 0).any()
    elif dgu is not None:
        empty = 1 if no_block is None else no_block
        assert not dgu[empty].any() and not ddn[empty].any()
        assert no_block is None or not (be == no_block).any()
        assert (dgu[0] != 0).any() and (ddn[0] != 0).any()


@pytest.mark.parametrize("bs,sentinel_empty,shape", [
    (64, False, dict(h=256, i=384, e=8)), (80, True, {}), (16, False, {}),
])
def test_grouped_glu_backward_bf16_is_deterministic(cuda, bs, sentinel_empty,
                                                    shape):
    """The bf16 pair sums every output inside one CTA in a fixed order,
    with no atomics: two launches on the same inputs agree bit for bit."""
    (xs, gu, dn, be, dy), bs = _bwd_case(cuda, 4, torch.bfloat16, bs=bs,
                                         sentinel_empty=sentinel_empty,
                                         **shape)
    args = (xs, gu, dn, be, dy, bs, gu.shape[-1] // 2)
    first = tbm.grouped_glu_bwd_cuda(*args)
    second = tbm.grouped_glu_bwd_cuda(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_grouped_glu_backward_bf16_refuses_widths_not_multiple_of_8(cuda):
    """cp.async moves 16-byte chunks, so the bf16 backward takes H and I
    multiples of 8 and raises on others; fp32 takes any width."""
    for h, i in ((204, 176), (200, 180)):
        (xs, gu, dn, be, dy), bs = _bwd_case(cuda, 1, torch.bfloat16, h=h,
                                             i=i)
        for fn in (tbm.grouped_glu_dx_cuda, tbm.grouped_glu_dw_cuda,
                   tbm.grouped_glu_bwd_cuda):
            with pytest.raises(ValueError, match="multiples of 8"):
                fn(xs, gu, dn, be, dy, bs, i // 2)
        f32 = [t.float() for t in (xs, gu, dn)]
        dx, dgu, ddn = tbm.grouped_glu_bwd_cuda(*f32, be, dy.float(), bs,
                                                i // 2)
        torch.cuda.synchronize()
        assert torch.isfinite(dx).all() and torch.isfinite(dgu).all()


@pytest.mark.parametrize("dtype,kernels", [
    (torch.bfloat16, ("glu_bwd_act_wgmma", "glu_bwd_dx_wgmma",
                      "glu_bwd_dw_wgmma")),
    (torch.float32, ("glu_bwd_act_kernel", "glu_bwd_dx_kernel",
                     "glu_bwd_dw_kernel")),
])
def test_grouped_glu_backward_routes_by_dtype(cuda, dtype, kernels):
    """The backward entries choose their kernels by the input type alone:
    the bf16 pair launches the three tensor-core passes and nothing else,
    fp32 the three CUDA-core ones (names as the profiler reports them)."""
    (xs, gu, dn, be, dy), bs = _bwd_case(cuda, 5, dtype)
    names = _traced_kernels(
        lambda: tbm.grouped_glu_bwd_cuda(xs, gu, dn, be, dy, bs, 88),
        "glu_bwd")
    assert len(names) == 3, names
    for want in kernels:
        assert sum(want in n for n in names) == 1, (want, names)


def test_grouped_glu_backward_wrappers_refuse_what_they_do_not_take(cuda):
    (xs, gu, dn, be, dy), bs = _bwd_case(cuda, 1, torch.bfloat16)
    for fn in (tbm.grouped_glu_dx_cuda, tbm.grouped_glu_dw_cuda,
               tbm.grouped_glu_bwd_cuda):
        with pytest.raises(ValueError, match="fp32 or bf16"):
            fn(xs, gu, dn, be, dy.float(), bs, 16)
        with pytest.raises(ValueError, match="contiguous"):
            fn(xs, gu, dn, be, dy.t().contiguous().t(), bs, 16)
        with pytest.raises(ValueError, match="int32"):
            fn(xs, gu, dn, be.long(), dy, bs, 16)
        with pytest.raises(ValueError, match="every tensor on"):
            fn(xs, gu, dn, be, dy.cpu(), bs, 16)
        with pytest.raises(ValueError, match="dy must be shaped"):
            fn(xs, gu, dn, be, dy[:bs], bs, 16)


def test_grouped_glu_autograd_on_card_matches_cpu(cuda):
    """``grouped_glu`` under autograd on the card (K5, then K7 and K8 in
    one launch) against the CPU (the plain versions), fp32; and with the
    weights frozen the backward runs K7 alone."""
    (xs, gu, dn, be, dy), bs = _bwd_case("cpu", 3, torch.float32,
                                         sentinel_empty=True)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_(True)
                  for t in (xs, gu, dn)]
        pair = tbm.grouped_glu_bwd.launches
        ys = tbm.grouped_glu(*leaves, be.to(dev), bs, 88)
        ys.backward(dy.to(dev))
        assert tbm.grouped_glu_bwd.launches - pair == (str(dev) != "cpu")
        grads[str(dev)] = [ys.detach().cpu()] + [t.grad.cpu()
                                                 for t in leaves]
    for a, r in zip(grads["cuda"], grads["cpu"]):
        assert flash_rel_err(a, r) <= 1e-4
    k7, k8 = tbm.grouped_glu_dx.launches, tbm.grouped_glu_dw.launches
    x = xs.detach().to(cuda).requires_grad_(True)
    tbm.grouped_glu(x, gu.to(cuda), dn.to(cuda), be.to(cuda), bs,
                    88).backward(dy.to(cuda))
    assert (tbm.grouped_glu_dx.launches - k7,
            tbm.grouped_glu_dw.launches - k8) == (1, 0)
    assert flash_rel_err(x.grad.cpu(), grads["cpu"][1]) <= 1e-4


def test_mixtral_train_step_on_card_matches_cpu(cuda):
    """Three fp32 blockwise Mixtral train steps with flash attention on
    the card and on the CPU from the same weights and batch: loss, grad
    norm and parameters; on the card K5, K7 and K8 launch once per layer
    per step."""
    cfg = tm.tiny_moe_config(dtype=torch.float32, hidden_size=256,
                             num_heads=4, num_kv_heads=2,
                             use_flash_attention=True,
                             moe_dispatch="blockwise", moe_block_size=16)
    sd = tm.init_state_dict(cfg, seed=0, std=0.02, device="cpu")
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 65)))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    counters = (tbm.grouped_glu, tbm.grouped_glu_dx, tbm.grouped_glu_dw)
    runs = {}
    for dev in ("cpu", cuda):
        pm, params = ttr.initialize_parallel_model(
            neuronx_distributed_config(), cfg, state_dict=sd, device=dev)
        tx, state = ttr.initialize_parallel_optimizer(pm, params, 1e-3)
        step = ttr.make_train_step(pm, tx)
        before = [c.launches for c in counters]
        metrics = [step(state, batch)[1] for _ in range(3)]
        want = 0 if dev == "cpu" else 3 * cfg.num_layers
        assert [c.launches - b for c, b in zip(counters, before)] == [want] * 3
        runs[str(dev)] = ([(float(m["loss"]), float(m["grad_norm"]))
                           for m in metrics],
                          {n: p.detach().cpu() for n, p in params.items()})
    (lc, pc), (lg, pg) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for name, ref in pc.items():
        torch.testing.assert_close(pg[name], ref, rtol=0,
                                   atol=1e-3 * ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_on_card_is_bitwise_and_skips_k2_under_save_attention(cuda,
                                                                    dtype):
    """Gradients under remat equal those without, bit for bit, for every
    policy (recompute is the same kernels on the same inputs); K2 launches
    once a layer under ``save_attention`` and ``dots_and_attention``,
    twice under the others, and K3/K4 once a layer in all."""
    from neuronx_distributed_tpu_torch.utils.remat import POLICIES

    cfg = tl.tiny_config(dtype=dtype, hidden_size=256, num_heads=4,
                         num_kv_heads=2, use_flash_attention=True,
                         loss_chunk=32)
    sd = tl.init_state_dict(cfg, seed=0, std=0.02, device=cuda)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 97))).to(cuda)

    def grads(**kw):
        pm, _ = ttr.initialize_parallel_model(
            neuronx_distributed_config(), dataclasses.replace(cfg, **kw),
            state_dict=sd, device=cuda)
        model = pm.module
        counts = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
                  tfa.flash_bwd_dkv.launches)
        loss = model.loss(ids[:, :-1], ids[:, 1:])
        loss.backward()
        launched = [c.launches - b for c, b in zip(
            (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv), counts)]
        return loss.detach(), {n: p.grad for n, p in
                               model.named_parameters()}, launched

    loss_ref, ref, launched = grads()
    layers = cfg.num_layers
    assert launched == [layers] * 3
    for policy in POLICIES:
        loss, got, launched = grads(remat=True, remat_policy=policy)
        once = policy in ("save_attention", "dots_and_attention")
        assert launched == [layers * (1 if once else 2), layers, layers]
        assert torch.equal(loss, loss_ref), policy
        for name, g in got.items():
            assert torch.equal(g, ref[name]), (policy, name)

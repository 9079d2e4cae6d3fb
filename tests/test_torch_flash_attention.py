"""Flash attention in the PyTorch port against the JAX package: the dropout
mask bit for bit, the plain forward and backward against the Pallas kernels
(interpret mode) and the XLA scan, gradcheck of the autograd function,
dispatch by device, and the kernels' ctypes bindings. The kernels
themselves are held against the plain versions on the card in
``test_torch_cuda.py``."""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuronx_distributed_tpu.modules import attention as jattn
from neuronx_distributed_tpu.ops import flash_attention as jfa
from neuronx_distributed_tpu_torch.modules import attention as tattn
from neuronx_distributed_tpu_torch.ops import flash_attention as tfa

TOL = 1e-5            # fp32, the same algorithm summed in another order


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many tiny ops (the gradcheck's
    float64 evaluations at a head width padded to 64 above all), which
    run 5-50x slower on torch's default threads beside other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 0x9E3779B9, 0xFFFFFFFF])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_mask_matches_jax_bitwise(seed, p):
    """Counters q * sk + k near 2**32 (sk = 65536, q near 65535) and near 0,
    large head indices and seeds at the uint32 edge."""
    rng = np.random.RandomState(seed % 1000)
    sk = 65536
    q_pos = np.concatenate([np.arange(65500, 65536), np.arange(0, 8)])
    k_pos = np.concatenate([rng.randint(0, sk, 40), [0, sk - 1]])
    heads = np.array([0, 1, 37, 4095, 65535])
    head = heads[:, None, None]
    qq, kk = q_pos[None, :, None], k_pos[None, None, :]
    want = np.asarray(jfa.dropout_keep_mask(
        jnp.uint32(seed), jnp.asarray(head), jnp.asarray(qq),
        jnp.asarray(kk), sk, p))
    got = tfa.dropout_keep_mask(seed, torch.from_numpy(head),
                                torch.from_numpy(qq), torch.from_numpy(kk),
                                sk, p).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_flat_bh_matches_jax():
    np.testing.assert_array_equal(tfa.flat_bh(3, 5).numpy(),
                                  np.asarray(jfa.flat_bh(3, 5)))


def _inputs(seed, d, n_rep, b=1, s=32, kv=2):
    rng = np.random.RandomState(seed)
    n = kv * n_rep
    q = rng.randn(b, s, n, d).astype(np.float32)
    k = rng.randn(b, s, kv, d).astype(np.float32)
    v = rng.randn(b, s, kv, d).astype(np.float32)
    g = rng.randn(b, s, n, d).astype(np.float32)
    return q, k, v, g


def _expand(x, n_rep):
    return np.repeat(x, n_rep, axis=2)


def _fold(x, n_rep):
    """dk/dv of expanded K/V summed back onto the kv heads."""
    b, s, n, d = x.shape
    return x.reshape(b, s, n // n_rep, n_rep, d).sum(3)


CASES = [(causal, p, d, n_rep) for causal in (True, False)
         for p in (0.0, 0.1) for d in (64, 128) for n_rep in (1, 2)]
SEED = 2024


@pytest.mark.parametrize("causal,p,d,n_rep", CASES)
def test_plain_forward_matches_jax(causal, p, d, n_rep):
    q, k, v, _ = _inputs(0, d, n_rep)
    scale = 1.0 / np.sqrt(d)
    ke, ve = _expand(k, n_rep), _expand(v, n_rep)
    seed = jnp.asarray([SEED], jnp.uint32)
    ref_p = jfa._flash_pallas_fwd(jnp.asarray(q), jnp.asarray(ke),
                                  jnp.asarray(ve), seed, causal, 16, 8, scale,
                                  interpret=True, dropout_p=p)
    ref_x = jfa._flash_xla_impl(jnp.asarray(q), jnp.asarray(ke),
                                jnp.asarray(ve), causal, 8, scale, p,
                                seed[0])
    out, lse = tfa.flash_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal, None, p, SEED)
    for ref_out, ref_lse in (ref_p, ref_x):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal,p,d,n_rep", CASES)
def test_plain_backward_matches_jax(causal, p, d, n_rep):
    """dq from K3's plain version and dk/dv from K4's, fed JAX's own out and
    lse, against both JAX backwards."""
    q, k, v, g = _inputs(1, d, n_rep)
    scale = 1.0 / np.sqrt(d)
    ke, ve = _expand(k, n_rep), _expand(v, n_rep)
    seed = jnp.asarray([SEED], jnp.uint32)
    jq, jk, jv, jg = map(jnp.asarray, (q, ke, ve, g))
    out, lse = jfa._flash_xla_impl(jq, jk, jv, causal, 8, scale, p, seed[0])
    refs = [
        jfa._flash_pallas_bwd(jq, jk, jv, out, lse, jg, seed, causal, 16, 8,
                              scale, interpret=True, dropout_p=p),
        jfa._flash_bwd_from_lse(jq, jk, jv, out, lse, jg, causal, 8, scale,
                                p, seed[0]),
    ]
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    t_out, t_lse = (torch.from_numpy(np.array(out)),
                    torch.from_numpy(np.array(lse)))
    delta = tfa.attention_delta(tg, t_out)
    args = (tq, tk, tv, tg, t_lse, delta, causal, None, p, SEED)
    dq = tfa.flash_bwd_dq_plain(*args).numpy()
    dk, dv = (x.numpy() for x in tfa.flash_bwd_dkv_plain(*args))
    for rdq, rdk, rdv in refs:
        np.testing.assert_allclose(dq, np.asarray(rdq), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(dk, _fold(np.asarray(rdk), n_rep),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(dv, _fold(np.asarray(rdv), n_rep),
                                   rtol=TOL, atol=TOL)


def test_ragged_length_matches_jax_sdpa():
    """A length that no key block divides (the kernels' ragged tail) against
    the JAX dense reference, with dropout and GQA."""
    q, k, v, _ = _inputs(4, 64, 2, s=23)
    n_rep = 2
    ref = jattn.sdpa_reference(jnp.asarray(q),
                               jnp.asarray(_expand(k, n_rep)),
                               jnp.asarray(_expand(v, n_rep)), causal=True,
                               dropout_p=0.2, dropout_seed=jnp.uint32(5))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              dropout_p=0.2, dropout_seed=5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)


def _padded_case(d, s, causal, n_rep=2, seed=None):
    """Port flash attention at head width ``d`` (padded to the kernels'
    width inside ``flash_attention``): out and dq, dk, dv of ``sum(out *
    g)``."""
    q, k, v, g = _inputs(d * 100 + s, d, n_rep, s=s)
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=causal, dropout_p=0.1,
                              dropout_seed=SEED)
    out.backward(torch.from_numpy(g))
    return (q, k, v, g), out.detach().numpy(), [
        t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("s", [5, 32, 33])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 80, 96])
def test_padded_head_width_matches_jax(d, causal, s):
    """Head widths the kernels do not take (BERT-tiny's 16, ViT-Huge's 80,
    GPT-NeoX-20B's 96) pass through the zero padding with the unpadded
    width's scale: out and gradients against JAX's ``flash_attention``, on
    its padded Pallas kernel (interpret mode) where S tiles by 8 and its
    XLA scan otherwise, with dropout."""
    n_rep = 2
    (q, k, v, g), out, (dq, dk, dv) = _padded_case(d, s, causal, n_rep)
    jq, jk, jv, jg = map(jnp.asarray, (q, _expand(k, n_rep),
                                       _expand(v, n_rep), g))
    ref, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=causal, block_q=16, block_k=8,
        force_pallas=s % 8 == 0, dropout_p=0.1,
        dropout_seed=jnp.uint32(SEED)), jq, jk, jv)
    rdq, rdk, rdv = vjp(jg)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dq, np.asarray(rdq), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dk, _fold(np.asarray(rdk), n_rep), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(dv, _fold(np.asarray(rdv), n_rep), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("s", [5, 33])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 80, 96])
def test_padded_head_width_matches_unpadded_plain(d, causal, s):
    """The padded path against the plain versions run at the unpadded
    width (which take any D): zero columns change nothing but the order of
    the sums, within 1e-6."""
    (q, k, v, g), out, (dq, dk, dv) = _padded_case(d, s, causal)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    ref, lse = tfa.flash_fwd_plain(tq, tk, tv, causal, None, 0.1, SEED)
    args = (tq, tk, tv, tg, lse, tfa.attention_delta(tg, ref), causal, None,
            0.1, SEED)
    rdk, rdv = tfa.flash_bwd_dkv_plain(*args)
    for got, want in ((out, ref), (dq, tfa.flash_bwd_dq_plain(*args)),
                      (dk, rdk), (dv, rdv)):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-6)


def test_kernel_head_dim_and_the_padded_scale():
    """64 and 128 pass as they are, narrower heads pad to 64, the rest to
    128, above 128 raises; the default scale is the unpadded width's, so
    an explicit ``1/sqrt(D)`` gives the same bits and the padded width's
    scale would not."""
    assert [tfa.kernel_head_dim(d) for d in (1, 16, 64, 65, 80, 96, 128)] \
        == [64, 64, 64, 128, 128, 128, 128]
    with pytest.raises(ValueError, match="head_dim 160"):
        tfa.kernel_head_dim(160)
    q, k, v, _ = map(torch.from_numpy, _inputs(8, 160, 1, s=4))
    with pytest.raises(ValueError, match="head_dim 160"):
        tfa.flash_attention(q, k, v)
    q, k, v, _ = map(torch.from_numpy, _inputs(9, 80, 1, s=12))
    got = tfa.flash_attention(q, k, v, causal=False)
    assert torch.equal(got, tfa.flash_attention(q, k, v, causal=False,
                                                scale=1 / np.sqrt(80)))
    assert not torch.allclose(got, tfa.flash_attention(
        q, k, v, causal=False, scale=1 / np.sqrt(128)), atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("p", [0.0, 0.25])
def test_sdpa_reference_matches_jax(causal, p):
    q, k, v, _ = _inputs(5, 64, 1, s=12)
    ref = jattn.sdpa_reference(*map(jnp.asarray, (q, k, v)), causal=causal,
                               dropout_p=p, dropout_seed=jnp.uint32(77))
    got = tattn.sdpa_reference(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, dropout_p=p, dropout_seed=77)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("causal,p", [(True, 0.0), (True, 0.3),
                                      (False, 0.3)])
def test_gradcheck_float64(monkeypatch, causal, p):
    """The flash backward (K3/K4's plain versions through the autograd
    function) is the gradient of the flash forward: finite differences in
    float64, with small key blocks so the online softmax spans blocks."""
    monkeypatch.setattr(tfa, "BLOCK_K", 3)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 7, h, 4, generator=gen, dtype=torch.float64,
                           requires_grad=True) for h in (4, 2, 2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=causal,
                                            dropout_p=p, dropout_seed=11),
        (q, k, v))


def test_dispatch_on_cpu_takes_the_plain_versions():
    q, k, v, g = map(torch.from_numpy, _inputs(6, 64, 2))
    before = [f.launches for f in (tfa.flash_fwd, tfa.flash_bwd_dq,
                                   tfa.flash_bwd_dkv)]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tfa.flash_attention(*leaves)
    out.backward(g)
    ref_out, ref_lse = tfa.flash_fwd_plain(q, k, v)
    assert torch.equal(out.detach(), ref_out)
    delta = tfa.attention_delta(g, ref_out)
    assert torch.equal(leaves[0].grad, tfa.flash_bwd_dq_plain(
        q, k, v, g, ref_lse, delta))
    assert [f.launches for f in (tfa.flash_fwd, tfa.flash_bwd_dq,
                                 tfa.flash_bwd_dkv)] == before


def test_validation_raises():
    q, k, v, g = map(torch.from_numpy, _inputs(7, 64, 2))
    with pytest.raises(ValueError, match="requires dropout_seed"):
        tfa.flash_attention(q, k, v, dropout_p=0.1)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfa.flash_fwd(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="every tensor on"):
        tfa.flash_fwd_cuda(q, k, v)                 # CPU tensors
    lse = torch.zeros(1, 4, 32)
    with pytest.raises(ValueError, match="every tensor on"):
        tfa.flash_bwd_dkv_cuda(q, k, v, g, lse, lse)


def test_attention_dropout_seed():
    assert tattn.attention_dropout_seed(0.1, None) == (0.0, None)
    assert tattn.attention_dropout_seed(0.0, torch.Generator()) == (0.0,
                                                                     None)
    p, seed = tattn.attention_dropout_seed(
        0.1, torch.Generator().manual_seed(3))
    assert p == 0.1 and 0 <= seed < 2 ** 32
    assert seed == tattn.attention_dropout_seed(
        0.1, torch.Generator().manual_seed(3))[1]


@pytest.mark.parametrize("fn,argtypes", [
    ("nxd_flash_fwd", tfa.FWD_ARGTYPES),
    ("nxd_flash_bwd_dq", tfa.DQ_ARGTYPES),
    ("nxd_flash_bwd_dkv", tfa.DKV_ARGTYPES),
])
def test_ctypes_binding_matches_the_c_prototype(fn, argtypes):
    """The ctypes argtypes agree with each kernel's extern "C" signature in
    count and kind (a mismatch shows only on the card otherwise)."""
    src = (pathlib.Path(tfa.__file__).parent.parent / "csrc"
           / "flash_attention.cu").read_text()
    proto = re.search(rf'extern "C" int {fn}\((.*?)\)\s*\{{', src,
                      re.S).group(1)
    kinds = []
    for param in (x.strip() for x in proto.split(",")):
        kinds.append(ctypes.c_void_p if "*" in param else
                     ctypes.c_float if param.startswith("float") else
                     ctypes.c_uint if param.startswith("unsigned") else
                     ctypes.c_int)
    assert kinds == argtypes


def test_card_check_flags_a_fault_late_in_the_sequence():
    """``chip_smoke.flash_rel_err``, by which the card checks hold the
    kernels to their plain versions, compares element by element against
    the element and its row's rms. Causal rows differ in scale along S, so a
    fault in the last rows must still show: K4 dropping one query head of
    each kv group for the last 5% of keys is flagged far above the bf16
    limit 2e-2, while one bf16 step on every element stays within it."""
    from chip_smoke import flash_rel_err

    gen = torch.Generator().manual_seed(0)
    b, s, n, kv, d = 1, 2048, 8, 2, 64
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen).bfloat16()
                  for h in (n, kv, kv, n))
    out, lse = tfa.flash_fwd_plain(q, k, v)
    dk, dv = tfa.flash_bwd_dkv_plain(q, k, v, g, lse,
                                     tfa.attention_delta(g, out))
    g_drop = g.unflatten(2, (kv, n // kv)).clone()
    g_drop[:, :, :, -1] = 0
    g_drop = g_drop.flatten(2, 3)
    dk_drop, dv_drop = tfa.flash_bwd_dkv_plain(
        q, k, v, g_drop, lse, tfa.attention_delta(g_drop, out))
    late = (torch.arange(s) >= s * 95 // 100)[None, :, None, None]
    for full, dropped in ((dk, dk_drop), (dv, dv_drop)):
        assert flash_rel_err(torch.where(late, dropped, full), full) > 0.5
        sign = torch.randint(0, 2, full.shape, generator=gen) * 2 - 1
        one_step = (full.float() * (1 + sign * 2.0 ** -8)).bfloat16()
        assert flash_rel_err(one_step, full) < 2e-2
    # causal dq of query 0 is zero but for rounding, which may differ
    dq = tfa.flash_bwd_dq_plain(q, k, v, g, lse, tfa.attention_delta(g, out))
    assert dq[:, 0].abs().max() < 1e-3 * dq.abs().max()
    noise_free = dq.clone()
    noise_free[:, 0] = 0
    assert flash_rel_err(noise_free, dq) < 1e-4
    zero = torch.zeros(2, 4)
    assert flash_rel_err(zero, zero) == 0
    assert not flash_rel_err(zero + float("nan"), zero) <= 2e-2


def _tensor_core_backward(q, k, v, g, lse, delta, causal, p, seed):
    """dq, dk, dv as the bf16 tensor-core K3 and K4 compute them: bf16
    operands, products summed in fp32, the dropped probabilities p_v and ds
    rounded once to bf16 before they enter the dq, dk and dv products, the
    outputs rounded to bf16. Dense over all keys (the kernels' tiles only
    change the order of fp32 sums)."""
    b, s, n, d = q.shape
    n_rep = n // k.shape[2]
    scale = 1.0 / np.sqrt(d)
    qf, gf = (x.float().transpose(1, 2) for x in (q, g))   # [B, N, S, D]
    kf, vf = (x.float().repeat_interleave(n_rep, 2).transpose(1, 2)
              for x in (k, v))
    pos = torch.arange(s)
    valid = (pos[:, None] >= pos[None, :]) if causal else torch.ones(
        s, s, dtype=torch.bool)
    prob = torch.where(valid, torch.exp(qf @ kf.transpose(-1, -2) * scale
                                        - lse[..., None]), 0.0)
    dp = gf @ vf.transpose(-1, -2)
    p_v = prob
    if p > 0.0:
        keep = tfa.dropout_keep_mask(seed, tfa.flat_bh(b, n), pos[:, None],
                                     pos[None, :], s, p)
        p_v = torch.where(keep, prob / (1.0 - p), 0.0)
        dp = torch.where(keep, dp / (1.0 - p), 0.0)
    ds = (prob * (dp - delta[..., None]) * scale).bfloat16().float()
    p_v = p_v.bfloat16().float()

    def fold(x):                       # [B, N, S, D] -> [B, S, KV, D]
        return x.unflatten(1, (n // n_rep, n_rep)).sum(2).transpose(1, 2)

    dq = (ds @ kf).transpose(1, 2)
    dk = fold(ds.transpose(-1, -2) @ qf)
    dv = fold(p_v.transpose(-1, -2) @ gf)
    return tuple(x.bfloat16() for x in (dq, dk, dv))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_rounding_of_p_and_ds_is_bounded(causal, d):
    """The bf16 K3 and K4 round p_v and ds to bf16 before the second
    products, where the Pallas kernels and the plain versions keep them in
    fp32. Emulated here at dropout 0.1, four query heads per kv head and a
    length that no 64-row tile divides: (1) the emulation stays within the
    card limit 2e-2 of the fp32 plain versions (``flash_rel_err``); (2)
    under the same rounding the rule still flags K4 dropping one query head
    of each kv group for the last 5% of keys, far above 0.5; (3) the plain
    versions still match the Pallas kernels in interpret mode."""
    from chip_smoke import flash_rel_err

    s, kv, n_rep, p = 136, 2, 4, 0.1
    q, k, v, g = (torch.from_numpy(x).bfloat16()
                  for x in _inputs(8, d, n_rep, s=s, kv=kv))
    q32, k32, v32, g32 = (x.float() for x in (q, k, v, g))
    out, lse = tfa.flash_fwd_plain(q32, k32, v32, causal, None, p, SEED)
    delta = tfa.attention_delta(g32, out)
    args = (q32, k32, v32, g32, lse, delta, causal, None, p, SEED)
    ref = (tfa.flash_bwd_dq_plain(*args), *tfa.flash_bwd_dkv_plain(*args))
    emu = _tensor_core_backward(q, k, v, g, lse, delta, causal, p, SEED)
    for a, r in zip(emu, ref):
        assert 0 < flash_rel_err(a, r) < 2e-2

    g_drop = g.unflatten(2, (kv, n_rep)).clone()
    g_drop[:, :, :, -1] = 0
    g_drop = g_drop.flatten(2, 3)
    emu_drop = _tensor_core_backward(
        q, k, v, g_drop, lse, tfa.attention_delta(g_drop.float(), out),
        causal, p, SEED)
    late = (torch.arange(s) >= s * 95 // 100)[None, :, None, None]
    for full, dropped, r in zip(emu[1:], emu_drop[1:], ref[1:]):
        assert flash_rel_err(torch.where(late, dropped, full), r) > 0.5

    scale = 1.0 / np.sqrt(d)
    seed = jnp.asarray([SEED], jnp.uint32)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (
        q32.numpy(), _expand(k32.numpy(), n_rep), _expand(v32.numpy(), n_rep),
        g32.numpy()))
    j_out, j_lse = jfa._flash_xla_impl(jq, jk, jv, causal, 8, scale, p,
                                       seed[0])
    rdq, rdk, rdv = jfa._flash_pallas_bwd(jq, jk, jv, j_out, j_lse, jg, seed,
                                          causal, 8, 8, scale, interpret=True,
                                          dropout_p=p)
    t_out, t_lse = (torch.from_numpy(np.array(x)) for x in (j_out, j_lse))
    args = (q32, k32, v32, g32, t_lse, tfa.attention_delta(g32, t_out),
            causal, None, p, SEED)
    dq = tfa.flash_bwd_dq_plain(*args)
    dk, dv = tfa.flash_bwd_dkv_plain(*args)
    np.testing.assert_allclose(dq.numpy(), np.asarray(rdq), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(dk.numpy(), _fold(np.asarray(rdk), n_rep),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dv.numpy(), _fold(np.asarray(rdv), n_rep),
                               rtol=TOL, atol=TOL)


def _tensor_core_forward(q, k, v, causal, p, seed, skip_last=False,
                         remainder=True):
    """out and lse as the bf16 tensor-core K2 computes them: per 64-row
    query tile, 64-key tiles up to the diagonal (causal), S in fp32 from
    the bf16 operands, the online softmax in log2 units with l summing
    the undropped p, the kept p as a bf16 value plus the bf16 remainder of
    its rounding (``remainder=False``: the value alone) before PV, the
    survivors rescaled by 1/(1-p) at the end. ``skip_last`` plants a fault:
    every row tile skips its last key tile."""
    b, s, n, d = q.shape
    n_rep = n // k.shape[2]
    scale2 = 1.4426950408889634 / np.sqrt(d)
    qf = q.float().transpose(1, 2)                          # [B, N, S, D]
    kf, vf = (x.float().repeat_interleave(n_rep, 2).transpose(1, 2)
              for x in (k, v))
    pos = torch.arange(s)
    out = torch.zeros(b, n, s, d)
    lse = torch.zeros(b, n, s)
    for q0 in range(0, s, 64):
        rows = pos[q0:q0 + 64]
        k_end = min(s, q0 + 64) if causal else s
        tiles = list(range(0, k_end, 64))
        if skip_last:
            tiles = tiles[:-1]
        m = torch.full((b, n, len(rows)), -np.inf)
        l = torch.zeros(b, n, len(rows))
        acc = torch.zeros(b, n, len(rows), d)
        for k0 in tiles:
            cols = pos[k0:k0 + 64]
            sc = qf[:, :, q0:q0 + 64] @ kf[:, :, k0:k0 + 64].transpose(-1, -2)
            sc = sc * scale2
            if causal:
                sc = sc.masked_fill(cols[None, :] > rows[:, None], -np.inf)
            m_new = torch.maximum(m, sc.amax(-1))
            base = torch.where(torch.isinf(m_new), 0.0, m_new)
            corr = torch.where(torch.isinf(m), 0.0, torch.exp2(m - base))
            pr = torch.exp2(sc - base[..., None])
            l = l * corr + pr.sum(-1)
            if p > 0.0:
                keep = tfa.dropout_keep_mask(seed, tfa.flat_bh(b, n),
                                             rows[:, None], cols[None, :], s,
                                             p)
                pr = torch.where(keep, pr, 0.0)
            hi = pr.bfloat16().float()
            if remainder:
                hi = hi + (pr - hi).bfloat16().float()
            acc = acc * corr[..., None] + hi @ vf[:, :, k0:k0 + 64]
            m = m_new
        inv_keep = 1.0 / (1.0 - p) if p > 0.0 else 1.0
        out[:, :, q0:q0 + 64] = acc * (inv_keep / l.clamp(min=1e-30))[..., None]
        lse[:, :, q0:q0 + 64] = m / 1.4426950408889634 + torch.log(l)
    return out.transpose(1, 2).bfloat16(), lse


def _chain(fwd, q, k, v, g, causal, p):
    """out, lse, dq, dk, dv: ``fwd``'s forward, then the backward on its
    out (delta = rowsum(g out)) and lse, in the emulated tensor-core K3/K4
    when ``fwd`` is the emulated K2, else in the plain versions."""
    out, lse = fwd(q, k, v, causal, p, SEED)
    delta = tfa.attention_delta(g, out)
    if fwd is _tensor_core_forward:
        return (out, lse, *_tensor_core_backward(q, k, v, g, lse, delta,
                                                 causal, p, SEED))
    args = (q, k, v, g, lse, delta, causal, None, p, SEED)
    return (out, lse, tfa.flash_bwd_dq_plain(*args),
            *tfa.flash_bwd_dkv_plain(*args))


def _plain_forward(q, k, v, causal, p, seed):
    return tfa.flash_fwd_plain(q, k, v, causal, None, p, seed)


@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_forward_p_is_bounded_through_the_backward(causal, p, d, n_rep):
    """The bf16 K2 carries the kept p into PV as a bf16 value plus the
    bf16 remainder of its rounding, where the Pallas kernel and
    ``flash_fwd_plain`` keep it in fp32; l sums the unrounded p. Emulated
    here at a length no 64-row tile divides: out stays within the card
    limit 2e-2 of ``flash_fwd_plain`` and lse within 1e-5
    (``flash_rel_err``); the emulated K2 followed by the emulated bf16
    K3/K4 stays within 2e-2 of the plain forward and backward, as the
    card's chained checks hold them; and the same rule flags a kernel
    whose rows skip their last key tile (the causal diagonal)."""
    from chip_smoke import flash_rel_err

    q, k, v, g = (torch.from_numpy(x).bfloat16()
                  for x in _inputs(9, d, n_rep, s=136, kv=2))
    ref = _chain(_plain_forward, q, k, v, g, causal, p)
    emu = _chain(_tensor_core_forward, q, k, v, g, causal, p)
    assert 0 < flash_rel_err(emu[0], ref[0]) < 2e-2
    assert flash_rel_err(emu[1], ref[1]) < 1e-5
    for a, r in zip(emu[2:], ref[2:]):
        assert flash_rel_err(a, r) < 2e-2
    bad, _ = _tensor_core_forward(q, k, v, causal, p, SEED, skip_last=True)
    assert flash_rel_err(bad, ref[0]) > 2e-2


def test_one_rounding_of_the_forward_p_breaks_the_chained_dq():
    """Why K2 keeps p's remainder: on the bf16 case of the card's
    ``test_flash_kernels_match_plain`` (B=2, S=192, 8 query heads on 2 kv
    heads, D=128, causal), p rounded once to bf16 moves out, and with it
    the backward's delta, enough to put the chained dq past the 2e-2
    limit, while value plus remainder keeps it well inside."""
    from chip_smoke import flash_rel_err

    rng = np.random.RandomState(0)
    q, k, v, g = (torch.from_numpy(rng.randn(2, 192, h, 128).astype(
        np.float32)).bfloat16() for h in (8, 2, 2, 8))
    ref = _chain(_plain_forward, q, k, v, g, True, 0.0)
    emu = _chain(_tensor_core_forward, q, k, v, g, True, 0.0)
    assert flash_rel_err(emu[2], ref[2]) < 1.5e-2
    out, lse = _tensor_core_forward(q, k, v, True, 0.0, SEED,
                                    remainder=False)
    once = _tensor_core_backward(q, k, v, g, lse,
                                 tfa.attention_delta(g, out), True, 0.0,
                                 SEED)
    assert flash_rel_err(once[0], ref[2]) > 2e-2


@pytest.mark.parametrize("kernel,group", [
    ("void (anonymous namespace)::flash_fwd_kernel<float, 128>(...)",
     "flash_fwd"),
    ("void (anonymous namespace)::tc::flash_fwd_wgmma<128>(...)",
     "flash_fwd"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<float, 128>(...)",
     "flash_bwd_dq"),
    ("void (anonymous namespace)::tc::flash_bwd_dq_wgmma<128>(...)",
     "flash_bwd_dq"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<float, 64>(...)",
     "flash_bwd_dkv"),
    ("void (anonymous namespace)::tc::flash_bwd_dkv_wgmma<64>(...)",
     "flash_bwd_dkv"),
])
def test_profile_train_groups_every_flash_kernel(kernel, group):
    """``scripts/profile_train.py`` counts each flash kernel, the CUDA-core
    fp32 ones and the bf16 wgmma ones, under its dispatcher's name."""
    from neuronx_distributed_tpu_torch.scripts import profile_train

    assert profile_train.group_of(kernel) == group


def test_profile_train_names_each_port_kernel_once():
    """``scripts/profile_train.py`` lists the port's kernels by name: the
    first ``(anonymous namespace)::`` starts the name and its arguments
    end it, so an argument type from that namespace (K2's ``Dropout``)
    neither becomes the name nor folds the three flash kernels into one;
    cuBLAS and "other" kernels stay out."""
    from neuronx_distributed_tpu_torch.scripts import profile_train

    keys = {f"void (anonymous namespace)::tc::{k}<128>(__nv_bfloat16 const*, "
            "(anonymous namespace)::Dropout)": us
            for k, us in (("flash_fwd_wgmma", 3000.0),
                          ("flash_bwd_dq_wgmma", 1500.0),
                          ("flash_bwd_dkv_wgmma", 1500.0))}
    keys["nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT"] = 9000.0
    keys["void at::native::vectorized_elementwise_kernel<4>(...)"] = 7.0
    assert profile_train.port_kernels(
            keys, 3, lambda k: profile_train.group_of(k) not in (
                "matmul", "other")) == {
        "tc::flash_fwd_wgmma<128>": 1.0, "tc::flash_bwd_dq_wgmma<128>": 0.5,
        "tc::flash_bwd_dkv_wgmma<128>": 0.5}

"""The PyTorch port's MoE pieces against the JAX package: the blockwise
metadata bit for bit, the top-k router (ties included), the plain grouped
GLU (K5), its decode form (K6) and its backward (K7 dx, K8 dW) against the
Pallas kernels in interpret mode, the autograd Function (``gradcheck``),
the expert bank in both dispatch modes, the MoE layer, and the kernels'
dispatch and ctypes binding. The kernels themselves run only on a card
(``tests/test_torch_cuda.py``)."""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuronx_distributed_tpu.modules.moe import blockwise as jbw
from neuronx_distributed_tpu.modules.moe import expert_mlps as jexp
from neuronx_distributed_tpu.modules.moe import model as jmodel
from neuronx_distributed_tpu.modules.moe import routing as jrouting
from neuronx_distributed_tpu.ops import blockwise_moe as jops
from neuronx_distributed_tpu_torch.modules.moe import blockwise as tbw
from neuronx_distributed_tpu_torch.modules.moe import expert_mlps as texp
from neuronx_distributed_tpu_torch.modules.moe import model as tmodel
from neuronx_distributed_tpu_torch.modules.moe import routing as trouting
from neuronx_distributed_tpu_torch.ops import blockwise_moe as tops


def _routing(case):
    """``[T, K]`` expert ids: random, skewed onto two experts with the
    others empty, all on one expert, and fewer pairs than one block."""
    rng = np.random.RandomState(0)
    if case == "random":
        return rng.randint(0, 4, (16, 2)), 4, 8
    if case == "skewed":
        idx = rng.choice([0, 2], (24, 2))
        idx[:, 1] = 2 - idx[:, 0]            # every token hits 0 and 2
        idx[:3, 1] = 3
        return idx, 5, 4
    if case == "one_expert":
        return np.full((10, 1), 2), 4, 4
    return np.array([[3, 1], [1, 0]]), 6, 16   # "tiny": 4 pairs, B=16


@pytest.mark.parametrize("sentinel_empty", [False, True])
@pytest.mark.parametrize("case", ["random", "skewed", "one_expert", "tiny"])
def test_block_metadata_bitwise(case, sentinel_empty):
    idx, e, b = _routing(case)
    ref = jbw.compute_block_metadata(jnp.asarray(idx, jnp.int32), e, b,
                                     sentinel_empty=sentinel_empty)
    got = tbw.compute_block_metadata(torch.from_numpy(idx), e, b,
                                     sentinel_empty=sentinel_empty)
    assert got[4:] == tuple(ref[4:])
    for name, g, r in zip(("order", "src", "dest_slot", "block_expert"),
                          got[:4], ref[:4]):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    if sentinel_empty and case in ("skewed", "one_expert", "tiny"):
        assert (got[3] == e).any()            # empty experts are sentinels


def test_scatter_and_combine_match_jax():
    idx, e, b = _routing("random")
    rng = np.random.RandomState(1)
    x = rng.randn(idx.shape[0], 8).astype(np.float32)
    gates = rng.rand(*idx.shape).astype(np.float32)
    jm = jbw.compute_block_metadata(jnp.asarray(idx, jnp.int32), e, b)
    tm = tbw.compute_block_metadata(torch.from_numpy(idx), e, b)
    jxs = jbw.scatter_to_blocks(jnp.asarray(x), jm[1], jm[2], jm[5])
    txs = tbw.scatter_to_blocks(torch.from_numpy(x), tm[1], tm[2], tm[5])
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    ys = rng.randn(*txs.shape).astype(np.float32)
    ref = jbw.combine_from_blocks(jnp.asarray(ys), jnp.asarray(gates), jm[0],
                                  jm[1], jm[2], idx.shape[0])
    got = tbw.combine_from_blocks(torch.from_numpy(ys),
                                  torch.from_numpy(gates), tm[0], tm[1],
                                  tm[2], idx.shape[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_router_matches_jax_with_ties(top_k):
    """Indices bit for bit and gates within 1e-6; row 0 is all ties (x = 0)
    and experts 1 and 3 share a kernel column, so every row ties them: the
    lowest index comes first, as in ``jax.lax.top_k``."""
    rng = np.random.RandomState(2)
    e, h = 6, 16
    x = rng.randn(12, h).astype(np.float32)
    x[0] = 0.0
    kernel = rng.randn(h, e).astype(np.float32)
    kernel[:, 3] = kernel[:, 1]
    gates, idx, aux = jrouting.RouterTopK(num_experts=e, top_k=top_k).apply(
        {"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x))
    router = trouting.RouterTopK(h, e, top_k)
    with torch.no_grad():
        router.kernel.copy_(torch.from_numpy(kernel))
        tg, ti, taux = router(torch.from_numpy(x))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))
    assert ti[0].tolist() == list(range(top_k))
    np.testing.assert_allclose(tg.numpy(), np.asarray(gates), rtol=1e-6,
                               atol=1e-6)
    for name in ("load_balance_loss", "z_loss"):
        np.testing.assert_allclose(taux[name].item(), float(aux[name]),
                                   rtol=1e-6)


def test_top_k_lowest_first_on_an_all_tie_row():
    vals, idx = trouting.top_k_lowest_first(torch.full((2, 8), 0.125), 2)
    assert idx.tolist() == [[0, 1], [0, 1]]
    assert vals.tolist() == [[0.125, 0.125]] * 2


def _glu_problem(sentinel_empty, dtype=np.float32, t=16, h=8, i=16, e=4,
                 k=2, b=8, skew=False):
    """The grouped GLU's inputs as numpy: expert-sorted blocks of ``t``
    tokens and random weights; ``skew`` sends every token to expert 0
    but one, which goes to 2, so experts 1 and 3 are empty."""
    rng = np.random.RandomState(3)
    idx = rng.randint(0, e, (t, k))
    if skew:
        idx = np.zeros((t, 1), np.int32)
        idx[0, 0] = 2
    x = rng.randn(t, h).astype(np.float32)
    _, src, dest, be, _, padded = jbw.compute_block_metadata(
        jnp.asarray(idx, jnp.int32), e, b, sentinel_empty=sentinel_empty)
    xs = np.array(jbw.scatter_to_blocks(jnp.asarray(x), src, dest, padded))
    gate_up = rng.randn(e, h, 2, i).astype(np.float32) * 0.3
    down = rng.randn(e, i, h).astype(np.float32) * 0.3
    return (xs.astype(dtype), gate_up.astype(dtype), down.astype(dtype),
            np.array(be), b)


@pytest.mark.parametrize("bi_frac", [1, 2])
@pytest.mark.parametrize("sentinel_empty,skew", [(False, False),
                                                 (True, False), (True, True)])
def test_plain_grouped_glu_matches_pallas_interpret(bi_frac, sentinel_empty,
                                                    skew):
    """K5's and K6's plain versions against the Pallas kernels run in
    interpret mode (``force_pallas=True``), fp32, within 1e-5; sentinel
    blocks are exact zeros in both."""
    xs, gu, dn, be, b = _glu_problem(sentinel_empty, skew=skew)
    bi = gu.shape[-1] // bi_frac
    j = [jnp.asarray(a) for a in (xs, gu, dn, be)]
    t = [torch.from_numpy(a) for a in (xs, gu, dn, be.astype(np.int32))]
    for jfn, tfn in ((jops.grouped_glu, tops.grouped_glu_plain),
                     (jops.grouped_glu_decode, tops.grouped_glu_decode_plain)):
        ref = np.asarray(jfn(*j, b, bi, force_pallas=True))
        got = tfn(*t, b, bi).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        sent = np.repeat(be >= gu.shape[0], b)
        assert sent.any() == sentinel_empty
        assert not got[sent].any() and not ref[sent].any()


def test_plain_grouped_glu_bf16_rounds_per_tile_like_jax():
    """In bf16 the plain K5 rounds each I-tile's partial, as the JAX
    reference does; both agree within a bf16 step of the largest value."""
    xs, gu, dn, be, b = _glu_problem(False)
    j = [jnp.asarray(a, jnp.bfloat16) for a in (xs, gu, dn)]
    t = [torch.from_numpy(a).bfloat16() for a in (xs, gu, dn)]
    for jfn, tfn in ((jops.grouped_glu_reference, tops.grouped_glu_plain),
                     (jops._ref_decode_fwd, tops.grouped_glu_decode_plain)):
        ref = np.asarray(jfn(*j, jnp.asarray(be), b, 8), np.float32)
        got = tfn(*t, torch.from_numpy(be).int(), b, 8).float().numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2 ** -7 * np.abs(ref).max())


def _cotangent(xs):
    return np.random.RandomState(9).randn(*xs.shape).astype(np.float32)


def test_dispatch_by_device_and_the_cuda_wrappers_refusals():
    """CPU tensors take the plain versions and launch nothing; the CUDA
    wrappers refuse them. K6 alone refuses inputs that require grad: it is
    forward-only, as in the JAX package; K5 has its backward."""
    *arrays, b = _glu_problem(True)
    xs, gu, dn, be = (torch.from_numpy(a) for a in arrays)
    be = be.int()
    dy = torch.from_numpy(_cotangent(xs))
    counters = (tops.grouped_glu, tops.grouped_glu_decode,
                tops.grouped_glu_dx, tops.grouped_glu_dw, tops.grouped_glu_bwd)
    counts = [c.launches for c in counters]
    assert torch.equal(tops.grouped_glu(xs, gu, dn, be, b, 16),
                       tops.grouped_glu_plain(xs, gu, dn, be, b, 16))
    assert torch.equal(tops.grouped_glu_decode(xs, gu, dn, be, b, 16),
                       tops.grouped_glu_decode_plain(xs, gu, dn, be, b, 16))
    dx, dgu, ddn = tops.grouped_glu_bwd(xs, gu, dn, be, dy, b, 16)
    assert torch.equal(tops.grouped_glu_dx(xs, gu, dn, be, dy, b, 16), dx)
    for got, want in zip(tops.grouped_glu_dw(xs, gu, dn, be, dy, b, 16),
                         (dgu, ddn)):
        assert torch.equal(got, want)
    assert [c.launches for c in counters] == counts
    for fn in (tops.grouped_glu_cuda, tops.grouped_glu_decode_cuda):
        with pytest.raises(ValueError, match="every tensor on"):
            fn(xs, gu, dn, be, b, 16)                     # CPU tensors
    with pytest.raises(ValueError, match="every tensor on"):
        tops.grouped_glu_cuda(xs, gu.requires_grad_(True), dn, be, b, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        tops.grouped_glu_decode_cuda(xs, gu, dn, be, b, 16)
    gu = gu.detach()
    for fn in (tops.grouped_glu_dx_cuda, tops.grouped_glu_dw_cuda,
               tops.grouped_glu_bwd_cuda):
        with pytest.raises(ValueError, match="every tensor on"):
            fn(xs, gu, dn, be, dy, b, 16)
    with pytest.raises(ValueError, match="multiple of block_i"):
        tops.grouped_glu(xs, gu, dn, be, b, 5)
    with pytest.raises(ValueError, match="block_expert"):
        tops.grouped_glu(xs, gu, dn, be[:-1], b, 16)
    with pytest.raises(ValueError, match="dy must be shaped"):
        tops.grouped_glu_bwd(xs, gu, dn, be, dy[1:], b, 16)


def test_ctypes_binding_matches_the_c_prototype():
    """The ctypes argtypes agree with every kernel entry's extern "C"
    signature in count and kind (a mismatch shows only on the card
    otherwise)."""
    src = (pathlib.Path(tops.__file__).parent.parent / "csrc"
           / "blockwise_moe.cu").read_text()
    entries = {"nxd_grouped_glu": tops.ARGTYPES,
               "nxd_grouped_glu_decode": tops.ARGTYPES,
               "nxd_grouped_glu_dx": tops.BWD_ARGTYPES,
               "nxd_grouped_glu_dw": tops.BWD_ARGTYPES,
               "nxd_grouped_glu_bwd": tops.BWD_ARGTYPES}
    assert set(re.findall(r'extern "C" int (\w+)\(', src)) == set(entries)
    for fn, argtypes in entries.items():
        proto = re.search(rf'extern "C" int {fn}\((.*?)\)\s*\{{', src,
                          re.S).group(1)
        kinds = [ctypes.c_void_p if "*" in p else
                 ctypes.c_float if p.strip().startswith("float") else
                 ctypes.c_int for p in proto.split(",")]
        assert kinds == argtypes, fn


@pytest.mark.parametrize("bi_frac", [1, 2])
@pytest.mark.parametrize("sentinel_empty,skew", [
    (False, False), (True, False), (False, True), (True, True)])
def test_plain_grouped_glu_backward_matches_pallas_interpret(
        bi_frac, sentinel_empty, skew):
    """Plain K7 and K8 against ``jax.vjp`` of the grouped GLU through the
    Pallas kernels in interpret mode (``force_pallas=True``, which runs
    ``_glu_dx_kernel`` and ``_glu_dw_kernel``) and through the jnp
    reference, fp32, within 1e-5 relative. Skewed routing leaves experts 1
    and 3 without a token: on plain metadata each owns a block of padding
    rows, on sentinel metadata no block at all. Their dW is exactly 0 in the
    port; the Pallas dW kernel never visits the tile of an expert that owns
    no block, which keeps whatever memory held (NaN here), so that tile is
    held to the reference only."""
    xs, gu, dn, be, b = _glu_problem(sentinel_empty, skew=skew)
    bi = gu.shape[-1] // bi_frac
    dy = _cotangent(xs)
    j = [jnp.asarray(a) for a in (xs, gu, dn)]
    refs = {}
    for name, force in (("pallas", True), ("reference", False)):
        _, vjp = jax.vjp(lambda x, g, d, _f=force: jops.grouped_glu(
            x, g, d, jnp.asarray(be), b, bi, force_pallas=_f), *j)
        refs[name] = [np.asarray(r) for r in vjp(jnp.asarray(dy))]
    t = [torch.from_numpy(a) for a in (xs, gu, dn, be.astype(np.int32), dy)]
    got = [g.numpy() for g in tops.grouped_glu_bwd_plain(*t, b, bi)]
    assert np.array_equal(got[0], tops.grouped_glu_dx_plain(*t, b, bi))
    for g, w in zip(got[1:], tops.grouped_glu_dw_plain(*t, b, bi)):
        assert np.array_equal(g, w.numpy())
    owned = np.isin(np.arange(gu.shape[0]), be)
    for name, ref in refs.items():
        for k, (g, r) in enumerate(zip(got, ref)):
            if k and name == "pallas":
                g, r = g[owned], r[owned]
            np.testing.assert_allclose(g, r, rtol=1e-5,
                                       atol=1e-5 * np.abs(r).max(),
                                       err_msg=f"{name} output {k}")
    sent = np.repeat(be >= gu.shape[0], b)
    assert not got[0][sent].any()
    if skew:
        for e in (1, 3):
            assert not got[1][e].any() and not got[2][e].any()
        assert owned.all() != sentinel_empty


def test_plain_grouped_glu_dx_bf16_rounds_per_tile_like_jax():
    """In bf16 the plain K7 rounds each I-tile's partial into dx, as the
    JAX ``_ref_dx`` does; the two agree within a bf16 step of the largest
    value."""
    xs, gu, dn, be, b = _glu_problem(False)
    dy = _cotangent(xs)
    j = [jnp.asarray(a, jnp.bfloat16) for a in (xs, gu, dn, dy)]
    ref = np.asarray(jops._ref_dx(j[0], j[1], j[2], jnp.asarray(be), j[3], b,
                                  8, gu.shape[0]), np.float32)
    t = [torch.from_numpy(a).bfloat16() for a in (xs, gu, dn, dy)]
    got = tops.grouped_glu_dx_plain(t[0], t[1], t[2],
                                    torch.from_numpy(be).int(), t[3], b, 8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=2 ** -7 * np.abs(ref).max())


def _tensor_core_bwd(xs, gu, dn, be, dy, bs, drop_last_block_of=None,
                     dx_cols=None):
    """The arithmetic of the bf16 backward on the tensor cores, emulated:
    products of bf16 inputs summed in fp32; dg, du and a split into a bf16
    value and the bf16 remainder of that rounding; dx from the values
    alone, summed over all of I; dW from both parts over each expert's
    blocks in ascending table order; each output rounded once. Two planted
    faults: ``drop_last_block_of`` leaves that expert's last block out of
    its dW, ``dx_cols`` sums dx over only the first I columns."""

    def split(v):
        hi = v.bfloat16().float()
        return hi, (v - hi).bfloat16().float()

    e, h, _, i = gu.shape
    f = [t.float() for t in (xs, gu, dn, dy)]
    x32, gu32, dn32, dy32 = f
    dx = torch.zeros_like(x32)
    dgu = torch.zeros_like(gu32)
    ddn = torch.zeros_like(dn32)
    table = be.tolist()
    for b, eb in enumerate(table):
        if eb >= e:
            continue
        rows = slice(b * bs, (b + 1) * bs)
        x, g_out = x32[rows], dy32[rows]
        g, u = x @ gu32[eb, :, 0], x @ gu32[eb, :, 1]
        da = g_out @ dn32[eb].T
        s = torch.sigmoid(g)
        sg = g * s
        dg, du, a = split(da * u * (s * (1 + g * (1 - s)))), split(da * sg), \
            split(sg * u)
        k = i if dx_cols is None else dx_cols
        dx[rows] = dg[0][:, :k] @ gu32[eb, :, 0, :k].T + du[0][:, :k] @ gu32[
            eb, :, 1, :k].T
        last = max(c for c, x_e in enumerate(table) if x_e == eb)
        if eb == drop_last_block_of and b == last:
            continue
        for part in range(2):
            ddn[eb] += a[part].T @ g_out
            dgu[eb, :, 0] += x.T @ dg[part]
            dgu[eb, :, 1] += x.T @ du[part]
    return dx.bfloat16(), dgu.bfloat16(), ddn.bfloat16()


def test_bf16_rounding_of_dg_du_and_a_is_bounded():
    """The bf16 K7 and K8 keep dg, du and a in bf16 between their passes,
    where the Pallas kernels and the plain versions keep them in fp32: dx
    = dg Wg^T + du Wu^T takes them rounded once to bf16; dW = x^T dg, x^T
    du, a^T dy takes each as its bf16 value plus the bf16 remainder (one
    rounding alone put dWg at 0.0123 of the 1e-2 card limit on the card's
    narrow test and 0.0107 at the train shape). Emulated here at a narrow
    width over six experts, one of which owns no block, with the block
    table reversed: (1) the emulation stays within the card limit 1e-2 of
    the fp32 plain backward (``flash_rel_err``); (2) under the same
    rounding the rule still flags a dW pass that drops an expert's last
    block, and a dx pass that drops the last 5% of I, far above the limit;
    (3) the plain backward still matches the Pallas kernels in interpret
    mode, on the table sorted."""
    from chip_smoke import flash_rel_err

    t, h, i, e, k, bs = 96, 64, 160, 6, 2, 16
    rng = np.random.RandomState(11)
    idx = np.stack([rng.choice([x for x in range(e) if x != 2], k,
                               replace=False) for _ in range(t)])
    x = rng.randn(t, h).astype(np.float32)
    _, src, dest, be, _, padded = jbw.compute_block_metadata(
        jnp.asarray(idx, jnp.int32), e, bs, sentinel_empty=True)
    xs = np.array(jbw.scatter_to_blocks(jnp.asarray(x), src, dest, padded))
    gu = rng.randn(e, h, 2, i).astype(np.float32) * 0.1
    dn = rng.randn(e, i, h).astype(np.float32) * 0.1
    dy = rng.randn(*xs.shape).astype(np.float32)
    be = np.array(be, np.int32)
    assert 2 not in be and (be >= e).any()
    bf = [torch.from_numpy(a).bfloat16() for a in (xs, gu, dn, dy)]
    rev = torch.from_numpy(be[::-1].copy())
    ref = [r.bfloat16() for r in tops.grouped_glu_bwd_plain(
        bf[0].float(), bf[1].float(), bf[2].float(), rev, bf[3].float(), bs,
        i)]
    emu = _tensor_core_bwd(*bf[:3], rev, bf[3], bs)
    for got, want in zip(emu, ref):
        assert 0 < flash_rel_err(got, want) < 1e-2
    assert not emu[1][2].any() and not emu[2][2].any()

    # an expert whose last block in the table holds real rows (a reversed
    # table hands some experts a block of padding rows last)
    last = {x_e: b for b, x_e in enumerate(rev.tolist()) if x_e < e}
    victim = next(x_e for x_e, b in sorted(last.items())
                  if bf[0][b * bs:(b + 1) * bs].any())
    faults = (_tensor_core_bwd(*bf[:3], rev, bf[3], bs,
                               drop_last_block_of=victim)[1:],
              _tensor_core_bwd(*bf[:3], rev, bf[3], bs,
                               dx_cols=i * 95 // 100)[:1])
    for got, want in zip(faults[0] + faults[1], ref[1:] + ref[:1]):
        assert flash_rel_err(got, want) > 0.25

    b = xs.shape[0] // bs
    _, vjp = jax.vjp(lambda x_, g_, d_: jops.grouped_glu(
        x_, g_, d_, jnp.asarray(be), bs, 32, force_pallas=True),
        *(jnp.asarray(a) for a in (xs, gu, dn)))
    pallas = [np.asarray(r) for r in vjp(jnp.asarray(dy))]
    plain = tops.grouped_glu_bwd_plain(
        *(torch.from_numpy(a) for a in (xs, gu, dn)), torch.from_numpy(be),
        torch.from_numpy(dy), bs, 32)
    owned = np.isin(np.arange(e), be[:b])
    for n, (got, want) in enumerate(zip(plain, pallas)):
        got = got.numpy()
        if n:
            got, want = got[owned], want[owned]
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def _tensor_core_fwd(xs, gu, dn, be, bs, act_cols=None, skip_block=None):
    """The arithmetic of the bf16 forward on the tensor cores, emulated:
    g and u from bf16 inputs summed in fp32; ``a = silu(g) u`` rounded once
    to bf16 (the scratch between the two passes); y = a Wd summed over all
    of I in fp32 and rounded once. Two planted faults: ``act_cols`` keeps
    only the first I columns of a (pass A drops the rest), ``skip_block``
    leaves that block's rows zero (pass B skips it)."""
    e = gu.shape[0]
    x32, gu32, dn32 = (t.float() for t in (xs, gu, dn))
    ys = torch.zeros_like(x32)
    for b, eb in enumerate(be.tolist()):
        if eb >= e or b == skip_block:
            continue
        rows = slice(b * bs, (b + 1) * bs)
        g, u = x32[rows] @ gu32[eb, :, 0], x32[rows] @ gu32[eb, :, 1]
        a = (g * torch.sigmoid(g) * u).bfloat16().float()
        if act_cols is not None:
            a[:, act_cols:] = 0
        ys[rows] = a @ dn32[eb]
    return ys.bfloat16()


def test_bf16_rounding_of_the_forward_act_is_bounded():
    """The bf16 K5 and K6 keep ``a = silu(x Wg) (x Wu)`` in bf16 between
    their two passes, where the Pallas kernels and the plain versions keep
    it in fp32. Emulated here at a narrow width over six experts, one of
    which owns no block, on sentinel metadata with the block table
    reversed: (1) the emulation stays within the card limit 1e-2 of the
    fp32 plain versions (``flash_rel_err``), and sentinel rows are exact
    zeros; (2) under the same rounding the rule still flags, far above the
    limit, a pass A that drops the last 5% of I and a pass B that skips a
    live block; (3) the plain K5 and K6 still match the Pallas kernels in
    interpret mode on the same inputs."""
    from chip_smoke import flash_rel_err

    t, h, i, e, k, bs = 96, 64, 160, 6, 2, 16
    rng = np.random.RandomState(12)
    idx = np.stack([rng.choice([x for x in range(e) if x != 2], k,
                               replace=False) for _ in range(t)])
    x = rng.randn(t, h).astype(np.float32)
    _, src, dest, be, _, padded = jbw.compute_block_metadata(
        jnp.asarray(idx, jnp.int32), e, bs, sentinel_empty=True)
    xs = np.array(jbw.scatter_to_blocks(jnp.asarray(x), src, dest, padded))
    gu = rng.randn(e, h, 2, i).astype(np.float32) * 0.1
    dn = rng.randn(e, i, h).astype(np.float32) * 0.1
    be = np.array(be, np.int32)
    assert 2 not in be and (be >= e).any()
    bf = [torch.from_numpy(a).bfloat16() for a in (xs, gu, dn)]
    rev = torch.from_numpy(be[::-1].copy())
    emu = _tensor_core_fwd(*bf, rev, bs)
    sent = torch.repeat_interleave(rev >= e, bs)
    assert not emu[sent].any() and emu[~sent].any()
    for plain in (tops.grouped_glu_plain, tops.grouped_glu_decode_plain):
        ref = plain(*(a.float() for a in bf), rev, bs, i).bfloat16()
        assert 0 < flash_rel_err(emu, ref) < 1e-2

    # a live block that holds real rows (a reversed table hands the
    # padding blocks of some experts real positions in the table)
    live = next(b for b, x_e in enumerate(rev.tolist())
                if x_e < e and bf[0][b * bs:(b + 1) * bs].any())
    for fault in (dict(act_cols=i * 95 // 100), dict(skip_block=live)):
        assert flash_rel_err(_tensor_core_fwd(*bf, rev, bs, **fault),
                             ref) > 0.25

    j = [jnp.asarray(a) for a in (xs, gu, dn, be)]
    tt = [torch.from_numpy(a) for a in (xs, gu, dn, be)]
    for jfn, tfn in ((jops.grouped_glu, tops.grouped_glu_plain),
                     (jops.grouped_glu_decode, tops.grouped_glu_decode_plain)):
        want = np.asarray(jfn(*j, bs, 32, force_pallas=True))
        got = tfn(*tt, bs, 32).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("kernel,group", [
    ("void (anonymous namespace)::glu_act_kernel<float>(...)",
     "grouped_glu"),
    ("void (anonymous namespace)::glu_down_kernel<float>(...)",
     "grouped_glu"),
    ("void (anonymous namespace)::tc::glu_act_wgmma<false>(...)",
     "grouped_glu"),
    ("void (anonymous namespace)::tc::glu_down_wgmma<false>(...)",
     "grouped_glu"),
    ("void (anonymous namespace)::tc::glu_act_wgmma<true>(...)",
     "grouped_glu"),
    ("void (anonymous namespace)::tc::glu_down_wgmma<true>(...)",
     "grouped_glu"),
    ("void (anonymous namespace)::glu_bwd_act_kernel<float>(...)",
     "grouped_glu_bwd_pass1"),
    ("(anonymous namespace)::tc::glu_bwd_act_wgmma(...)",
     "grouped_glu_bwd_pass1"),
    ("void (anonymous namespace)::glu_bwd_dx_kernel<float>(...)",
     "grouped_glu_dx"),
    ("(anonymous namespace)::tc::glu_bwd_dx_wgmma(...)", "grouped_glu_dx"),
    ("void (anonymous namespace)::glu_bwd_dw_kernel<float>(...)",
     "grouped_glu_dw"),
    ("(anonymous namespace)::tc::glu_bwd_dw_wgmma(...)", "grouped_glu_dw"),
])
def test_profile_train_groups_every_backward_kernel(kernel, group):
    """``scripts/profile_train.py --mixtral`` puts both passes of the
    grouped-GLU forward under ``grouped_glu`` and splits the backward into
    pass 1, the dx pass and the dW pass, in both designs: the fp32
    CUDA-core kernels and the bf16 wgmma ones (pairs of row tiles, or one
    tile split by columns)."""
    from neuronx_distributed_tpu_torch.scripts import profile_train

    assert profile_train.group_of(kernel) == group


@pytest.mark.parametrize("kernel,group", [
    ("void (anonymous namespace)::glu_act_kernel<float>(...)",
     "grouped_glu"),
    ("void (anonymous namespace)::glu_down_kernel<float>(...)",
     "grouped_glu"),
    ("void (anonymous namespace)::tc::glu_act_wgmma<false>(...)",
     "grouped_glu"),
    ("void (anonymous namespace)::tc::glu_down_wgmma<false>(...)",
     "grouped_glu"),
    ("void (anonymous namespace)::tc::glu_act_wgmma<true>(...)",
     "grouped_glu_decode"),
    ("void (anonymous namespace)::tc::glu_down_wgmma<true>(...)",
     "grouped_glu_decode"),
    ("void (anonymous namespace)::paged_attention_kernel<float>(...)",
     "paged_attention"),
])
def test_profile_serving_groups_every_forward_kernel(kernel, group):
    """``scripts/profile_serving.py --mixtral`` counts both passes of the
    grouped-GLU forward in both designs: bf16 K6 (one row tile split by
    columns) apart from bf16 K5 (row tiles in pairs); fp32, where K5 and
    K6 share their kernels, under K5."""
    from neuronx_distributed_tpu_torch.scripts import profile_serving

    assert profile_serving.group_of(kernel) == group


def test_grouped_glu_function_passes_gradcheck():
    """``torch.autograd.gradcheck`` in float64 through
    ``GroupedGLUFunction`` on the CPU (the plain forward and backward), on
    metadata with sentinel blocks, for all three inputs together and for
    the weights alone (the K8-only branch of the backward)."""
    *arrays, b = _glu_problem(True, t=6, h=5, i=8, b=4)
    xs, gu, dn = (torch.from_numpy(a).double().requires_grad_(True)
                  for a in arrays[:3])
    be = torch.from_numpy(arrays[3]).int()
    assert (be >= gu.shape[0]).any()

    def fn(x, g, d):
        return tops.grouped_glu(x, g, d, be, b, 4)

    assert torch.autograd.gradcheck(fn, (xs, gu, dn))
    assert torch.autograd.gradcheck(lambda g, d: fn(xs.detach(), g, d),
                                    (gu, dn))
    assert torch.autograd.gradcheck(lambda x: fn(x, gu.detach(), dn.detach()),
                                    (xs,))


def _experts_inputs(t=12, h=16, i=32, e=4, k=2, seed=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(t, h).astype(np.float32)
    idx = np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
    gates = rng.rand(t, k).astype(np.float32)
    gate_up = rng.randn(e, h, 2, i).astype(np.float32) * 0.2
    down = rng.randn(e, i, h).astype(np.float32) * 0.2
    return x, idx.astype(np.int32), gates, gate_up, down


def _port_experts(mode, gate_up, down, **kw):
    e, h, _, i = gate_up.shape
    mod = texp.ExpertMLPs(e, h, i, dispatch_mode=mode, dtype=torch.float32,
                          **kw)
    with torch.no_grad():
        mod.gate_up.copy_(torch.from_numpy(gate_up))
        mod.down.copy_(torch.from_numpy(down))
    return mod


@pytest.mark.parametrize("mode,cf,block", [
    ("capacity", 2.0, 512), ("capacity", 0.5, 512),   # 0.5 drops pairs
    ("blockwise", 2.0, 4), ("blockwise", 2.0, 16),
])
def test_expert_mlps_match_jax(mode, cf, block):
    x, idx, gates, gate_up, down = _experts_inputs()
    e, h, _, i = gate_up.shape
    ref, raux = jexp.ExpertMLPs(
        num_experts=e, hidden_size=h, intermediate_size=i, top_k=2,
        capacity_factor=cf, dispatch_mode=mode, block_size=block,
        block_i=16, dtype=jnp.float32, param_dtype=jnp.float32).apply(
            {"params": {"gate_up": jnp.asarray(gate_up),
                        "down": jnp.asarray(down)}},
            jnp.asarray(x), jnp.asarray(gates), jnp.asarray(idx))
    mod = _port_experts(mode, gate_up, down, capacity_factor=cf,
                        block_size=block, block_i=16)
    got, aux = mod(torch.from_numpy(x), torch.from_numpy(gates),
                   torch.from_numpy(idx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux["dropped_fraction"].item(),
                               float(raux["dropped_fraction"]), atol=1e-7)
    if cf < 1:
        assert aux["dropped_fraction"].item() > 0


def test_capacity_and_blockwise_agree_without_drops():
    """With capacity for every pair the two dispatch programs compute the
    same function; the decode form (sentinel metadata) too."""
    x, idx, gates, gate_up, down = (torch.from_numpy(a)
                                    for a in _experts_inputs(seed=5))
    cap = _port_experts("capacity", gate_up.numpy(), down.numpy(),
                        capacity_factor=4.0)
    blk = _port_experts("blockwise", gate_up.numpy(), down.numpy(),
                        block_size=8)
    y_cap, aux = cap(x, gates, idx)
    assert aux["dropped_fraction"].item() == 0
    for sentinel in (False, True):
        y_blk, _ = blk(x, gates, idx, sentinel_empty=sentinel)
        torch.testing.assert_close(y_blk, y_cap, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["capacity", "blockwise"])
def test_moe_layer_matches_jax(mode):
    rng = np.random.RandomState(6)
    e, h, i = 4, 16, 32
    x = rng.randn(2, 5, h).astype(np.float32)
    params = {"router": {"kernel": rng.randn(h, e).astype(np.float32)},
              "experts": {"gate_up": rng.randn(e, h, 2, i).astype(
                  np.float32) * 0.2,
                          "down": rng.randn(e, i, h).astype(np.float32) * .2}}
    ref, raux = jmodel.MoE(
        num_experts=e, hidden_size=h, intermediate_size=i, top_k=2,
        dispatch_mode=mode, block_size=4, dtype=jnp.float32,
        param_dtype=jnp.float32).apply(
            {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x))
    moe = tmodel.MoE(e, h, i, top_k=2, dispatch_mode=mode, block_size=4,
                     dtype=torch.float32)
    with torch.no_grad():
        moe.router.kernel.copy_(torch.from_numpy(params["router"]["kernel"]))
        moe.experts.gate_up.copy_(torch.from_numpy(
            params["experts"]["gate_up"]))
        moe.experts.down.copy_(torch.from_numpy(params["experts"]["down"]))
        got, aux = moe(torch.from_numpy(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    for name in ("load_balance_loss", "z_loss", "dropped_fraction"):
        np.testing.assert_allclose(aux[name].item(), float(raux[name]),
                                   rtol=1e-5, atol=1e-7)

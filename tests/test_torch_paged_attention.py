"""Paged decode attention in the PyTorch port: the plain version against
the JAX package's XLA reference and its Pallas kernel (interpret mode),
dispatch by device, and the kernel's ctypes binding. The kernel itself is
held against the plain version on the card in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuronx_distributed_tpu.inference.kv_cache import quantize_kv as jquant
from neuronx_distributed_tpu.ops.paged_attention import paged_attention as jpa
from neuronx_distributed_tpu_torch.inference.kv_cache import (PAD_POSITION,
                                                              quantize_kv)
from neuronx_distributed_tpu_torch.ops import paged_attention as tpa


def _case(seed, quantized, t=6, n=4, kv=2, d=16, nb=8, bs=4, maxb=3):
    """GQA n_rep=2, -1 table entries, a block shared by two tokens, a pad
    slot in the pool and one token with no valid key at all."""
    rng = np.random.RandomState(seed)
    q = rng.randn(t, n, d).astype(np.float32)
    k = rng.randn(nb, bs, kv, d).astype(np.float32)
    v = rng.randn(nb, bs, kv, d).astype(np.float32)
    pool_pos = rng.randint(0, 12, (nb, bs)).astype(np.int32)
    pool_pos[0, 2] = PAD_POSITION
    tables = rng.randint(-1, nb, (t, maxb)).astype(np.int32)
    tables[1, 0] = tables[0, 0] = 5          # shared block
    tables[2, 1] = -1
    tables[3, :] = -1                        # no valid key: a pad row
    q_pos = rng.randint(4, 12, (t,)).astype(np.int32)
    arrs = dict(q=q, k=k, v=v, pool_pos=pool_pos, tables=tables, q_pos=q_pos,
                ks=None, vs=None)
    if quantized:
        kq, ks = jquant(jnp.asarray(k))
        vq, vs = jquant(jnp.asarray(v))
        arrs.update(k=np.array(kq), v=np.array(vq), ks=np.array(ks),
                    vs=np.array(vs))
    return arrs


def _real_rows(a):
    valid = ((a["q_pos"][:, None, None] >= a["pool_pos"][
        np.clip(a["tables"], 0, None)]) & (a["tables"][:, :, None] >= 0))
    return valid.reshape(len(valid), -1).any(axis=1)


def _torch_args(a):
    def t(x):
        return None if x is None else torch.from_numpy(x)
    return (t(a["q"]), t(a["k"]), t(a["v"]), t(a["pool_pos"]),
            t(a["tables"]), t(a["q_pos"]), t(a["ks"]), t(a["vs"]))


@pytest.mark.parametrize("force_pallas", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax(seed, quantized, force_pallas):
    a = _case(seed, quantized)
    ks = None if a["ks"] is None else jnp.asarray(a["ks"])
    vs = None if a["vs"] is None else jnp.asarray(a["vs"])
    ref = np.asarray(jpa(jnp.asarray(a["q"]), jnp.asarray(a["k"]),
                         jnp.asarray(a["v"]), jnp.asarray(a["pool_pos"]),
                         jnp.asarray(a["tables"]), jnp.asarray(a["q_pos"]),
                         k_scale=ks, v_scale=vs, force_pallas=force_pallas))
    got = tpa.paged_attention_plain(*_torch_args(a)).numpy()
    real = _real_rows(a)
    assert real.sum() >= 4 and not real[3]
    np.testing.assert_allclose(got[real], ref[real], rtol=1e-5, atol=1e-5)
    # a row with no valid key is zeros in the port (the JAX XLA path
    # averages uniformly there; its Pallas kernel gives zeros too)
    assert not got[~real].any()


def test_dispatch_on_cpu_takes_the_plain_version():
    a = _case(4, False)
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(*_torch_args(a))
    assert torch.equal(out, tpa.paged_attention_plain(*_torch_args(a)))
    assert tpa.paged_attention.launches == before


def test_validation_raises():
    q, k, v, pp, tb, qp, ks, vs = _torch_args(_case(5, True))
    with pytest.raises(ValueError):
        tpa.paged_attention(q, k, v, pp, tb, qp, k_scale=ks)
    with pytest.raises(ValueError):
        tpa.paged_attention(q[:, :3], k, v, pp, tb, qp, ks, vs)
    with pytest.raises(ValueError):
        tpa.paged_attention_cuda(q, k, v, pp, tb, qp, ks, vs)  # CPU tensors


def test_ctypes_binding_matches_the_c_prototype():
    """The ctypes argtypes agree with the kernel's extern "C" signature in
    count and kind (a mismatch shows only on the card otherwise)."""
    import ctypes
    import pathlib
    import re

    src = (pathlib.Path(tpa.__file__).parent.parent / "csrc"
           / "paged_attention.cu").read_text()
    proto = re.search(r'extern "C" int nxd_paged_attention\((.*?)\)\s*\{',
                      src, re.S).group(1)
    params = [p.strip() for p in proto.split(",")]
    kinds = [ctypes.c_void_p if "*" in p else
             ctypes.c_float if p.startswith("float") else ctypes.c_int
             for p in params]
    assert kinds == tpa.ARGTYPES


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernel's schedule, emulated
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634


def _tensor_core_schedule(q, k, v, pool_pos, tables, q_pos, splits,
                          drop_last_run=False, drop_last_split=False,
                          split_by="width"):
    """What ``tc::paged_attention_wgmma`` computes, step by step in fp32
    on bf16 inputs: per kv head, tiles of ``64 // n_rep`` tokens; in each
    tile the runs of consecutive tokens with equal table rows; per run the
    valid entries, split z of ``splits`` taking those of rank [z c, (z + 1)
    c), c = ceil(MAXB / splits), in rounds of 256, their keys in 64-key
    tiles (the ragged tail zero-filled and masked); S in fp32, scaled in
    fp32, masked by each row's q_pos; the online softmax in log2 units with
    P rounded once to bf16 before PV; the splits merged in order. The
    flags plant faults: a tile that drops its last run, a run that drops
    the last split holding any of its entries, and ``split_by="mapped"``,
    the split points of earlier versions (the z-th share of the run's
    valid entries, which follows how much of the table is mapped)."""
    t, n, d = q.shape
    _, bs, kv, _ = k.shape
    maxb = tables.shape[1]
    n_rep = n // kv
    per = tpa.ROWS // n_rep
    scale2 = LOG2E / np.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros(t, n, d)

    def split_range(z, nv):
        if split_by == "mapped":
            return z * nv // splits, (z + 1) * nv // splits
        c = -(-maxb // splits)
        return min(z * c, nv), min((z + 1) * c, nv)

    for h in range(kv):
        heads = slice(h * n_rep, (h + 1) * n_rep)
        for t0 in range(0, t, per):
            ntok = min(per, t - t0)
            starts = [0] + [i for i in range(1, ntok) if not torch.equal(
                tables[t0 + i], tables[t0 + i - 1])]
            runs = list(zip(starts, starts[1:] + [ntok]))
            if drop_last_run and len(runs) > 1:
                runs = runs[:-1]
            parts = []
            for z in range(splits):
                m = torch.full((ntok, n_rep), -np.inf)
                l = torch.zeros(ntok, n_rep)
                acc = torch.zeros(ntok, n_rep, d)
                for a, b in runs:
                    valid = tables[t0 + a][tables[t0 + a] >= 0].long()
                    lo, hi = split_range(z, len(valid))
                    if drop_last_split and lo < hi and not any(
                            x < y for x, y in (split_range(w, len(valid))
                                               for w in range(z + 1,
                                                              splits))):
                        continue
                    for r0 in range(lo, hi, 256):
                        blocks = valid[r0:min(hi, r0 + 256)]
                        keys = kf[blocks, :, h].reshape(-1, d)
                        vals = vf[blocks, :, h].reshape(-1, d)
                        pos = pool_pos[blocks].reshape(-1)
                        for k0 in range(0, len(keys), 64):
                            kt, vt = keys[k0:k0 + 64], vals[k0:k0 + 64]
                            real = len(kt)
                            kt = torch.cat([kt, kt.new_zeros(64 - real, d)])
                            vt = torch.cat([vt, vt.new_zeros(64 - real, d)])
                            s = torch.einsum("trd,kd->trk",
                                             qf[t0 + a:t0 + b, heads],
                                             kt) * scale2
                            ok = (q_pos[t0 + a:t0 + b, None]
                                  >= pos[None, k0:k0 + 64])
                            ok = torch.cat([ok, ok.new_zeros(b - a,
                                                             64 - real)], 1)
                            s = s.masked_fill(~ok[:, None, :], -np.inf)
                            m_old = m[a:b]
                            m_new = torch.maximum(m_old, s.amax(-1))
                            base = torch.where(torch.isinf(m_new), 0.0,
                                               m_new)
                            corr = torch.where(torch.isinf(m_old), 0.0,
                                               torch.exp2(m_old - base))
                            p = torch.exp2(s - base[..., None])
                            l[a:b] = l[a:b] * corr + p.sum(-1)
                            acc[a:b] = (acc[a:b] * corr[..., None]
                                        + p.bfloat16().float() @ vt)
                            m[a:b] = m_new
                parts.append((m, l, acc))
            mx = torch.stack([p[0] for p in parts]).amax(0)
            lt = torch.zeros_like(mx)
            at = torch.zeros(ntok, n_rep, d)
            for m, l, acc in parts:
                w = torch.where(torch.isinf(m), 0.0, torch.exp2(m - mx))
                lt += l * w
                at += acc * w[..., None]
            out[t0:t0 + ntok, heads] = at / lt.clamp(min=1e-30)[..., None]
    return out.to(q.dtype)


def _step_case(kind, t, n_rep, bs, kv=2, d=64, seed=0):
    """Random bf16 q and pools over :func:`chip_smoke.packed_step`'s
    tables: 256 keys a table at most."""
    from chip_smoke import packed_step

    maxb = 256 // bs
    nb = 9 * maxb
    pool_pos, tables, q_pos = packed_step(seed, kind, t, bs, maxb, nb, 300)
    rng = np.random.RandomState(seed + 1)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .bfloat16() for shape in ((t, kv * n_rep, d),
                                         (nb, bs, kv, d), (nb, bs, kv, d)))
    return (q, k, v, torch.from_numpy(pool_pos), torch.from_numpy(tables),
            torch.from_numpy(q_pos))


STEP_CASES = [("random", 40, 4, 16), ("prefill", 48, 4, 16),
              ("decode", 40, 4, 16), ("worker", 4, 4, 16),
              ("random", 70, 1, 32), ("prefill", 70, 1, 32),
              ("decode", 21, 8, 32), ("prefill", 21, 8, 16)]


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("kind,t,n_rep,bs", STEP_CASES)
def test_tensor_core_schedule_matches_plain_and_jax(kind, t, n_rep, bs,
                                                     splits):
    """The bf16 tensor-core K1's schedule (runs of equal table rows in
    tiles of 64 // n_rep tokens, each run's table split across CTAs and
    merged in order, P rounded to bf16) stays within the card's 2e-2 of
    ``paged_attention_plain``, which matches the JAX ``_paged_attention_xla``
    on every row with a valid key: the random case, steps shaped like the
    engine's (prefill chunks, decode rows and pad rows, the decode worker),
    T not a multiple of the tile, block sizes 16 and 32, n_rep 1, 4 and 8.
    The same rule flags a schedule that drops a tile's last run or a run's
    last split."""
    args = _step_case(kind, t, n_rep, bs)
    q, k, v, pool_pos, tables, q_pos = args
    ref = tpa.paged_attention_plain(*args)
    ref32 = tpa.paged_attention_plain(q.float(), k.float(), v.float(),
                                      pool_pos, tables, q_pos)
    jref = np.asarray(jpa(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
                          *(jnp.asarray(x.numpy())
                            for x in (pool_pos, tables, q_pos))))
    real = _real_rows(dict(q_pos=q_pos.numpy(), pool_pos=pool_pos.numpy(),
                           tables=tables.numpy()))
    np.testing.assert_allclose(ref32.numpy()[real], jref[real], rtol=1e-5,
                               atol=1e-5)
    got = _tensor_core_schedule(*args, splits)
    assert (got.float() - ref.float()).abs().max() <= 2e-2
    assert not got[~torch.from_numpy(real)].any()
    per = tpa.ROWS // n_rep
    n_runs = [1 + int((tile[1:] != tile[:-1]).any(1).sum())
              for tile in tables.split(per)]
    faults = []
    if max(n_runs) > 1:
        faults.append(dict(drop_last_run=True))
    if splits > 1:
        faults.append(dict(drop_last_split=True))
    for fault in faults:
        bad = _tensor_core_schedule(*args, splits, **fault)
        assert (bad.float() - ref.float()).abs().max() > 2e-2, fault


@pytest.mark.parametrize("splits", [2, 3])
@pytest.mark.parametrize("maxb", [24, 40])
def test_tensor_core_split_points_follow_the_tables_width(maxb, splits):
    """The bf16 K1's split points come from the table's width: 16 rows
    (positions in block 11) attend the same keys through tables of that
    width with 16, 24 or all entries mapped, the later blocks past every
    row, and the emulated schedule gives the same bits each time (as the
    reference, which walks every entry in order and adds exact zeros for
    the rest), within 2e-2 of the plain version. The split points of
    earlier versions, a share of the mapped entries, give other bits for
    the same rows, which is why bf16 greedy ids followed how a prompt was
    chunked."""
    rng = np.random.RandomState(9)
    t, n, kv, d, bs, nb = 16, 8, 2, 64, 16, 48
    q = torch.from_numpy(rng.randn(t, n, d).astype(np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.randn(nb, bs, kv, d).astype(np.float32))
            .bfloat16() for _ in "kv")
    pool_pos = torch.arange(nb * bs, dtype=torch.int32).view(nb, bs)
    q_pos = torch.arange(176, 192, dtype=torch.int32)
    outs = {}
    for split_by in ("width", "mapped"):
        for valid in sorted({16, 24, maxb}):
            tables = torch.full((t, maxb), -1, dtype=torch.int32)
            tables[:, :valid] = torch.arange(valid, dtype=torch.int32)
            args = (q, k, v, pool_pos, tables, q_pos)
            got = _tensor_core_schedule(*args, splits, split_by=split_by)
            ref = tpa.paged_attention_plain(*args).float()
            assert (got.float() - ref).abs().max() <= 2e-2
            outs.setdefault(split_by, []).append(got)
    first = outs["width"][0]
    assert all(torch.equal(first, o) for o in outs["width"][1:])
    assert not all(torch.equal(outs["mapped"][0], o)
                   for o in outs["mapped"][1:])


@pytest.mark.parametrize("t,n,kv,want", [(512, 32, 8, 2), (4, 32, 8, 16),
                                         (48, 8, 2, 16), (64, 32, 8, 16),
                                         (1024, 32, 8, 1), (2048, 32, 8, 1)])
def test_tc_splits_fill_the_card_from_the_shapes(t, n, kv, want):
    """The split count comes from T, N and KV alone (no data the host
    would have to sync for): two at the packed step (32 token tiles x 8 kv
    heads = 256 CTAs on 132 SMs), 16 at the decode worker (one tile x 8 kv
    heads), one from 64 token tiles up."""
    assert tpa.tc_splits(t, n, kv, 132) == want


@pytest.mark.parametrize("kernel", [
    "void (anonymous namespace)::tc::paged_attention_wgmma<128, 2>(...)",
    "void (anonymous namespace)::tc::paged_combine<128>(...)",
    "void (anonymous namespace)::paged_attention_kernel<float, float, 64>"
    "(...)",
])
def test_profile_serving_groups_every_k1_kernel(kernel):
    """``scripts/profile_serving.py`` counts K1's kernels, the bf16
    tensor-core kernel with its split combine and the CUDA-core one, under
    ``paged_attention``."""
    from neuronx_distributed_tpu_torch.scripts import profile_serving

    assert profile_serving.group_of(kernel) == "paged_attention"

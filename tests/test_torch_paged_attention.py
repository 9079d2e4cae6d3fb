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

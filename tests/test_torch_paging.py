"""Parity of the PyTorch port's paged-pool host and write plumbing with the
JAX package: the refcounted block allocator, the flat write indices and the
pool scatters (bitwise), and the int8 KV quantizer (bitwise codes)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuronx_distributed_tpu.inference import kv_cache as jkv
from neuronx_distributed_tpu.inference import paging as jpg
from neuronx_distributed_tpu_torch.inference import kv_cache as tkv
from neuronx_distributed_tpu_torch.inference import paging as tpg


def _state(a):
    return ([list(f) for f in a._free], sorted(a._allocated),
            sorted(a._refs.items()))


@pytest.mark.parametrize("cp_size,seed", [(1, 0), (1, 1), (2, 2)])
def test_block_allocator_matches_jax(cp_size, seed):
    """A seeded random sequence of alloc / free / ref calls leaves both
    allocators in the same state and raises at the same points."""
    rng = np.random.RandomState(seed)
    nb = 16
    ja, ta = jpg.BlockAllocator(nb, cp_size), tpg.BlockAllocator(nb, cp_size)
    held = []
    raised = 0
    for _ in range(300):
        op = rng.randint(4)
        if op == 0:
            n = int(rng.randint(0, 6))
            rank = (int(rng.randint(cp_size)) if cp_size > 1
                    and rng.rand() < 0.5 else None)
            outs = []
            for a, err in ((ja, jpg.CacheExhaustedError),
                           (ta, tpg.CacheExhaustedError)):
                try:
                    outs.append(a.alloc(n, rank=rank))
                except err:
                    outs.append("exhausted")
            assert outs[0] == outs[1]
            if outs[0] == "exhausted":
                raised += 1
            else:
                held += outs[0]
        elif op == 1 and held:
            pick = [held.pop(rng.randint(len(held)))
                    for _ in range(rng.randint(1, min(3, len(held)) + 1))]
            assert ja.free(pick) == ta.free(pick)
        elif op == 2 and held:
            b = held[rng.randint(len(held))]
            ja.ref(b)
            ta.ref(b)
            held.append(b)
        elif op == 3:
            b = int(rng.randint(nb))
            if b not in held:       # unallocated: a double free raises
                for a in (ja, ta):
                    with pytest.raises(ValueError):
                        a.free([b])
            assert ja.refcount(b) == ta.refcount(b)
        assert _state(ja) == _state(ta)
        assert (ja.num_free, ja.num_allocated, ja.num_shared,
                ja.free_per_rank()) == (ta.num_free, ta.num_allocated,
                                        ta.num_shared, ta.free_per_rank())
    assert raised > 0  # the sequence reached the exhausted pool


def _routing_case(seed):
    rng = np.random.RandomState(seed)
    nb, bs, maxb, t = 8, 4, 3, 12
    tables = rng.randint(-1, nb, (t, maxb)).astype(np.int32)
    positions = rng.randint(0, maxb * bs + 3, (t,)).astype(np.int32)
    positions[rng.rand(t) < 0.25] = tkv.PAD_POSITION
    return nb, bs, tables, positions


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flat_write_indices_bitwise(seed):
    nb, bs, tables, positions = _routing_case(seed)
    ref = np.asarray(jpg.flat_write_indices(
        jnp.asarray(tables), jnp.asarray(positions), bs, nb * bs))
    got = tpg.flat_write_indices(torch.from_numpy(tables),
                                 torch.from_numpy(positions), bs, nb * bs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref == nb * bs).any()  # pad / unmapped rows were routed out


@pytest.mark.parametrize("seed", [0, 1])
def test_pool_writes_bitwise_with_pad_rows(seed):
    """K/V rows and positions land where the JAX drop-mode scatters put
    them; rows indexed at the capacity sentinel are dropped."""
    rng = np.random.RandomState(seed)
    nb, bs, kv, d = 6, 4, 2, 8
    cap = nb * bs
    # distinct valid indices plus pad rows at the sentinel
    idx = rng.permutation(cap)[:10].astype(np.int32)
    idx[[1, 4, 7]] = cap
    pool = rng.randn(nb, bs, kv, d).astype(np.float32)
    rows = rng.randn(10, kv, d).astype(np.float32)
    pos = rng.randint(0, 50, (nb, bs)).astype(np.int32)
    new_pos = rng.randint(0, 50, (10,)).astype(np.int32)
    ref_pool = np.asarray(jpg.write_pool_rows(
        jnp.asarray(pool), jnp.asarray(rows), jnp.asarray(idx)))
    ref_pos = np.asarray(jpg.write_pool_positions(
        jnp.asarray(pos), jnp.asarray(new_pos), jnp.asarray(idx)))
    t_pool, t_pos = torch.from_numpy(pool.copy()), torch.from_numpy(pos.copy())
    tpg.write_pool_rows(t_pool, torch.from_numpy(rows), torch.from_numpy(idx))
    tpg.write_pool_positions(t_pos, torch.from_numpy(new_pos),
                             torch.from_numpy(idx))
    np.testing.assert_array_equal(t_pool.numpy(), ref_pool)
    np.testing.assert_array_equal(t_pos.numpy(), ref_pos)


def test_quantize_kv_matches_jax():
    """int8 codes bitwise (both round half to even), scales within one
    ulp; exact halves and all-zero vectors included."""
    rng = np.random.RandomState(3)
    x = rng.randn(6, 5, 16).astype(np.float32) * 3.0
    x[0, 0] = 0.0
    x[1, 1, :] = np.arange(16, dtype=np.float32) - 7.5   # .5 ties
    x[1, 1, 0] = 127.0
    q_ref, s_ref = (np.asarray(a) for a in jkv.quantize_kv(jnp.asarray(x)))
    q, s = tkv.quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), q_ref)
    np.testing.assert_array_max_ulp(s.numpy(), s_ref, maxulp=1)
    deq_ref = np.asarray(jkv.dequantize_kv(jnp.asarray(q_ref),
                                           jnp.asarray(s_ref), jnp.float32))
    np.testing.assert_array_equal(
        tkv.dequantize_kv(q, s, torch.float32).numpy(), deq_ref)
    assert tkv.PAD_POSITION == int(jkv.PAD_POSITION)


def test_init_paged_caches_match_jax_layout():
    j = jpg.init_paged_kv_cache(2, 8, 4, 2, 16, 3, 5, dtype=jnp.float32)
    t = tpg.init_paged_kv_cache(2, 8, 4, 2, 16, 3, 5, dtype=torch.float32,
                                device="cpu")
    jq = jpg.init_quantized_paged_kv_cache(2, 8, 4, 2, 16, 3, 5)
    tq = tpg.init_quantized_paged_kv_cache(2, 8, 4, 2, 16, 3, 5,
                                           device="cpu")
    for a, b in ((j, t), (jq, tq)):
        for name in ("k", "v", "pos", "block_tables", "lengths"):
            np.testing.assert_array_equal(getattr(b, name).numpy(),
                                          np.asarray(getattr(a, name)))
        assert (b.capacity, b.max_slots, b.max_blocks_per_seq) == (
            a.capacity, a.max_slots, a.max_blocks_per_seq)
    np.testing.assert_array_equal(tq.k_scale.numpy(), np.asarray(jq.k_scale))
    assert tq.k.dtype == torch.int8

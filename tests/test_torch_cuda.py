"""Card-only checks of the PyTorch port: the hand-written paged-attention
kernel against its plain version, the wrapper's refusals, and the serving
engine on the card against the same engine on the CPU.

This file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.) Without
a CUDA card every test here skips.
"""

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.inference import engine as te
from neuronx_distributed_tpu_torch.inference.kv_cache import (PAD_POSITION,
                                                              quantize_kv)
from neuronx_distributed_tpu_torch.models import llama as tl
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

"""The port's AdamW updates a large parameter a block of rows at a time
(``trainer/optimizer.py`` ``UPDATE_CHUNK``), so that its temporaries stay
small: the blocks change no bit of the update, and a ZeRO-1 view (a
narrowed, non-contiguous slice) is updated in place through them."""

import torch

from neuronx_distributed_tpu_torch.trainer import optimizer as opt


def _run(chunk, monkeypatch, params, grads):
    monkeypatch.setattr(opt, "UPDATE_CHUNK", chunk)
    tx = opt.AdamW(learning_rate=1e-2, weight_decay=0.1, max_grad_norm=None)
    ps = [p.clone() for p in params]
    state = tx.init(ps)
    for _ in range(3):
        tx.update(ps, [g.clone() for g in grads], state)
    return ps, state


def test_row_blocks_change_no_bit(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(s, generator=gen) for s in ((9, 4, 5), (7,),
                                                      (3, 11), ())]
    grads = [torch.randn(p.shape, generator=gen) for p in params]
    whole, sw = _run(1 << 30, monkeypatch, params, grads)
    blocks, sb = _run(16, monkeypatch, params, grads)
    for a, b in zip(whole + sw.mu + sw.nu, blocks + sb.mu + sb.nu):
        assert torch.equal(a, b)
    # the first parameter (180 elements) went through 20-element blocks
    monkeypatch.setattr(opt, "UPDATE_CHUNK", 16)
    assert [b[0].shape for b in opt._row_blocks(params[0])] == [(1, 4, 5)] * 9


def test_a_narrowed_view_is_updated_in_place(monkeypatch):
    monkeypatch.setattr(opt, "UPDATE_CHUNK", 8)
    gen = torch.Generator().manual_seed(1)
    full = torch.randn(6, 10, generator=gen)
    view = full.narrow(1, 5, 5)             # what ZeRO-1 updates
    want = view.clone()
    tx = opt.AdamW(learning_rate=1e-2, max_grad_norm=None)
    g = torch.randn(view.shape, generator=gen)
    tx.update([want], [g.clone()], tx.init([want]))
    tx.update([view], [g.clone()], tx.init([view]))
    assert torch.equal(full[:, 5:], want)
    assert len(list(opt._row_blocks(view))) == 6

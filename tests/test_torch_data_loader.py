"""The port's ``TokenBatchLoader`` against the JAX package's: the numpy path
bit for bit, the native path bit for bit with one producer thread (each
package's own build of ``csrc/data_loader.cpp`` under its own wrapper), the
port's library under ``build/``, the stall timeout and the argument
checks."""

import os
import shutil
import threading

import numpy as np
import pytest

from neuronx_distributed_tpu.data import native_loader as jnl
from neuronx_distributed_tpu_torch.data import native_loader as tnl


@pytest.fixture(scope="module", params=["uint16", "uint32"])
def token_file(request, tmp_path_factory):
    p = tmp_path_factory.mktemp("data") / f"tokens_{request.param}.bin"
    np.random.RandomState(0).randint(0, 60000, 40 * 17).astype(
        request.param).tofile(p)
    return str(p), request.param


def _batches(cls, path, dtype, n, **kw):
    loader = cls(path, batch=3, seqlen=16, seed=5, dtype=dtype, **kw)
    try:
        return loader.native, [loader.next_batch() for _ in range(n)]
    finally:
        loader.close()


@pytest.fixture(scope="module")
def jax_source(tmp_path_factory):
    """A copy of ``csrc/data_loader.cpp`` in a directory of its own. The JAX
    package compiles its library beside the source it is given; given this
    copy, it builds with its own command and flags where no other test
    file's worker can be writing the same library at the same moment."""
    src = tmp_path_factory.mktemp("jax_csrc") / "data_loader.cpp"
    shutil.copyfile(jnl._csrc_path(), src)
    return str(src)


@pytest.mark.parametrize("native", [False, True])
def test_batches_equal_the_jax_loader_bit_for_bit(token_file, native,
                                                  jax_source, monkeypatch):
    """Natively, each package runs over its own build: the port's under
    ``build/``, the JAX package's from its own ``_load_native`` (its
    ``g++`` command, over a copy of the source)."""
    path, dtype = token_file
    kw = dict(nthreads=1) if native else dict(force_python=True)
    if native:
        monkeypatch.setattr(jnl, "_csrc_path", lambda: jax_source)
        monkeypatch.setattr(jnl, "_LIB", None)
        monkeypatch.setattr(jnl, "_LIB_FAILED", False)
    t_native, got = _batches(tnl.TokenBatchLoader, path, dtype, 6, **kw)
    j_native, ref = _batches(jnl.TokenBatchLoader, path, dtype, 6, **kw)
    assert t_native == j_native == native
    if native:
        assert jnl._LIB is not None and os.path.dirname(
            jnl._LIB._name) == os.path.dirname(jax_source)
    tokens = np.fromfile(path, dtype=dtype)
    for g, r in zip(got, ref):
        for key in ("input_ids", "labels"):
            assert g[key].dtype == np.int32 and g[key].shape == (3, 16)
            np.testing.assert_array_equal(g[key], r[key])
        np.testing.assert_array_equal(g["input_ids"][:, 1:],
                                      g["labels"][:, :-1])
        # every row is one whole sequence of the file
        for row in np.concatenate([g["input_ids"], g["labels"][:, -1:]],
                                  axis=1):
            start = np.flatnonzero(tokens == row[0])
            assert any(np.array_equal(tokens[i:i + 17], row)
                       for i in start if i % 17 == 0)


def test_the_library_lands_under_build():
    lib = tnl.library_path()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert lib.parent == tnl.BUILD_DIR
    assert str(lib).startswith(os.path.join(repo, "build", "data_loader"))
    assert tnl._load_native() is not None and lib.is_file()
    assert str(tnl.SOURCE) == jnl._csrc_path()


def test_several_threads_give_whole_sequences(token_file):
    path, dtype = token_file
    native, got = _batches(tnl.TokenBatchLoader, path, dtype, 20,
                           nthreads=4, capacity=2)
    assert native
    assert all(b["input_ids"].shape == (3, 16) for b in got)


def test_stall_timeout_raises(token_file, monkeypatch):
    path, dtype = token_file
    loader = tnl.TokenBatchLoader(path, 3, 16, dtype=dtype,
                                  force_python=True, stall_timeout_s=0.2)
    release = threading.Event()
    produce = loader._produce
    monkeypatch.setattr(loader, "_produce",
                        lambda: (release.wait(5), produce())[1])
    with pytest.raises(tnl.DataLoaderStallError):
        loader.next_batch()
    release.set()


def test_bad_arguments_raise(token_file):
    path, dtype = token_file
    for kw in (dict(dtype="int8"), dict(nthreads=0), dict(capacity=0)):
        with pytest.raises(ValueError):
            tnl.TokenBatchLoader(path, 3, 16, **{"dtype": dtype, **kw})
    for force in (False, True):
        with pytest.raises(ValueError):
            tnl.TokenBatchLoader(path, 100, 16, dtype=dtype,
                                 force_python=force)

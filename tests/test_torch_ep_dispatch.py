"""The expert-parallel dispatch of the port (``parallel/ep_dispatch.py``)
on four gloo ranks on the CPU at ep=4, held to JAX's
``tests/test_ep_dispatch.py`` contracts and to the JAX functions under
``shard_map`` on a 4-device mesh, from the same numpy inputs:

* ring == monolithic bit for bit at fp32, int8 and fp8, the gather's
  chunks, the combine's shard and both backwards;
* the fp32 gather equals the ``all_gather``'s slices; the fp32 combine
  equals JAX's ``psum_scatter`` bit for bit (both sum in ascending rank
  order) and gloo's ``reduce_scatter`` within 1e-6 (gloo sums in its own
  order);
* the port's chunks, combined shards and gradients equal the JAX
  functions' under ``shard_map`` bit for bit at fp32; on the quantized
  wires the codes and scales equal JAX's ``encode_payload`` bit for bit,
  and the decoded values equal the jitted JAX functions' within 1e-6
  relative (XLA's compiler turns the scale's ``amax / qmax`` into a
  product by the reciprocal inside ``jit``, one ulp off the division that
  eager JAX and the port compute);
* an unbound or size-1 axis is the identity; ``overlap_engaged``;
* the wire-byte counters (``ep_dispatch``, ``ep_combine``);
* at the layer (the blockwise expert bank): the fp32 ring equals the
  monolithic path bit for bit forward and in dx and dgates (dW within
  1e-5, as JAX), int8 ring equals int8 monolithic bit for bit in every
  gradient leaf, and both equal JAX's bank under ``shard_map`` (fp32 within
  2e-5, int8 within 0.05, JAX's own bounds against its fp32 baseline)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.modules.moe.expert_mlps import \
    ExpertMLPs as JExpertMLPs
from neuronx_distributed_tpu.parallel import comm as jcomm
from neuronx_distributed_tpu.parallel import ep_dispatch as jepd
from neuronx_distributed_tpu.parallel import mesh as jps
from neuronx_distributed_tpu.parallel import wire_codec as jwc
from neuronx_distributed_tpu_torch.parallel import ep_dispatch as tepd
from neuronx_distributed_tpu_torch.parallel import wire_codec as twc
from neuronx_distributed_tpu_torch.utils.cpu_mesh import run_ranks

import torch_ep_ranks

N, T, H = 4, 8, 64
WIRES = ("fp32", "int8", "fp8")
E, HM, IM = 4, 16, 32


def _inputs():
    rng = np.random.RandomState(0)
    x = rng.randn(N * T, H).astype(np.float32)
    ys = rng.randn(N, N * T, H).astype(np.float32)
    # the cotangents of the chunks and of the combined shard
    gx = rng.randn(N, N * T, H).astype(np.float32)
    gy = rng.randn(N * T, H).astype(np.float32)
    mlp = dict(
        kw=dict(num_experts=E, hidden=HM, intermediate=IM,
                dispatch_mode="blockwise", block_size=8, block_i=32),
        gate_up=(rng.randn(E, HM, 2, IM) * 0.2).astype(np.float32),
        down=(rng.randn(E, IM, HM) * 0.2).astype(np.float32),
        x=rng.randn(32, HM).astype(np.float32),
        gates=rng.dirichlet((1.0, 1.0), 32).astype(np.float32),
        idx=rng.randint(0, E, (32, 2)).astype(np.int32))
    return x, ys, gx, gy, mlp


def _wire(name):
    return None if name == "fp32" else jepd.wire_config(name)


def _jax_refs(x, ys, gx, gy, mlp):
    """JAX's functions under ``shard_map`` on the expert mesh of 4 devices
    at ep=4: per wire and form the chunks, combined shards and both
    backwards (by rank), and the bank's outputs and gradients."""
    nxd.neuronx_distributed_config(expert_parallel_size=N,
                                   devices=jax.devices()[:N])
    try:
        em = jps.get_expert_mesh()
        out = {}
        for name in WIRES:
            wire = _wire(name)
            for ring in (True, False):
                def gather(xs, wire=wire, ring=ring):
                    return jepd.gather_token_chunks(xs, "ep", wire=wire,
                                                    overlap=ring)

                def combine(ysl, wire=wire, ring=ring):
                    return jepd.combine_token_chunks(
                        tuple(ysl[t] for t in range(N)), "ep", wire=wire,
                        overlap=ring)

                def dgather(xs, g, gather=gather):
                    return jax.grad(lambda a: sum(
                        jnp.sum(c * g[t])
                        for t, c in enumerate(gather(a))))(xs)

                def dcombine(ysl, g, combine=combine):
                    return jax.grad(lambda a: jnp.sum(combine(a) * g))(ysl)

                chunks = jax.jit(jps.shard_map(
                    gather, em, in_specs=P("ep", None),
                    out_specs=tuple(P("ep", None) for _ in range(N))))(x)
                comb = jax.jit(jps.shard_map(
                    combine, em, in_specs=P(None, "ep", None),
                    out_specs=P("ep", None)))(ys)
                dx = jax.jit(jps.shard_map(
                    dgather, em, in_specs=(P("ep", None), P(None, "ep", None)),
                    out_specs=P("ep", None)))(x, gx)
                dys = jax.jit(jps.shard_map(
                    dcombine, em, in_specs=(P(None, "ep", None),
                                            P("ep", None)),
                    out_specs=P(None, "ep", None)))(ys, gy)
                out[(name, ring)] = dict(
                    chunks=[np.asarray(c) for c in chunks],
                    combined=np.asarray(comb), dx=np.asarray(dx),
                    dys=np.asarray(dys))

        def rs(ysl):
            me = jcomm.combined_axis_index("ep")
            stacked = jnp.stack(tuple(ysl[t] for t in range(N)))
            dest = jnp.roll(stacked, shift=me, axis=0).reshape(N * T, H)
            return jcomm.reduce_scatter(dest, "ep", dim=0)
        out["psum_scatter"] = np.asarray(jax.jit(jps.shard_map(
            rs, em, in_specs=P(None, "ep", None),
            out_specs=P("ep", None)))(ys))
        out["bank"] = _jax_bank(em, mlp)
    finally:
        jps.destroy_model_parallel()
    return out


def _jax_bank(em, mlp):
    params = {"params": {"gate_up": jnp.asarray(mlp["gate_up"]),
                         "down": jnp.asarray(mlp["down"])}}
    pspec = {"params": {"gate_up": P("ep", None, None, None),
                        "down": P("ep", None, None)}}
    args = tuple(jnp.asarray(mlp[k]) for k in ("x", "gates", "idx"))
    out = {}
    for wire, ring in (("fp32", False), ("int8", True)):
        m = JExpertMLPs(num_experts=E, hidden_size=HM, intermediate_size=IM,
                        top_k=2, dispatch_mode="blockwise", block_size=8,
                        block_i=32, dtype=jnp.float32, ep_wire_dtype=wire,
                        ep_overlap=ring)

        def grads(p, a, g, i, m=m):
            def loss(p, a, g):
                return jnp.sum(jnp.tanh(m.apply(p, a, g, i)[0]))
            return jax.grad(loss, argnums=(0, 1, 2))(p, a, g)

        y = jax.jit(jps.shard_map(
            lambda p, a, g, i, m=m: m.apply(p, a, g, i)[0], em,
            in_specs=(pspec, P("ep", None), P("ep", None), P("ep", None)),
            out_specs=P("ep", None)))(params, *args)
        g = jax.jit(jps.shard_map(
            grads, em,
            in_specs=(pspec, P("ep", None), P("ep", None), P("ep", None)),
            out_specs=(pspec, P("ep", None), P("ep", None))))(params, *args)
        out[(wire, ring)] = dict(
            y=np.asarray(y), gate_up=np.asarray(g[0]["params"]["gate_up"]),
            down=np.asarray(g[0]["params"]["down"]), x=np.asarray(g[1]),
            gates=np.asarray(g[2]))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    x, ys, gx, gy, mlp = _inputs()
    outs = run_ranks(torch_ep_ranks.dispatch_world, N, backend="gloo",
                     device="cpu",
                     store_dir=str(tmp_path_factory.mktemp("ep_dispatch")),
                     args=(x, ys, gx, gy, mlp), timeout=300)
    return dict(x=x, ys=ys, mlp=mlp, outs=outs,
                jax=_jax_refs(x, ys, gx, gy, mlp))


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.array_equal(a, b), (
        what, np.abs(a.astype(np.float64) - b).max())


def test_ranks_import_no_jax(run):
    for o in run["outs"]:
        assert o["jax_modules"] == [], o["jax_modules"]


@pytest.mark.parametrize("wire", WIRES)
def test_ring_equals_monolithic_bitwise(run, wire):
    """Chunks, combined shard and both backwards: the ring's are the
    monolithic path's, bit for bit, on every rank."""
    for o in run["outs"]:
        ring, mono = o[(wire, True)], o[(wire, False)]
        assert len(ring["chunks"]) == N
        for t, (a, b) in enumerate(zip(ring["chunks"], mono["chunks"])):
            _eq(a, b, f"chunk {t}")
        for key in ("combined", "dx", "dys"):
            _eq(ring[key], mono[key], key)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("ring", [True, False])
def test_chunks_and_shards_equal_jax(run, wire, ring):
    """Each rank's chunks, combined shard and gradients equal the JAX
    functions' under ``shard_map``: bit for bit at fp32, within 1e-6
    relative on a quantized wire (the module docstring)."""
    want = run["jax"][(wire, ring)]

    def check(a, b, what):
        if wire == "fp32":
            _eq(a, b, what)
        else:
            np.testing.assert_allclose(np.asarray(a), b, rtol=1e-6,
                                       atol=1e-6, err_msg=what)
    for o in run["outs"]:
        r, got = o["me"], o[(wire, ring)]
        rows = slice(r * T, (r + 1) * T)
        for t in range(N):
            check(got["chunks"][t], want["chunks"][t][rows], f"chunk {t}")
        check(got["combined"], want["combined"][rows], "combined")
        check(got["dx"], want["dx"][rows], "dx")
        check(got["dys"], want["dys"][:, rows], "dys")


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_quantized_codes_and_scales_equal_jax(run, wire):
    """The wire's payload itself: codes and scales of a rank's rows and of
    a stacked combine payload equal JAX's ``encode_payload``."""
    for a in (run["x"][:T], run["ys"][:, :T]):
        jq, js = jwc.encode_payload(jnp.asarray(a), jepd.wire_config(wire))
        tq, ts = twc.encode_payload(torch.from_numpy(a),
                                    tepd.wire_config(wire))
        _eq(tq.view(torch.uint8).numpy(),
            np.asarray(jq).view(np.uint8), "codes")
        _eq(ts.numpy(), np.asarray(js), "scales")


def test_gather_fp32_equals_all_gather_slices(run):
    for o in run["outs"]:
        for ring in (True, False):
            for a, b in zip(o[("fp32", ring)]["chunks"], o["all_gather"]):
                _eq(a, b, "chunk")


def test_combine_fp32_equals_reduce_scatter(run):
    """Bit for bit JAX's ``psum_scatter`` of the destination-ordered
    partials; gloo's ``reduce_scatter`` sums in another order, within
    1e-6."""
    for o in run["outs"]:
        r = o["me"]
        for ring in (True, False):
            got = o[("fp32", ring)]["combined"]
            _eq(got, run["jax"]["psum_scatter"][r * T:(r + 1) * T],
                "psum_scatter")
            np.testing.assert_allclose(got.numpy(),
                                       o["reduce_scatter"].numpy(),
                                       rtol=0, atol=1e-6)


def test_unbound_axis_is_identity():
    """No layout (or an axis of one rank): the gather is ``(x,)`` and the
    combine ``ys[0]``, the tensors given, whatever the wire and form."""
    x = torch.randn(T, H)
    chunks = tepd.gather_token_chunks(x)
    assert len(chunks) == 1 and chunks[0] is x
    y = tepd.combine_token_chunks((x,), wire=tepd.wire_config("int8"),
                                  overlap=True)
    assert y is x
    assert tepd.overlap_engaged(None, "ep") is False
    assert tepd.overlap_engaged(True, "ep") is False
    assert tepd.wire_config("fp32") is None and tepd.wire_config(None) is None
    assert tepd.wire_config("int8") == twc.CompressionConfig(
        dtype="int8", block_size=256, hierarchical=False,
        error_feedback=False)


def test_overlap_engaged_at_ep4(run):
    """Auto engages at ep=4 (``MIN_AUTO_AXIS_SIZE``), True engages, False
    never; the ring moves the payload by ``ppermute``, the monolithic
    form by ``all_gather``, each hop at the wire's bytes."""
    assert tepd.MIN_AUTO_AXIS_SIZE == jepd.MIN_AUTO_AXIS_SIZE == N
    for o in run["outs"]:
        assert o["engaged"] == {None: True, True: True, False: False}
        for wire in WIRES:
            assert set(o[(wire, True)]["gather_bytes"]) == {"ppermute"}
            assert set(o[(wire, False)]["gather_bytes"]) == {"all_gather"}
        assert o[("int8", True)]["gather_bytes"]["ppermute"] * 3 < \
            o[("fp32", True)]["gather_bytes"]["ppermute"]


def test_wire_bytes_are_recorded(run):
    """Each call accounts ``(n - 1)`` hops of the payload's wire bytes
    under ``ep_dispatch``/``ep_combine``: two calls each (forward, and
    the one differentiated) per form, both forms."""
    for o in run["outs"]:
        wb = o["wire_bytes"]
        for wire in WIRES:
            per = twc.payload_wire_bytes((T, H), tepd.wire_config(wire))
            for kind in ("ep_dispatch", "ep_combine"):
                assert wb[(kind, wire)] == 4 * (N - 1) * per, (kind, wire)


_LEAVES = ("y", "gate_up", "down", "x", "gates")


def test_expert_mlps_fp32_ring_bitwise_vs_baseline(run):
    """The fp32 ring at the layer: output, dx and dgates bit for bit the
    monolithic path's, dW within 1e-5 (another split of its sum)."""
    for o in run["outs"]:
        ring, mono = o["bank"][("fp32", True)], o["bank"][("fp32", False)]
        for key in ("y", "x", "gates"):
            _eq(ring[key], mono[key], key)
        for key in ("gate_up", "down"):
            np.testing.assert_allclose(ring[key].numpy(), mono[key].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)


def test_expert_mlps_int8_ring_bitwise_vs_monolithic(run):
    for o in run["outs"]:
        ring, mono = o["bank"][("int8", True)], o["bank"][("int8", False)]
        for key in _LEAVES:
            _eq(ring[key], mono[key], key)


@pytest.mark.parametrize("wire,ring,tol", [("fp32", False, 2e-5),
                                           ("int8", True, 5e-2)])
def test_expert_mlps_match_jax_bank(run, wire, ring, tol):
    """The port's bank at ep=4 against JAX's under ``shard_map``: output
    and every gradient leaf (this rank's experts and rows)."""
    want = run["jax"]["bank"][(wire, ring)]
    for o in run["outs"]:
        r = o["me"]
        got = o["bank"][(wire, ring)]
        rows = slice(r * 8, (r + 1) * 8)
        for key in _LEAVES:
            w = want[key][r:r + 1] if key in ("gate_up", "down") \
                else want[key][rows]
            np.testing.assert_allclose(got[key].numpy(), w, rtol=tol,
                                       atol=tol, err_msg=key)

"""Cross-host KV handoff: chunked, checksummed session streaming
(counterpart of ``neuronx_distributed_tpu/inference/transport.py``).

* **Wire format**: a :class:`.engine.SessionTicket` becomes a sequence of
  self-describing chunks, each ``NXDKVC1`` magic + one JSON header line
  (stream id, sequence number, tensor/layer coordinates, codec descriptor,
  payload fingerprint) + raw payload bytes. Chunk 0 is the *meta* chunk
  (the ticket's ``to_bytes`` with its KV stripped); every later chunk
  carries one per-layer tensor slab, so the decode side lands layers as
  they arrive. The bytes are the JAX package's for the same ticket: a bf16
  slab travels as its raw words under the dtype name ``bfloat16``
  (:mod:`..utils.bfloat16`), fp8 codes as their bytes.

* **Quantized payloads**: fp-pool K/V chunks go through the blockwise
  codec of :mod:`..parallel.wire_codec` (int8 or fp8 values + per-block
  fp32 scales on the wire); quantized pools ship their int8 values + pool
  scales raw, lossless against the pool and ~4x under the fp32 baseline.
  Positions always ride exact int32.

* **Fault surface**: :class:`DcnLink` paces bytes through a bandwidth and a
  latency under the caller's clock and asks the chaos plan about every
  send: ``link_drop`` loses the chunk, ``link_corrupt`` flips a payload
  bit, ``link_delay`` adds transit time, ``link_partition`` downs the link
  (losing whatever was in flight). :class:`KVStreamTransport` answers with
  a fingerprint check per chunk, NACK + bounded retransmit with
  exponential backoff on corruption, ACK-deadline retransmit on loss,
  assembly out of order by sequence number, and an atomic commit: the
  destination engine maps the streamed blocks into a slot only when every
  chunk has landed verified. A stream that exhausts a chunk's retransmit
  budget aborts, freeing every reserved block.

The ACK/NACK control plane is modelled reliable and instant, so sender
state (attempts, deadlines, backoff) and receiver state (dedup, the stash
of chunks that beat the meta chunk, the engine's stream handle) both live
on :class:`KVStreamTransport`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs.events import emit_event
from ..obs.metrics import get_registry
from ..parallel.wire_codec import (CompressionConfig, dequantize_blockwise,
                                   quantize_blockwise)
from ..resilience.integrity import fingerprint_array_np
from ..utils.bfloat16 import (BF16_NAME, dtype_name, from_buffer, is_bf16,
                              to_host, to_torch, widen_to_fp32_words)
from .engine import (CacheExhaustedError, RequestRejected, SessionTicket,
                     TicketWireError)

__all__ = [
    "CHUNK_MAGIC", "ChunkError", "ChunkIntegrityError", "StreamConfig",
    "LinkStats", "DcnLink", "TransportStats", "KVStreamTransport",
    "encode_chunk", "decode_chunk",
]

#: Chunk wire magic, the same versioned-ASCII-line shape as ``NXDTKT1``
#: (session tickets): skew between fabric builds shows in the first 8
#: bytes of any chunk.
CHUNK_MAGIC = b"NXDKVC1\n"


class ChunkError(RuntimeError):
    """A wire chunk is structurally unreadable: wrong magic, version skew,
    or an unparseable header. It carries no sequence number, so the
    receiver cannot NACK it; the sender's ACK deadline recovers it."""


class ChunkIntegrityError(ChunkError):
    """A chunk parsed but its payload is not what the sender fingerprinted
    (a bitflip in transit, truncation). The header survived, so ``seq``
    names the chunk to NACK."""

    def __init__(self, seq: int, msg: str):
        super().__init__(msg)
        self.seq = seq


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """How a KV handoff stream moves and protects its bytes.

    ``bandwidth`` / ``latency_s`` parameterize the :class:`DcnLink`
    carrier (defaults ≈ one 25 GbE NIC). ``wire_dtype`` picks the payload
    codec: ``"auto"`` ships quantized pools raw (int8 values + pool scales)
    and blockwise-int8-encodes fp pools; ``"int8"``/``"fp8"`` force the
    lossy blockwise codec for fp pools; ``"fp32"`` is the uncompressed
    baseline the wire ratio is measured against. ``max_chunk_attempts``
    bounds the transmissions of one chunk; ``ack_timeout_s`` is how long
    past the expected delivery the sender waits before declaring a chunk
    lost; ``backoff_base_s`` seeds the retransmit backoff
    (``base * 2**(attempt-1)``). ``cp_shards > 1`` splits every per-layer
    slab (and the position slab) into that many disjoint block-subset
    chunks; the commit still needs every chunk of every shard."""

    bandwidth: float = 3.125e9
    latency_s: float = 25e-6
    wire_dtype: str = "auto"
    wire_block: int = 256
    max_chunk_attempts: int = 4
    ack_timeout_s: float = 0.05
    backoff_base_s: float = 0.02
    cp_shards: int = 1

    def __post_init__(self) -> None:
        if self.wire_dtype not in ("auto", "fp32", "int8", "fp8"):
            raise ValueError(
                f"wire_dtype must be auto|fp32|int8|fp8, got "
                f"{self.wire_dtype!r}")
        if self.max_chunk_attempts < 1:
            raise ValueError("max_chunk_attempts must be >= 1")
        if self.cp_shards < 1:
            raise ValueError("cp_shards must be >= 1")


# ---------------------------------------------------------------------------
# Chunk codec
# ---------------------------------------------------------------------------

def _payload_fp(payload: bytes) -> int:
    if not payload:
        return 0
    return int(fingerprint_array_np(np.frombuffer(payload, np.uint8))[0])


def _raw_bytes(t: torch.Tensor) -> bytes:
    """A CPU tensor's bytes (fp8 through a byte view: numpy has no fp8)."""
    t = t.contiguous()
    if t.dtype == torch.float8_e4m3fn:
        t = t.view(torch.uint8)
    return t.numpy().tobytes()


def encode_chunk(stream: str, seq: int, kind: str, tensor: str,
                 layer: int, payload_arr: Optional[np.ndarray],
                 raw_payload: Optional[bytes] = None,
                 codec: Optional[CompressionConfig] = None,
                 part: Optional[List[int]] = None) -> bytes:
    """One wire chunk: magic + JSON header line + payload bytes. Data
    chunks carry ``payload_arr`` (a host array, bf16 as
    :class:`..utils.bfloat16.BF16Words`; raw, or through the blockwise
    codec when ``codec`` quantizes); the meta chunk carries ``raw_payload``
    (an already-serialized ticket). ``part`` marks a shard chunk: the
    payload covers only these block indices of the session's block list.
    The header records everything the receiver needs to rebuild the tensor
    and a fingerprint of the payload bytes."""
    head: Dict[str, Any] = {"stream": stream, "seq": int(seq),
                            "kind": kind, "tensor": tensor,
                            "layer": int(layer)}
    if part is not None:
        head["part"] = [int(b) for b in part]
    if raw_payload is not None:
        payload = raw_payload
        head.update(dtype=None, shape=None, codec=None)
    elif codec is not None and codec.quantized:
        q, s, n = quantize_blockwise(to_torch(payload_arr), codec)
        qb = _raw_bytes(q)
        payload = qb + _raw_bytes(s)
        head.update(dtype=dtype_name(payload_arr),
                    shape=list(np.shape(payload_arr)),
                    codec={"dtype": codec.dtype,
                           "block": int(codec.block_size),
                           "nb": int(q.shape[0]), "n": int(n),
                           "q_nbytes": len(qb)})
    else:
        arr = np.ascontiguousarray(payload_arr)
        payload = arr.tobytes()
        head.update(dtype=dtype_name(payload_arr), shape=list(arr.shape),
                    codec=None)
    head["nbytes"] = len(payload)
    head["fp"] = _payload_fp(payload)
    return CHUNK_MAGIC + json.dumps(head).encode("utf-8") + b"\n" + payload


def decode_chunk(data: bytes) -> Tuple[Dict[str, Any], bytes,
                                       Optional[np.ndarray]]:
    """Parse + verify one wire chunk → ``(header, payload_bytes, arr)``
    (``arr`` is the rebuilt — dequantized if needed — host array for data
    chunks, bf16 as :class:`..utils.bfloat16.BF16Words`; ``None`` for
    meta). Raises :class:`ChunkError` when the frame is unreadable and
    :class:`ChunkIntegrityError` (with the seq to NACK) when the frame
    parsed but the payload bytes are not the bytes the sender
    fingerprinted."""
    if len(data) < len(CHUNK_MAGIC) or data[:6] != CHUNK_MAGIC[:6]:
        raise ChunkError("not a KV stream chunk (bad magic)")
    if data[:len(CHUNK_MAGIC)] != CHUNK_MAGIC:
        got = data[:len(CHUNK_MAGIC)].rstrip(b"\n").decode("ascii",
                                                           "replace")
        raise ChunkError(
            f"chunk version skew: got {got!r}, this reader speaks "
            f"{CHUNK_MAGIC.rstrip().decode('ascii')!r}")
    nl = data.find(b"\n", len(CHUNK_MAGIC))
    if nl < 0:
        raise ChunkError("truncated chunk: no header line")
    try:
        head = json.loads(data[len(CHUNK_MAGIC):nl])
    except ValueError as e:
        raise ChunkError(f"corrupt chunk header: {e}") from e
    payload = data[nl + 1:]
    seq = int(head.get("seq", -1))
    if len(payload) != int(head["nbytes"]):
        raise ChunkIntegrityError(
            seq, f"chunk {seq}: header promises {head['nbytes']} "
            f"payload byte(s), {len(payload)} arrived")
    if _payload_fp(payload) != int(head["fp"]):
        raise ChunkIntegrityError(
            seq, f"chunk {seq}: payload failed its integrity "
            "fingerprint — corrupted in transit")
    if head["kind"] != "data":
        return head, payload, None
    codec = head.get("codec")
    if codec is None:
        return head, payload, from_buffer(payload, head["dtype"],
                                          head["shape"])
    cfg = CompressionConfig(dtype=codec["dtype"],
                            block_size=codec["block"])
    qb = bytearray(payload[:codec["q_nbytes"]])
    q = torch.frombuffer(qb, dtype=torch.int8)
    if codec["dtype"] != "int8":
        q = q.view(torch.float8_e4m3fn)
    s = torch.frombuffer(bytearray(payload[codec["q_nbytes"]:]),
                         dtype=torch.float32)
    arr = dequantize_blockwise(q.reshape(codec["nb"], codec["block"]),
                               s.reshape(codec["nb"], 1), head["shape"],
                               cfg)
    if head["dtype"] == BF16_NAME:
        return head, payload, to_host(arr.to(torch.bfloat16))
    return head, payload, arr.numpy().astype(np.dtype(head["dtype"]))


# ---------------------------------------------------------------------------
# Simulated DCN carrier
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LinkStats:
    sent: int = 0
    bytes: int = 0
    dropped: int = 0
    corrupted: int = 0
    delayed: int = 0
    partitions: int = 0


def _flip_payload_bit(data: bytes, bit: int) -> bytes:
    """Flip one bit inside the payload region (past the header line), so
    the frame still parses and the fingerprint, not the JSON parser,
    catches the corruption. Payload-less frames flip the tail byte."""
    off = data.find(b"\n", len(CHUNK_MAGIC)) + 1
    n_bits = (len(data) - off) * 8
    if n_bits <= 0:
        off, n_bits = len(data) - 1, 8
    bit %= n_bits
    buf = bytearray(data)
    buf[off + bit // 8] ^= 1 << (bit % 8)
    return bytes(buf)


class DcnLink:
    """Simulated cross-host path under the caller's clock: serializing
    bandwidth (``busy_until``), propagation latency, and a chaos-driven
    fault surface consulted per send (``op="link"``, path = the route).
    Faults are enacted here (:mod:`..resilience.chaos` only decides), so
    every transport sharing the link sees one physical story: a partition
    downs the link for everyone and loses everything in flight."""

    def __init__(self, bandwidth: float = 3.125e9,
                 latency_s: float = 25e-6, chaos: Any = None):
        self.bandwidth = float(bandwidth)
        self.latency_s = float(latency_s)
        self.chaos = chaos
        self.busy_until = 0.0
        self.down_until = 0.0
        self.stats = LinkStats()
        self._inflight: List[Tuple[float, str, bytes]] = []

    def transit_s(self, nbytes: int) -> float:
        """Unloaded wire time for ``nbytes`` (no queueing)."""
        return nbytes / self.bandwidth + self.latency_s

    def send(self, route: str, data: bytes, now: float
             ) -> Optional[float]:
        """Put ``data`` on the wire toward ``route``. Returns the delivery
        time, or ``None`` when the link ate it (drop / partition); the
        sender cannot tell which."""
        kind, _lat, detail = (None, 0.0, {})
        if self.chaos is not None:
            kind, _lat, detail = self.chaos.consult_detail("link", route)
        if kind == "link_partition":
            heal = float(detail.get("latency_s", 0.0))
            self.down_until = (now + heal) if heal > 0 else float("inf")
            self.stats.partitions += 1
            self._inflight.clear()  # in flight when the path died: gone
            return None
        if now < self.down_until:
            return None
        self.stats.sent += 1
        self.stats.bytes += len(data)
        depart = max(now, self.busy_until)
        self.busy_until = depart + len(data) / self.bandwidth
        deliver_at = self.busy_until + self.latency_s
        if kind == "link_drop":
            self.stats.dropped += 1
            return None
        if kind == "link_delay":
            self.stats.delayed += 1
            deliver_at += float(detail.get("latency_s", 0.0))
        if kind == "link_corrupt":
            self.stats.corrupted += 1
            data = _flip_payload_bit(data, int(detail.get("bit", 0)))
        self._inflight.append((deliver_at, route, data))
        return deliver_at

    def deliver(self, now: float) -> List[Tuple[str, bytes]]:
        """Pop every message whose delivery time has passed, in arrival
        order, as ``(route, data)`` pairs."""
        ready = sorted(m for m in self._inflight if m[0] <= now)
        self._inflight = [m for m in self._inflight if m[0] > now]
        return [(route, data) for _, route, data in ready]

    def next_deliver(self) -> Optional[float]:
        """Earliest pending delivery time (fake-clock fast-forward)."""
        return min((t for t, _, _ in self._inflight), default=None)


# ---------------------------------------------------------------------------
# The stream
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TransportStats:
    """Per-stream wire accounting. ``wire_payload_bytes`` /
    ``fp32_payload_bytes`` count first-copy payload bytes (the ratio
    reported; chunk headers are a fixed ~200 B); ``wire_bytes`` counts
    every byte transmitted, headers and retransmits included."""

    chunks: int = 0
    sends: int = 0
    retries: int = 0
    nacks: int = 0
    wire_bytes: int = 0
    wire_payload_bytes: int = 0
    fp32_payload_bytes: int = 0

    @property
    def wire_ratio(self) -> float:
        """First-copy payload compression vs the fp32 baseline."""
        return self.fp32_payload_bytes / max(1, self.wire_payload_bytes)


def _as_fp32(arr: np.ndarray) -> np.ndarray:
    """A host array's values in fp32 (bf16 words widened exactly)."""
    if is_bf16(arr):
        return widen_to_fp32_words(arr).view(np.float32).reshape(arr.shape)
    return np.asarray(arr).astype(np.float32)


class KVStreamTransport:
    """One session's streamed handoff: serialize ``ticket`` into chunks,
    push them through ``link`` toward ``dest`` (a ``ServingEngine``),
    survive the link's faults, land atomically.

    Driving: :meth:`start` once, then feed every delivered ``(route,
    data)`` whose route matches into :meth:`on_wire` and call :meth:`pump`
    with the advancing clock until :attr:`state` leaves ``"streaming"``.
    ``"committed"`` means the session is live on ``dest``; ``"aborted"``
    means nothing landed (reserved blocks freed) and the caller owns the
    fallback. A terminal stream drops its reference to ``dest``, so a
    finished transport never keeps an engine (and its pool) alive.

    ``on_precommit(transport)`` is called just before the commit and may
    return a replacement trace dict for the landing ticket."""

    def __init__(self, ticket: SessionTicket, dest: Any, link: DcnLink,
                 route: str, cfg: StreamConfig = StreamConfig(),
                 on_precommit: Any = None):
        if ticket.kv is None or ticket.n_blocks <= 0:
            raise ValueError(
                f"{ticket.uid}: streaming needs a KV-bearing ticket; "
                "queued-state tickets travel as one meta message")
        self.ticket = ticket
        self.dest = dest
        self.link = link
        self.route = route
        self.cfg = cfg
        self.on_precommit = on_precommit
        self.state = "streaming"
        self.reason: Optional[str] = None
        self.stats = TransportStats()
        self._handle: Optional[Dict[str, Any]] = None
        self._stash: List[Tuple[str, int, np.ndarray,
                                Optional[List[int]]]] = []
        self._n_acked = 0
        self._tx: List[Dict[str, Any]] = [
            {"wire": wire, "attempts": 0, "acked": False,
             "next_send": None, "ack_deadline": None}
            for wire in self._encode_stream()]
        self.stats.chunks = len(self._tx)

    # -- wire planning ----------------------------------------------------

    def _encode_stream(self) -> List[bytes]:
        """Chunk 0: the kv-stripped ticket. Then, layer-major so the
        receiver lands whole layers early: k/v (and pool scales for
        quantized pools) per layer, positions last."""
        t, cfg = self.ticket, self.cfg
        kv = t.kv
        meta = dataclasses.replace(t, kv=None)
        wires = [encode_chunk(t.uid, 0, "meta", "", -1, None,
                              raw_payload=meta.to_bytes())]
        quant_pool = "k_scale" in kv
        items: List[Tuple[str, int, np.ndarray,
                          Optional[CompressionConfig]]] = []
        n_layers = kv["k"].shape[0]
        if cfg.wire_dtype == "fp32":
            for l in range(n_layers):
                for name in ("k", "v"):
                    slab = _as_fp32(kv[name][l])
                    if quant_pool:
                        # the fp32 baseline of a quantized pool ships the
                        # dequantized values, not the raw int8
                        slab = slab * np.asarray(kv[f"{name}_scale"][l],
                                                 np.float32)[..., None]
                    items.append((name, l, slab, None))
        elif quant_pool:
            # raw passthrough: int8 values + pool scales, lossless against
            # the pool, so greedy decode on the far side is unchanged
            for l in range(n_layers):
                for name in ("k", "v", "k_scale", "v_scale"):
                    items.append((name, l, np.asanyarray(kv[name][l]), None))
        else:
            codec = CompressionConfig(
                dtype=("int8" if cfg.wire_dtype == "auto"
                       else cfg.wire_dtype),
                block_size=cfg.wire_block)
            for l in range(n_layers):
                for name in ("k", "v"):
                    items.append((name, l, np.asanyarray(kv[name][l]),
                                  codec))
        items.append(("pos", -1, np.asarray(kv["pos"], np.int32), None))
        # each shard streams the block slice it owns: every slab splits
        # into cp_shards disjoint block-subset chunks (block axis 0)
        shards = max(1, int(cfg.cp_shards))
        pieces: List[Tuple[str, int, np.ndarray,
                           Optional[CompressionConfig],
                           Optional[List[int]]]] = []
        for name, layer, arr, codec in items:
            if shards == 1 or arr.shape[0] < shards:
                pieces.append((name, layer, arr, codec, None))
                continue
            for sel in np.array_split(np.arange(arr.shape[0]), shards):
                pieces.append((name, layer, arr[sel], codec,
                               [int(i) for i in sel]))
        for seq0, (name, layer, arr, codec, part) in enumerate(pieces):
            wire = encode_chunk(t.uid, seq0 + 1, "data", name, layer,
                                arr, codec=codec, part=part)
            nl = wire.find(b"\n", len(CHUNK_MAGIC)) + 1
            self.stats.wire_payload_bytes += len(wire) - nl
            if name in ("k", "v", "pos"):
                # the fp32 baseline ships k/v as f32 and pos as i32; pool
                # scales do not exist there
                self.stats.fp32_payload_bytes += 4 * arr.size
            wires.append(wire)
        return wires

    # -- sender side ------------------------------------------------------

    def start(self, now: float) -> None:
        """First transmission of every chunk. The link's pacing staggers
        the deliveries, so the receiver lands layers while later ones are
        still on (or waiting for) the wire."""
        reg = get_registry()
        if reg.enabled:
            reg.counter("nxd_handoff_chunks_total",
                        "KV handoff chunks entering the wire"
                        ).inc(len(self._tx))
        for seq in range(len(self._tx)):
            self._transmit(seq, now)

    def _transmit(self, seq: int, now: float) -> None:
        st = self._tx[seq]
        st["attempts"] += 1
        self.stats.sends += 1
        reg = get_registry()
        if st["attempts"] > 1:
            self.stats.retries += 1
            if reg.enabled:
                reg.counter("nxd_handoff_retries_total",
                            "KV handoff chunk retransmissions").inc()
        wire = st["wire"]
        self.stats.wire_bytes += len(wire)
        if reg.enabled:
            reg.counter("nxd_handoff_bytes_total",
                        "KV handoff bytes transmitted (incl. "
                        "headers and retransmits)").inc(len(wire))
        deliver_at = self.link.send(self.route, wire, now)
        # the sender cannot see a drop, only a missing ACK: arm the
        # deadline off the expected delivery (or the unloaded estimate
        # when the link ate the send)
        est = (deliver_at if deliver_at is not None
               else now + self.link.transit_s(len(wire)))
        st["ack_deadline"] = est + self.cfg.ack_timeout_s
        st["next_send"] = None

    def _schedule_retry(self, seq: int, now: float, why: str) -> None:
        st = self._tx[seq]
        if st["acked"] or self.state != "streaming":
            return
        if st["attempts"] >= self.cfg.max_chunk_attempts:
            self.abort(f"chunk {seq}: retransmit budget "
                       f"({self.cfg.max_chunk_attempts}) exhausted "
                       f"after {why}")
            return
        backoff = self.cfg.backoff_base_s * 2 ** (st["attempts"] - 1)
        st["next_send"] = now + backoff
        st["ack_deadline"] = None

    # -- receiver side ----------------------------------------------------

    def on_wire(self, data: bytes, now: float) -> None:
        """One delivered frame. Corrupt payloads NACK straight into the
        sender's retry schedule; unreadable frames are dropped (the ACK
        deadline recovers them). Duplicates dedup by seq."""
        if self.state != "streaming":
            return
        try:
            head, payload, arr = decode_chunk(data)
        except ChunkIntegrityError as e:
            self.stats.nacks += 1
            if 0 <= e.seq < len(self._tx):
                self._schedule_retry(e.seq, now, "NACK (corrupt)")
            return
        except ChunkError:
            return
        seq = int(head["seq"])
        if not (0 <= seq < len(self._tx)) or self._tx[seq]["acked"]:
            return
        if head["kind"] == "meta":
            try:
                ticket = SessionTicket.from_bytes(payload)
            except TicketWireError:
                self.stats.nacks += 1
                self._schedule_retry(seq, now, "NACK (bad ticket)")
                return
            try:
                self._handle = self.dest.begin_stream_import(ticket)
            except (RequestRejected, CacheExhaustedError) as e:
                self.abort(f"destination refused the stream: {e}")
                return
            for name, layer, stashed, part in self._stash:
                self.dest.stream_inject(self._handle, name, layer,
                                        stashed, blocks=part)
            self._stash.clear()
        elif self._handle is None:
            self._stash.append((head["tensor"], head["layer"], arr,
                                head.get("part")))
        else:
            self.dest.stream_inject(self._handle, head["tensor"],
                                    head["layer"], arr,
                                    blocks=head.get("part"))
        self._tx[seq]["acked"] = True
        self._n_acked += 1
        if self._n_acked == len(self._tx):
            self._commit(now)

    # -- lifecycle --------------------------------------------------------

    def _commit(self, now: float) -> None:
        if self.on_precommit is not None:
            trace = self.on_precommit(self)
            if trace is not None:
                self._handle["ticket"].trace = trace
        try:
            self.dest.commit_stream_import(self._handle)
        except (RequestRejected, CacheExhaustedError) as e:
            self.abort(f"commit refused: {e}")
            return
        self._handle = None
        self.state = "committed"
        self.dest = None

    def abort(self, reason: str) -> None:
        """Tear the stream down: free reserved blocks (if the receiver
        ever opened), record why, go terminal. Idempotent."""
        if self.state == "aborted":
            return
        if self._handle is not None:
            self.dest.abort_stream_import(self._handle)
            self._handle = None
        self.state = "aborted"
        self.reason = reason
        self.dest = None
        self._stash.clear()
        emit_event("handoff_abort", uid=self.ticket.uid,
                   route=self.route, reason=reason)

    def pump(self, now: float) -> str:
        """Advance sender timers: fire due retransmits, turn expired ACK
        deadlines into backoff-scheduled retries (or an abort once a
        chunk's attempt budget is gone). Returns :attr:`state`."""
        if self.state != "streaming":
            return self.state
        for seq, st in enumerate(self._tx):
            if st["acked"]:
                continue
            if st["next_send"] is not None and now >= st["next_send"]:
                self._transmit(seq, now)
            elif st["ack_deadline"] is not None \
                    and now >= st["ack_deadline"]:
                self._schedule_retry(seq, now, "ACK timeout")
            if self.state != "streaming":
                break
        return self.state

    def next_timer(self) -> Optional[float]:
        """Earliest sender-side timer (retry fire or ACK deadline); the
        fake-clock runner fast-forwards to min(this, link delivery)."""
        if self.state != "streaming":
            return None
        times = [t for st in self._tx if not st["acked"]
                 for t in (st["next_send"], st["ack_deadline"])
                 if t is not None]
        return min(times, default=None)

"""Inference stack of the PyTorch port (counterpart of
``neuronx_distributed_tpu/inference``), the names ported so far:

* :mod:`.kv_cache` — the contiguous KV cache.
* :mod:`.generation` — the prefill/decode loop over it.
* :mod:`.sampling` — greedy/top-k/top-p.
* :mod:`.paging` — the paged KV block pool and host-side block allocator.
* :mod:`.engine` — the continuous-batching serving engine over the pool.
* :mod:`.speculative` — speculative decoding.
* :mod:`.router` — the multi-replica front end: placement, admission,
  failover, drain, elastic scaling by migration, the two-tier fabric.
* :mod:`.transport` — the cross-host KV handoff stream and its link.
* :mod:`.aot_cache` — the executable cache: serving workers captured in
  CUDA graphs, leased by later replicas (warm scale-up and revival).
* :mod:`.model_builder` — the multi-key, multi-bucket builder and runtime
  container (``ModelBuilder`` / ``NxDModel``) with its bundles.
* :mod:`.benchmark` — latency and throughput of the decode paths.
"""

import importlib

# Every name resolves at first use (PEP 562): the model modules import
# ``kv_cache`` and ``paging`` from this package, and the engine imports the
# models, so importing the engine here would be a cycle.
_NAMES = {
    "aot_cache": ("AotExecutableCache", "AotWorker"),
    "benchmark": (),
    "engine": ("EngineConfig", "EngineStats", "RequestRejected",
               "RequestResult", "ServingEngine", "SessionTicket",
               "TICKET_MAGIC", "TicketWireError"),
    "generation": ("DECODE_BUCKETS", "decode_step", "generate",
                   "pick_bucket", "prefill"),
    "kv_cache": ("KVCache", "init_kv_cache"),
    "model_builder": ("ModelBuilder", "NxDModel", "bundle_generate",
                      "bundle_speculative_generate", "generate_buckets",
                      "register_serving_workers", "serving_state_spec",
                      "shard_checkpoint"),
    "paging": ("BlockAllocator", "CacheExhaustedError", "PagedKVCache",
               "PrefixCache", "QuantizedPagedKVCache", "cow_copy_blocks",
               "init_paged_kv_cache", "init_quantized_paged_kv_cache"),
    "router": ("FabricConfig", "ReplicaRouter", "RouterConfig",
               "RouterResult", "RouterStats", "ScalePolicy",
               "ServingPreempted", "TenantPolicy", "elastic_chaos_drill",
               "fabric_chaos_drill"),
    "sampling": ("SamplingConfig", "sample"),
    "speculative": ("make_speculation_round_fn",),
    "transport": ("CHUNK_MAGIC", "ChunkError", "ChunkIntegrityError",
                  "DcnLink", "KVStreamTransport", "StreamConfig"),
}
_MODULE_OF = {name: mod for mod, names in _NAMES.items() for name in names}

__all__ = list(_NAMES) + list(_MODULE_OF)


def __getattr__(name: str):
    if name in _NAMES:
        return importlib.import_module(f".{name}", __name__)
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))

"""Resilience (counterpart of ``neuronx_distributed_tpu/resilience``):
preemption-safe checkpointing (:mod:`.preemption`), the training watchdog
(:mod:`.watchdog`) and per-tag save manifests behind verified resume
(:mod:`.manifest`). Fault injection (``chaos``) and silent-data-corruption
checks (``integrity``) come with a later slice."""

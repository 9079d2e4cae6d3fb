"""Resilience (counterpart of ``neuronx_distributed_tpu/resilience``):
preemption-safe checkpointing (:mod:`.preemption`), the training watchdog
(:mod:`.watchdog`), per-tag save manifests behind verified resume
(:mod:`.manifest`), deterministic fault injection (:mod:`.chaos`) and
silent-data-corruption fingerprints with their training-loop monitor
(:mod:`.integrity`)."""

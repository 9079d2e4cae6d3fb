"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one line of its own; any failure raises, so the
script exits non-zero and prints no result:

1. device: refuses to run without CUDA; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. build: compiles every kernel under ``neuronx_distributed_tpu_torch/csrc``
   from source (one ``nvcc`` per file, in parallel) and prints the seconds.
3. kernel_vs_plain: K1's wrapper at the serving step's shapes (T=512,
   N=32, KV=8, D=128, BS=16, maxb=128) against its plain PyTorch version
   on the same inputs — fp32 pools within 1e-4, bf16 and int8 within 2e-2
   — on random tables, plus D=64 and BS=32, and on three bf16 steps shaped
   like the main path's (``packed_step``): a packed prefill step (3-4
   chunks), a packed decode step (8 decode rows, 504 pad rows on the last
   slot's table) and the T=4 decode worker; also at DBRX's heads (N=48
   over KV=8, n_rep 6: four spare rows in each tensor-core tile) on
   random tables and a packed decode step; in bf16 over a bf16
   pool (the tensor-core kernel) a second launch equal to the first bit
   for bit; times the kernel, the plain version and one PyTorch library
   call, and computes the card's bound.
4. serve: ``ServingEngine`` with Llama-3-8B at full width and 16 layers
   in bf16 (random weights, seed 0, std 0.02): 8 requests of 128-1024
   prompt tokens and 64 new tokens each, two admitted mid-flight. Asserts
   every request completes, one step shape, and ``launches == layers x
   steps``.
5. serve_int8: the same with an int8 pool at 4 layers.
6. cross_check: one packed step at full width, 2 layers, fp32, on the card
   and on the port's CPU path; logits within 1e-3 x max|logit|.
7. flash_vs_plain: the flash kernels K2 (forward), K3 (dq) and K4 (dk/dv)
   against their plain versions at the train step's shapes (B=1, S=4096,
   N=32, KV=8, D=128, causal), element by element (``flash_rel_err``):
   bf16 within 2e-2 and fp32 within 1e-4 of |ref| + rms(ref's row) + 1e-3
   max|ref|, in bf16 also dropout 0.1, D=64, n_rep=1, non-causal and
   S=1000; the kernel's dropout mask equal to the plain mask bit for bit
   (bf16 and fp32); in bf16 (where K2, K3 and K4 run on the tensor cores)
   a second launch of each equal to the first bit for bit; times each
   kernel, its plain version and SDPA's forward (K2) and backward
   (K3+K4), and prints each kernel's TFLOP/s, K2 against SDPA's forward
   (``flash_fwd_k2``) and the K3+K4 factor against SDPA's backward
   (``flash_bwd_pair``) on lines of their own.
8. train: ``make_train_step`` on Llama-3-8B widths at 4 layers, fp32
   params, bf16 compute, flash attention (random weights, seed 0, std
   0.02), B=1, S=4096, AdamW lr 1e-4 clipped at 1.0, 5 steps on one batch.
   Asserts finite losses and grad norms, a falling loss, ``step == 5`` and
   each flash kernel launched layers x steps = 20 times.
9. train_cross_check: two fp32 train steps at full width, 2 layers,
   S=256, on the card and on the port's CPU path from the same weights and
   batch: each step's loss within 1e-4 relative and grad norm within 1e-3,
   and each parameter's update within 1e-3 of its norm.
10. moe_vs_plain: the grouped-GLU kernels against their plain versions at
   Mixtral 8x7B's widths (E=8, top-2, H=4096, I=14336, block 64): K5 at the
   packed step's shapes (512 tokens, P=1536) and K6 at the decode worker's
   (4 tokens, sentinel metadata), fp32 element by element within 1e-4, bf16
   against the plain version in fp32 on the same bf16 inputs, rounded once,
   within 1e-2 (``flash_rel_err``); in bf16 (where K5 and K6 run on the
   tensor cores) a second launch of each equal to the first bit for bit;
   times each kernel, its plain version and cuBLAS over the same rows
   expert by expert, computes the bound, and prints each bf16 kernel's
   TFLOP/s and its factor against cuBLAS. Then the same four cases at
   DBRX's widths (E=16, top-4, H=6144, I=10752: K5 at 512 tokens, 2048
   pairs; K6 at 4 tokens, 16 pairs).
11. serve_mixtral: ``ServingEngine`` with ``MIXTRAL_8X7B``'s widths cut to
   4 layers, bf16, blockwise dispatch with block 64 (random weights, seed
   0, std 0.02), phase 4's engine config and requests. Asserts every
   request completes, one step shape, paged_attention and grouped_glu
   launches = layers x steps, and no grouped_glu_decode launch.
12. serve_mixtral_disagg: the same, disaggregated, ``max_slots=4``,
   ``prefill_budget=512``: grouped_glu launches = layers x prefill runs,
   grouped_glu_decode launches = layers x decode runs, one step shape per
   worker.
13. mixtral_cross_check: one packed step (width 64) and one decode-worker
   step (width 4) at full width, 2 layers, fp32, blockwise, on the card and
   on the port's CPU path; logits within 1e-3 x max|logit|.
14. moe_bwd_vs_plain: the grouped GLU's backward kernels K7 (dx), K8 (dW)
   and the pair behind one shared first pass against the plain backward at
   the train step's shapes (Mixtral 8x7B widths, 4096 tokens top-2, block
   64, P=8704), fp32 (CUDA cores) within 1e-4 and bf16 (tensor cores,
   ``wgmma``) within 1e-2 element by element (``flash_rel_err``, bf16
   against the plain version in fp32 on the same inputs, rounded once); an
   expert that owns no block gets exact zeros of dW; in bf16 a second
   launch of the pair equal to the first bit for bit; times each entry,
   its plain version and cuBLAS expert by expert, and computes the bound;
   holds K5 (the forward) at the same shape in bf16 to its plain version
   in fp32 within 1e-2 element by element, and times it beside its cuBLAS
   yardstick and bound.
15. train_mixtral: ``make_train_step`` on Mixtral 8x7B widths cut to 2
   layers, fp32 params, bf16 compute, flash attention, blockwise dispatch
   with block 64, router coefficients 0.02 and 0.001, otherwise phase 8's
   settings; asserts finite losses and grad norms, a falling loss, ``step
   == 5``, K2-K5, K7 and K8 each launched layers x steps = 10 times and K6
   never.
16. mixtral_train_cross_check: phase 9 for Mixtral at full width, 1 layer,
   blockwise with block 64; both sides must first route every token to the
   same experts.
17. generate: ``generate`` (contiguous KV cache) on Llama-3-8B's widths
   at 8 layers in bf16 (random weights, seed 0, std 0.02): B=8 right-padded
   prompts of 100-500 tokens (bucket 512), 64 greedy tokens (a 576-slot
   cache). Asserts the ``[8, 64]`` shape, ids inside the vocabulary, and,
   in a second call with an ``eos_id``, every row pinned past it; prints
   prefill ms, decode step p50/p99 ms, output tokens/s and peak GiB.
18. generate_cross_check: ``prefill`` and 4 ``decode_step`` calls at full
   width, 2 layers, fp32, B=3 ragged prompts, on the card and on the CPU
   path, for a ``KVCache`` and a ``QuantizedKVCache``: logits within 1e-3
   x max|logit| at every step; for the int8 cache, codes after the prefill
   at most one step apart between card and CPU (where they part, and how
   close the CPU's value lies to a rounding boundary, is printed), and each
   decode step run on the CPU from a copy of the card's cache within 1e-4
   x max|logit| of the card.
19. generate_mixtral: ``generation.prefill`` and ``decode_step`` with
   Mixtral's cached forward over a contiguous ``KVCache``, Mixtral 8x7B
   widths cut to 4 layers, bf16, blockwise with block 64: B=4 prompts of
   100-500 tokens padded to 512, then 32 greedy decode steps; asserts K5
   launched layers times (the prefill) and K6 layers x 32 times (sentinel
   metadata), holds K5's launch at layer 0 of the prefill and K6's at
   layer 0 of the first decode step to their plain versions on the
   inputs the path gave them (within 1e-2, as ``moe_vs_plain``), prints
   prefill ms and decode step p50 ms.
20. serve_prefix: phase 4's engine at 8 layers with
   ``prefix_sharing=True`` on 8
   requests that share a 1000-token system prompt and add 16-256 tokens
   each, 64 new tokens; request 0 runs alone until its first token.
   Asserts every request completes, one step shape, K1 launched layers x
   worker runs over the shared and cloned tables, 7 x 1000 hit tokens, 7
   copy-on-write clones and an empty pool after ``release_prefix_cache``;
   holds K1's launch at layer 0 of two steps after the last clone, whose
   tables map shared and cloned blocks, to its plain version on the
   inputs the path gave it within 2e-2, and a second launch to the same
   bits;
   runs the same requests without sharing and prints both runs' TTFT,
   prefill tokens, steps and output tokens/s and the share of greedy ids
   that match (bf16 K1's split points follow the table's width, so the
   share is 1.0).
21. prefix_cross_check: the same at full width, 2 layers, fp32, block 16,
   a 40-token shared prefix, three requests, fp32 and int8 pools: greedy
   ids with sharing equal those without, and ``cow_copy_blocks`` on the
   card writes the CPU's pool bit for bit.

22. train_loop: ``Trainer.fit`` on ``LLAMA3_8B`` widths through
   ``configure_model`` with ``ActivationCheckpointConfig(mode="full")``
   (remat, ``remat_policy="save_attention"``), bf16 compute, fp32 params,
   flash attention, ``loss_chunk=512``, random weights (seed 0, std
   0.02), AdamW lr 1e-4 clipped at 1.0; B=1, S=4096 batches from the
   native ``TokenBatchLoader`` over a uint32 token file written from numpy
   seed 0 into a temporary directory under ``build/``;
   ``MetricsLogger(every=1)`` and ``Watchdog(policy="halt")``; 8 steps at
   4 layers, then 8 at 12. Asserts finite losses, the native loader, and
   K2, K3 and K4 each launched layers x steps times at each depth; prints
   step ms p50/p99, tokens/s, peak GiB and the losses.
23. train_resume: full width, 1 layer, ``tie_embeddings=True``, the
   full-logits loss, the step built with ``integrity_every=2``: run A
   trains 6 loader batches; run B trains the first 4 with
   ``CheckpointCallback(every=2, num_kept=1)`` (async) and an
   ``IntegrityMonitor(every=2)`` whose chaos plan flips a bit of the
   largest parameter after step 4's save: the monitor must catch it there
   and its ``Watchdog(policy="rewind")`` restore tag 4, whose fingerprint
   must be step 4's; B runs under a storage plan of 3 transient
   ``save_text`` faults, which the commits heal. Then a new model (seed 1)
   resumes through ``Trainer(resume_path=...)`` and trains batches 5-6.
   B's losses and final params must equal A's bit for bit; prints the
   free disk, bytes written, the seconds the loop blocks in each save (the
   snapshot to host memory) and each commit's seconds. The temporary
   directory is removed at the end.
24. train_loop_cross_check: phase 9 with remat (``save_attention``) and
   ``loss_chunk=64`` (fp32, full width, 2 layers, S=256, card against the
   CPU); then on the card at 2 layers, S=4096, ``loss_chunk=512``, in fp32
   and bf16: gradients with ``save_attention`` and ``"nothing"`` remat
   equal to those without remat bit for bit, K2 launched layers times
   (``save_attention``, no remat) or 2 x layers (``"nothing"``), K3 and K4
   layers times; then ``scan_steps``: ``make_train_step(scan_steps=2)`` at
   2 layers on two stacked batches leaves the parameters and Adam moments
   of two single steps, bit for bit.
25. train_mixtral_remat (run after phase 15): phase 15 with ``remat=True``
   (each layer recomputed whole, as the reference's ``nothing_saveable``):
   K2 and K5 launched 2 x layers x steps = 20 times, K3, K4, K7 and K8 10,
   K6 never; prints step p50 and peak beside phase 15's. Then
   mixtral_remat_bitwise: Mixtral 8x7B widths at 1 layer, S=4096, fp32 and
   bf16 compute: loss and gradients with remat equal those without bit for
   bit.
26. train_integrity (run after phase 22): ``Trainer.fit`` on phase 8's
   model with ``make_train_step(integrity_every=4)`` and
   ``IntegrityMonitor(every=4)`` over loader batches, 12 steps with obs
   enabled, then 12 disabled: no mismatch, the registry's step count and
   histogram, one step shape, nothing recorded while disabled, the last
   ``integrity_fp`` equal bit for bit to the numpy mirror of the
   parameters copied to the host; times one fingerprint pass against its
   byte bound; prints the ``train/*`` span stats and the step p50 with obs
   on and off.

27. serve_mixtral_int8 (run after phase 31): ``MIXTRAL_8X7B``'s widths at
   16 layers with ``weight_quant="int8"`` (capacity dispatch, bf16
   compute; random weights, seed 0, std 0.02, quantized layer by layer as
   they are made on the card, so the 47 GB float model never exists),
   phase 4's engine config and requests. Asserts every request completes,
   one step shape, K1 launched 16 x steps and no grouped GLU; times one
   step's expert
   dequantize, capacity einsums and K1 with CUDA events
   (``probe_step``).
28. serve_quant_tiers: ``ServingEngine`` handed Llama-3-8B's float bf16
   state dict at 4 layers on the card with ``weight_quant`` ``fp8``,
   ``mxfp8`` and
   ``mxfp4`` (the engine quantizes it there), 4 of phase 4's requests
   each; asserts completion, one step shape and K1 layers x steps; prints
   each tier's weight GiB and step p50.
29. quant_cross_check: full width, 1 layer, fp32: Llama-3-8B at ``mxfp4``
   and ``fp8``, Mixtral 8x7B at ``int8`` and ``mxfp8`` (its experts in the
   tier's format), quantized on the card and on the CPU (codes and scales
   equal bit for bit), one packed step each, logits within 1e-3 x
   max|logit|.
30. serve_dbrx, serve_dbrx_disagg: ``DBRX``'s widths cut to 8 layers in
   bf16, blockwise with block 64, as phases 11 and 12 (K5 for 2048 pairs a
   packed step; the 4-wide decode worker puts 16 pairs on K6's sentinel
   metadata).
31. moe_variants_cross_check: Mixtral 8x7B's widths, 1 layer, fp32,
   capacity dispatch, the Sinkhorn and the group-limited router, each with
   shared experts of intermediate 14336: one packed step on the card and
   on the CPU, logits within 1e-3 x max|logit|.
32. serve_spec (run after phase 21): phase 4's model at 4 layers on 8
   requests of 200-1000 prompt tokens, 64 new, served plain, with
   ``SpeculationConfig(4, num_branches=2)`` and a draft of Llama-3.2-1B's
   widths (``llama32_1b_widths``, seed 1), and with a self-draft. Asserts
   completion, one shape per worker and K1 launched once per layer per
   forward of each worker; holds K1's first launch in the draft worker
   (head_dim 64) and in the verify worker to its plain version within
   2e-2 on the path's inputs, equal bits on a relaunch, and times them
   beside the bound and SDPA; prints step p50/p99, each worker's device
   ms, accepted tokens a round, output tokens/s and the bf16 greedy match
   share against the plain run (recorded, not limited).
33. spec_cross_check: full width, 2 layers, fp32: greedy ids with a
   self-draft and with a 1-layer draft, on the card and on the CPU, equal
   the card's ids without speculation, or part only at a near tie (top-2
   gap under 1e-4 x max|logit|, printed); the CPU runs and the weights,
   made on the host, come from the CPU side's thread.
34. serve_mixtral_spec: phase 11's model with a self-draft and two
   speculating slots: K6 in the draft worker, K5 in the verify worker (and
   twice a packed run), each held to its plain version within 1e-2 with
   equal bits on a relaunch; launch counts asserted.
35. migrate: two engines sharing one Llama-3-8B at 8 layers in bf16;
   sessions exported mid-decode with integrity on, through ``to_bytes`` /
   ``from_bytes``, into the other engine (``import_session`` and the
   stream import) finish with the unmigrated ids bit for bit; a flipped
   byte on the wire and a flipped bit in a parsed ticket are refused with
   the destination unchanged; an int8 pool's tickets round-trip; prefix
   shipping gives the promised hits; an evicted request resubmitted
   elsewhere gives the same ids; prints ticket bytes a token and the ms of
   each step of a move.
36. router (run after phase 51, as 37-39): ``ReplicaRouter`` over 2
   replicas of phase 4's engine at 8 layers sharing
   one copy of the weights, 16 requests from two tenants (one on a finite
   token bucket), ``r1`` crashed after 6 steps: availability 1.0, one
   failover, resubmissions, one step shape per engine, K1 layers x worker
   runs over every engine, one ``data_ptr`` for every replica's weights,
   the crashed engine freed and the card's memory back to its baseline
   after ``del`` (no garbage collection); prints fleet and single-replica
   output tokens/s, TTFT p50/p99, resubmitted tokens and the bf16 greedy
   match share (recorded, not limited).
37. fabric: the two-tier prefill/decode fabric (Llama-3-8B's widths at 4
   layers) streaming every session over the KV transport: a bf16 pool through
   the int8 wire codec, with and without ``link_corrupt``, an int8 pool
   shipped raw (ids equal to one engine's bit for bit) and a
   ``link_partition`` that tears every stream (re-prefill); no leaked block,
   one decode step shape; prints wire bytes a token, the ratio against fp32,
   chunks, retries and the host ms a session of export, encode, transit and
   land.
38. router_elastic: ``elastic_chaos_drill`` at full width, 16 layers, on
   the real
   clock (preemption with migration, ``scale_burst``, scale-down by
   migration, revival, the SLO breach): availability 1.0, ids equal to
   the reference, migrated tokens, one step shape. Every engine of the
   drill serves through its executable cache (captured workers): K1 is
   launched twice a layer by each capture (warm-up and capture) and runs
   once a layer each replay, one replay a worker run;
   ``router_elastic_aot`` prints the drill's spin-up times cold and warm
   and the cache's hits and misses.
39. router_cross_check: full width, 2 layers, fp32: ``chaos_drill``,
   ``sdc_serving_drill`` and ``fabric_chaos_drill`` on the card and on the
   CPU give the same ids and dicts; the wire codec's codes and scales from
   card tensors equal the CPU's bit for bit.

40. serve_graph (run after phase 5): phase 4's model, engine config and
   requests served eagerly and through ``ServingEngine(aot_cache=
   AotExecutableCache())``, whose packed worker is a CUDA graph: greedy
   ids equal bit for bit (also to phase 4's), one step shape, every step
   of the captured run under ``torch.cuda.set_sync_debug_mode("error")``,
   K1's output of every layer at a captured step equal to the eager
   forward's on the same inputs and pool bit for bit; K1 launched only by
   the capture (twice a layer), replays one a step. Prints each run's step
   p50, and over five steady decode steps the wall ms a step, the
   profiler's device busy ms a step and the idle share.
41. aot_warm: phase 40's captured engine freed and a second built against
   its cache: ``aot_warm()``, the same ids, construction ms cold (capture)
   against warm (lease).
42. serve_graph_mixtral (run after phase 12): phases 11 and 12 through the
   cache, packed and disaggregated: ids equal to those phases', K5 (packed
   step, prefill worker) and K6 (decode worker) launched only by the
   captures and replayed each run.
43. bundle: ``register_serving_workers`` on Llama-3-8B's widths at 4
   layers (phase 12's disaggregated geometry) and a contiguous
   ``context_encoding``/``token_generation`` bundle over the same weights,
   both captured here, saved, and loaded in a fresh ``python3`` process on
   the card: each key's logits there equal this process's bit for bit, and
   ``bundle_generate`` gives the ids of ``generate`` in both.
44. benchmark: ``python -m neuronx_distributed_tpu_torch.inference.
   benchmark`` on the card, in a process that runs beside phase 35 and
   phase 43; its JSON line is printed on a line of its own.

45. flash_families: ``flash_attention`` (K2-K4; a head width other than 64
   or 128 zero-padded around them) at GPT-NeoX-20B's attention (B=1,
   S=2048, N=64, D=96, causal; bf16 and fp32), BERT-large's (B=8, S=512,
   N=16, D=64, bidirectional; bf16, and with dropout 0.1), ViT-Huge/14's
   (B=32, S=257, N=16, D=80) and ViT-Base's (B=32, S=197, N=12, D=64)
   against the plain versions at the unpadded width, element by element
   (bf16 2e-2, fp32 1e-4), each kernel launched once, in bf16 a second run
   equal bit for bit; each kernel's ms, its plain version's, SDPA's and the
   bound of the useful work; NeoX's forward entry at D=96 against K2 at
   D=128 (the padding's cost).
46. train_families: ``make_train_step`` (fp32 params, bf16 compute, flash,
   AdamW clipped at 1.0, 5 steps on one batch) on GPT-NeoX-20B's widths at
   4 layers (B=1, S=2048), BERT-large at 24 layers with the tied MLM head
   (B=8, S=512, 15% labelled) and ViT-Huge/14 at 32 layers (B=32 images):
   finite losses, K2-K4 launched layers x steps; step p50 and peak GiB.
47. vit_serve: ViT-Huge/14 at 32 layers in bf16 through ``ModelBuilder``
   with buckets 1, 8, 32: a batch of 5 routes to bucket 8, captured logits
   equal the eager forward's bit for bit, K2 launched only by the captures;
   p50 ms per bucket and images/s.
48. families_cross_check: fp32, full width, 1 layer, card against CPU:
   GPT-NeoX-20B and BERT-large at S=128, ViT-Huge at B=2: logits within
   1e-4 x max|logit|, the loss within 1e-5, every gradient within 1e-3 of
   its norm.

49. lora_train: LoRA fine-tuning of ``LLAMA3_8B`` at all 32 layers: an
   HF-layout bf16 checkpoint made on the card from seed 0, converted by
   ``scripts.checkpoint_converter`` (the round trip back to HF bit for
   bit), held in fp32; ``LoraConfig(r=16, alpha=32)`` on qkv, o_proj,
   gate_up and down, fresh adapters (seed 1); ``make_lora_optimizer`` over
   AdamW (lr 1e-4, clipped at 1.0), bf16 compute, flash attention, remat
   (``save_attention``), ``loss_chunk=512``; B=1, S=4096 from
   ``pack_tokens`` -> a ``.bin`` -> the native loader; 5 steps on that
   batch inside a ``Timeline`` saved under ``build/``. Asserts finite,
   falling losses, every frozen tensor's fingerprint unchanged, every B
   moved off zero, K2-K4 each launched 32 x 5 times and the timeline's
   step events; prints step p50, tokens/s, peak GiB, trainable and frozen
   parameter counts.
50. lora_serve: the adapters through ``torch.save`` /
   ``torch.load(weights_only=True)`` and ``merge_lora_state`` into a
   freshly converted base (bit for bit); the unmerged LoRA model's
   prefill logits and ``generate``; ``merge_lora_params`` into the base
   config, served by a ``ServingEngine`` with an ``AotExecutableCache``
   (4 requests, 32 new; K1 launched twice a layer at the capture, then
   replayed); merged prefill logits within 1e-4 of max|logit| of the
   unmerged ones in fp32, and in bf16 within the bf16 floor (the base
   model bf16 against fp32 on the same prompt) plus 2e-2.
51. lora_cross_check: ``LLAMA3_8B``'s widths at 2 layers, fp32, LoRA on
   all six targets, S=256: one backward and two steps on the card and on
   the CPU from the same state: losses 1e-4, grad norms 1e-3, each adapter
   gradient and update within 1e-3 of its norm, the base unchanged; the
   largest per-module gaps through ``tensor_capture``; a conv LoRA pair
   (bf16 compute) card against CPU within 2e-2 of max|y|.
52. train_tp: four ranks on the one card, each a process of its own
   (``utils.cpu_mesh.run_ranks``) joined over gloo with CUDA tensors
   (NCCL refuses two ranks on one device): ``neuronx_distributed_config(
   tensor_parallel_size=2, sequence_parallel=True, ZeRO-1)`` ->
   ``initialize_parallel_model`` -> ``initialize_parallel_optimizer`` ->
   ``make_train_step`` on Llama-3-8B's widths at 2 layers (each rank
   makes the whole weights from seed 0 on the card and keeps its shards),
   bf16 compute over fp32 parameters, flash attention on each rank's 16
   query heads over 4 kv heads, global batch 2 at S=4096 (one row a data
   rank), 2 steps. Asserts on every rank finite losses and grad norms
   equal to rank 0's, a falling loss, K2, K3 and K4 each launched layers x
   steps times, the first launch of each held to its plain version on the
   path's inputs within 2e-2 (``flash_rel_err``), nothing staged through
   the host by ``parallel/comm.py``, and equal parameters on the data
   ranks of one tp rank; prints per rank the step times, peak GiB (while
   loading and while stepping) and the bytes of gloo's collectives, and
   K2-K4 timed at the local shape by rank 0 while the others wait.
   Phases 52 and 53 share one start of the four processes.
53. train_tp_cross_check: the same path at full width, 2 layers, S=256,
   fp32, global batch 2, 2 steps, against the port's tp=1 step on the card
   (run on rank 0 before the ranks build their shards) from the same
   weights (both made on the card from seed 1): losses within 1e-4
   relative, grad norms within 1e-3, each parameter's update (the tp
   shards gathered on rank 0) within 1e-3 of its norm; the kernels' first
   launches within 1e-4 of plain.
54. train_tp_loop, and 55. train_tp_loop_cross_check, around one sharded
   tag (Llama-3-8B's widths at 1 layer with the tied head: the card's
   machine caps what a run writes to its disk at 45 GiB, and a tag holds
   12 bytes a parameter). 55's part A: ``Trainer.fit``, 4 fp32 steps at
   S=256 (global batch 2) at tp=2 x dp=2 with sequence parallelism and
   ZeRO-1, an async sharded save at step 2 (block and commit seconds,
   bytes); B: the same model resumed from the tag trains steps 3-4 bit
   for bit A's (losses and every leaf's whole-tensor fingerprint). 54: a
   bf16-compute model over fp32 parameters, attention dropout 0.1 and
   ``integrity_every=2`` resumes from the tag and trains steps 3-4 at
   S=4096; K2-K4 launched layers x 2 times with dropout at each rank's
   offsets and held to plain within 2e-2; a bit flipped in data rank 1's
   shard at the step-4 boundary is seen on every rank, whose watchdog
   rewinds to the tag, the fingerprint the tag's; rank 0 times K2-K4
   with dropout at its offsets (after part D, alone on the card). 55's
   part C: tp=4 x dp=1 without ZeRO-1 resumes from the tag, losses within
   1e-5 of A's, each update within 1e-3 of its norm; D (in this process,
   beside 54 and C): ``scripts/reshard_checkpoint.py`` merges the tag on
   the card and the port's tp=1 step resumed from it gives step 3's loss
   within 1e-4.
56. train_mixtral_tp: Mixtral 8x7B's widths at 2 layers, tp=4 x dp=1 with
   sequence parallelism, blockwise dispatch (block 64), bf16 over fp32,
   S=4096, 2 steps: the experts at I/tp = 3584; K2-K5, K7 and K8 each
   launched layers x steps times on every rank, the first launch of each
   held to its plain version on the path's inputs (1e-2 for K5, K7, K8
   in bf16, 2e-2 for K2-K4); rank 0 times K5, K7 and K8 at the local width
   (kernel, plain, bound, cuBLAS per expert).
57. train_mixtral_tp_cross_check: that step in fp32 at 1 layer, S=256,
   against the port's tp=1 Mixtral step on the card (run on rank 0 first)
   under phase 53's limits.
58. train_pp: the same four ranks laid out as pp=2 x tp=2 with sequence
   parallelism: ``neuronx_distributed_config(pipeline_parallel_size=2,
   pipeline_config=PipelineConfig(num_microbatches=4))``, each rank
   building its stage of Llama-3-8B's widths at 4 untied layers (2 a
   stage, the embedding on stage 0, the norm and head on stage 1), then
   ``make_train_step(grad_fn=llama_pipeline.make_pipeline_grad_fn(...,
   schedule="1f1b"))``, bf16 over fp32, 4 microbatches of one row at
   S=4096, 3 steps. Asserts finite losses equal on every rank and
   falling; K2-K4 launched (layers / pp) x M x steps times a rank and
   held to plain within 2e-2; the bytes the stage rings staged through
   the host equal to four activations a tick; at most S - s graphs live.
59. train_pp_cross_check: fp32, the same widths at 4 layers, S=256, global
   batch 4, 2 steps at pp=2 x tp=2 under 1F1B, interleaved (C=2) and
   GPipe, against the same ranks at tp=2 x dp=2 from the same weights and
   batch: losses within 1e-5, grad norms within 1e-4, each parameter's
   update within 1e-3 of its norm.
60. train_mixtral_pp: Mixtral 8x7B's widths at 2 layers (1 a stage),
   pp=2 x tp=2, blockwise (block 64), 1F1B with M=2 and the router's aux,
   3 steps: K2-K5, K7 and K8 launched and held on every rank; rank 0 times
   K5, K7 and K8 at I/tp = 7168.
61. train_pp_resume: phase 54's tag (tp=2 x dp=2) loaded at pp=2 x tp=2,
   stage 1 holding only the norm and the tied table: every tensor equal
   to the tag's pieces bit for bit, the parameters' fingerprint the tag's;
   steps 3-4 within 1e-5 of the tp=2 x dp=2 resume's losses. Writes no
   tag.
62. train_mixtral_ep: Mixtral 8x7B's widths at 2 layers, tp=2 x dp=2
   with ep=2 (``neuronx_distributed_config(tensor_parallel_size=2,
   expert_parallel_size=2)``: each rank holds 4 of the 8 experts at I/tp
   = 7168, ``[4, 4096, 2, 7168]``), sequence parallelism, ZeRO-1,
   blockwise dispatch (block 64), bf16 over fp32, one sequence of S=4096
   a data rank, 2 steps, the fp32 wire and auto overlap (off at ep=2).
   Each rank gathers both data ranks' tokens over ep, routes the other
   rank's experts' pairs to the sentinel expert and reduce-scatters its
   partials back, so K5, K7 and K8 see sentinel blocks in training: K2-K5,
   K7 and K8 launched layers x steps times on every rank, the first launch
   of each held to plain (2e-2, 1e-2), K5's and K7's sentinel rows exactly
   zero and K8's dW of the expert whose run the sentinels follow held on
   its own; rank 0 times K5, K7 and K8 at this local shape (kernel, plain,
   bound, cuBLAS per expert); per-rank peak memory, step ms, gloo bytes
   and host-staged bytes.
63. train_mixtral_ep_cross_check: fp32, 1 layer at Mixtral's widths,
   S=256, 2 steps: the ep=2 step against the ep=1 step at the same tp=2 x
   dp=2 layout (no ZeRO-1: at ep=1 its transients at a whole bank leave
   four ranks no room) from the same weights (seed 1) and batch: first loss
   within 1e-6 relative, later 1e-4, grad norms 1e-3, each update within
   1e-3 of its norm; on layer 0's inputs as the path gave them, the bank's
   fp32 ring (``moe_overlap_dispatch=True``, its hops staged through the
   host) equal to the monolithic path bit for bit forward and in dx and
   dgates (dW within 1e-5), int8 ring equal to int8 monolithic bit for bit
   in every output and gradient.
   Phases 52-63 share one start of the four processes, started beside
   phases 49-51 (the ranks wait for their turn, and phase 36 waits until
   every rank has started); phase 55's part D
   (the merge and the tp=1 step) runs in this process beside them. The
   CPU halves of phases 9, 16, 24, 29, 31, 33, 39 and 51 (the train steps,
   the quantized codes, the other routers, speculation, the replica
   router's drills, LoRA) are computed on a background thread
   (``CpuSide``) while earlier phases run; phase 36 waits until the
   thread is idle: 39's tap swaps the router module's classes, and the
   router phases run on the host's clock.

Each phase line carries ``elapsed_s``, the seconds since the start.

The last two lines are the kernels' JSON summary (``path_launches`` gives
each path's launches of K1-K8) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import weakref

if __name__ == "__main__":
    # the card phases' host thread shares the host's cores with the CPU
    # side's OpenMP team (CpuSide): threads that sleep as soon as a
    # parallel region ends, instead of spinning, leave those cores to it
    os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}  # dense, per the q dtype
KERNEL_SOURCE = "neuronx_distributed_tpu_torch/csrc/paged_attention.cu"
KERNEL_REPLACES = "neuronx_distributed_tpu/ops/paged_attention.py:95"
FLASH_SOURCE = "neuronx_distributed_tpu_torch/csrc/flash_attention.cu"
FLASH_KERNELS = (   # dispatcher (and its launch count), TPU kernel replaced
    ("flash_fwd", "neuronx_distributed_tpu/ops/flash_attention.py:229"),
    ("flash_bwd_dq", "neuronx_distributed_tpu/ops/flash_attention.py:426"),
    ("flash_bwd_dkv", "neuronx_distributed_tpu/ops/flash_attention.py:474"),
)
# each kernel's design (csrc/paged_attention.cu, csrc/flash_attention.cu)
K1_DESIGN = {
    "tensor_cores": "bf16 q over a bf16 pool: wgmma (tensor cores), one kv "
                    "head and 64 // n_rep tokens a CTA, each run of equal "
                    "table rows streamed once through a cp.async ring, the "
                    "table split across CTAs where the card would idle",
    "cuda_cores": "fp32 FMAs (CUDA cores), one CTA per (token, kv head)"}
FLASH_DESIGN = {torch.bfloat16: "wgmma (tensor cores)",
                torch.float32: "fp32 FMAs (CUDA cores)"}
MOE_SOURCE = "neuronx_distributed_tpu_torch/csrc/blockwise_moe.cu"
MOE_KERNELS = (
    ("grouped_glu", "neuronx_distributed_tpu/ops/blockwise_moe.py:64"),
    ("grouped_glu_decode", "neuronx_distributed_tpu/ops/blockwise_moe.py:208"),
)
MOE_BWD_KERNELS = (
    ("grouped_glu_dx", "neuronx_distributed_tpu/ops/blockwise_moe.py:91"),
    ("grouped_glu_dw", "neuronx_distributed_tpu/ops/blockwise_moe.py:123"),
)
# the bf16 forward's design per entry (csrc/blockwise_moe.cu; fp32 runs
# on the CUDA cores)
MOE_FWD_DESIGN = {
    "grouped_glu": "wgmma (tensor cores), 64-row tiles in pairs",
    "grouped_glu_decode": "wgmma (tensor cores), one 64-row tile a CTA, "
                          "its columns split between the warpgroups"}
# the backward's design per input type (csrc/blockwise_moe.cu)
MOE_BWD_DESIGN = {torch.bfloat16: "wgmma (tensor cores)",
                  torch.float32: "fp32 FMAs (CUDA cores)"}
# per grouped-GLU entry: (FLOP per live row in units of H I, [P, H] tensors
# read or written, whether it writes the E experts' dW)
MOE_WORK = {"grouped_glu": (6, 2, False), "grouped_glu_decode": (6, 2, False),
            "grouped_glu_dx": (10, 3, False),
            "grouped_glu_dw": (12, 2, True),
            "grouped_glu_bwd": (16, 3, True)}


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - T_START}),
          flush=True)


def time_ms(fn, reps: int = 25, flush: torch.Tensor = None,
            warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, CUDA events around
    each, after ``warmup`` runs; ``flush`` is overwritten before each run
    so the 50 MB L2 holds no pool data, as for a layer of the real step."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------

def packed_step(seed, kind, t, bs, maxb, nb, max_pos):
    """Pool positions ``[nb, bs]``, block tables ``[t, maxb]`` and query
    positions ``[t]`` (int32 numpy) of one packed step, each sequence on
    its own random pool blocks, filled to its length:

    * ``random``: every token carries one of 8 sequences' table rows at
      random (so no two neighbours need share one), 5% of the entries -1
      (never the first), at a random position the sequence holds;
    * ``prefill``: chunks of 3-4 sequences' prompts fill the rows in turn,
      each chunk's rows carrying its sequence's table at rising positions
      up to the chunk's end, which the pool holds (a step writes its K/V
      before it attends);
    * ``decode``: 8 decode rows, one per sequence of 128-1088 tokens, then
      pad rows carrying the last sequence's table at position ``max_pos``,
      as the engine's pad rows do;
    * ``worker``: ``t`` decode rows, one per sequence (the disaggregated
      decode worker)."""
    from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION

    rng = np.random.RandomState(seed)
    cap = maxb * bs
    lens = rng.randint(bs, cap // 2, 8) if kind == "random" else None
    perm = rng.permutation(nb)
    pool_pos = np.full((nb, bs), PAD_POSITION, np.int32)
    used = 0

    def sequence(length):
        """A table row over fresh blocks holding positions [0, length)."""
        nonlocal used
        nblk = -(-length // bs)
        if used + nblk > nb or nblk > maxb:
            raise ValueError(f"packed_step: {length} tokens do not fit")
        blocks = perm[used:used + nblk]
        used += nblk
        row = np.full(maxb, -1, np.int32)
        row[:nblk] = blocks
        p = np.arange(nblk * bs).reshape(nblk, bs)
        pool_pos[blocks] = np.where(p < length, p, PAD_POSITION)
        return row

    if kind == "random":
        rows = np.stack([sequence(n) for n in lens])
        seq_of = rng.randint(0, 8, t)
        tables = rows[seq_of]
        holes = rng.rand(t, maxb) < 0.05
        holes[:, 0] = False
        tables[holes] = -1
        q_pos = rng.randint(0, lens[seq_of])
    elif kind == "prefill":
        n_seq = rng.randint(3, 5)
        cuts = np.sort(rng.choice(np.arange(1, t), n_seq - 1, replace=False))
        tables, q_pos = [], []
        for c in np.diff(np.concatenate([[0], cuts, [t]])):
            start = rng.randint(0, max(1, min(cap // 2, cap - c + 1)))
            tables += [sequence(start + c)] * c
            q_pos += list(range(start, start + c))
    elif kind in ("decode", "worker"):
        n_seq = 8 if kind == "decode" else t
        top = min(cap, 1088)
        lens = rng.randint(min(128, top), top + 1, n_seq)
        rows = [sequence(n) for n in lens]
        tables = rows + [rows[-1]] * (t - n_seq)
        q_pos = list(lens - 1) + [max_pos] * (t - n_seq)
    else:
        raise ValueError(f"packed_step: no kind {kind!r}")
    return (pool_pos, np.asarray(tables, np.int32).reshape(t, maxb),
            np.asarray(q_pos, np.int32))


def paged_case(seed, t=512, n=32, kv=8, d=128, bs=16, maxb=128, nb=2048,
               dtype=torch.bfloat16, quantized=False, kind="random",
               max_pos=4095):
    """A packed step's attention inputs on the card: random q, pools of
    ``nb`` blocks (int8 with scales when ``quantized``), and the tables and
    positions of :func:`packed_step`'s ``kind`` (pad rows at ``max_pos``,
    Llama-3-8B's ``max_seq_len - 1``, as the engine puts them)."""
    from neuronx_distributed_tpu_torch.inference.kv_cache import quantize_kv

    pool_pos, tables, q_pos = packed_step(seed, kind, t, bs, maxb, nb,
                                          max_pos)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q = randn(t, n, d).to(dtype)
    k, v = randn(nb, bs, kv, d), randn(nb, bs, kv, d)
    ks = vs = None
    if quantized:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    else:
        k, v = k.to(dtype), v.to(dtype)

    def dev_i32(a):
        return torch.from_numpy(a).to(dev)

    return (q, k, v, dev_i32(pool_pos), dev_i32(tables), dev_i32(q_pos), ks,
            vs)


def paged_bound(args):
    """Least time for the call: the larger of the bytes it must move (q
    and out once, each distinct referenced pool block's K/V, scales and
    positions once, the tables) over HBM bandwidth, and its multiply-adds
    (QK^T and PV over every valid table entry of every token) over the
    peak rate for q's dtype."""
    q, k, v, pool_pos, tables, q_pos, ks, vs = args
    t, n, d = q.shape
    nb, bs, kv, _ = k.shape
    valid = tables[tables >= 0]
    distinct = torch.unique(valid).numel()
    per_block = 2 * bs * kv * d * k.element_size() + bs * 4
    if ks is not None:
        per_block += 2 * bs * kv * 4
    nbytes = (2 * q.numel() * q.element_size() + distinct * per_block
              + tables.numel() * 4 + q_pos.numel() * 4)
    flops = 4.0 * valid.numel() * bs * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def sdpa_on_gathered(args):
    """One PyTorch library call computing the same function, given K/V
    already gathered to dense per-token rows (the gather is excluded from
    its time): ``scaled_dot_product_attention`` with a boolean mask."""
    from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION

    q, k, v, pool_pos, tables, q_pos, _, _ = args
    t, n, d = q.shape
    nb, bs, kv, _ = k.shape
    safe = tables.long().clamp(0, nb - 1)
    length = tables.shape[1] * bs
    kg = k[safe].reshape(t, length, kv, d).transpose(1, 2).contiguous()
    vg = v[safe].reshape(t, length, kv, d).transpose(1, 2).contiguous()
    pg = pool_pos[safe].masked_fill(tables[:, :, None] < 0, PAD_POSITION)
    mask = (q_pos[:, None] >= pg.reshape(t, length))[:, None, None, :]
    qq = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qq, kg, vg, attn_mask=mask,
                                                  enable_gqa=True)


def phase_kernel_vs_plain():
    from neuronx_distributed_tpu_torch.ops import paged_attention as pa

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    # (case, paged_case arguments, limit); the last three are shaped like
    # the main path's steps (chip_smoke.packed_step)
    cases = [
        ("fp32", dict(dtype=torch.float32), 1e-4),
        ("bf16", dict(dtype=torch.bfloat16), 2e-2),
        ("int8_q_fp32", dict(dtype=torch.float32, quantized=True), 2e-2),
        ("int8_q_bf16", dict(dtype=torch.bfloat16, quantized=True), 2e-2),
        ("bf16_d64", dict(dtype=torch.bfloat16, d=64), 2e-2),
        ("bf16_bs32", dict(dtype=torch.bfloat16, bs=32, maxb=64, nb=1024),
         2e-2),
        ("packed_prefill", dict(kind="prefill"), 2e-2),
        ("packed_decode", dict(kind="decode"), 2e-2),
        ("decode_worker", dict(kind="worker", t=4), 2e-2),
        # DBRX's heads (N=48 over KV=8: n_rep=6, so a tensor-core tile
        # packs 10 tokens and masks 4 of its 64 rows)
        ("dbrx_bf16", dict(n=48), 2e-2),
        ("dbrx_packed_decode", dict(n=48, kind="decode", max_pos=32767),
         2e-2),
    ]
    timed = ("bf16", "fp32", "int8_q_bf16", "packed_prefill",
             "packed_decode", "decode_worker", "dbrx_bf16",
             "dbrx_packed_decode")
    results = []
    for i, (name, kw, tol) in enumerate(cases):
        args = paged_case(100 + i, **kw)
        got = pa.paged_attention_cuda(*args)
        torch.cuda.synchronize()
        ref = pa.paged_attention_plain(*args)
        err = (got.float() - ref.float()).abs().max().item()
        if not (err <= tol) or not torch.isfinite(got).all():
            raise AssertionError(f"paged_attention {name}: max abs error "
                                 f"{err} above {tol}")
        res = dict(case=name, max_err=err, tol=tol, tokens=args[0].shape[0])
        if args[0].dtype == args[1].dtype == torch.bfloat16:
            # the tensor-core kernel: each run's sums in one CTA, splits
            # merged in a fixed order, so a second launch gives the same bits
            again = pa.paged_attention_cuda(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"paged_attention {name}: two launches "
                                     "on the same inputs differ")
            res.update(deterministic=True, design=K1_DESIGN["tensor_cores"],
                       splits=pa.tc_splits(
                           args[0].shape[0], args[0].shape[1],
                           args[1].shape[2], torch.cuda.get_device_properties(
                               0).multi_processor_count))
            del again
        else:
            res["design"] = K1_DESIGN["cuda_cores"]
        if name in timed:
            bound, by, nbytes, flops = paged_bound(args)
            res.update(
                kernel_ms=time_ms(lambda: pa.paged_attention_cuda(*args),
                                  flush=flush),
                plain_ms=time_ms(lambda: pa.paged_attention_plain(*args),
                                 reps=20, flush=flush),
                bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
            if args[0].dtype == args[1].dtype == torch.bfloat16:
                lib = sdpa_on_gathered(args)
                res["library_ms"] = time_ms(lib, flush=flush)
                res["library"] = ("F.scaled_dot_product_attention on K/V "
                                  "pre-gathered to dense, masked; gather "
                                  "excluded")
                del lib
        results.append(res)
        del args, got, ref
        torch.cuda.empty_cache()
    emit("kernel_vs_plain", cases=results)
    return results


# ---------------------------------------------------------------------------
# phases 4-6: the serving engine
# ---------------------------------------------------------------------------

#: each serve() run's greedy ids and stats report, by phase label
SERVE_RUNS = {}


def serve(cfg, ecfg, label, probe=None):
    """Serve 8 requests through ``ServingEngine`` and check the launch
    counts: K1 once per layer per worker run; for a blockwise Mixtral K5
    once per layer per packed or prefill run and K6 once per layer per
    decode run (a capacity-dispatch Mixtral launches neither). A weight
    quantized ``cfg`` gets its weights quantized layer by layer as they are
    made (``init_state_dict``). ``probe(eng)``, when given, runs one step
    of its own right after the mid-flight admissions and returns fields
    for the phase's line."""
    from neuronx_distributed_tpu_torch.inference.engine import ServingEngine
    from neuronx_distributed_tpu_torch.models import llama, mixtral
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as bm
    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention)

    moe = isinstance(cfg, mixtral.MixtralConfig)
    glu = moe and cfg.moe_dispatch == "blockwise"
    torch.cuda.reset_peak_memory_stats()
    # serving holds its weights in the compute dtype: make them there
    sd = (mixtral if moe else llama).init_state_dict(
        dataclasses.replace(cfg, param_dtype=cfg.dtype), seed=0, std=0.02)
    eng = ServingEngine(cfg, sd, ecfg)
    del sd
    rng = np.random.RandomState(0)
    lens = rng.randint(128, 1025, 8)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]
    new = 64
    torch.cuda.synchronize()
    paged_attention.launches = 0
    bm.grouped_glu.launches = bm.grouped_glu_decode.launches = 0
    t0 = time.perf_counter()
    for i in range(6):
        eng.submit(prompts[i], new, uid=f"r{i}")
    while eng.stats.tokens_generated == 0:
        eng.step()
    for i in (6, 7):                  # admitted mid-flight
        eng.submit(prompts[i], new, uid=f"r{i}")
    probed = probe(eng) if probe is not None else {}
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": paged_attention.launches,
                "grouped_glu": bm.grouped_glu.launches,
                "grouped_glu_decode": bm.grouped_glu_decode.launches}
    steps = eng.stats.steps
    runs = dict(eng.worker_runs)
    bad = [u for u, r in res.items()
           if r.status != "completed" or len(r.tokens) != new]
    if len(res) != 8 or bad:
        raise AssertionError(f"{label}: requests not completed: {bad}")
    if set(eng.worker_compile_counts().values()) != {1}:
        raise AssertionError(f"{label}: step shapes per worker "
                             f"{eng.worker_compile_counts()}")
    nl = cfg.num_layers
    wide = runs.get("packed", 0) + runs.get("prefill", 0)
    want = {"paged_attention": nl * sum(runs.values()),
            "grouped_glu": nl * wide if glu else 0,
            "grouped_glu_decode": nl * runs.get("decode", 0) if glu else 0}
    if launches != want or launches["paged_attention"] == 0 or (
            glu and launches["grouped_glu"] == 0):
        raise AssertionError(f"{label}: launches {launches}, want {want} "
                             f"(layers x worker runs {runs})")
    rep = eng.stats.report()
    SERVE_RUNS[label] = ({u: r.tokens for u, r in res.items()}, rep)
    emit(label, layers=cfg.num_layers, dtype=str(cfg.dtype),
         weight_quant=cfg.weight_quant, weight_gib=state_gib(eng.model),
         quantized_pool=ecfg.quantized,
         disaggregated=ecfg.disaggregated, requests=len(res),
         prompt_tokens=int(lens.sum()), new_tokens=8 * new, steps=steps,
         worker_runs=runs, launches=launches,
         output_tok_per_s=8 * new / wall, wall_s=wall,
         engine_tok_per_s=rep["tokens_per_s"],
         ttft_p50_ms=rep["ttft_p50_ms"], ttft_p99_ms=rep["ttft_p99_ms"],
         step_latency_p50_ms=rep["step_latency_p50_ms"],
         step_latency_p99_ms=rep["step_latency_p99_ms"],
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         **probed)
    del eng
    torch.cuda.empty_cache()
    return launches


def state_gib(model):
    """GiB of a model's weights as it holds them."""
    return sum(t.numel() * t.element_size()
               for t in model.state_dict().values()) / 2 ** 30


class SpanTimer:
    """CUDA events around every call of the functions it wraps, by label:
    the device time between each call's first and last launch (the card
    runs behind the host here, so no host gap falls inside). ``now`` is the
    label of the call running now (None between calls)."""

    def __init__(self):
        self.spans, self.undo, self.now = {}, [], None

    def wrap(self, owner, attr, label):
        fn = getattr(owner, attr)

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            self.now = label
            start.record()
            try:
                return fn(*args, **kw)
            finally:
                end.record()
                self.now = None
                self.spans.setdefault(label, []).append((start, end))
        setattr(owner, attr, timed)
        self.undo.append((owner, attr, fn))

    def restore(self):
        for owner, attr, fn in reversed(self.undo):
            setattr(owner, attr, fn)
        self.undo = []

    def ms(self):
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v)
                for k, v in self.spans.items()}

    def per_call(self):
        """Calls, and the mean and median device ms of a call, by label."""
        torch.cuda.synchronize()
        out = {}
        for k, v in self.spans.items():
            times = [s.elapsed_time(e) for s, e in v]
            out[k] = dict(runs=len(times), mean_ms=float(np.mean(times)),
                          p50_ms=float(np.median(times)))
        return out


def expert_step_probe(eng):
    """One serving step of a quantized-expert Mixtral with its device time
    split: the expert bank's dequantize, the capacity path (dispatch mask
    and the four einsums), K1; and the step's host time."""
    from neuronx_distributed_tpu_torch.models import llama
    from neuronx_distributed_tpu_torch.modules.moe import expert_mlps
    from neuronx_distributed_tpu_torch.quantization import (
        quantization_layers as ql)

    timer = SpanTimer()
    timer.wrap(ql.QuantizedExpertMLPs, "bank", "expert_dequantize_ms")
    timer.wrap(expert_mlps, "capacity_glu", "expert_einsums_ms")
    timer.wrap(llama, "paged_attention", "k1_ms")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        eng.step()
        torch.cuda.synchronize()
    finally:
        timer.restore()
    wall = (time.perf_counter() - t0) * 1e3
    return {"probe_step": {"wall_ms": wall, **timer.ms()}}


def phase_cross_check(base_cfg):
    """One packed step (two prompts, pad rows) then one decode step, at
    full width with 2 layers in fp32, on the card and on the CPU path."""
    from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION
    from neuronx_distributed_tpu_torch.inference.paging import (
        init_paged_kv_cache)
    from neuronx_distributed_tpu_torch.models.llama import (
        build_model, init_state_dict, llama_forward_with_cache)

    cfg = dataclasses.replace(base_cfg, num_layers=2, dtype=torch.float32)
    width, bs, nb, maxb = 64, 16, 64, 8
    sd = init_state_dict(cfg, seed=1, std=0.02)
    sides = {}
    for dev in ("cuda", "cpu"):
        sides[dev] = (build_model(cfg, sd, dev), init_paged_kv_cache(
            cfg.num_layers, nb, bs, cfg.num_kv_heads, cfg.head_dim_, 2, maxb,
            dtype=torch.float32, device=dev))
    del sd
    tables = np.full((2, maxb), -1, np.int32)
    tables[0, :3] = [17, 3, 40]
    tables[1, :2] = [8, 62]
    rng = np.random.RandomState(2)
    steps = [(list(range(40)) + list(range(20)), [0] * 40 + [1] * 20),
             ([40, 20], [0, 1])]
    worst = 0.0
    for pos, slots in steps:
        n = len(pos)
        toks = np.zeros((1, width), np.int32)
        toks[0, :n] = rng.randint(0, cfg.vocab_size, n)
        p = np.full((1, width), PAD_POSITION, np.int32)
        p[0, :n] = pos
        s = np.full((width,), 2, np.int32)
        s[:n] = slots
        out = {}
        for dev, (model, cache) in sides.items():
            cache.block_tables.copy_(torch.from_numpy(tables))
            logits, _ = llama_forward_with_cache(
                model, torch.from_numpy(toks).to(dev),
                torch.from_numpy(p).to(dev), cache,
                torch.from_numpy(s).to(dev))
            out[dev] = logits[0, :n].float().cpu()
        diff = (out["cuda"] - out["cpu"]).abs().max().item()
        scale = out["cpu"].abs().max().item()
        worst = max(worst, diff / scale)
        if not diff <= 1e-3 * scale:
            raise AssertionError(f"cross_check: max |diff| {diff} above "
                                 f"1e-3 x max|logit| ({scale})")
    emit("cross_check", layers=cfg.num_layers, width=width,
         max_rel_diff=worst, tol=1e-3)
    del sides
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 10-13: Mixtral and the grouped-GLU kernels
# ---------------------------------------------------------------------------

def moe_case(seed, tokens, weights, sentinel_empty, k=2, bs=64, avoid=None):
    """The expert-sorted blocks of ``tokens`` random tokens routed top-``k``
    by random router logits over the experts of ``weights`` (``gate_up``,
    ``down``), laid out by the port's block metadata; no token goes to
    expert ``avoid``."""
    from neuronx_distributed_tpu_torch.modules.moe import blockwise as bw

    gate_up, down = weights
    e, h = gate_up.shape[0], gate_up.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((tokens, e), generator=gen, device="cuda")
    if avoid is not None:
        logits[:, avoid] = -float("inf")
    idx = logits.topk(k)[1]
    _, src, dest, be, _, padded = bw.compute_block_metadata(
        idx, e, bs, sentinel_empty=sentinel_empty)
    x = torch.randn((tokens, h), generator=gen, device="cuda")
    xs = bw.scatter_to_blocks(x.to(gate_up.dtype), src, dest, padded)
    return xs, gate_up, down, be, bs


def moe_bound(xs, gate_up, down, be, bs, kind="grouped_glu"):
    """Least time for one call of the grouped-GLU entry ``kind``: the
    larger of its bytes (each ``[P, H]`` tensor it reads or writes once:
    xs and ys forward, xs, dy and dx for dx; the weights of each expert
    some live block uses, once; the dW of all E experts written once, in
    the weights' type; the block table) over HBM bandwidth, and its
    products over the live blocks' rows over the peak rate for the dtype:
    x Wg, x Wu, a Wd forward (6 H I FLOP per row); g, u, da = dy Wd^T, dg
    Wg^T, du Wu^T for dx (10); g, u, da and a^T dy, x^T dg, x^T du for dW
    (12); all eight for the pair (16)."""
    per_row, tensors, writes_dw = MOE_WORK[kind]
    e, h, _, i = gate_up.shape
    live = be[be < e]
    hit = torch.unique(live).numel()
    es = xs.element_size()
    nbytes = (tensors * xs.numel() * es + hit * 3 * h * i * es
              + be.numel() * 4 + (e * 3 * h * i * es if writes_dw else 0))
    flops = float(per_row) * live.numel() * bs * h * i
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[xs.dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, hit_experts=hit,
                live_blocks=live.numel())


def moe_rates(t):
    """TFLOP/s of a timed kernel (its bound's operations over its time)
    and its factor against the cuBLAS yardstick."""
    return dict(tflops=t["flops"] / t["kernel_ms"] / 1e9,
                factor_vs_library=t["kernel_ms"] / t["library_ms"])


def expert_runs(be, e, bs):
    """``[expert, first row, end row]`` of each run of one expert's
    consecutive live blocks."""
    runs = []
    for b, x in enumerate(be.tolist()):
        if x >= e:
            continue
        if runs and runs[-1][0] == x and runs[-1][2] == b * bs:
            runs[-1][2] = (b + 1) * bs
        else:
            runs.append([x, b * bs, (b + 1) * bs])
    return runs


def moe_library(xs, gate_up, down, be, bs):
    """The yardstick, several PyTorch calls: per run of one expert's live
    blocks, cuBLAS ``x @ gate_up[e]`` (gate and up in one product),
    ``silu(g) * u`` and ``a @ down[e]``. Timed only."""
    e, h, _, i = gate_up.shape
    runs = expert_runs(be, e, bs)

    def call():
        for x, r0, r1 in runs:
            gu = xs[r0:r1] @ gate_up[x].reshape(h, 2 * i)
            _ = (F.silu(gu[:, :i]) * gu[:, i:]) @ down[x]
    return call


def moe_bwd_library(xs, gate_up, down, be, bs, dy, kind):
    """The backward's yardstick, several PyTorch calls per run of one
    expert's live blocks: cuBLAS ``x @ gate_up[e]`` (g and u in one
    product) and ``dy @ down[e].T``, the elementwise dg, du (and a), then
    for dx ``[dg | du] @ gate_up[e]^T`` (dg Wg^T + du Wu^T in one product),
    for dW ``x^T @ [dg | du]`` and ``a^T @ dy``, for the pair all three.
    Timed only."""
    e, h, _, i = gate_up.shape
    runs = expert_runs(be, e, bs)

    def call():
        for x, r0, r1 in runs:
            w = gate_up[x].reshape(h, 2 * i)
            gu = xs[r0:r1] @ w
            g, u = gu[:, :i], gu[:, i:]
            da = dy[r0:r1] @ down[x].T
            s = torch.sigmoid(g)
            sg = g * s
            dgdu = torch.cat([da * u * (s * (1 + g * (1 - s))), da * sg], 1)
            if kind != "grouped_glu_dw":
                _ = dgdu @ w.T
            if kind != "grouped_glu_dx":
                _ = xs[r0:r1].T @ dgdu
                _ = (sg * u).T @ dy[r0:r1]
    return call


def phase_moe_vs_plain():
    """K5 and K6 against their plain versions at Mixtral 8x7B's widths, then
    at DBRX's (E=16, top-4, H=6144, I=10752: K5 at 512 tokens, 2048 pairs;
    K6 at 4 tokens, 16 pairs on sentinel metadata)."""
    from neuronx_distributed_tpu_torch.models.mixtral import (DBRX,
                                                              MIXTRAL_8X7B)

    results = []
    for prefix, cfg, seed in (("", MIXTRAL_8X7B, 300), ("dbrx_", DBRX, 310)):
        results += moe_vs_plain_at(prefix, cfg, seed)
    emit("moe_vs_plain", cases=results)
    return results


def moe_vs_plain_at(prefix, cfg, seed):
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as bm

    e, h, i = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w32 = (torch.randn((e, h, 2, i), generator=gen, device="cuda") * 0.02,
           torch.randn((e, i, h), generator=gen, device="cuda") * 0.02)
    weights = {torch.float32: w32,
               torch.bfloat16: tuple(w.bfloat16() for w in w32)}
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    kernels = {"grouped_glu": (bm.grouped_glu_cuda, bm.grouped_glu_plain),
               "grouped_glu_decode": (bm.grouped_glu_decode_cuda,
                                      bm.grouped_glu_decode_plain)}
    # (case, kernel, tokens, dtype, sentinel metadata, tolerance)
    cases = [("k5_bf16", "grouped_glu", 512, torch.bfloat16, False, 1e-2),
             ("k5_fp32", "grouped_glu", 512, torch.float32, False, 1e-4),
             ("k6_bf16", "grouped_glu_decode", 4, torch.bfloat16, True, 1e-2),
             ("k6_fp32", "grouped_glu_decode", 4, torch.float32, True, 1e-4)]
    bi = min(512, i)
    results = []
    for n, (case, name, tokens, dtype, sentinel, tol) in enumerate(cases):
        case = prefix + case
        args = moe_case(seed + 100 + n, tokens, weights[dtype], sentinel,
                        k=cfg.top_k)
        xs, gate_up, down, be, bs = args
        kernel, plain = kernels[name]
        got = kernel(*args, bi)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            # every sum stays in one CTA in a fixed order: a second launch
            # on the same inputs gives the same bits
            again = kernel(*args, bi)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{case}: two launches on the same "
                                     "inputs differ")
            del again
        # bf16: the kernel sums over I in fp32 and rounds once, so it is
        # held to the plain version in fp32 on the same inputs, rounded once
        ref = plain(xs.float(), gate_up.float(), down.float(), be, bs,
                    bi).to(dtype)
        rel = flash_rel_err(got, ref)
        sent = torch.repeat_interleave(be >= e, bs)
        if not (rel <= tol) or not torch.isfinite(got).all() \
                or got[sent].any():
            raise AssertionError(f"{case}: error {rel} of |ref| + rms(row) "
                                 f"above {tol}, or sentinel rows not zero")
        res = dict(case=case, kernel=name, tokens=tokens, dtype=str(dtype),
                   experts=e, top_k=cfg.top_k, hidden=h, intermediate=i,
                   rows=xs.shape[0], blocks=be.numel(), tol=tol,
                   max_rel_err=rel,
                   max_abs_err=(got.float() - ref.float()).abs().max().item(),
                   kernel_ms=time_ms(lambda: kernel(*args, bi), reps=10,
                                     flush=flush),
                   plain_ms=time_ms(lambda: plain(*args, bi), reps=3,
                                    flush=flush),
                   **moe_bound(*args, kind=name))
        if dtype == torch.bfloat16:
            res["library_ms"] = time_ms(moe_library(*args), reps=10,
                                        flush=flush)
            res["library"] = ("several calls: per run of one expert's live "
                              "blocks, torch.matmul (cuBLAS) x @ gate_up[e], "
                              "silu(g) * u, and @ down[e]")
            res.update(deterministic=True, design=MOE_FWD_DESIGN[name],
                       **moe_rates(res))
        results.append(res)
        del args, xs, got, ref
        torch.cuda.empty_cache()
    del weights, w32
    torch.cuda.empty_cache()
    return results


def phase_mixtral_cross_check(base_cfg):
    """One packed step (two prompts and pad rows, width 64: K5) and one
    decode-worker step (two decode rows, width 4: K6) at full width, 2
    layers, fp32, blockwise with block 64, on the card and the CPU path."""
    from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION
    from neuronx_distributed_tpu_torch.inference.paging import (
        init_paged_kv_cache)
    from neuronx_distributed_tpu_torch.models.mixtral import (
        build_model, init_state_dict, mixtral_forward_with_cache)
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as bm

    cfg = dataclasses.replace(base_cfg, num_layers=2, dtype=torch.float32,
                              param_dtype=torch.float32,
                              moe_dispatch="blockwise", moe_block_size=64)
    bs, nb, maxb = 16, 64, 8
    sd = init_state_dict(cfg, seed=1, std=0.02)
    sides = {}
    for dev in ("cuda", "cpu"):
        sides[dev] = (build_model(cfg, sd, dev), init_paged_kv_cache(
            cfg.num_layers, nb, bs, cfg.num_kv_heads, cfg.head_dim_, 2, maxb,
            dtype=torch.float32, device=dev))
    del sd
    tables = np.full((2, maxb), -1, np.int32)
    tables[0, :3] = [17, 3, 40]
    tables[1, :2] = [8, 62]
    rng = np.random.RandomState(2)
    steps = [(64, list(range(40)) + list(range(20)), [0] * 40 + [1] * 20,
              "grouped_glu"),
             (4, [40, 20], [0, 1], "grouped_glu_decode")]
    worst, cpu_s = 0.0, 0.0
    for width, pos, slots, kernel in steps:
        n = len(pos)
        toks = np.zeros((1, width), np.int32)
        toks[0, :n] = rng.randint(0, cfg.vocab_size, n)
        p = np.full((1, width), PAD_POSITION, np.int32)
        p[0, :n] = pos
        s = np.full((width,), 2, np.int32)
        s[:n] = slots
        out = {}
        for dev, (model, cache) in sides.items():
            before = getattr(bm, kernel).launches
            t0 = time.perf_counter()
            cache.block_tables.copy_(torch.from_numpy(tables))
            logits, _ = mixtral_forward_with_cache(
                model, torch.from_numpy(toks).to(dev),
                torch.from_numpy(p).to(dev), cache,
                torch.from_numpy(s).to(dev))
            out[dev] = logits[0, :n].float().cpu()
            if dev == "cpu":
                cpu_s += time.perf_counter() - t0
            elif getattr(bm, kernel).launches - before != cfg.num_layers:
                raise AssertionError(f"mixtral_cross_check: width {width} "
                                     f"did not launch {kernel} per layer")
        diff = (out["cuda"] - out["cpu"]).abs().max().item()
        scale = out["cpu"].abs().max().item()
        worst = max(worst, diff / scale)
        if not diff <= 1e-3 * scale:
            raise AssertionError(f"mixtral_cross_check: width {width} max "
                                 f"|diff| {diff} above 1e-3 x max|logit| "
                                 f"({scale})")
    emit("mixtral_cross_check", layers=cfg.num_layers, widths=[64, 4],
         max_rel_diff=worst, tol=1e-3, cpu_s=cpu_s)
    del sides
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 28-31: weight-quantized serving, DBRX, the other MoE routers
# ---------------------------------------------------------------------------

def phase_serve_quant_tiers(cfg, ecfg, tiers=("fp8", "mxfp8", "mxfp4"),
                            new=64):
    """Hand ``ServingEngine`` a float bf16 state dict on the card with
    ``EngineConfig.weight_quant`` set, so the engine quantizes it there,
    and serve 4 of phase 4's requests per tier. Asserts every request
    completes, one step shape and K1 launched layers x steps."""
    from neuronx_distributed_tpu_torch.inference.engine import ServingEngine
    from neuronx_distributed_tpu_torch.models import llama
    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention)

    sd = llama.init_state_dict(dataclasses.replace(cfg, param_dtype=cfg.dtype),
                               seed=0, std=0.02)
    float_gib = sum(t.numel() * t.element_size()
                    for t in sd.values()) / 2 ** 30
    rng = np.random.RandomState(0)
    lens = rng.randint(128, 1025, 8)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens][:4]
    out, launches = {}, 0
    for tier in tiers:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ServingEngine(cfg, sd,
                            dataclasses.replace(ecfg, weight_quant=tier))
        torch.cuda.synchronize()
        convert_s = time.perf_counter() - t0
        paged_attention.launches = 0
        t0 = time.perf_counter()
        for i, prompt in enumerate(prompts):
            eng.submit(prompt, new, uid=f"r{i}")
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bad = [u for u, r in res.items()
               if r.status != "completed" or len(r.tokens) != new]
        if len(res) != len(prompts) or bad or eng.compile_count() != 1:
            raise AssertionError(f"serve_quant_tiers {tier}: requests {bad} "
                                 f"not completed or {eng.compile_count()} "
                                 "step shapes")
        want = cfg.num_layers * eng.stats.steps
        if paged_attention.launches != want:
            raise AssertionError(f"serve_quant_tiers {tier}: K1 launched "
                                 f"{paged_attention.launches}, want {want}")
        launches += paged_attention.launches
        rep = eng.stats.report()
        out[tier] = dict(
            weight_gib=state_gib(eng.model), convert_s=convert_s,
            steps=eng.stats.steps, launches=paged_attention.launches,
            output_tok_per_s=len(prompts) * new / wall,
            step_latency_p50_ms=rep["step_latency_p50_ms"],
            step_latency_p99_ms=rep["step_latency_p99_ms"],
            ttft_p50_ms=rep["ttft_p50_ms"],
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del eng
        torch.cuda.empty_cache()
    del sd
    torch.cuda.empty_cache()
    emit("serve_quant_tiers", layers=cfg.num_layers, requests=len(prompts),
         new_tokens=new, float_weight_gib=float_gib, tiers=out)
    return launches


def same_bits(a, b) -> bool:
    """Whether two tensors hold the same dtype, shape and bits."""
    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.element_size() in (1, 2, 4, 8):
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[a.element_size()]
        return torch.equal(a.view(ints), b.view(ints))
    return torch.equal(a, b)


def packed_logits(cfg, sd, dev, width=64):
    """The real rows' logits (fp32, on the host) of one packed step of
    ``cfg`` (two prompts of 40 and 20 tokens, pad rows up to ``width``) on
    ``dev`` from the state dict ``sd``."""
    from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION
    from neuronx_distributed_tpu_torch.inference.paging import (
        init_paged_kv_cache)
    from neuronx_distributed_tpu_torch.models import llama, mixtral

    moe = isinstance(cfg, mixtral.MixtralConfig)
    family = mixtral if moe else llama
    forward = (mixtral.mixtral_forward_with_cache if moe
               else llama.llama_forward_with_cache)
    bs, nb, maxb = 16, 64, 8
    tables = np.full((2, maxb), -1, np.int32)
    tables[0, :3] = [17, 3, 40]
    tables[1, :2] = [8, 62]
    pos, slots = list(range(40)) + list(range(20)), [0] * 40 + [1] * 20
    n = len(pos)
    toks = np.zeros((1, width), np.int32)
    toks[0, :n] = np.random.RandomState(2).randint(0, cfg.vocab_size, n)
    p = np.full((1, width), PAD_POSITION, np.int32)
    p[0, :n] = pos
    s = np.full((width,), 2, np.int32)
    s[:n] = slots
    model = family.build_model(cfg, sd, dev)
    cache = init_paged_kv_cache(
        cfg.num_layers, nb, bs, cfg.num_kv_heads, cfg.head_dim_, 2, maxb,
        dtype=torch.float32, device=dev)
    cache.block_tables.copy_(torch.from_numpy(tables))
    logits, _ = forward(model, torch.from_numpy(toks).to(dev),
                        torch.from_numpy(p).to(dev), cache,
                        torch.from_numpy(s).to(dev))
    return logits[0, :n].float().cpu()


def card_vs_cpu_step(cfg, sd, cpu, width=64):
    """One packed step of ``cfg`` (:func:`packed_logits`) on the card from
    the state dict ``sd``, against ``cpu``, the logits the CPU side's path
    gave. Returns max |diff| over max |logit| of the real rows."""
    card = packed_logits(cfg, sd, "cuda", width)
    return (card - cpu).abs().max().item() / cpu.abs().max().item()


QUANT_CASES = (("llama", "mxfp4"), ("llama", "fp8"), ("mixtral", "int8"),
               ("mixtral", "mxfp8"))


def quant_case(model, fmt):
    """The family module and config of one ``quant_cross_check`` case:
    full width, 1 layer, fp32, ``weight_quant=fmt``."""
    from neuronx_distributed_tpu_torch.models import llama, mixtral

    family = mixtral if model == "mixtral" else llama
    base = mixtral.MIXTRAL_8X7B if model == "mixtral" else llama.LLAMA3_8B
    return family, dataclasses.replace(base, num_layers=1,
                                       dtype=torch.float32,
                                       param_dtype=torch.float32,
                                       weight_quant=fmt)


def quant_cpu_half(model, fmt):
    """The CPU half of one ``quant_cross_check`` case (run by
    :class:`CpuSide`): the float weights (seed 1) on the host, quantized
    there, and the packed step's logits on the CPU path."""
    from neuronx_distributed_tpu_torch.quantization.serving import (
        quantize_params_for_serving)

    family, cfg = quant_case(model, fmt)
    t0 = time.perf_counter()
    fsd = family.init_state_dict(
        dataclasses.replace(cfg, weight_quant=None), seed=1, std=0.02,
        device="cpu")
    cpu_q = quantize_params_for_serving(cfg, fsd)
    cpu_s = time.perf_counter() - t0
    return dict(fsd=fsd, cpu_q=cpu_q, logits=packed_logits(cfg, cpu_q, "cpu"),
                cpu_quantize_s=cpu_s)


def phase_quant_cross_check(cpu_side):
    """Full width, 1 layer, fp32: the float weights (seed 1) quantized on
    the card and on the CPU, the codes and scales compared bit for bit, then
    one packed step each, logits within 1e-3 x max|logit|. Llama-3-8B at
    ``mxfp4`` and ``fp8``, Mixtral 8x7B at ``int8`` and ``mxfp8`` (its
    experts in the tier's format). The CPU halves come from ``cpu_side``
    (computed while earlier phases ran on the card)."""
    from neuronx_distributed_tpu_torch.quantization.serving import (
        quantize_params_for_serving)

    results = []
    for model, fmt in QUANT_CASES:
        _, cfg = quant_case(model, fmt)
        half = cpu_side.result(f"quant_{fmt}")
        cpu_q = half["cpu_q"]
        card_q = quantize_params_for_serving(
            cfg, {k: v.cuda() for k, v in half["fsd"].items()})
        differ = [k for k in cpu_q if not same_bits(card_q[k], cpu_q[k])]
        if differ or set(card_q) != set(cpu_q):
            raise AssertionError(f"quant_cross_check {fmt}: the card's "
                                 f"codes differ from the CPU's at {differ}")
        rel = card_vs_cpu_step(cfg, card_q, half["logits"])
        if not rel <= 1e-3:
            raise AssertionError(f"quant_cross_check {fmt}: max |diff| "
                                 f"{rel} x max|logit|, above 1e-3")
        results.append(dict(model=type(cfg).__name__, weight_quant=fmt,
                            tensors=len(cpu_q), codes_equal=True,
                            max_rel_diff=rel,
                            cpu_quantize_s=half["cpu_quantize_s"],
                            cpu_job_s=half.get("cpu_job_s")))
        del cpu_q, card_q, half
        torch.cuda.empty_cache()
    emit("quant_cross_check", layers=1, tol=1e-3, cases=results)


MOE_ROUTERS = ("sinkhorn", "group_limited")


def moe_variant_cfg(router):
    from neuronx_distributed_tpu_torch.models import mixtral

    return dataclasses.replace(
        mixtral.MIXTRAL_8X7B, num_layers=1, dtype=torch.float32,
        param_dtype=torch.float32, router_type=router,
        shared_expert_intermediate=14336)


def moe_variant_cpu_half(router):
    """The CPU half of one ``moe_variants_cross_check`` case (run by
    :class:`CpuSide`): the weights (seed 1) and the CPU path's logits."""
    from neuronx_distributed_tpu_torch.models import mixtral

    cfg = moe_variant_cfg(router)
    sd = mixtral.init_state_dict(cfg, seed=1, std=0.02, device="cpu")
    return dict(sd=sd, logits=packed_logits(cfg, sd, "cpu"))


def phase_moe_variants_cross_check(cpu_side):
    """Mixtral 8x7B's widths, 1 layer, fp32, capacity dispatch, with the
    Sinkhorn router and with the group-limited one, each beside shared
    experts of intermediate 14336: one packed step on the card and on the
    CPU path, logits within 1e-3 x max|logit| (the CPU half from
    ``cpu_side``)."""
    results = []
    for router in MOE_ROUTERS:
        cfg = moe_variant_cfg(router)
        half = cpu_side.result(f"moe_variants_{router}")
        rel = card_vs_cpu_step(cfg, half["sd"], half["logits"])
        if not rel <= 1e-3:
            raise AssertionError(f"moe_variants_cross_check {router}: max "
                                 f"|diff| {rel} x max|logit|, above 1e-3")
        results.append(dict(router_type=router,
                            shared_expert_intermediate=14336,
                            max_rel_diff=rel))
        del half
        torch.cuda.empty_cache()
    emit("moe_variants_cross_check", layers=1, tol=1e-3, cases=results)


def phase_moe_bwd_vs_plain(tokens=4096):
    """K7 and K8, and the pair behind one pass 1, against the plain
    backward at the train step's shapes (Mixtral 8x7B widths, ``tokens``
    tokens top-2 over 8 experts, block 64, training metadata: every block
    live), fp32 and bf16, element by element (``flash_rel_err``): fp32
    within 1e-4, bf16 against the plain version in fp32 on the same bf16
    inputs, rounded once, within 1e-2. A third case routes no token to
    expert 5 and then hands its padding block to expert 4 and reverses the
    table, so expert 5 owns no block: its dW must be exact zeros. In bf16
    (the tensor-core design) a second launch of the pair must give the
    same bits. Times each entry, its plain version (bf16) and cuBLAS over
    the same rows expert by expert, and computes the bound; times K5 at the
    same shape (the train step's forward), its cuBLAS yardstick and its
    bound."""
    from neuronx_distributed_tpu_torch.models.mixtral import MIXTRAL_8X7B
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as bm

    cfg = MIXTRAL_8X7B
    e, h, i = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    gen = torch.Generator(device="cuda").manual_seed(310)
    w32 = (torch.randn((e, h, 2, i), generator=gen, device="cuda") * 0.02,
           torch.randn((e, i, h), generator=gen, device="cuda") * 0.02)
    weights = {torch.float32: w32,
               torch.bfloat16: tuple(w.bfloat16() for w in w32)}
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    entries = ("grouped_glu_dx", "grouped_glu_dw", "grouped_glu_bwd")
    outputs = {"grouped_glu_dx": (0,), "grouped_glu_dw": (1, 2),
               "grouped_glu_bwd": (0, 1, 2)}
    bi = min(512, i)
    results = []
    for n, (case, dtype, tol) in enumerate((
            ("bf16", torch.bfloat16, 1e-2), ("fp32", torch.float32, 1e-4),
            ("bf16_empty_expert", torch.bfloat16, 1e-2))):
        empty = case == "bf16_empty_expert"
        xs, gate_up, down, be, bs = moe_case(600 + n, tokens, weights[dtype],
                                             False, avoid=5 if empty else None)
        if empty:
            be = torch.where(be == 5, 4, be).flip(0).contiguous()
        dy = torch.randn(xs.shape, generator=gen, device="cuda").to(dtype)
        args = (xs, gate_up, down, be, dy, bs, bi)
        # the kernels sum over I in fp32 and round once: held to the plain
        # version in fp32 on the same inputs, rounded once
        ref = bm.grouped_glu_bwd_plain(*(t.float() for t in args[:3]), be,
                                       dy.float(), bs, bi)
        ref = [r.to(dtype) for r in ref]
        res = dict(case=case, dtype=str(dtype), rows=xs.shape[0],
                   blocks=be.numel(), tol=tol, max_rel_err={},
                   max_abs_err={}, design=MOE_BWD_DESIGN[dtype])
        for name in entries:
            got = getattr(bm, f"{name}_cuda")(*args)
            got = (got,) if name == "grouped_glu_dx" else got
            torch.cuda.synchronize()
            if name == "grouped_glu_bwd" and dtype == torch.bfloat16:
                # every sum stays in one CTA in a fixed order: a second
                # launch on the same inputs gives the same bits
                again = bm.grouped_glu_bwd_cuda(*args)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"moe_bwd {case}: two launches of "
                                         "the pair on the same inputs differ")
                res["pair_deterministic"] = True
                del again
            for k, g in zip(outputs[name], got):
                rel = flash_rel_err(g, ref[k])
                label = f"{name}.{('dx', 'dgate_up', 'ddown')[k]}"
                if not (rel <= tol) or not torch.isfinite(g).all():
                    raise AssertionError(f"moe_bwd {case} {label}: error "
                                         f"{rel} of |ref| + rms(row) above "
                                         f"{tol}")
                res["max_rel_err"][label] = rel
                res["max_abs_err"][label] = (g.float() - ref[k].float()
                                             ).abs().max().item()
                if k and empty and g[5].any():
                    raise AssertionError(f"moe_bwd {label}: expert 5 owns "
                                         "no block, its dW is not zero")
            del got
        if not empty:
            timing = {}
            for name in entries:
                kern = getattr(bm, f"{name}_cuda")
                plain = getattr(bm, f"{name}_plain")
                t = dict(kernel_ms=time_ms(lambda: kern(*args), reps=5,
                                           flush=flush),
                         **moe_bound(*args[:4], bs, kind=name))
                if dtype == torch.bfloat16:
                    t["plain_ms"] = time_ms(lambda: plain(*args), reps=1,
                                            flush=flush, warmup=1)
                    t["library_ms"] = time_ms(
                        moe_bwd_library(xs, gate_up, down, be, bs, dy, name),
                        reps=5, flush=flush)
                timing[name] = t
            res["timing"] = timing
            if dtype == torch.bfloat16:
                res["library"] = ("several calls per run of one expert's live "
                                  "blocks: torch.matmul (cuBLAS) x @ "
                                  "gate_up[e] and dy @ down[e].T, the "
                                  "elementwise dg, du, a, then [dg|du] @ "
                                  "gate_up[e].T (dx) and x.T @ [dg|du], "
                                  "a.T @ dy (dW)")
                # K5 where the train step runs it: the same rows forward,
                # its largest grid, with the most pairs of two experts
                got = bm.grouped_glu_cuda(xs, gate_up, down, be, bs, bi)
                want = bm.grouped_glu_plain(
                    *(t.float() for t in (xs, gate_up, down)), be, bs,
                    bi).to(dtype)
                rel = flash_rel_err(got, want)
                if not (rel <= tol) or not torch.isfinite(got).all():
                    raise AssertionError(f"moe_bwd {case}: K5 at the train "
                                         f"shape, error {rel} of |ref| + "
                                         f"rms(row) above {tol}")
                k5 = dict(max_rel_err=rel,
                          max_abs_err=(got.float() - want.float()
                                       ).abs().max().item(),
                          kernel_ms=time_ms(lambda: bm.grouped_glu_cuda(
                              xs, gate_up, down, be, bs, bi), reps=5,
                              flush=flush),
                          library_ms=time_ms(moe_library(
                              xs, gate_up, down, be, bs), reps=5,
                              flush=flush),
                          **moe_bound(xs, gate_up, down, be, bs))
                res["k5_at_train_shape"] = dict(k5, **moe_rates(k5))
                del got, want
        results.append(res)
        del args, xs, dy, ref
        torch.cuda.empty_cache()
    del weights, w32
    torch.cuda.empty_cache()
    emit("moe_bwd_vs_plain", cases=results)
    return results


# ---------------------------------------------------------------------------
# phase 7: the flash kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_inputs(seed, b=1, s=4096, n=32, kv=8, d=128, dtype=torch.bfloat16):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return randn(b, s, n, d), randn(b, s, kv, d), randn(b, s, kv, d), \
        randn(b, s, n, d)


def flash_rel_err(a: torch.Tensor, r: torch.Tensor) -> float:
    """Largest ``|a - r| / (|r| + rms(r's row) + 1e-3 max|r|)`` over the
    elements, a row being the last dim (D of out/dq/dk/dv, S of lse).
    Kernel and plain version sum in fp32 from the same inputs, except that
    the bf16 K3 and K4 round p and ds once to bf16 before the dq, dk and dv
    products (2^-9 relative on each term, which the sums average; bounded
    on the CPU by ``test_bf16_rounding_of_p_and_ds_is_bounded`` in
    ``tests/test_torch_flash_attention.py``). So they differ by a few
    roundings of each element, and by a few roundings of its row's scale
    where a sum cancels. Causal attention's rows differ in
    scale by orders of magnitude along S, so the scale is the row's: one
    taken over the whole tensor, from its first rows, would let a late row
    drop a term unseen. The small whole-tensor term covers rows that are
    zero but for rounding (causal dq of query 0). Equal elements count 0;
    a NaN stays NaN."""
    a, r = a.double(), r.double()
    row = r.pow(2).mean(-1, keepdim=True).sqrt()
    err = (a - r).abs()
    scale = r.abs() + row + 1e-3 * r.abs().max()
    return torch.where(err == 0, 0.0, err / scale).max().item()


def flash_run(impl, q, k, v, g, causal, p, seed):
    """(out, lse, dq, dk, dv) through the given versions: the kernels'
    wrappers or the plain functions; each backward takes its own forward's
    out and lse."""
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    fwd, dq_fn, dkv_fn = impl
    out, lse = fwd(q, k, v, causal, None, p, seed)
    delta = fa.attention_delta(g, out)
    args = (q, k, v, g, lse, delta, causal, None, p, seed)
    return (out, lse, dq_fn(*args), *dkv_fn(*args)), delta


def flash_bounds(q, k, causal):
    """Least time of each kernel: the larger of its bytes (each input read
    once, each output written once) over HBM bandwidth and its products
    over the peak rate for the input type. Causal attention does only the
    pairs k <= q; K2 does 2 products (s, pv), K3 3 (s, dp, dq), K4 4 (s,
    dv, dp, dk), 2 FLOP per multiply-add."""
    b, s, n, d = q.shape
    kv = k.shape[2]
    pairs = s * (s + 1) // 2 if causal else s * s
    es = q.element_size()
    qb, kvb, stat = b * s * n * d * es, b * s * kv * d * es, b * n * s * 4
    work = {"flash_fwd": (2, 2 * qb + 2 * kvb + stat),
            "flash_bwd_dq": (3, 3 * qb + 2 * kvb + 2 * stat),
            "flash_bwd_dkv": (4, 2 * qb + 4 * kvb + 2 * stat)}
    out = {}
    for name, (products, nbytes) in work.items():
        flops = 2.0 * products * b * n * pairs * d
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
        out[name] = dict(bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", bytes=nbytes, flops=flops)
    return out


def sdpa_yardsticks(q, k, v, g, causal, flush):
    """One PyTorch call for the same function, timed as a yardstick only:
    ``F.scaled_dot_product_attention`` forward (K2), and its backward (the
    work of K3 and K4 together), on [B, N, S, D] copies."""
    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    qt, kt, vt = (x.requires_grad_(True) for x in (qt, kt, vt))

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    with torch.no_grad():
        fwd_ms = time_ms(fwd, flush=flush)
    out = fwd()
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                                 retain_graph=True),
                     flush=flush)
    return fwd_ms, bwd_ms


def check_flash_mask(dtype):
    """q = k = 0 makes every valid score equal (p exactly 1, also in bf16),
    so with V one-hot over a window of D keys K2's output is keep / (l (1 -
    p)): its nonzero pattern is the kernel's mask, held bit for bit against
    dropout_keep_mask (and causality) over all 512 x 512 (q, k) pairs of
    all 32 heads; in ``dtype`` (bf16: the tensor-core K2, fp32: the
    CUDA-core one)."""
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    b, s, n, kv, d, p, seed = 1, 512, 32, 8, 128, 0.1, 0xC0FFEE
    q = torch.zeros(b, s, n, d, device="cuda", dtype=dtype)
    k = torch.zeros(b, s, kv, d, device="cuda", dtype=dtype)
    q_pos = torch.arange(s, device="cuda")[:, None]
    kept = total = 0
    for k0 in range(0, s, d):
        v = torch.zeros(b, s, kv, d, device="cuda", dtype=dtype)
        v[0, k0:k0 + d] = torch.eye(d, device="cuda")[:, None, :]
        out, _ = fa.flash_fwd_cuda(q, k, v, True, None, p, seed)
        k_pos = torch.arange(k0, k0 + d, device="cuda")[None, :]
        want = fa.dropout_keep_mask(seed, fa.flat_bh(b, n, "cuda"), q_pos,
                                    k_pos, s, p) & (k_pos <= q_pos)
        got = out.permute(0, 2, 1, 3) != 0
        if not torch.equal(got, want):
            raise AssertionError(f"flash dropout mask differs from the plain "
                                 f"mask in {(got != want).sum().item()} "
                                 f"places (keys {k0}..{k0 + d - 1})")
        kept += int(want.sum())
        total += int((k_pos <= q_pos).sum()) * n
    return dict(pairs=total, kept_share=kept / total)


def phase_flash_vs_plain():
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    kernels = (fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)
    plains = (fa.flash_fwd_plain, fa.flash_bwd_dq_plain,
              fa.flash_bwd_dkv_plain)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    cases = [
        ("bf16", {}, True, 0.0, 2e-2),
        ("fp32", dict(dtype=torch.float32), True, 0.0, 1e-4),
        ("bf16_dropout", {}, True, 0.1, 2e-2),
        ("bf16_d64", dict(d=64), True, 0.0, 2e-2),
        ("bf16_nrep1", dict(kv=32), True, 0.0, 2e-2),
        ("bf16_noncausal", {}, False, 0.0, 2e-2),
        ("bf16_s1000", dict(s=1000), True, 0.0, 2e-2),
    ]
    names = ("out", "lse", "dq", "dk", "dv")
    results = []
    for i, (case, kw, causal, p, tol) in enumerate(cases):
        q, k, v, g = flash_inputs(200 + i, **kw)
        seed = 1234 + i
        (got, delta), (ref, _) = (flash_run(impl, q, k, v, g, causal, p, seed)
                                  for impl in (kernels, plains))
        torch.cuda.synchronize()
        errs, rels = {}, {}
        for name, a, r in zip(names, got, ref):
            rel = flash_rel_err(a, r)
            if not (rel <= tol) or not torch.isfinite(a).all():
                raise AssertionError(f"flash {case} {name}: error {rel} of "
                                     f"|ref| + rms(row) above {tol}")
            errs[name] = (a.float() - r.float()).abs().max().item()
            rels[name] = rel
        res = dict(case=case, causal=causal, dropout_p=p, tol=tol,
                   shape=list(q.shape), kv_heads=k.shape[2],
                   dtype=str(q.dtype), max_abs_err=errs, max_rel_err=rels)
        if q.dtype == torch.bfloat16:
            # K2, K3 and K4 sum inside one CTA in a fixed order: a second
            # launch on the same inputs gives the same bits
            bwd = (q, k, v, g, got[1], delta, causal, None, p, seed)
            again = (*kernels[0](q, k, v, causal, None, p, seed),
                     kernels[1](*bwd), *kernels[2](*bwd))
            torch.cuda.synchronize()
            for name, a, b in zip(names, got, again):
                if not torch.equal(a, b):
                    raise AssertionError(f"flash {case} {name}: two launches "
                                         "on the same inputs differ")
            res["deterministic"] = True
        res["design"] = FLASH_DESIGN[q.dtype]
        if case in ("bf16", "fp32"):
            out, lse = got[0], got[1]
            bwd = (q, k, v, g, lse, delta, causal, None, p, seed)
            calls = {"flash_fwd": (lambda: kernels[0](q, k, v, causal),
                                   lambda: plains[0](q, k, v, causal)),
                     "flash_bwd_dq": (lambda: kernels[1](*bwd),
                                      lambda: plains[1](*bwd)),
                     "flash_bwd_dkv": (lambda: kernels[2](*bwd),
                                       lambda: plains[2](*bwd))}
            bounds = flash_bounds(q, k, causal)
            timing = {}
            for name, (kern, plain) in calls.items():
                timing[name] = dict(
                    kernel_ms=time_ms(kern, flush=flush),
                    plain_ms=time_ms(plain, reps=5, flush=flush),
                    **bounds[name])
                timing[name]["tflops"] = (bounds[name]["flops"]
                                          / timing[name]["kernel_ms"] / 1e9)
            if case == "bf16":
                fwd_ms, bwd_ms = sdpa_yardsticks(q, k, v, g, causal, flush)
                timing["flash_fwd"]["library_ms"] = fwd_ms
                timing["flash_bwd_dq"]["library_ms"] = bwd_ms
                timing["flash_bwd_dkv"]["library_ms"] = bwd_ms
                res["library"] = ("F.scaled_dot_product_attention (is_causal, "
                                  "enable_gqa): forward for flash_fwd; its "
                                  "backward (dq, dk, dv together) for both "
                                  "backward kernels")
            res["timing"] = timing
        results.append(res)
        del q, k, v, g, got, ref, delta
        torch.cuda.empty_cache()
    mask = {str(dt): check_flash_mask(dt)
            for dt in (torch.bfloat16, torch.float32)}
    emit("flash_vs_plain", cases=results, dropout_mask=mask)
    rates = {c["case"]: {name: t["tflops"] for name, t in c["timing"].items()}
             for c in results if "timing" in c}
    t = next(c for c in results if c["case"] == "bf16")["timing"]
    k2 = t["flash_fwd"]
    emit("flash_fwd_k2", k2_ms=k2["kernel_ms"], tflops=k2["tflops"],
         sdpa_fwd_ms=k2["library_ms"],
         factor_vs_sdpa_fwd=k2["kernel_ms"] / k2["library_ms"],
         bound_ms=k2["bound_ms"],
         fp32_k2_ms=next(c for c in results if c["case"] == "fp32")[
             "timing"]["flash_fwd"]["kernel_ms"])
    pair = t["flash_bwd_dq"]["kernel_ms"] + t["flash_bwd_dkv"]["kernel_ms"]
    emit("flash_bwd_pair", tflops=rates, k3_k4_ms=pair,
         sdpa_bwd_ms=t["flash_bwd_dq"]["library_ms"],
         factor_vs_sdpa_bwd=pair / t["flash_bwd_dq"]["library_ms"],
         bound_ms=t["flash_bwd_dq"]["bound_ms"]
         + t["flash_bwd_dkv"]["bound_ms"])
    return results


# ---------------------------------------------------------------------------
# phases 8-9: the train step
# ---------------------------------------------------------------------------

# each train phase's step p50 and peak, read by later phases of the call
TRAIN_RESULTS = {}


def phase_train(steps=5, seq=4096, mixtral=False, remat=False):
    """``train`` (Llama-3-8B widths, 4 layers), ``train_mixtral`` (Mixtral
    8x7B widths, 2 layers, blockwise) or ``train_mixtral_remat`` (the same
    with ``remat=True``, each layer recomputed whole): ``steps`` steps of
    the workload on one batch; the kernels' counts are set to 0 just
    before and read just after. Under remat K2 and K5 run twice a layer,
    the backward kernels once."""
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as bm
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_tpu_torch.scripts.workloads import (
        llama3_train_workload, mixtral_train_workload)

    phase = ("train_mixtral" + "_remat" * remat) if mixtral else "train"
    counters = {name: getattr(fa, name) for name, _ in FLASH_KERNELS}
    if mixtral:
        counters.update({name: getattr(bm, name) for name in (
            "grouped_glu", "grouped_glu_decode", "grouped_glu_dx",
            "grouped_glu_dw")})
    torch.cuda.reset_peak_memory_stats()
    w = (mixtral_train_workload(layers=2, seq=seq, remat=remat) if mixtral
         else llama3_train_workload(layers=4, seq=seq))
    cfg, state, step, batch = w.cfg, w.state, w.step, w.batch
    n_params = sum(p.numel() for p in state.params.values())
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    losses, norms, times = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    launches = {name: c.launches for name, c in counters.items()}
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"{phase}: non-finite loss or grad norm: "
                             f"{losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: loss did not fall: {losses}")
    if state.step != steps:
        raise AssertionError(f"{phase}: state.step {state.step} != {steps}")
    twice = ("flash_fwd", "grouped_glu") if remat else ()
    for name, n in launches.items():
        want = (0 if name == "grouped_glu_decode" else cfg.num_layers * steps
                * (2 if name in twice else 1))
        if n != want:
            raise AssertionError(f"{phase}: {name} launched {n} times, want "
                                 f"{want} (layers x steps, twice that for "
                                 "K2 and K5 under remat, or none)")
    p50 = float(np.median(times))
    TRAIN_RESULTS[phase] = dict(
        step_ms_p50=p50,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    beside = ({f"train_mixtral_{k}": v for k, v in
               TRAIN_RESULTS.get("train_mixtral", {}).items()}
              if remat else {})
    emit(phase, layers=cfg.num_layers, params=n_params, seq=seq,
         compute_dtype=str(cfg.dtype), param_dtype=str(cfg.param_dtype),
         remat=cfg.remat, steps=steps, losses=losses, grad_norms=norms,
         step_ms=times, step_ms_p50=p50, tokens_per_s=seq / (p50 / 1e3),
         peak_mem_gib=TRAIN_RESULTS[phase]["peak_mem_gib"],
         launches=launches, **beside)
    del w, state, step
    torch.cuda.empty_cache()
    return launches


def phase_mixtral_remat_bitwise(seq=4096):
    """Mixtral 8x7B widths at 1 layer, blockwise with block 64, S=``seq``,
    in fp32 and in bf16 compute (fp32 params): the loss and every gradient
    with ``remat=True`` equal those without bit for bit (the recompute
    routes every token to the same experts and rebuilds the same blocks),
    with K2 and K5 launched twice, K3, K4, K7 and K8 once."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import neuronx_distributed_config
    from neuronx_distributed_tpu_torch.models.mixtral import MIXTRAL_8X7B
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as bm
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_tpu_torch.scripts.workloads import train_batch

    counters = {name: getattr(fa, name) for name, _ in FLASH_KERNELS}
    counters.update({name: getattr(bm, name) for name in (
        "grouped_glu", "grouped_glu_dx", "grouped_glu_dw")})
    batch = train_batch(MIXTRAL_8X7B.vocab_size, seq, seed=3)
    ids, labels = batch["input_ids"].cuda(), batch["labels"].cuda()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        ref = None
        for remat in (False, True):
            cfg = dataclasses.replace(
                MIXTRAL_8X7B, num_layers=1, dtype=dtype,
                param_dtype=torch.float32, use_flash_attention=True,
                moe_dispatch="blockwise", moe_block_size=64, remat=remat)
            pm, params = trainer.initialize_parallel_model(
                neuronx_distributed_config(), cfg, seed=0, std=0.02)
            torch.cuda.synchronize()
            before = {n: c.launches for n, c in counters.items()}
            loss = pm.module.loss(ids, labels)
            loss.backward()
            torch.cuda.synchronize()
            launched = {n: c.launches - before[n]
                        for n, c in counters.items()}
            want = {n: 2 if remat and n in ("flash_fwd", "grouped_glu")
                    else 1 for n in counters}
            if launched != want:
                raise AssertionError(f"mixtral_remat_bitwise: {dtype} remat="
                                     f"{remat}: launches {launched}, want "
                                     f"{want}")
            grads = {n: p.grad for n, p in params.items()}
            del pm, params
            if ref is None:
                ref = (loss.detach(), grads)
            else:
                differ = [n for n, g in grads.items()
                          if not torch.equal(g, ref[1][n])]
                if differ or not torch.equal(loss.detach(), ref[0]):
                    raise AssertionError(
                        f"mixtral_remat_bitwise: {dtype}: remat gradients "
                        f"not bitwise: {differ}")
            out[f"{str(dtype).split('.')[-1]}_"
                f"{'remat' if remat else 'no_remat'}"] = launched
            del grads, loss
        del ref
        free_cuda()
    emit("mixtral_remat_bitwise", layers=1, seq=seq, launches=out,
         bitwise=True)


def plain_steps_p50(ms, every):
    """Median of the steps whose interval holds no fingerprint: neither a
    cadence step (the step's own pass) nor the one after it (the
    monitor's recompute, in the callbacks), nor the run's first."""
    return float(np.median([t for k, t in enumerate(ms, 1)
                            if k > 1 and k % every not in (0, 1)]))


def phase_train_integrity(workdir, steps=12, seq=4096):
    """``Trainer.fit`` on ``LLAMA3_8B`` widths at 4 layers (``train``'s
    model: no remat, the full-logits loss) with
    ``make_train_step(integrity_every=4)`` and ``IntegrityMonitor(every=4)``
    over native-loader batches: ``steps`` steps with obs enabled, then
    ``steps`` more with it disabled. Asserts the monitor's checks and no
    mismatch, the registry's step count and histogram, one step shape,
    and the last step's ``integrity_fp``
    equal, bit for bit, to the numpy mirror of the parameters copied to
    the host; times one fingerprint pass over the parameters against its
    byte bound; prints the ``train/*`` span stats and both runs' step p50,
    over all steps and over the steps that hold no fingerprint pass
    (:func:`plain_steps_p50`). While disabled nothing is recorded: no span
    and no metric value.
    Returns K2-K4's launches in the enabled run."""
    from neuronx_distributed_tpu_torch import obs
    from neuronx_distributed_tpu_torch.data import TokenBatchLoader
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_tpu_torch.resilience.integrity import (
        IntegrityMonitor, fingerprint_array_np, fingerprint_tree)
    from neuronx_distributed_tpu_torch.trainer import Trainer

    counters = {name: getattr(fa, name) for name, _ in FLASH_KERNELS}
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    cfg, pm, state, step = loop_model(4, mode="none",
                                      step_kw=dict(integrity_every=4))
    loader = TokenBatchLoader(token_file(workdir, 128256, seq, seed=2),
                              batch=1, seqlen=seq, seed=2, dtype="uint32")
    runs = {}
    try:
        for enabled in (True, False):
            obs.reset()
            if enabled:
                obs.enable()
            clock, mon = StepClock(), IntegrityMonitor(every=4)
            trainer = Trainer(step, state, callbacks=[clock, mon])
            torch.cuda.synchronize()
            for c in counters.values():
                c.launches = 0
            _, metrics = trainer.fit(loader,
                                     max_steps=trainer.host_step + steps)
            launches = {n: c.launches for n, c in counters.items()}
            snap = obs.get_registry().snapshot()
            stats = {n: v for n, v in obs.get_tracer().stats().items()
                     if n.startswith("train/")}
            obs.disable()
            if mon.checks != steps // 4 or mon.mismatches:
                raise AssertionError(f"train_integrity: {mon.checks} checks, "
                                     f"{mon.mismatches} mismatches")
            runs["enabled" if enabled else "disabled"] = dict(
                step_ms_p50=float(np.median(clock.ms)),
                plain_step_ms_p50=plain_steps_p50(clock.ms, 4),
                step_ms=clock.ms, losses=clock.losses, launches=launches)
            if enabled:
                hist = snap["nxd_train_step_seconds"]["samples"][0]
                if (hist["count"] != steps
                        or snap["nxd_train_steps_total"]["samples"][0][
                            "value"] != steps
                        or snap["nxd_compile_total"]["samples"][0]["value"]
                        != 1 or "nxd_recompile_total" in snap
                        or stats["train/step"]["count"] != steps):
                    raise AssertionError(f"train_integrity: registry {snap}, "
                                         f"spans {stats}")
                for name, n in launches.items():
                    if n != cfg.num_layers * steps:
                        raise AssertionError(f"train_integrity: {name} "
                                             f"launched {n} times")
                runs["enabled"].update(span_stats_us=stats,
                                       step_seconds=hist)
                enabled_launches = launches
            else:
                # families may exist (the monitor's), but hold no values
                recorded = [n for n, m in snap.items() if any(
                    x.get("value", x.get("count")) for x in m["samples"])]
                if recorded or stats:
                    raise AssertionError("train_integrity: obs recorded "
                                         f"while disabled: {recorded} "
                                         f"{stats}")
            reported = metrics["integrity_fp"].cpu().numpy()
        t0 = time.perf_counter()
        host = [p.detach().cpu().numpy() for p in state.params.values()]
        copy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        # numpy's ufuncs release the interpreter lock: a leaf a thread
        with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
            mirror = np.array([fp[0] for fp in pool.map(
                fingerprint_array_np, host)])
        mirror_s = time.perf_counter() - t0
        if not np.array_equal(reported, mirror):
            raise AssertionError(
                "train_integrity: integrity_fp differs from the host "
                f"mirror at leaves {np.nonzero(reported != mirror)[0]}")
        del host
        fp_ms = time_ms(lambda: fingerprint_tree(state.params), reps=5,
                        warmup=1)
        nbytes = sum(p.numel() * p.element_size()
                     for p in state.params.values())
        n_params = sum(p.numel() for p in state.params.values())
    finally:
        loader.close()
        obs.disable()
        obs.reset()
    emit("train_integrity", layers=cfg.num_layers, seq=seq, params=n_params,
         integrity_every=4, steps_per_run=steps, runs=runs,
         obs_plain_step_ms_p50_delta=(
             runs["enabled"]["plain_step_ms_p50"]
             - runs["disabled"]["plain_step_ms_p50"]),
         integrity_fp_equals_host_mirror=True, leaves=len(reported),
         host_copy_s=copy_s, host_mirror_s=mirror_s, fingerprint_ms=fp_ms,
         fingerprint_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
         fingerprint_bound_by="bytes", fingerprint_bytes=nbytes,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del pm, state, step, trainer
    free_cuda()
    return enabled_launches


def train_cross_cfg(base_cfg, layers, cfg_kw):
    return dataclasses.replace(base_cfg, num_layers=layers,
                               dtype=torch.float32, param_dtype=torch.float32,
                               use_flash_attention=True, **cfg_kw)


def train_cross_side(cfg, sd, batch, steps, dev):
    """``steps`` fp32 steps of the port's one-rank path on ``dev`` from
    ``sd``: each step's loss and grad norm, each parameter's update on the
    host, the seconds, and the experts each MoE layer routed to."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import neuronx_distributed_config

    t0 = time.perf_counter()
    # no layout: the CPU side runs this on a thread beside the card phases
    pm, params = trainer.initialize_parallel_model(
        neuronx_distributed_config(init_mesh=False), cfg, state_dict=sd,
        device=dev)
    routes = []
    for layer in pm.module.layers:
        if hasattr(layer, "moe"):
            layer.moe.router.register_forward_hook(
                lambda mod, inp, out, r=routes: r.append(out[1].cpu()))
    tx, state = trainer.initialize_parallel_optimizer(pm, params, 1e-4)
    step = trainer.make_train_step(pm, tx)
    metrics = [step(state, batch)[1] for _ in range(steps)]
    return ([(m["loss"].item(), m["grad_norm"].item()) for m in metrics],
            {n: p.detach().cpu() - sd[n] for n, p in params.items()},
            time.perf_counter() - t0, routes)


def train_cross_cpu_half(base_cfg, layers, seq, steps, cfg_kw):
    """The CPU half of ``train_cross_check`` (run by :class:`CpuSide`):
    the weights (seed 1), the batch, and the CPU path's steps."""
    from neuronx_distributed_tpu_torch.models import llama, mixtral
    from neuronx_distributed_tpu_torch.scripts.workloads import train_batch

    cfg = train_cross_cfg(base_cfg, layers, cfg_kw)
    family = mixtral if isinstance(cfg, mixtral.MixtralConfig) else llama
    sd = family.init_state_dict(cfg, seed=1, std=0.02, device="cpu")
    batch = train_batch(cfg.vocab_size, seq, seed=1)
    return dict(sd=sd, batch=batch, side=train_cross_side(cfg, sd, batch,
                                                          steps, "cpu"))


def phase_train_cross_check(base_cfg, cpu_side, layers=2, seq=256, steps=2,
                            phase="train_cross_check", **cfg_kw):
    """Two fp32 steps at full width on the card and on the CPU path, from
    the same weights and batch. The second step's loss and grad norm depend
    on the first update. The updates themselves, ``p_after - p_before``,
    are held in norm per parameter: Adam's first step moves an element by
    ``lr g / (|g| + eps)``, so an element whose gradient is within rounding
    of zero may move by any fraction of ``lr`` on either side, and no
    element-wise limit below ``lr`` would hold; the norm bounds how much
    of the update such elements carry. A Mixtral config first has both
    sides route every token to the same experts in every step, so that a
    failure names its cause. The CPU half comes from ``cpu_side`` (job
    ``phase``, the same ``layers``, ``seq``, ``steps`` and ``cfg_kw``),
    computed while earlier phases ran on the card."""
    cfg = train_cross_cfg(base_cfg, layers, cfg_kw)
    half = cpu_side.result(phase)
    sd, batch = half["sd"], half["batch"]
    mg, ug, tg, rg = train_cross_side(cfg, sd, batch, steps, "cuda")
    torch.cuda.empty_cache()
    mc, uc, tc, rc = half["side"]
    if len(rg) != len(rc) or any(not torch.equal(a, b)
                                 for a, b in zip(rg, rc)):
        moved = sum(int((a != b).any(-1).sum()) for a, b in zip(rg, rc))
        raise AssertionError(f"{phase}: the card routed {moved} token(s) "
                             "to other experts than the CPU")
    for i, ((lg, ng), (lc, nc)) in enumerate(zip(mg, mc)):
        if not abs(lg - lc) <= 1e-4 * abs(lc):
            raise AssertionError(f"{phase}: step {i + 1} loss {lg} vs CPU "
                                 f"{lc}")
        if not abs(ng - nc) <= 1e-3 * abs(nc):
            raise AssertionError(f"{phase}: step {i + 1} grad norm {ng} vs "
                                 f"CPU {nc}")
    if not mc[-1][0] < mc[0][0] - 1e-2:
        raise AssertionError(f"{phase}: the update did not lower the loss: "
                             f"{mc}")
    worst, worst_name, worst_elem = 0.0, None, 0.0
    for name, ref in uc.items():
        diff = ug[name] - ref
        rel = (diff.norm() / ref.norm()).item()
        if rel > worst:
            worst, worst_name = rel, name
        worst_elem = max(worst_elem, (diff.abs().max()
                                      / ref.abs().max()).item())
        if not rel <= 1e-3:
            raise AssertionError(f"{phase}: {name}'s update differs by {rel} "
                                 "of its norm, above 1e-3")
    del sd, half
    emit(phase, layers=layers, seq=seq, steps=steps,
         loss_card=[m[0] for m in mg], loss_cpu=[m[0] for m in mc],
         grad_norm_card=[m[1] for m in mg], grad_norm_cpu=[m[1] for m in mc],
         max_update_rel_diff=worst, max_update_rel_diff_param=worst_name,
         max_update_elem_diff_of_max=worst_elem, routed_calls=len(rc),
         card_s=tg, cpu_s=tc)


CPU_SIDE_THREAD = "cpu-side"


def on_cpu_side() -> bool:
    """Whether this call runs on :class:`CpuSide`'s thread."""
    return threading.current_thread().name == CPU_SIDE_THREAD


class CpuSide:
    """The CPU halves of cross checks, computed on a thread of this
    process while the card phases before them run (PyTorch's CPU ops
    release the interpreter lock, so the two overlap): ``jobs`` is a list
    of ``(name, function name in this module, args, kwargs)``, run in
    order, at most ``PENDING`` results held ahead of the phase that takes
    them (weights of 8B widths are gigabytes: four hold about 25 GB of
    host memory). :meth:`result` takes the
    next one, which must be ``name``; :meth:`close` stops the thread after
    its current job. Nothing of the checks changes: the same functions
    compute the same halves, on another thread. The thread's CPU ops run
    on all the intra-op threads but ``SPARE`` (PyTorch's count is kept per
    thread), so the card phases' host thread keeps cores of its own; the
    count is set back when the jobs are done."""

    PENDING = 4
    SPARE = 2

    def __init__(self, jobs):
        import queue

        # read here first, so the main thread's count is fixed before the
        # side thread lowers the default for threads that start later
        self.full = torch.get_num_threads()
        self.threads = max(1, self.full - self.SPARE)
        self.ready = queue.Queue(maxsize=self.PENDING)
        self.stop = threading.Event()
        self.done = {name: threading.Event() for name, *_ in jobs}
        self.thread = threading.Thread(target=self._run, args=(jobs,),
                                       daemon=True, name=CPU_SIDE_THREAD)
        self.thread.start()

    def _run(self, jobs):
        torch.set_num_threads(self.threads)
        try:
            self._jobs(jobs)
        finally:
            torch.set_num_threads(self.full)

    def _jobs(self, jobs):
        import queue
        import traceback

        for name, fn, args, kw in jobs:
            t0 = time.perf_counter()
            try:
                out = globals()[fn](*args, **kw)
                out["cpu_job_s"] = time.perf_counter() - t0
            except BaseException:  # handed to the phase, which raises it
                out = {"error": traceback.format_exc()}
            self.done[name].set()
            while not self.stop.is_set():
                try:
                    self.ready.put((name, out), timeout=1.0)
                    break
                except queue.Full:
                    pass
            del out
            if self.stop.is_set():
                return

    def result(self, name, timeout=900):
        t0 = time.perf_counter()
        got, out = self.ready.get(timeout=timeout)
        if got != name or "error" in out:
            raise AssertionError(f"cpu side: got {got}, want {name}: "
                                 f"{out.get('error', '')}")
        out["cpu_wait_s"] = time.perf_counter() - t0
        return out

    def wait_idle(self, timeout=900):
        """Block until every job has finished (the results may still wait
        in the queue, which holds all of the last ``PENDING``): a phase
        that must not run beside the thread calls this."""
        deadline = time.perf_counter() + timeout
        for name, event in self.done.items():
            if not event.wait(max(0.0, deadline - time.perf_counter())):
                raise AssertionError(f"cpu side: {name} not done in "
                                     f"{timeout} s")

    def close(self):
        self.stop.set()


def cpu_side_jobs(llama_cfg, mixtral_cfg):
    """The CPU halves :func:`main` computes in the background, in the
    order the phases want them."""
    return ([(f"quant_{fmt}", "quant_cpu_half", (model, fmt), {})
             for model, fmt in QUANT_CASES]
            + [(f"moe_variants_{router}", "moe_variant_cpu_half", (router,),
                {}) for router in MOE_ROUTERS]
            + [("train_cross_check", "train_cross_cpu_half",
                (llama_cfg, 2, 256, 2, {}), {}),
               ("mixtral_train_cross_check", "train_cross_cpu_half",
                (mixtral_cfg, 1, 256, 2, dict(moe_dispatch="blockwise",
                                              moe_block_size=64)), {}),
               ("spec_cross_check", "spec_cpu_half", (llama_cfg,), {}),
               ("train_loop_cross_check", "train_cross_cpu_half",
                (llama_cfg, 2, 256, 2, LOOP_CROSS_KW), {}),
               ("lora_cross_check", "lora_cpu_half", (2, 256, 2), {}),
               ("router_cross_check", "router_cpu_half", (llama_cfg,), {})])


# ---------------------------------------------------------------------------
# phases 17-21: contiguous-cache generation and prefix sharing
# ---------------------------------------------------------------------------

def ragged_prompts(seed, b, lo, hi, vocab):
    """``b`` right-padded prompts of ``lo``-``hi`` tokens (numpy seed
    ``seed``): ids ``[b, max len]`` (pad id 0) and the lengths."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(lo, hi + 1, b).astype(np.int32)
    ids = np.zeros((b, lens.max()), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(0, vocab, n)
    return ids, lens


class EventLog:
    """CUDA events around each call of a function (no host sync while it
    runs); ``ms()`` synchronises and returns the device time of each."""

    def __init__(self, fn):
        self.fn, self.events = fn, []

    def __call__(self, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args, **kw)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def phase_generate(cfg, new=64):
    """``generate`` on ``cfg`` at full depth in bf16: B=8 right-padded
    prompts of 100-500 tokens (bucket 512), ``new`` greedy tokens (a cache
    of 512 + 64 slots); prefill and each decode step timed by CUDA events
    around ``generation.prefill`` and ``generation.decode_step``. A second
    call with an ``eos_id`` must pin every row past it."""
    from neuronx_distributed_tpu_torch.inference import generation
    from neuronx_distributed_tpu_torch.models.llama import (build_model,
                                                            init_state_dict)

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, init_state_dict(
        dataclasses.replace(cfg, param_dtype=cfg.dtype), seed=0, std=0.02))
    ids, lens = ragged_prompts(0, 8, 100, 500, cfg.vocab_size)
    bucket = generation.pick_bucket(ids.shape[1], (128, 512, 2048))
    generation.generate(model, ids, lens, 2)          # warm-up
    plain = generation.prefill, generation.decode_step
    generation.prefill, generation.decode_step = map(EventLog, plain)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generation.generate(model, ids, lens, new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prefill_ms = generation.prefill.ms()
        step_ms = generation.decode_step.ms()
    finally:
        generation.prefill, generation.decode_step = plain
    out = out.cpu()
    if tuple(out.shape) != (8, new) or not (
            (out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"generate: output {tuple(out.shape)} or ids "
                             "outside the vocabulary")
    eos = int(out[0, 3])
    pinned = generation.generate(model, ids, lens, new, eos_id=eos).cpu()
    hit = 0
    for row, ref in zip(pinned.tolist(), out.tolist()):
        if eos in row:
            first = row.index(eos)
            hit += 1
            if row[first:] != [eos] * (new - first) or row[:first] != \
                    ref[:first]:
                raise AssertionError(f"generate: a row ran past eos {eos}")
        elif row != ref:
            raise AssertionError("generate: a row without eos changed")
    if hit == 0:
        raise AssertionError("generate: no row hit the eos id")
    emit("generate", layers=cfg.num_layers, dtype=str(cfg.dtype), batch=8,
         prompt_tokens=int(lens.sum()), bucket=bucket,
         cache_len=bucket + generation.pick_bucket(
             new, generation.DECODE_BUCKETS),
         new_tokens=new, prefill_ms=prefill_ms[0],
         decode_step_p50_ms=float(np.percentile(step_ms, 50)),
         decode_step_p99_ms=float(np.percentile(step_ms, 99)),
         decode_steps=len(step_ms), output_tok_per_s=8 * new / wall,
         wall_s=wall, eos_rows=hit,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del model
    torch.cuda.empty_cache()


def cache_to_cpu(cache):
    """A copy on the CPU of a contiguous cache's tensors."""
    return dataclasses.replace(cache, **{
        f: getattr(cache, f).to("cpu", copy=True)
        for f in ("k", "v", "pos", "k_scale", "v_scale")
        if getattr(cache, f, None) is not None})


def int8_code_gap(fp_prefill, q_prefill):
    """Where the card's and the CPU's int8 codes after the prefill part,
    and why. ``fp_prefill``/``q_prefill``: each side's fp32 and int8 caches
    after the same prefill, on the CPU. The prefill attends to its own K/V
    unquantized, so each side's codes and scales are ``quantize_kv``, on
    that side's device, of the K/V its fp32 run stored (``reproduced``; on
    the CPU the card's scales, ``amax / 127``, can be one ulp off, counted
    in ``scales_off_on_the_cpu``: ATen's CUDA division by a scalar
    multiplies by its reciprocal). A code differs
    where the two sides' ``r = x / scale`` fall either side of a rounding
    boundary (k + 1/2): the boundary then lies within ``|r_card - r_cpu|``
    of the CPU's ``r``."""
    from neuronx_distributed_tpu_torch.inference.kv_cache import (
        PAD_POSITION, quantize_kv)

    out = dict(differing=0, total=0, max_step=0, scale_max_rel_diff=0.0,
               reproduced={"cuda": True, "cpu": True},
               scales_off_on_the_cpu=0,
               max_boundary_distance=0.0, max_r_diff=0.0,
               within_r_diff_of_boundary=0)
    real = q_prefill["cpu"].pos < PAD_POSITION
    for f in ("k", "v"):
        codes = {d: getattr(c, f)[:, real] for d, c in q_prefill.items()}
        scales = {d: getattr(c, f + "_scale")[:, real]
                  for d, c in q_prefill.items()}
        r = {}
        for d, c in fp_prefill.items():
            x = getattr(c, f)[:, real].float()
            q, sc = (t.cpu() for t in quantize_kv(x.to(d)))
            out["reproduced"][d] &= bool(torch.equal(q, codes[d]) and
                                         torch.equal(sc, scales[d]))
            if d != "cpu":
                out["scales_off_on_the_cpu"] += int(
                    (quantize_kv(x)[1] != sc).sum())
            r[d] = x / sc[..., None]
        step = (codes["cuda"].int() - codes["cpu"].int()).abs()
        diff = step > 0
        dist = (r["cpu"] - torch.floor(r["cpu"]) - 0.5).abs()
        rdiff = (r["cuda"] - r["cpu"]).abs()
        out["differing"] += int(diff.sum())
        out["total"] += step.numel()
        out["max_step"] = max(out["max_step"], int(step.max()))
        out["scale_max_rel_diff"] = max(out["scale_max_rel_diff"], float(
            ((scales["cuda"] - scales["cpu"]).abs() / scales["cpu"]).max()))
        if diff.any():
            out["max_boundary_distance"] = max(out["max_boundary_distance"],
                                               float(dist[diff].max()))
        out["max_r_diff"] = max(out["max_r_diff"], float(rdiff.max()))
        out["within_r_diff_of_boundary"] += int(
            (dist <= rdiff.max()).sum())
    return out


def phase_generate_cross_check(base_cfg, steps=4):
    """``prefill`` and ``steps`` greedy ``decode_step`` calls at full width,
    2 layers, fp32, B=3 ragged prompts, on the card and on the CPU path
    from the same weights, for a ``KVCache`` and a ``QuantizedKVCache``:
    logits within 1e-3 x max|logit| at every step. For the int8 cache it
    also finds where the two sides' codes part (``int8_code_gap``: no code
    more than one step apart) and runs each decode step a third time, on
    the CPU from a copy of the card's cache as it stood before the step:
    with the same codes the CPU must agree with the card within 1e-4 x
    max|logit|, so that the gap comes from the codes alone."""
    from neuronx_distributed_tpu_torch.inference import generation, kv_cache
    from neuronx_distributed_tpu_torch.models.llama import (build_model,
                                                            init_state_dict)

    cfg = dataclasses.replace(base_cfg, num_layers=2, dtype=torch.float32)
    sd = init_state_dict(cfg, seed=2, std=0.02)
    models = {dev: build_model(cfg, sd, dev) for dev in ("cuda", "cpu")}
    del sd
    ids, lens = ragged_prompts(3, 3, 20, 60, cfg.vocab_size)
    bucket = generation.pick_bucket(ids.shape[1], (64,))
    ids = np.pad(ids, ((0, 0), (0, bucket - ids.shape[1])))
    worst, cpu_s, toks = {}, 0.0, None
    prefilled = {}
    same_cache = 0.0
    for quantized in (False, True):
        logits, caches = {}, {}
        for dev, model in models.items():
            shape = (cfg.num_layers, 3, bucket + steps, cfg.num_kv_heads,
                     cfg.head_dim_)
            caches[dev] = (kv_cache.init_quantized_kv_cache(*shape,
                                                             device=dev)
                           if quantized else kv_cache.init_kv_cache(
                               *shape, dtype=torch.float32, device=dev))
        name = "quantized" if quantized else "fp32"
        worst[name] = 0.0
        for step in range(steps + 1):
            if quantized and step:
                card_cache = cache_to_cpu(caches["cuda"])
            for dev, model in models.items():
                t0 = time.perf_counter()
                if step == 0:
                    logits[dev], caches[dev] = generation.prefill(
                        model, torch.from_numpy(ids).to(dev),
                        torch.from_numpy(lens).to(dev), caches[dev])
                    prefilled[name, dev] = cache_to_cpu(caches[dev])
                else:
                    logits[dev], caches[dev] = generation.decode_step(
                        model, toks.to(dev),
                        torch.from_numpy(lens + step - 1).to(dev),
                        caches[dev])
                if dev == "cpu":
                    cpu_s += time.perf_counter() - t0
            diff = (logits["cuda"].cpu() - logits["cpu"]).abs().max().item()
            scale = logits["cpu"].abs().max().item()
            worst[name] = max(worst[name], diff / scale)
            if not diff <= 1e-3 * scale:
                raise AssertionError(
                    f"generate_cross_check: {name} step {step} max |diff| "
                    f"{diff} above 1e-3 x max|logit| ({scale})")
            if quantized and step:
                same, _ = generation.decode_step(
                    models["cpu"], toks, torch.from_numpy(lens + step - 1),
                    card_cache)
                same_cache = max(same_cache, (logits["cuda"].cpu() - same)
                                 .abs().max().item() / scale)
            toks = torch.argmax(logits["cpu"], dim=-1)   # both sides' next
    gap = int8_code_gap(
        {d: prefilled["fp32", d] for d in models},
        {d: prefilled["quantized", d] for d in models})
    gap["same_cache_max_rel_diff"] = same_cache
    if gap["max_step"] > 1 or not same_cache <= 1e-4 or not all(
            gap["reproduced"].values()):
        raise AssertionError(
            f"generate_cross_check: int8 codes {gap['max_step']} steps "
            f"apart, or {same_cache} of max|logit| between card and CPU "
            "from the same cache (above 1e-4), or codes that are not "
            f"quantize_kv of the fp32 run's K/V: {gap['reproduced']}")
    emit("generate_cross_check", layers=cfg.num_layers, batch=3,
         prompt_lens=lens.tolist(), decode_steps=steps, max_rel_diff=worst,
         tol=1e-3, int8_codes=gap, cpu_s=cpu_s)
    del models
    torch.cuda.empty_cache()


class Capture:
    """Wraps the function ``name`` of ``module`` while a path runs: every
    call goes through as before, and up to ``limit`` calls that ``want``
    picks (it sees the call's arguments) are kept as copies of their
    arguments and output, to hold a kernel to its plain version on the
    inputs the path gave it. Calls made on the CPU side's thread, which
    runs the same functions on host tensors meanwhile, are not kept (the
    autograd engine's threads, which run a backward's kernels, are).
    Positional arguments in ``by_ref`` (weights,
    which the path does not change) are kept by reference. With ``host``
    every tensor is copied to host memory instead (none by reference), so
    the copies take no room on the card while the path runs;
    :meth:`on_card` moves them back."""

    def __init__(self, module, name, want=None, limit=1, by_ref=(),
                 host=False):
        self.module, self.name, self.limit = module, name, limit
        self.want = want or (lambda *a, **kw: True)
        self.by_ref = () if host else by_ref
        self.host, self.calls = host, []

    def on_card(self):
        """The kept calls with every tensor moved to the card."""
        def back(a):
            if isinstance(a, tuple):
                return tuple(back(x) for x in a)
            return a.to("cuda") if isinstance(a, torch.Tensor) else a

        return [([back(a) for a in args], {k: back(v) for k, v in kw.items()},
                 back(out)) for args, kw, out in self.calls]

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def copy(a):
            if not self.host:
                return a.clone() if isinstance(a, torch.Tensor) else a
            if isinstance(a, tuple):
                return tuple(copy(x) for x in a)
            return (a.to("cpu", copy=True) if isinstance(a, torch.Tensor)
                    else a)

        def spy(*args, **kw):
            out = self.real(*args, **kw)
            if (len(self.calls) < self.limit and not on_cpu_side()
                    and self.want(*args, **kw)):
                self.calls.append(([a if i in self.by_ref else copy(a)
                                    for i, a in enumerate(args)],
                                   {k: copy(v) for k, v in kw.items()},
                                   copy(out)))
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def hold_glu(call, plain, tol=1e-2):
    """A grouped-GLU launch the path made (``Capture``'d), held element by
    element (``flash_rel_err``) to the plain version in fp32 on the same
    inputs, rounded once, as ``moe_vs_plain`` holds it; sentinel rows must
    be zero."""
    (xs, gate_up, down, be, bs, bi), _, got = call
    e = gate_up.shape[0]
    ref = plain(xs.float(), gate_up.float(), down.float(), be, bs,
                bi).to(xs.dtype)
    rel = flash_rel_err(got, ref)
    sent = torch.repeat_interleave(be >= e, bs)
    res = dict(rows=xs.shape[0], blocks=be.numel(),
               live_blocks=int((be < e).sum()), tol=tol, max_rel_err=rel,
               max_abs_err=(got.float() - ref.float()).abs().max().item())
    if not (rel <= tol) or not torch.isfinite(got).all() or got[sent].any():
        raise AssertionError(f"{plain.__name__} on the path's inputs: {res}, "
                             "or sentinel rows not zero")
    return res


def phase_generate_mixtral(cfg, steps=32):
    """``generation.prefill`` and ``decode_step`` given Mixtral's cached
    forward over a contiguous ``KVCache`` (the reference's ``generate`` is
    Llama-only): B=4 prompts of 100-500 tokens padded to 512, then
    ``steps`` greedy decode steps. Asserts K5 launched once per layer (the
    prefill: 4 x 512 tokens x top-2 > 8 experts) and K6 once per layer per
    decode step (4 tokens x top-2 <= 8 experts: sentinel metadata), and
    holds the first launch of each (layer 0 of the prefill, of the first
    decode step) to its plain version on the inputs the path gave it;
    returns the launch counts."""
    from neuronx_distributed_tpu_torch.inference import generation, kv_cache
    from neuronx_distributed_tpu_torch.models.mixtral import (
        build_model, init_state_dict, mixtral_forward_with_cache)
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as bm

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, init_state_dict(
        dataclasses.replace(cfg, param_dtype=cfg.dtype), seed=0, std=0.02))
    ids, lens = ragged_prompts(1, 4, 100, 500, cfg.vocab_size)
    bucket = generation.pick_bucket(ids.shape[1], (128, 512, 2048))
    ids = torch.from_numpy(np.pad(ids, ((0, 0), (0, bucket - ids.shape[1])))
                           ).cuda()
    plen = torch.from_numpy(lens).cuda()
    fwd = dict(forward=mixtral_forward_with_cache)

    def empty_cache():
        return kv_cache.init_kv_cache(
            cfg.num_layers, 4, bucket + generation.pick_bucket(
                steps, generation.DECODE_BUCKETS), cfg.num_kv_heads,
            cfg.head_dim_, dtype=cfg.dtype)

    generation.prefill(model, ids, plen, empty_cache(), **fwd)  # warm-up
    prefill = EventLog(generation.prefill)
    decode = EventLog(generation.decode_step)
    torch.cuda.synchronize()
    with Capture(bm, "grouped_glu_cuda", by_ref=(1, 2)) as k5, \
            Capture(bm, "grouped_glu_decode_cuda", by_ref=(1, 2)) as k6:
        bm.grouped_glu.launches = bm.grouped_glu_decode.launches = 0
        logits, cache = prefill(model, ids, plen, empty_cache(), **fwd)
        out, at = [], plen
        for _ in range(steps):
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
            logits, cache = decode(model, tok, at, cache, **fwd)
            at = at + 1
        torch.cuda.synchronize()
        launches = {"grouped_glu": bm.grouped_glu.launches,
                    "grouped_glu_decode": bm.grouped_glu_decode.launches}
    prefill_ms, step_ms = prefill.ms(), decode.ms()
    out = torch.stack(out, 1).cpu()
    nl = cfg.num_layers
    want = {"grouped_glu": nl, "grouped_glu_decode": nl * steps}
    if launches != want:
        raise AssertionError(f"generate_mixtral: launches {launches}, want "
                             f"{want}")
    if not torch.isfinite(logits).all() or not (
            (out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError("generate_mixtral: non-finite logits or ids "
                             "outside the vocabulary")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del cache
    held = {"grouped_glu": hold_glu(k5.calls[0], bm.grouped_glu_plain),
            "grouped_glu_decode": hold_glu(k6.calls[0],
                                           bm.grouped_glu_decode_plain)}
    emit("generate_mixtral", layers=nl, dtype=str(cfg.dtype), batch=4,
         prompt_tokens=int(lens.sum()), bucket=bucket, decode_steps=steps,
         launches=launches, prefill_ms=prefill_ms[0],
         decode_step_p50_ms=float(np.percentile(step_ms, 50)),
         decode_step_p99_ms=float(np.percentile(step_ms, 99)),
         held_to_plain=held, peak_mem_gib=peak)
    del model, k5, k6
    torch.cuda.empty_cache()
    return launches


def shared_prefix_prompts(seed, n, prefix_len, lo, hi, vocab):
    """``n`` prompts: one ``prefix_len``-token system prompt, then each its
    own suffix of ``lo``-``hi`` tokens whose first token differs from the
    first request's."""
    rng = np.random.RandomState(seed)
    system = rng.randint(0, vocab, prefix_len).tolist()
    suffixes = []
    for i in range(n):
        suf = rng.randint(0, vocab, rng.randint(lo, hi + 1)).tolist()
        if i and suf[0] == suffixes[0][0]:
            suf[0] = (suf[0] + 1) % vocab
        suffixes.append(suf)
    return [system + suf for suf in suffixes]


def serve_shared(eng, prompts, new):
    """Request 0 alone until it has its first token, then the rest at
    once; returns each request's tokens and the wall seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.submit(prompts[0], new, uid="r0")
    while eng.stats.tokens_generated == 0:
        eng.step()
    for i in range(1, len(prompts)):
        eng.submit(prompts[i], new, uid=f"r{i}")
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [u for u, r in res.items()
           if r.status != "completed" or len(r.tokens) != new]
    if len(res) != len(prompts) or bad:
        raise AssertionError(f"requests not completed: {bad}")
    return [res[f"r{i}"].tokens for i in range(len(prompts))], wall


def hold_k1(call, clones, tol=2e-2):
    """A K1 launch the path made (``Capture``'d) over shared and cloned
    tables: the distinct tables of the step, the pool blocks two or more
    of them map (shared), the clones' destinations they map (cloned), and
    the launch's output against the plain version on the same inputs
    within ``tol``; a second launch on the same inputs gives the same
    bits."""
    from neuronx_distributed_tpu_torch.ops import paged_attention as pa

    args, kw, got = call
    tables = np.unique(args[4].cpu().numpy(), axis=0)
    owners = {}
    for row in tables:
        for b in set(row[row >= 0].tolist()):
            owners[b] = owners.get(b, 0) + 1
    ref = pa.paged_attention_plain(*args, **kw)
    again = pa.paged_attention_cuda(*args, **kw)
    res = dict(tokens=args[0].shape[0], distinct_tables=len(tables),
               shared_blocks=sum(n >= 2 for n in owners.values()),
               cloned_blocks=len(set(clones) & set(owners)), tol=tol,
               max_abs_err=(got.float() - ref.float()).abs().max().item(),
               same_bits_again=bool(torch.equal(got, again)))
    if not (res["max_abs_err"] <= tol) or not torch.isfinite(got).all() \
            or not res["shared_blocks"] or not res["cloned_blocks"] \
            or not res["same_bits_again"]:
        raise AssertionError(f"serve_prefix: K1 on the path's inputs {res}")
    return res


def phase_serve_prefix(cfg, ecfg, new=64, prefix_len=1000):
    """``ServingEngine`` with ``prefix_sharing=True`` on 8 requests that
    share a ``prefix_len``-token system prompt (62 full blocks of 16 and 8
    tokens, so every sharer maps a partial tail and clones it) and add
    16-256 tokens each; then the same requests without sharing. Asserts the
    hit tokens, the clones, one step shape, K1 launched once per layer per
    step over the shared and cloned tables, and an empty pool after the
    trie's release; holds K1 at layer 0 of two steps of the sharing run
    (the first after the last clone, and 16 steps later) to its plain
    version on the inputs the path gave it (``hold_k1``); returns K1's
    launches."""
    from neuronx_distributed_tpu_torch.inference import engine as em
    from neuronx_distributed_tpu_torch.inference.engine import ServingEngine
    from neuronx_distributed_tpu_torch.models import llama
    from neuronx_distributed_tpu_torch.models.llama import init_state_dict
    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention)

    sd = init_state_dict(dataclasses.replace(cfg, param_dtype=cfg.dtype),
                         seed=0, std=0.02)
    prompts = shared_prefix_prompts(0, 8, prefix_len, 16, 256,
                                    cfg.vocab_size)
    runs, tokens = {}, {}
    for sharing in (True, False):
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(cfg, sd, dataclasses.replace(
            ecfg, prefix_sharing=sharing))
        picked = []

        def after_clones(*args, eng=eng, **kw):
            """Layer 0 of the first step after the last clone, and of the
            step 16 later (the first call of each step)."""
            s = eng.stats.steps
            if eng.stats.cow_copies < len(prompts) - 1 or s in picked or (
                    picked and s != picked[0] + 16):
                return False
            picked.append(s)
            return True

        with Capture(llama, "paged_attention", want=after_clones,
                     limit=2 if sharing else 0) as k1, \
                Capture(em, "cow_copy_blocks", limit=len(prompts)) as cow:
            paged_attention.launches = 0
            tokens[sharing], wall = serve_shared(eng, prompts, new)
            launches = paged_attention.launches
        rep = eng.stats.report()
        runs["sharing" if sharing else "no_sharing"] = dict(
            steps=eng.stats.steps, prefill_tokens=eng.stats.prefill_tokens,
            prefix_hit_tokens=eng.stats.prefix_hit_tokens,
            cow_copies=eng.stats.cow_copies,
            output_tok_per_s=len(prompts) * new / wall, wall_s=wall,
            ttft_p50_ms=rep["ttft_p50_ms"], ttft_p99_ms=rep["ttft_p99_ms"],
            step_latency_p50_ms=rep["step_latency_p50_ms"],
            step_latency_p99_ms=rep["step_latency_p99_ms"],
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        if eng.compile_count() != 1:
            raise AssertionError(f"serve_prefix: {eng.compile_count()} step "
                                 "shapes")
        if sharing:
            k1_launches = launches
            want = cfg.num_layers * eng.worker_runs["packed"]
            hits = (len(prompts) - 1) * prefix_len
            if launches != want or eng.stats.prefix_hit_tokens != hits or \
                    eng.stats.cow_copies != len(prompts) - 1:
                raise AssertionError(
                    f"serve_prefix: K1 launches {launches} (want {want}), "
                    f"hit tokens {eng.stats.prefix_hit_tokens} (want "
                    f"{hits}), clones {eng.stats.cow_copies} (want "
                    f"{len(prompts) - 1})")
            clones = [int(d) for args, _, _ in cow.calls for d in args[2]]
            if len(k1.calls) != 2:
                raise AssertionError(f"serve_prefix: {len(k1.calls)} K1 "
                                     "launches captured after the clones")
            k1_held = [dict(step=s, **hold_k1(c, clones))
                       for s, c in zip(picked, k1.calls)]
            del k1, cow
            eng.release_prefix_cache()
            if eng.allocator.num_allocated != 0:
                raise AssertionError(
                    f"serve_prefix: {eng.allocator.num_allocated} blocks "
                    "still allocated after the trie's release")
        del eng
        torch.cuda.empty_cache()
    same = [np.asarray(a) == np.asarray(b)
            for a, b in zip(tokens[True], tokens[False])]
    diverge = [(i, int(np.argmin(m))) for i, m in enumerate(same)
               if not m.all()]
    emit("serve_prefix", layers=cfg.num_layers, dtype=str(cfg.dtype),
         requests=len(prompts), prefix_tokens=prefix_len,
         prompt_tokens=sum(map(len, prompts)), new_tokens=len(prompts) * new,
         k1_launches=k1_launches, k1_held_to_plain=k1_held, runs=runs,
         greedy_match_share=float(np.mean(np.concatenate(same))),
         first_divergence=diverge[:8])
    del sd
    torch.cuda.empty_cache()
    return k1_launches


def phase_prefix_cross_check(base_cfg, new=8):
    """Prefix sharing at full width, 2 layers, fp32, block 16: a 40-token
    shared prefix (2 full blocks and 8 tokens), three requests, fp32 and
    int8 pools. Greedy ids with sharing equal those without, on the card;
    ``cow_copy_blocks`` on the card writes the same pool rows as on the CPU
    from the same pool, bit for bit."""
    from neuronx_distributed_tpu_torch.inference.engine import (
        EngineConfig, ServingEngine)
    from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION
    from neuronx_distributed_tpu_torch.inference.paging import (
        cow_copy_blocks)
    from neuronx_distributed_tpu_torch.models.llama import init_state_dict

    cfg = dataclasses.replace(base_cfg, num_layers=2, dtype=torch.float32)
    sd = init_state_dict(cfg, seed=4, std=0.02)
    prompts = shared_prefix_prompts(5, 3, 40, 8, 20, cfg.vocab_size)
    ecfg = EngineConfig(block_size=16, num_blocks=64, max_slots=4,
                        max_blocks_per_seq=8, token_budget=64)
    out = {}
    for quantized in (False, True):
        tokens = {}
        for sharing in (True, False):
            eng = ServingEngine(cfg, sd, dataclasses.replace(
                ecfg, quantized=quantized, prefix_sharing=sharing))
            tokens[sharing], _ = serve_shared(eng, prompts, new)
            if sharing:
                if (eng.stats.prefix_hit_tokens != 80
                        or eng.stats.cow_copies != 2):
                    raise AssertionError(
                        f"prefix_cross_check: hit tokens "
                        f"{eng.stats.prefix_hit_tokens}, clones "
                        f"{eng.stats.cow_copies} (want 80, 2)")
                shared_pool = eng.cache
        name = "int8" if quantized else "fp32"
        if tokens[True] != tokens[False]:
            raise AssertionError(f"prefix_cross_check: {name} greedy ids "
                                 "differ with prefix sharing")
        # clone six written blocks, rows cut at six points, into five
        # unwritten blocks and the first source (read before it is written)
        used = [int(b) for b in torch.nonzero(
            (shared_pool.pos < PAD_POSITION).any(1)).flatten()[:6]]
        free = [b for b in range(ecfg.num_blocks) if b not in used][-5:]
        src, dst = used, free + used[:1]
        keep = [0, 5, 16, 40, 1000, PAD_POSITION]
        cpu = dataclasses.replace(shared_pool, **{
            f: getattr(shared_pool, f).cpu() for f in
            ("k", "v", "pos", "k_scale", "v_scale")
            if getattr(shared_pool, f, None) is not None})
        cow_copy_blocks(shared_pool, src, dst, keep)
        cow_copy_blocks(cpu, src, dst, keep)
        for f in ("k", "v", "pos", "k_scale", "v_scale"):
            a = getattr(shared_pool, f, None)
            if a is not None and not torch.equal(a.cpu(), getattr(cpu, f)):
                raise AssertionError(f"prefix_cross_check: {name} "
                                     f"cow_copy_blocks' {f} differs")
        out[name] = dict(requests=len(prompts), cow_checked_blocks=len(src),
                         greedy_ids_equal=True)
        del eng, shared_pool, cpu
    emit("prefix_cross_check", layers=cfg.num_layers, prefix_tokens=40,
         runs=out)
    del sd
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 22-24: the Trainer entry point
# ---------------------------------------------------------------------------

def free_cuda():
    """Hand the caching allocator's free blocks back, with no garbage
    collection: a model that a phase dropped must already be freed, as a
    user who builds the next model in the same process needs it to be."""
    torch.cuda.empty_cache()


def memory_base():
    """Allocated bytes once the current stream has its cuBLAS workspace
    (made by the process's first product on it, and kept)."""
    torch.ones(8, 8, device="cuda") @ torch.ones(8, 8, device="cuda")
    free_cuda()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def check_freed(label, base, slack=64 * 2 ** 20):
    """Raise when more than ``slack`` bytes (the capture stream's cuBLAS
    workspace, made once) stay allocated over ``base`` (``memory_base``)
    once a phase dropped its objects; names the engines, captures and
    caches still alive and what refers to them."""
    import gc

    from neuronx_distributed_tpu_torch.inference import aot_cache as ac
    from neuronx_distributed_tpu_torch.inference import engine as te

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    if held > slack:
        live = [(type(o).__name__, sorted({type(r).__name__ for r in
                                           gc.get_referrers(o)}))
                for o in gc.get_objects()
                if isinstance(o, (te.ServingEngine, ac.CapturedStep,
                                  ac.AotExecutableCache))]
        raise AssertionError(f"{label}: {held / 2 ** 30:.3f} GiB still "
                             f"allocated after the phase; alive: {live}")
    return held


def token_file(directory, vocab, seq, n_seqs=64, seed=0):
    """A flat uint32 token file of ``n_seqs`` sequences of ``seq + 1``
    tokens from numpy ``RandomState(seed)``."""
    path = os.path.join(directory, "tokens.bin")
    np.random.RandomState(seed).randint(
        0, vocab, n_seqs * (seq + 1)).astype(np.uint32).tofile(path)
    return path


class StepClock:
    """A ``Trainer`` callback: the wall time from one step's end to the
    next, each ended by ``torch.cuda.synchronize()``: the other callbacks
    of the step before, the loader's next batch and the step."""

    def __init__(self):
        self.ms, self.losses, self._t = [], [], None

    def on_train_start(self, trainer):
        torch.cuda.synchronize()
        self._t = time.perf_counter()

    def on_step_end(self, trainer, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.ms.append((now - self._t) * 1e3)
        self.losses.append(metrics["loss"].item())
        self._t = now

    def on_eval_end(self, trainer, metrics):
        pass

    def on_train_end(self, trainer):
        pass


def loop_model(layers, seed=0, mode="full", compute="bfloat16",
               step_kw=None, **cfg_kw):
    """``LLAMA3_8B`` widths at ``layers`` layers through
    ``configure_model`` with ``ActivationCheckpointConfig(mode)`` (remat
    on unless ``"none"``) and ``compute`` as the compute dtype, fp32
    params, flash attention, random weights (``seed``, std 0.02); AdamW lr
    1e-4 clipped at 1.0; ``step_kw`` goes to ``make_train_step``."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import (
        ActivationCheckpointConfig, MixedPrecisionConfig, OptimizerConfig,
        configure_model, neuronx_distributed_config)
    from neuronx_distributed_tpu_torch.models.llama import LLAMA3_8B

    ncfg = neuronx_distributed_config(
        optimizer_config=OptimizerConfig(grad_clipping=True,
                                         max_grad_norm=1.0),
        activation_checkpoint_config=ActivationCheckpointConfig(mode=mode),
        mixed_precision_config=MixedPrecisionConfig(compute_dtype=compute))
    cfg = configure_model(ncfg, dataclasses.replace(
        LLAMA3_8B, num_layers=layers, param_dtype=torch.float32,
        use_flash_attention=True, **cfg_kw))
    pm, params = trainer.initialize_parallel_model(ncfg, cfg, seed=seed,
                                                   std=0.02)
    tx, state = trainer.initialize_parallel_optimizer(pm, params,
                                                      learning_rate=1e-4)
    return cfg, pm, state, trainer.make_train_step(pm, tx, **(step_kw or {}))


def phase_train_loop(workdir, depths=(4, 12), steps=8, seq=4096):
    """``Trainer.fit`` with remat (``save_attention``), the chunked loss
    (512), ``TokenBatchLoader`` batches, ``MetricsLogger(every=1)`` and
    ``Watchdog(policy="halt")``, ``steps`` steps at each depth; K2, K3 and
    K4 each launched layers x steps. Returns the launches of the last
    depth."""
    from neuronx_distributed_tpu_torch.data import TokenBatchLoader
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_tpu_torch.resilience.watchdog import Watchdog
    from neuronx_distributed_tpu_torch.trainer import MetricsLogger, Trainer

    counters = {name: getattr(fa, name) for name, _ in FLASH_KERNELS}
    tokens = token_file(workdir, 128256, seq)
    for layers in depths:
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        cfg, pm, state, step = loop_model(layers,
                                          remat_policy="save_attention",
                                          loss_chunk=512)
        loader = TokenBatchLoader(tokens, batch=1, seqlen=seq, seed=0,
                                  dtype="uint32", nthreads=2)
        if not loader.native:
            raise AssertionError("train_loop: the native loader did not "
                                 "build")
        clock = StepClock()
        trainer = Trainer(step, state, callbacks=[
            clock, MetricsLogger(every=1), Watchdog(policy="halt")])
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        trainer.fit(loader, max_steps=steps)
        launches = {name: c.launches for name, c in counters.items()}
        loader.close()
        if trainer.host_step != steps or state.step != steps:
            raise AssertionError(f"train_loop: {trainer.host_step} steps, "
                                 f"want {steps}")
        if not np.isfinite(clock.losses).all():
            raise AssertionError(f"train_loop: losses {clock.losses}")
        for name, n in launches.items():
            if n != layers * steps:
                raise AssertionError(
                    f"train_loop: {name} launched {n} times at {layers} "
                    f"layers, want layers x steps = {layers * steps}")
        p50 = float(np.median(clock.ms))
        emit("train_loop", layers=layers, steps=steps, seq=seq,
             params=sum(p.numel() for p in state.params.values()),
             remat_policy=cfg.remat_policy, loss_chunk=cfg.loss_chunk,
             compute_dtype=str(cfg.dtype), native_loader=loader.native,
             losses=clock.losses, step_ms=clock.ms, step_ms_p50=p50,
             step_ms_p99=float(np.percentile(clock.ms, 99)),
             tokens_per_s=seq / (p50 / 1e3),
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             launches=launches)
        del pm, state, step, trainer
    free_cuda()
    return launches


def timed_checkpoint(path, every, num_kept):
    """A ``CheckpointCallback`` that also records, for each save, the time
    the loop blocks in it (the snapshot to host memory) and the seconds
    until the tag's done-marker lands (the commit)."""
    from neuronx_distributed_tpu_torch.trainer import CheckpointCallback

    class Timed(CheckpointCallback):
        def __init__(self):
            super().__init__(path, every=every, num_kept=num_kept)
            self.block_s, self.commit_s, self.waiters = [], [], []

        def on_step_end(self, trainer, metrics):
            saved = self._last_saved
            t0 = time.perf_counter()
            super().on_step_end(trainer, metrics)
            if self._last_saved == saved:
                return
            self.block_s.append(time.perf_counter() - t0)
            marker = os.path.join(path, str(self._last_saved), "checkpoint")

            def wait():
                while not os.path.isfile(marker):
                    time.sleep(0.01)
                self.commit_s.append(time.perf_counter() - t0)

            self.waiters.append(threading.Thread(target=wait, daemon=True))
            self.waiters[-1].start()

    return Timed()


class StepFingerprints:
    """A ``Trainer`` callback keeping each cadence step's
    ``integrity_fp`` (a copy)."""

    def __init__(self):
        self.fps = {}

    def on_train_start(self, trainer):
        pass

    def on_step_end(self, trainer, metrics):
        fp = metrics.get("integrity_fp")
        if fp is not None and fp.any():
            self.fps[trainer.host_step] = fp.clone()

    def on_eval_end(self, trainer, metrics):
        pass

    def on_train_end(self, trainer):
        pass


def phase_train_resume(workdir, seq=4096, steps=6):
    """Full width, 1 layer, ``tie_embeddings``, the full-logits loss, the
    step built with ``integrity_every=2``: run A trains ``steps`` batches;
    run B trains 4 with async checkpoints every 2 (``num_kept=1``) and an
    ``IntegrityMonitor(every=2)`` whose chaos plan flips a bit of the
    largest parameter at the step-4 boundary, after that step's save: the
    monitor must detect it there, and its ``Watchdog(policy="rewind")``
    restore the newest verified tag, whose fingerprint must be the step's
    own. B and the resume run under a storage plan that throws transient
    faults on ``save_text``, which the commits heal. Then a new model
    resumes through ``Trainer(resume_path=...)`` and trains the rest; B's
    losses and the final params must equal A's bit for bit."""
    from neuronx_distributed_tpu_torch.data import TokenBatchLoader
    from neuronx_distributed_tpu_torch.resilience.chaos import (
        FaultPlan, wrapper_for_plan)
    from neuronx_distributed_tpu_torch.resilience.integrity import (
        IntegrityMonitor, fingerprint_tree)
    from neuronx_distributed_tpu_torch.resilience.watchdog import Watchdog
    from neuronx_distributed_tpu_torch.trainer import Trainer
    from neuronx_distributed_tpu_torch.trainer import checkpoint as ck
    from neuronx_distributed_tpu_torch.trainer import checkpoint_storage

    free_gib = shutil.disk_usage(workdir).free / 2 ** 30
    loader = TokenBatchLoader(token_file(workdir, 128256, seq, seed=1),
                              batch=1, seqlen=seq, seed=1, dtype="uint32")
    batches = [loader.next_batch() for _ in range(steps)]
    loader.close()
    kw = dict(tie_embeddings=True, remat_policy="nothing",
              step_kw=dict(integrity_every=2))

    def run(batches, callbacks=(), seed=0, resume=None):
        cfg, pm, state, step = loop_model(1, seed=seed, **kw)
        clock = StepClock()
        trainer = Trainer(step, state, callbacks=[clock, *callbacks],
                          resume_path=resume)
        trainer.fit(iter(batches), max_steps=steps)
        return pm, state, clock.losses

    pm, state_a, losses_a = run(batches)
    want = {n: p.detach().clone() for n, p in state_a.params.items()}
    n_params = sum(p.numel() for p in want.values())
    del pm, state_a
    free_cuda()
    path = os.path.join(workdir, "ckpt")
    saver = timed_checkpoint(path, every=2, num_kept=1)
    watchdog = Watchdog(policy="rewind", checkpoint_path=path)
    monitor = IntegrityMonitor(every=2, watchdog=watchdog, chaos=FaultPlan.parse(
        "seed=5; integrity|params : bitflip, after=1, times=1"))
    fps = StepFingerprints()
    storage_plan = FaultPlan.parse(
        "seed=1; save_text : transient, p=0.5, times=3")
    checkpoint_storage.install_storage_wrapper(wrapper_for_plan(
        storage_plan, base_delay=0.01, max_delay=0.05))
    try:
        pm, state_b, losses_b = run(batches[:4], [saver, fps, monitor])
        for waiter in saver.waiters:
            waiter.join(timeout=600)
        rewound_fp = fingerprint_tree(state_b.params)
        tags = ck.list_complete_tags(path)
        tag_bytes = sum(os.path.getsize(os.path.join(r, f))
                        for r, _, fs in os.walk(os.path.join(path, tags[-1]))
                        for f in fs)
        del pm, state_b
        free_cuda()
        t0 = time.perf_counter()
        pm, state_c, losses_c = run(batches[4:], seed=1, resume=path)
        resume_s = time.perf_counter() - t0
    finally:
        checkpoint_storage.clear_storage_wrapper()
    if (monitor.flips_injected, monitor.mismatches, monitor.checks,
            watchdog.anomalies) != (1, 1, 2, 1):
        raise AssertionError(
            f"train_resume: flips {monitor.flips_injected}, mismatches "
            f"{monitor.mismatches}, checks {monitor.checks}, rewinds "
            f"{watchdog.anomalies}; want 1, 1, 2, 1 (the step-4 boundary)")
    if not torch.equal(rewound_fp, fps.fps[4]):
        raise AssertionError("train_resume: the rewound parameters' "
                             "fingerprint is not step 4's")
    if not storage_plan.fire_count():
        raise AssertionError("train_resume: the storage plan fired nothing")
    if tags != ["4"]:
        raise AssertionError(f"train_resume: complete tags {tags}, want "
                             "['4'] (num_kept=1)")
    if losses_b != losses_a[:4] or losses_c != losses_a[4:]:
        raise AssertionError(f"train_resume: losses {losses_b} + "
                             f"{losses_c} differ from the uninterrupted "
                             f"{losses_a}")
    differ = [n for n, p in state_c.params.items()
              if not torch.equal(p, want[n])]
    if differ or state_c.step != steps:
        raise AssertionError(f"train_resume: step {state_c.step}, params "
                             f"not bitwise equal: {differ}")
    emit("train_resume", layers=1, tie_embeddings=True, params=n_params,
         seq=seq, steps=steps, losses=losses_a, resumed_losses=losses_c,
         bitwise=True, bitflip_detected_at=4, rewound_to_tag=4,
         rewound_fingerprint_is_step_4s=True,
         storage_faults_healed=storage_plan.fire_count(),
         storage_faults=storage_plan.injected[:8],
         free_disk_gib=free_gib, tag_bytes=tag_bytes,
         saves=len(saver.block_s), bytes_written=tag_bytes * len(
             saver.block_s), save_block_s=saver.block_s,
         commit_s=sorted(saver.commit_s),
         resume_s_with_two_steps=resume_s)
    del pm, state_c, want
    free_cuda()


LOOP_CROSS_KW = dict(remat=True, remat_policy="save_attention", loss_chunk=64)


def phase_train_loop_cross_check(base_cfg, cpu_side, seq=4096):
    """fp32 card against the CPU with remat and the chunked loss (phase
    9's limits; the CPU half from ``cpu_side``), then on the
    card, in fp32 and bf16 at S=4096, the gradients under
    ``save_attention`` and ``"nothing"`` remat equal to those without, bit
    for bit, with K2 launched layers or 2 x layers times and K3/K4 layers
    times."""
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_tpu_torch.scripts.workloads import train_batch

    phase_train_cross_check(base_cfg, cpu_side, seq=256,
                            phase="train_loop_cross_check", **LOOP_CROSS_KW)
    counters = [getattr(fa, name) for name, _ in FLASH_KERNELS]
    batch = train_batch(base_cfg.vocab_size, seq, seed=2)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        ref = None
        for policy in (None, "save_attention", "nothing"):
            cfg, pm, state, _ = loop_model(
                2, mode="full" if policy else "none",
                compute=str(dtype).split(".")[-1], loss_chunk=512,
                remat_policy=policy or "nothing")
            torch.cuda.synchronize()
            before = [c.launches for c in counters]
            loss = pm.module.loss(batch["input_ids"].cuda(),
                                  batch["labels"].cuda())
            loss.backward()
            torch.cuda.synchronize()
            launched = [c.launches - b for c, b in zip(counters, before)]
            k2 = cfg.num_layers * (2 if policy == "nothing" else 1)
            if (launched != [k2, cfg.num_layers, cfg.num_layers]
                    or cfg.dtype != dtype or cfg.remat != bool(policy)):
                raise AssertionError(f"train_loop_cross_check: {dtype} "
                                     f"{policy}: launches {launched}")
            grads = {n: p.grad for n, p in pm.module.named_parameters()}
            if ref is None:
                ref = (loss.detach(), grads)
            else:
                differ = [n for n, g in grads.items()
                          if not torch.equal(g, ref[1][n])]
                if differ or not torch.equal(loss.detach(), ref[0]):
                    raise AssertionError(
                        f"train_loop_cross_check: {dtype} {policy}: remat "
                        f"gradients not bitwise: {differ}")
            out[f"{str(dtype).split('.')[-1]}_{policy or 'no_remat'}"] = (
                launched)
            del pm, state, grads, loss
        del ref
        free_cuda()
    emit("train_loop_remat_bitwise", layers=2, seq=seq, launches=out,
         bitwise=True)
    check_scan_steps(base_cfg, seq)


def check_scan_steps(base_cfg, seq):
    """``make_train_step(scan_steps=2)`` at 2 layers (bf16 compute, no
    remat) on two batches stacked ``[2, 1, S]`` leaves the same
    parameters and Adam moments, bit for bit, as two single steps, and
    reports the second step's loss."""
    from neuronx_distributed_tpu_torch.scripts.workloads import train_batch

    batches = [train_batch(base_cfg.vocab_size, seq, seed=s) for s in (4, 5)]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    _, pm, state, step = loop_model(2, mode="none")
    for b in batches:
        _, single = step(state, b)
    want = ([p.detach().clone() for p in state.params.values()],
            [t.clone() for t in state.opt_state.mu + state.opt_state.nu])
    del pm, state, step
    free_cuda()
    _, pm, state, step = loop_model(2, mode="none",
                                    step_kw=dict(scan_steps=2))
    _, scanned = step(state, stacked)
    got = (list(state.params.values()),
           state.opt_state.mu + state.opt_state.nu)
    differ = sum(not torch.equal(a, b) for x, y in zip(got, want)
                 for a, b in zip(x, y))
    if (differ or state.step != 2 or not torch.equal(scanned["loss"],
                                                     single["loss"])):
        raise AssertionError(f"scan_steps: {differ} tensors differ from two "
                             f"single steps (step {state.step})")
    emit("scan_steps", layers=2, seq=seq, scan_steps=2, bitwise=True,
         loss=scanned["loss"].item())
    del pm, state, step, want, got
    free_cuda()


# ---------------------------------------------------------------------------
# phases 32-35: speculative decoding and session migration in the engine
# ---------------------------------------------------------------------------

def llama32_1b_widths(base):
    """Llama-3.2-1B's published widths (the ``meta-llama/Llama-3.2-1B``
    config: hidden 2048, 16 layers, 32 heads over 8 kv heads, head_dim 64,
    intermediate 8192, vocab 128256, tied embeddings, rope theta 500000),
    in ``base``'s dtypes and context length; no preset of the package."""
    return dataclasses.replace(
        base, hidden_size=2048, num_layers=16, num_heads=32, num_kv_heads=8,
        head_dim=64, intermediate_size=8192, vocab_size=128256,
        tie_embeddings=True, rope_theta=500000.0)


def spec_timer(eng):
    """A ``SpanTimer`` around an engine's two speculation workers (its
    ``now`` names the worker running, for ``Capture``'s ``want``)."""
    timer = SpanTimer()
    for name in ("spec_draft", "spec_verify"):
        timer.wrap(eng, f"_{name}_fn", name)
    return timer


def hold_and_time_k1(call, flush, tol=2e-2):
    """A K1 launch the path made (``Capture``'d): its output against the
    plain version on the same inputs within ``tol``, a second launch equal
    bit for bit, and the kernel's, the plain version's and SDPA's times
    beside the bound."""
    from neuronx_distributed_tpu_torch.ops import paged_attention as pa

    args, kw, got = call
    full = tuple(args) + (None,) * (8 - len(args))
    ref = pa.paged_attention_plain(*args, **kw)
    again = pa.paged_attention_cuda(*args, **kw)
    bound, by, nbytes, flops = paged_bound(full)
    res = dict(tokens=args[0].shape[0], heads=args[0].shape[1],
               head_dim=args[0].shape[2], table_width=args[4].shape[1],
               tol=tol,
               max_abs_err=(got.float() - ref.float()).abs().max().item(),
               same_bits_again=bool(torch.equal(got, again)),
               kernel_ms=time_ms(lambda: pa.paged_attention_cuda(*args,
                                                                 **kw),
                                 flush=flush),
               plain_ms=time_ms(lambda: pa.paged_attention_plain(*args,
                                                                 **kw),
                                reps=10, flush=flush),
               bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
    res["library_ms"] = time_ms(sdpa_on_gathered(full), flush=flush)
    if not (res["max_abs_err"] <= tol) or not torch.isfinite(got).all() \
            or not res["same_bits_again"]:
        raise AssertionError(f"K1 on the path's inputs: {res}")
    return res


def spec_launches_want(eng, target_layers, draft_layers, k):
    """K1 launches a speculating engine's run must make: the packed worker
    runs the target and the draft over its rows, the draft worker the
    draft k+1 times, the verify worker the target once."""
    runs = eng.worker_runs
    return ((target_layers + draft_layers) * runs["packed"]
            + draft_layers * (k + 1) * runs["spec_draft"]
            + target_layers * runs["spec_verify"])


def phase_serve_spec(cfg, ecfg, new=64, k=4, nb=2):
    """``ServingEngine`` with Llama-3-8B's widths at ``cfg``'s depth (4
    layers in the whole script) in bf16 (random weights, seed 0, std
    0.02) on 8 requests of 200-1000 prompt tokens,
    64 new tokens each: without speculation, with
    ``SpeculationConfig(k=4, num_branches=2)`` and a draft of Llama-3.2-1B's
    widths (seed 1), and with a self-draft. Asserts every request completes,
    one shape per worker, K1 launched once per layer per forward of each
    worker; holds K1's first launch in the draft worker (head_dim 64) and in
    the verify worker to its plain version on the inputs the path gave it,
    with the same bits on a relaunch, and times each; prints step p50/p99,
    each worker's device ms, accepted tokens per round, output tokens/s and
    the share of greedy ids equal to the run without speculation (recorded,
    not asserted: the verify worker's width gives other bf16 bits)."""
    from neuronx_distributed_tpu_torch.inference.engine import ServingEngine
    from neuronx_distributed_tpu_torch.inference.speculative import (
        SpeculationConfig)
    from neuronx_distributed_tpu_torch.models import llama
    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention)

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    bf16 = dict(param_dtype=cfg.dtype)
    sd = llama.init_state_dict(dataclasses.replace(cfg, **bf16), seed=0,
                               std=0.02)
    dcfg = llama32_1b_widths(cfg)
    dsd = llama.init_state_dict(dataclasses.replace(dcfg, **bf16), seed=1,
                                std=0.02)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in rng.randint(200, 1001, 8)]
    runs, tokens, held = {}, {}, {}
    for label, spec, draft in (("plain", False, None),
                               ("draft_1b", True, (dcfg, dsd)),
                               ("self_draft", True, None)):
        torch.cuda.reset_peak_memory_stats()
        kw = dict(draft_cfg=draft[0], draft_params=draft[1]) if draft else {}
        eng = ServingEngine(cfg, sd, dataclasses.replace(
            ecfg, speculation=SpeculationConfig(k, nb) if spec else None),
            **kw)
        timer = spec_timer(eng) if spec else None
        dl = (draft[0] if draft else cfg).num_layers
        pick = {}
        if spec:
            def want(q, *a, worker, **kw):
                return timer.now == worker and worker not in pick and \
                    pick.setdefault(worker, True)
        with Capture(llama, "paged_attention", limit=1 if spec else 0,
                     want=lambda *a, **kw: want(*a, worker="spec_draft",
                                                **kw)) as k1d, \
                Capture(llama, "paged_attention", limit=1 if spec else 0,
                        want=lambda *a, **kw: want(*a, worker="spec_verify",
                                                   **kw)) as k1v:
            paged_attention.launches = 0
            tokens[label], wall = serve_shared(eng, prompts, new)
            launches = paged_attention.launches
        rep = eng.stats.report()
        runs[label] = dict(
            steps=eng.stats.steps, worker_runs=dict(eng.worker_runs),
            k1_launches=launches, output_tok_per_s=len(prompts) * new / wall,
            wall_s=wall, step_latency_p50_ms=rep["step_latency_p50_ms"],
            step_latency_p99_ms=rep["step_latency_p99_ms"],
            ttft_p50_ms=rep["ttft_p50_ms"],
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        if set(eng.worker_compile_counts().values()) != {1}:
            raise AssertionError(f"serve_spec {label}: step shapes "
                                 f"{eng.worker_compile_counts()}")
        want_k1 = (spec_launches_want(eng, cfg.num_layers, dl, k) if spec
                   else cfg.num_layers * eng.worker_runs["packed"])
        if launches != want_k1 or launches == 0:
            raise AssertionError(f"serve_spec {label}: K1 launches "
                                 f"{launches}, want {want_k1}")
        if spec:
            if not (eng.worker_runs["spec_draft"]
                    and eng.worker_runs["spec_verify"]):
                raise AssertionError(f"serve_spec {label}: a speculation "
                                     f"worker never ran: {eng.worker_runs}")
            runs[label].update(
                spec_rounds=eng.stats.spec_rounds,
                accepted_per_round=rep["spec_accept_mean"],
                workers=timer.per_call(),
                draft_layers=dl, draft_head_dim=(draft[0] if draft
                                                  else cfg).head_dim_)
            if len(k1d.calls) != 1 or len(k1v.calls) != 1:
                raise AssertionError(f"serve_spec {label}: K1 launches "
                                     "captured in the workers: "
                                     f"{len(k1d.calls)}, {len(k1v.calls)}")
            held[label] = {
                "spec_draft": hold_and_time_k1(k1d.calls[0], flush),
                "spec_verify": hold_and_time_k1(k1v.calls[0], flush)}
            timer.restore()     # the wrappers refer to the timer: no cycle
        del eng, k1d, k1v, timer
        torch.cuda.empty_cache()
    base = np.concatenate([np.asarray(t) for t in tokens["plain"]])
    share = {label: float(np.mean(np.concatenate(
        [np.asarray(t) for t in tokens[label]]) == base))
        for label in ("draft_1b", "self_draft")}
    emit("serve_spec", layers=cfg.num_layers, dtype=str(cfg.dtype),
         requests=len(prompts), prompt_tokens=sum(map(len, prompts)),
         new_tokens=len(prompts) * new, speculation_length=k,
         num_branches=nb, runs=runs, k1_held_to_plain=held,
         greedy_match_share=share)
    del sd, dsd, flush
    torch.cuda.empty_cache()
    return {label: r["k1_launches"] for label, r in runs.items()}, held


def first_parting(a, b):
    """Index of the first position where two id lists differ, or None."""
    for j, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return j
    return None if len(a) == len(b) else min(len(a), len(b))


SPEC_CROSS = dict(new=8, k=3, nb=2)


def spec_cross_setup(base_cfg):
    """``spec_cross_check``'s model (full width, 2 layers, fp32), its
    1-layer draft's config, three prompts of 20-40 tokens and the engine
    config (block 16)."""
    from neuronx_distributed_tpu_torch.inference.engine import EngineConfig

    cfg = dataclasses.replace(base_cfg, num_layers=2, dtype=torch.float32)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in rng.randint(20, 41, 3)]
    ecfg = EngineConfig(block_size=16, num_blocks=64, max_slots=3,
                        max_blocks_per_seq=8, token_budget=32)
    return cfg, dataclasses.replace(cfg, num_layers=1), prompts, ecfg


def spec_run(cfg, sd, ecfg, prompts, dev, speculate, draft):
    """One ``spec_cross_check`` run on ``dev`` (None: the card): the
    greedy ids, the engine's counts and its model."""
    from neuronx_distributed_tpu_torch.inference.engine import ServingEngine
    from neuronx_distributed_tpu_torch.inference.speculative import (
        SpeculationConfig)

    spec = SpeculationConfig(SPEC_CROSS["k"], SPEC_CROSS["nb"])
    kw = dict(draft_cfg=draft[0], draft_params=draft[1]) if draft else {}
    eng = ServingEngine(cfg, sd, dataclasses.replace(
        ecfg, speculation=spec if speculate else None), device=dev, **kw)
    ids, _ = serve_shared(eng, prompts, SPEC_CROSS["new"])
    stats = dict(steps=eng.stats.steps, spec_rounds=eng.stats.spec_rounds,
                 accepted=eng.stats.spec_accepted_tokens,
                 worker_runs=dict(eng.worker_runs))
    return ids, stats, eng.model


def spec_cpu_half(base_cfg):
    """The CPU half of ``spec_cross_check`` (run by :class:`CpuSide`): the
    weights (seed 4) and the 1-layer draft's (seed 7), made on the host,
    and the CPU path's runs without and with the self-draft."""
    from neuronx_distributed_tpu_torch.models.llama import init_state_dict

    cfg, dcfg, prompts, ecfg = spec_cross_setup(base_cfg)
    sd = init_state_dict(cfg, seed=4, std=0.02, device="cpu")
    dsd = init_state_dict(dcfg, seed=7, std=0.02, device="cpu")
    runs = {}
    for label, speculate in (("cpu_plain", False), ("cpu_self_draft", True)):
        ids, stats, _ = spec_run(cfg, sd, ecfg, prompts, "cpu", speculate,
                                 None)
        runs[label] = (ids, stats)
    return dict(sd=sd, dsd=dsd, runs=runs)


def phase_spec_cross_check(base_cfg, cpu_side=None):
    """Speculation at full width, 2 layers, fp32, block 16: three requests
    of 20-40 prompt tokens, 8 new tokens, served on the card without
    speculation, with a self-draft and with a 1-layer draft (seed 7), and
    on the CPU without and with the self-draft (the CPU half and the
    weights, made on the host, from ``cpu_side``, else computed here).
    Every run's greedy ids must
    equal the card's run without speculation; two runs may part only at a
    near tie: the top-2 gap of the reference's logits at the parting
    position under 1e-4 x max|logit| (each parting is printed with its
    gap)."""
    cfg, dcfg, prompts, ecfg = spec_cross_setup(base_cfg)
    half = (cpu_side.result("spec_cross_check") if cpu_side is not None
            else spec_cpu_half(base_cfg))
    sd = {k: v.to("cuda") for k, v in half.pop("sd").items()}
    dsd = {k: v.to("cuda") for k, v in half.pop("dsd").items()}
    # (run, speculate, draft) on the card
    plans = [("card_plain", False, None),
             ("card_self_draft", True, None),
             ("card_draft_1l", True, (dcfg, dsd))]
    ids, stats, ref_model = {}, {}, None
    for label, speculate, draft in plans:
        ids[label], stats[label], model = spec_run(
            cfg, sd, ecfg, prompts, None, speculate, draft)
        if label == "card_plain":
            ref_model = model
        del model
    for label, (got, st) in half["runs"].items():
        ids[label], stats[label] = got, st
    for label in ("card_self_draft", "card_draft_1l", "cpu_self_draft"):
        if not stats[label]["spec_rounds"]:
            raise AssertionError(f"spec_cross_check {label}: no round ran")
    partings = []
    for label in ids:
        for r, (got, want) in enumerate(zip(ids[label], ids["card_plain"])):
            j = first_parting(got, want)
            if j is None:
                continue
            seq = torch.tensor([prompts[r] + want[:j]],
                               device=ref_model.embed.embedding.device)
            with torch.no_grad():
                logits = ref_model(seq)[0, -1].float()
            top = torch.topk(logits, 2).values
            gap = (top[0] - top[1]).item()
            limit = 1e-4 * logits.abs().max().item()
            partings.append(dict(run=label, request=r, position=j,
                                 top2_gap=gap, limit=limit))
            if not gap < limit:
                raise AssertionError(
                    f"spec_cross_check: {label} request {r} parts from the "
                    f"card's plain ids at {j} with a top-2 gap {gap} not "
                    f"under {limit}")
    emit("spec_cross_check", layers=cfg.num_layers, requests=len(prompts),
         new_tokens=SPEC_CROSS["new"], speculation_length=SPEC_CROSS["k"],
         num_branches=SPEC_CROSS["nb"], runs=stats, partings=partings,
         ids_equal={label: ids[label] == ids["card_plain"] for label in ids})
    del ref_model, sd, dsd, half
    torch.cuda.empty_cache()


def hold_glu_again(call, cuda_fn, plain):
    """``hold_glu``, and a second launch on the same inputs equal to the
    path's bit for bit."""
    res = hold_glu(call, plain)
    args, kw, got = call
    res["same_bits_again"] = bool(torch.equal(got, cuda_fn(*args, **kw)))
    if not res["same_bits_again"]:
        raise AssertionError(f"{plain.__name__}: a relaunch gave other bits")
    return res


def phase_serve_mixtral_spec(cfg, ecfg, new=64, k=4, nb=2, spec_slots=2):
    """``ServingEngine`` with Mixtral 8x7B's widths at 4 layers (as
    ``serve_mixtral``) and a self-draft, ``SpeculationConfig(k=4,
    num_branches=2, max_spec_slots=2)``: the draft worker's 4 rows put 8
    pairs on sentinel metadata (K6), the verify worker's 20 rows run K5, and
    the packed worker runs K5 twice (target and draft). Asserts completion,
    one shape per worker and the launch counts of K1, K5 and K6; holds the
    first K5 launch of the verify worker and the first K6 launch of the
    draft worker to their plain versions within 1e-2, with the same bits
    on a relaunch."""
    from neuronx_distributed_tpu_torch.inference.engine import ServingEngine
    from neuronx_distributed_tpu_torch.inference.speculative import (
        SpeculationConfig)
    from neuronx_distributed_tpu_torch.models import mixtral
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as bm
    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention)

    torch.cuda.reset_peak_memory_stats()
    sd = mixtral.init_state_dict(
        dataclasses.replace(cfg, param_dtype=cfg.dtype), seed=0, std=0.02)
    eng = ServingEngine(cfg, sd, dataclasses.replace(
        ecfg, speculation=SpeculationConfig(k, nb,
                                            max_spec_slots=spec_slots)))
    del sd
    timer = spec_timer(eng)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in rng.randint(128, 1025, 8)]
    with Capture(bm, "grouped_glu_cuda", by_ref=(1, 2),
                 want=lambda *a, **kw: timer.now == "spec_verify") as k5, \
            Capture(bm, "grouped_glu_decode_cuda", by_ref=(1, 2),
                    want=lambda *a, **kw: timer.now == "spec_draft") as k6:
        paged_attention.launches = 0
        bm.grouped_glu.launches = bm.grouped_glu_decode.launches = 0
        _, wall = serve_shared(eng, prompts, new)
        launches = {"paged_attention": paged_attention.launches,
                    "grouped_glu": bm.grouped_glu.launches,
                    "grouped_glu_decode": bm.grouped_glu_decode.launches}
    nl, runs = cfg.num_layers, eng.worker_runs
    want = {"paged_attention": spec_launches_want(eng, nl, nl, k),
            "grouped_glu": nl * (2 * runs["packed"] + runs["spec_verify"]),
            "grouped_glu_decode": nl * (k + 1) * runs["spec_draft"]}
    if launches != want or not all(launches.values()):
        raise AssertionError(f"serve_mixtral_spec: launches {launches}, want "
                             f"{want} (worker runs {runs})")
    if set(eng.worker_compile_counts().values()) != {1}:
        raise AssertionError("serve_mixtral_spec: step shapes "
                             f"{eng.worker_compile_counts()}")
    held = {"grouped_glu_verify": hold_glu_again(
                k5.calls[0], bm.grouped_glu_cuda, bm.grouped_glu_plain),
            "grouped_glu_decode_draft": hold_glu_again(
                k6.calls[0], bm.grouped_glu_decode_cuda,
                bm.grouped_glu_decode_plain)}
    rep = eng.stats.report()
    emit("serve_mixtral_spec", layers=nl, dtype=str(cfg.dtype),
         requests=len(prompts), new_tokens=len(prompts) * new,
         speculation_length=k, num_branches=nb, spec_slots=spec_slots,
         steps=eng.stats.steps, worker_runs=dict(runs), launches=launches,
         held_to_plain=held, spec_rounds=eng.stats.spec_rounds,
         accepted_per_round=rep["spec_accept_mean"],
         workers=timer.per_call(),
         output_tok_per_s=len(prompts) * new / wall, wall_s=wall,
         step_latency_p50_ms=rep["step_latency_p50_ms"],
         step_latency_p99_ms=rep["step_latency_p99_ms"],
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    timer.restore()
    del eng, k5, k6, timer
    torch.cuda.empty_cache()
    return launches


def migrate_sessions(src, dst, uids, stream=False):
    """Export ``uids`` from ``src`` (integrity on), through ``to_bytes`` /
    ``from_bytes``, into ``dst`` (the stream import: begin, one chunk a
    tensor and layer, commit); returns the timings and sizes of each."""
    from neuronx_distributed_tpu_torch.inference.engine import SessionTicket

    out = []
    for uid in uids:
        t0 = time.perf_counter()
        ticket = src.export_session(uid)
        t1 = time.perf_counter()
        raw = ticket.to_bytes()
        t2 = time.perf_counter()
        back = SessionTicket.from_bytes(raw)
        t3 = time.perf_counter()
        if stream:
            handle = dst.begin_stream_import(dataclasses.replace(back,
                                                                 kv=None))
            for name, arr in back.kv.items():
                if name == "pos":
                    dst.stream_inject(handle, "pos", 0, arr)
                else:
                    for layer in range(arr.shape[0]):
                        dst.stream_inject(handle, name, layer, arr[layer])
            dst.commit_stream_import(handle)
        else:
            dst.import_session(back)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        out.append(dict(uid=uid, n_cached=ticket.n_cached,
                        n_blocks=ticket.n_blocks, bytes=len(raw),
                        bytes_per_token=len(raw) / ticket.n_cached,
                        export_ms=(t1 - t0) * 1e3,
                        serialize_ms=(t2 - t1) * 1e3,
                        parse_ms=(t3 - t2) * 1e3,
                        import_ms=(t4 - t3) * 1e3, stream=stream))
    return out


def phase_migrate(cfg, ecfg, new=32, n=4):
    """Session migration between two engines in one process that share one
    Llama-3-8B model at ``cfg``'s depth (8 layers in the whole script) in
    bf16 (random weights, seed 0, std
    0.02). ``n`` requests of 200-500 prompt tokens, 32 new tokens: run on
    engine A without moving (the reference ids); then again on A, each
    exported mid-decode with ``integrity=True``, passed through
    ``to_bytes``/``from_bytes`` and landed on B, half through
    ``import_session``, half through the stream import; their ids must
    equal the reference bit for bit, with no prefill on B. A ticket with
    one flipped payload byte is refused on the wire (``TicketWireError``),
    and a parsed ticket whose KV lost one bit is refused with
    ``IntegrityError`` with B's allocator and pool unchanged. An int8-pool
    pair of engines migrates a session to the same ids. ``export_prefixes``
    / ``import_prefixes`` give B the prefix hits the donor's trie promised.
    ``evict`` on A and a resubmission on B give the reference ids. Prints
    ticket bytes per cached token (bf16 at 8 layers: 8 x 2 x 8 x 128 x
    2 B = 32 KiB, plus the positions and the last block's unused rows) and
    export, serialize, parse and import ms a session; K1 launches on the
    migrated run."""
    from neuronx_distributed_tpu_torch.inference.engine import (
        ServingEngine, TicketWireError)
    from neuronx_distributed_tpu_torch.models.llama import init_state_dict
    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention)
    from neuronx_distributed_tpu_torch.resilience.integrity import (
        IntegrityError)

    sd = init_state_dict(dataclasses.replace(cfg, param_dtype=cfg.dtype),
                         seed=0, std=0.02)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, m).tolist()
               for m in rng.randint(200, 501, n)]
    icfg = dataclasses.replace(ecfg, integrity=True)
    a = ServingEngine(cfg, sd, icfg, name="a")
    b = ServingEngine(cfg, sd, icfg, name="b")
    if a.model.embed.embedding.data_ptr() != \
            b.model.embed.embedding.data_ptr():
        raise AssertionError("migrate: the engines do not share the model")
    want, _ = serve_shared(a, prompts, new)

    def decode_a_while(eng, uids, steps=4):
        for i, uid in enumerate(uids):
            eng.submit(prompts[i], new, uid=uid)
        while not all(eng.handoff_ready(u) for u in uids):
            eng.step()
        for _ in range(steps):
            eng.step()

    uids = [f"r{i}" for i in range(n)]
    paged_attention.launches = 0
    decode_a_while(a, uids)
    prefill_b = b.stats.prefill_tokens
    moved = (migrate_sessions(a, b, uids[:n // 2])
             + migrate_sessions(a, b, uids[n // 2:], stream=True))
    res = b.run()
    k1 = paged_attention.launches
    got = [res[u].tokens for u in uids]
    if got != want or b.stats.prefill_tokens != prefill_b \
            or a.allocator.num_allocated or a.has_work():
        raise AssertionError(
            f"migrate: ids equal {[g == w for g, w in zip(got, want)]}, B "
            f"prefilled {b.stats.prefill_tokens - prefill_b} tokens, A "
            f"holds {a.allocator.num_allocated} blocks")
    # corruption: on the wire, and inside a parsed ticket
    a.submit(prompts[0], new, uid="c")
    while not a.handoff_ready("c"):
        a.step()
    ticket = a.export_session("c")
    raw = ticket.to_bytes()
    refused = {}
    try:
        flipped = bytearray(raw)
        flipped[-100] ^= 0x10
        type(ticket).from_bytes(bytes(flipped))
    except TicketWireError as e:
        refused["wire"] = type(e).__name__
    before = (list(b.allocator._free), dict(b.allocator._refs),
              b.cache.pos.clone(), b._tables.copy())
    bad = type(ticket).from_bytes(raw)
    bad.kv["k"].reshape(-1)[7:8].view(np.uint8)[0] ^= 0x01
    try:
        b.import_session(bad)
    except IntegrityError as e:
        refused["kv"] = type(e).__name__
    after = (list(b.allocator._free), dict(b.allocator._refs),
             b.cache.pos, b._tables)
    unchanged = (before[0] == after[0] and before[1] == after[1]
                 and torch.equal(before[2], after[2])
                 and (before[3] == after[3]).all())
    if set(refused) != {"wire", "kv"} or not unchanged \
            or b.stats.integrity_rejects != 1:
        raise AssertionError(f"migrate: corrupt tickets refused {refused}, "
                             f"B unchanged {unchanged}")
    # evict on A, resubmit on B: the reference ids
    a.submit(prompts[1], new, uid="e")
    for _ in range(3):
        a.step()
    prompt, _ = a.evict("e")
    b.submit(prompt, new, uid="e")
    evicted_equal = b.run()["e"].tokens == want[1]
    if not evicted_equal or a.stats.resubmitted != 1:
        raise AssertionError("migrate: the evicted request resubmitted on B "
                             "gave other ids")
    del a, b
    torch.cuda.empty_cache()
    # an int8 pool
    q8 = dataclasses.replace(icfg, quantized=True)
    a8, b8 = (ServingEngine(cfg, sd, q8, name=nm) for nm in ("a8", "b8"))
    want8, _ = serve_shared(a8, prompts[:1], new)
    decode_a_while(a8, ["r0"])
    moved8 = migrate_sessions(a8, b8, ["r0"])
    if b8.run()["r0"].tokens != want8[0]:
        raise AssertionError("migrate: the int8 pool's session gave other "
                             "ids")
    del a8, b8
    torch.cuda.empty_cache()
    # prefix shipping
    pcfg = dataclasses.replace(icfg, prefix_sharing=True)
    donor, fresh = (ServingEngine(cfg, sd, pcfg, name=nm)
                    for nm in ("donor", "fresh"))
    system = rng.randint(0, cfg.vocab_size, 1000).tolist()
    donor.submit(system + prompts[0][:40], 4, uid="d")
    donor.run()
    asker = system + prompts[1][:30]
    promised = donor.prefix_lookup(asker)
    shipment = donor.export_prefixes()
    nodes = fresh.import_prefixes(shipment)
    fresh.submit(asker, 4, uid="f")
    fresh.run()
    if not promised or fresh.stats.prefix_hit_tokens != promised \
            or nodes != len(shipment["nodes"]):
        raise AssertionError(
            f"migrate: B hit {fresh.stats.prefix_hit_tokens} prefix tokens, "
            f"the donor promised {promised}; {nodes} nodes landed")
    emit("migrate", layers=cfg.num_layers, dtype=str(cfg.dtype),
         requests=n, new_tokens=new, sessions=moved, int8_sessions=moved8,
         kv_bytes_per_token_bf16=2 * cfg.num_layers * cfg.num_kv_heads
         * cfg.head_dim_ * 2,
         ids_equal=True, refused=refused, b_unchanged_after_refusal=True,
         evicted_resubmitted_equal=evicted_equal, prefix_nodes=nodes,
         prefix_hit_tokens=fresh.stats.prefix_hit_tokens,
         k1_launches=k1)
    del donor, fresh, sd
    torch.cuda.empty_cache()
    return k1


# ---------------------------------------------------------------------------
# phases 36-39: the replica router and the two-tier fabric
# ---------------------------------------------------------------------------

class RouterTap:
    """Within ``with RouterTap() as tap``, the router module builds its
    engines, routers and streams as subclasses that record, and never
    keep alive, what the router phases check: each engine's
    ``worker_runs`` dict (K1 runs once per layer per worker run, crashed
    engines included), how many workers it captured (``captured``) and
    each graph replay (``replays``), and the host ms of its session
    exports, each
    router's ``results`` dict, and each stream's host ms per stage:
    ``encode`` (the codec and the fingerprints of every chunk), ``land``
    (decode, verify and inject each delivered chunk, and the commit) and
    ``transit`` (start to commit, less ``land``: the link and the router
    loop's cadence). The module's own classes are back on exit."""

    def __enter__(self):
        from neuronx_distributed_tpu_torch.inference import router as rt

        self._rt = rt
        self._orig = (rt.ServingEngine, rt.ReplicaRouter,
                      rt.KVStreamTransport)
        from neuronx_distributed_tpu_torch.inference import aot_cache

        runs, results, stages, exports, engines = [], [], [], [], []
        captured, replays = [], []
        self.runs, self.results = runs, results
        self.captured, self.replays = captured, replays
        self.stages, self.export_ms = stages, exports
        self.engines = engines     # (name, weak reference), built in order

        class Engine(rt.ServingEngine):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                runs.append(self.worker_runs)
                captured.append(sum(not w.from_cache for w in
                                    (self._aot_workers or {}).values()))
                engines.append((self.name, weakref.ref(self)))

            def export_session(self, request_id):
                t0 = time.perf_counter()
                ticket = super().export_session(request_id)
                exports.append((time.perf_counter() - t0) * 1e3)
                return ticket

        class Router(rt.ReplicaRouter):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                results.append(self.results)

        class Stream(rt.KVStreamTransport):
            def _encode_stream(self):
                t0 = time.perf_counter()
                wires = super()._encode_stream()
                self._stage = {"encode_ms": (time.perf_counter() - t0)
                               * 1e3, "land_ms": 0.0}
                stages.append(self._stage)
                return wires

            def start(self, now):
                self._stage["t0"] = time.perf_counter()
                super().start(now)

            def on_wire(self, data, now):
                t0 = time.perf_counter()
                super().on_wire(data, now)
                t1 = time.perf_counter()
                self._stage["land_ms"] += (t1 - t0) * 1e3
                if self.state == "committed":
                    self._stage["transit_ms"] = (
                        (t1 - self._stage["t0"]) * 1e3
                        - self._stage["land_ms"])

        worker_call = aot_cache.AotWorker.__call__

        def counted(worker):
            replays.append(1)
            return worker_call(worker)

        self._aot, self._worker_call = aot_cache, worker_call
        aot_cache.AotWorker.__call__ = counted
        rt.ServingEngine, rt.ReplicaRouter, rt.KVStreamTransport = (
            Engine, Router, Stream)
        return self

    def __exit__(self, *exc):
        (self._rt.ServingEngine, self._rt.ReplicaRouter,
         self._rt.KVStreamTransport) = self._orig
        self._aot.AotWorker.__call__ = self._worker_call
        return False

    def k1_want(self, layers):
        return layers * sum(sum(r.values()) for r in self.runs)

    def stage_ms(self):
        """Mean host ms a session of each stage (committed streams for
        transit)."""
        out = {"export_ms": float(np.mean(self.export_ms))
               if self.export_ms else None}
        for key in ("encode_ms", "land_ms", "transit_ms"):
            vals = [s[key] for s in self.stages if key in s]
            out[key] = float(np.mean(vals)) if vals else None
        return out


def serving_weights(cfg):
    """Llama weights made in the serving dtype on the card (seed 0)."""
    from neuronx_distributed_tpu_torch.models.llama import init_state_dict

    return init_state_dict(dataclasses.replace(cfg, param_dtype=cfg.dtype),
                           seed=0, std=0.02)


def match_share(got, want):
    """Share of requests whose ids equal the reference's, and share of
    the ids (position by position)."""
    same = sum(got[u] == want[u] for u in want)
    pos = sum(a == b for u in want for a, b in zip(got[u], want[u]))
    total = sum(len(want[u]) for u in want)
    return same / max(1, len(want)), pos / max(1, total)


def phase_router(cfg, ecfg, new=64, n=16):
    """``ReplicaRouter`` with 2 replicas of phase 4's engine on one copy of
    Llama-3-8B at ``cfg``'s depth (8 layers in the whole script) in bf16:
    16 requests of 128-1024 prompt tokens
    and 64 new tokens from two tenants, ``batch`` on a finite token bucket
    (rate 0, a burst for 6 of its 8 requests: 2 throttled at submit), under
    ``step|r1 : crash, after=6, times=1``; then the same requests on a
    1-replica router with no fault. Asserts availability 1.0, one
    failover, resubmits > 0, one step shape per replica engine that ran,
    K1 launched layers x worker runs summed over every engine (the crashed
    one too), one weight storage for every replica (``data_ptr``), the
    crashed engine freed when dropped, and the card's allocated memory
    back to its baseline after the router is deleted (no garbage
    collection). Prints output tokens/s of the fleet beside the single
    replica, TTFT p50/p99, resubmitted tokens and the bf16 greedy match
    share against the single replica (recorded, not limited)."""
    from neuronx_distributed_tpu_torch.inference import router as rt
    from neuronx_distributed_tpu_torch.inference.engine import (
        RequestRejected)
    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention)
    from neuronx_distributed_tpu_torch.resilience.chaos import FaultPlan

    sd = serving_weights(cfg)
    rng = np.random.RandomState(3)
    lens = rng.randint(128, 1025, n)
    prompts = [rng.randint(0, cfg.vocab_size, m).tolist() for m in lens]
    tenant_of = ["interactive" if i % 2 == 0 else "batch" for i in range(n)]
    batch_cost = [int(lens[i]) + new for i in range(n)
                  if tenant_of[i] == "batch"]
    tenants = {"interactive": rt.TenantPolicy(priority=2),
               "batch": rt.TenantPolicy(rate_tokens_per_s=0.0,
                                        burst_tokens=float(
                                            sum(batch_cost[:6])),
                                        priority=1)}

    def drive(num_replicas, chaos):
        # the budget of the 2-replica fleet in both runs, so that both
        # admit the same requests at the same load
        router = rt.ReplicaRouter(
            cfg, sd, ecfg, rt.RouterConfig(
                num_replicas=num_replicas, tenants=tenants,
                global_token_budget=2 * ecfg.num_blocks * ecfg.block_size),
            chaos=chaos)
        rejected = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, prompt in enumerate(prompts):
            try:
                router.submit(prompt, new, tenant=tenant_of[i], uid=f"r{i}")
            except RequestRejected as e:
                rejected.append((f"r{i}", e.reason))
        res = router.run()
        torch.cuda.synchronize()
        return router, res, rejected, time.perf_counter() - t0

    # the process's cuBLAS workspace (32 MiB on this card) comes with the
    # first product on the stream and stays: make it before the baseline
    torch.ones(8, 8, device="cuda") @ torch.ones(8, 8, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with RouterTap() as tap:
        paged_attention.launches = 0
        router, res, rejected, wall = drive(2, FaultPlan.parse(
            "step|r1 : crash, after=6, times=1"))
        k1, k1_want = paged_attention.launches, tap.k1_want(cfg.num_layers)
    # the first r1 crashed and was dropped: nothing may keep it alive
    crashed_freed = next(ref for name, ref in tap.engines
                         if name == "r1")() is None
    sd_ptrs = {k: v.data_ptr() for k, v in sd.items()}
    shared = all({k: v.data_ptr() for k, v in
                  rep.engine.model.state_dict().items()} == sd_ptrs
                 for rep in router.replicas if rep.engine is not None)
    shapes = {rep.name: rep.engine.worker_compile_counts()
              for rep in router.replicas if rep.engine is not None}
    ran = {rep.name: sum(rep.engine.worker_runs.values())
           for rep in router.replicas if rep.engine is not None}
    one_shape = all(set(shapes[r].values()) == ({1} if ran[r] else {0})
                    for r in shapes)
    d = router.stats.to_dict()
    admitted = d["admitted"]
    got = {u: r.tokens for u, r in res.items() if r.status == "completed"}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del router, res
    torch.cuda.synchronize()
    leaked = torch.cuda.memory_allocated() - base
    ref, ref_res, ref_rejected, ref_wall = drive(1, None)
    want = {u: r.tokens for u, r in ref_res.items()
            if r.status == "completed"}
    del ref, ref_res
    same_req, same_ids = match_share(got, want)
    ok = (d["availability"] == 1.0 and d["failovers"] == 1
          and d["resubmits"] > 0 and rejected == ref_rejected
          and len(rejected) == 2 and set(got) == set(want)
          and all(len(t) == new for t in got.values()))
    if not ok:
        raise AssertionError(f"router: stats {d}, rejected {rejected} "
                             f"(reference {ref_rejected})")
    if not shared or not one_shape or k1 != k1_want or k1 == 0 \
            or not crashed_freed:
        raise AssertionError(
            f"router: shared weights {shared}, step shapes {shapes}, K1 "
            f"{k1} want {k1_want}, crashed engine freed {crashed_freed}")
    if leaked != 0:
        raise AssertionError(f"router: {leaked} bytes still allocated "
                             "after the router was deleted")
    emit("router", layers=cfg.num_layers, dtype=str(cfg.dtype),
         replicas=2, requests=n, admitted=admitted, throttled=rejected,
         new_tokens=new, prompt_tokens=int(lens.sum()),
         fleet_output_tok_per_s=admitted * new / wall, fleet_wall_s=wall,
         single_output_tok_per_s=admitted * new / ref_wall,
         single_wall_s=ref_wall,
         availability=d["availability"], failovers=d["failovers"],
         resubmits=d["resubmits"],
         resubmitted_tokens=d["resubmitted_tokens"],
         revivals=d["revivals"], ttft_p50_ms=d["ttft_p50_ms"],
         ttft_p99_ms=d["ttft_p99_ms"], steps=d["steps"],
         greedy_match_requests=same_req, greedy_match_ids=same_ids,
         step_shapes=shapes, shared_weights=shared,
         crashed_engine_freed=crashed_freed,
         weight_gib=sum(t.numel() * t.element_size()
                        for t in sd.values()) / 2 ** 30,
         peak_mem_gib=peak, leaked_bytes_after_delete=leaked,
         k1_launches=k1)
    del sd
    free_cuda()
    return k1


def phase_fabric(cfg, ecfg, new=64, n=8):
    """The two-tier fabric, ``FabricConfig(prefill_replicas=1,
    decode_replicas=1)``, on one copy of phase 4's model: 8 requests of
    200-1000 prompt tokens and 64 new tokens, every session streamed from
    ``p0`` to ``d0`` once it has its first token over the default
    ``StreamConfig`` link (25 GbE, 25 us). Four runs: a bf16 pool under
    ``wire_dtype="auto"`` (the int8 blockwise codec); the same under
    ``link|* : link_corrupt, p=0.2, times=4``; an int8 pool, shipped raw;
    and a bf16 pool under a ``link_partition`` that tears every stream.
    Asserts availability 1.0 and no pool block left allocated; the decode
    tier's one step shape; with the int8 pool, ids equal bit for bit to
    one colocated engine's (a raw passthrough is lossless); retries under
    corruption; every stream aborted and re-prefilled under the partition;
    K1 launched layers x worker runs. Prints wire bytes per cached token,
    the wire ratio against fp32, chunks and retries, and the host ms a
    session of each stage (export, encode, transit, land)."""
    from neuronx_distributed_tpu_torch.inference import router as rt
    from neuronx_distributed_tpu_torch.inference.engine import ServingEngine
    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention)
    from neuronx_distributed_tpu_torch.resilience.chaos import FaultPlan

    sd = serving_weights(cfg)
    rng = np.random.RandomState(4)
    lens = rng.randint(200, 1001, n)
    prompts = [rng.randint(0, cfg.vocab_size, m).tolist() for m in lens]
    int8 = dataclasses.replace(ecfg, quantized=True)
    # the colocated reference for the lossless int8 passthrough
    ref = ServingEngine(cfg, sd, int8, name="colocated")
    for i, prompt in enumerate(prompts):
        ref.submit(prompt, new, uid=f"r{i}")
    want_int8 = {u: r.tokens for u, r in ref.run().items()}
    del ref
    runs = [("bf16", ecfg, ""),
            ("bf16_corrupt", ecfg, "link|* : link_corrupt, p=0.2, times=4"),
            ("int8", int8, ""),
            ("bf16_partition", ecfg, "link|* : link_partition, times=1")]
    out, k1_total = {}, 0
    for label, e, plan in runs:
        with RouterTap() as tap:
            paged_attention.launches = 0
            router = rt.ReplicaRouter(
                cfg, sd, e,
                rt.RouterConfig(fabric=rt.FabricConfig(
                    prefill_replicas=1, decode_replicas=1)),
                chaos=FaultPlan.parse(plan) if plan else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i, prompt in enumerate(prompts):
                router.submit(prompt, new, uid=f"r{i}")
            res = router.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k1, k1_want = (paged_attention.launches,
                           tap.k1_want(cfg.num_layers))
        d = router.stats.to_dict()
        tiers = {rep.tier: rep.engine.worker_compile_counts()
                 for rep in router.replicas}
        leaked = sum(rep.engine.allocator.num_allocated
                     for rep in router.replicas)
        got = {u: r.tokens for u, r in res.items()}
        payload = router.stats.handoff_wire_payload_bytes
        del router, res
        free_cuda()
        k1_total += k1
        problems = []
        if d["availability"] != 1.0 or leaked or k1 != k1_want or not k1:
            problems.append("availability, leak or K1")
        if label == "bf16_partition":
            if d["handoffs"] or d["handoff_aborts"] != n \
                    or not d["reprefilled_tokens"]:
                problems.append("partition did not tear every stream")
            if set(tiers["decode"].values()) != {0}:
                problems.append("the decode tier ran under the partition")
        else:
            if d["handoffs"] != n or d["handoff_aborts"]:
                problems.append("not every session handed off")
            if set(tiers["decode"].values()) != {1}:
                problems.append("decode tier step shapes")
        if label == "bf16_corrupt" and not d["handoff_retries"]:
            problems.append("no retry under corruption")
        if label == "int8" and got != want_int8:
            problems.append("int8 passthrough ids differ from one engine's")
        if problems:
            raise AssertionError(f"fabric/{label}: {problems}: stats {d}, "
                                 f"step shapes {tiers}, leaked {leaked}, K1 "
                                 f"{k1} want {k1_want}")
        out[label] = dict(
            wall_s=wall, output_tok_per_s=n * new / wall,
            handoffs=d["handoffs"], aborts=d["handoff_aborts"],
            chunks=d["handoff_chunks"], retries=d["handoff_retries"],
            wire_bytes=d["handoff_bytes"],
            wire_payload_bytes_per_token=(
                payload / d["migrated_tokens"] if d["handoffs"] else None),
            wire_ratio=d["handoff_wire_ratio"],
            migrated_tokens=d["migrated_tokens"],
            reprefilled_tokens=d["reprefilled_tokens"],
            ttft_p50_ms=d["ttft_p50_ms"], ttft_p99_ms=d["ttft_p99_ms"],
            stages=tap.stage_ms(), decode_step_shapes=tiers["decode"],
            k1_launches=k1)
    emit("fabric", layers=cfg.num_layers, dtype=str(cfg.dtype),
         requests=n, new_tokens=new, prompt_tokens=int(lens.sum()),
         int8_ids_equal_one_engine=True, runs=out, k1_launches=k1_total)
    del sd
    free_cuda()
    return k1_total


def phase_router_elastic(cfg, ecfg, n=8, prompt_len=256, new=16):
    """``elastic_chaos_drill`` on phase 4's model at full width on the real
    clock with 8 requests of 256 prompt tokens and 16 new: chaos preempts
    ``r1`` (its sessions migrate out), a ``scale_burst`` scales up, a
    scripted scale-down retires a replica by migration, ``r1`` revives,
    and the drill's unmeetable TTFT objective breaches. Asserts
    availability 1.0, greedy ids equal to the drill's 1-replica reference,
    migrated tokens > 0, one step shape per engine, and K1 launched layers
    x worker runs over every engine the drill built. Prints the drill's
    dict."""
    from neuronx_distributed_tpu_torch.inference import router as rt
    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention)

    base = memory_base()
    sd = serving_weights(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with RouterTap() as tap:
        paged_attention.launches = 0
        d = rt.elastic_chaos_drill(cfg, sd, ecfg, n_requests=n,
                                   prompt_len=prompt_len,
                                   max_new_tokens=new)
        k1 = paged_attention.launches
        nl = cfg.num_layers
        captures, replays = sum(tap.captured), len(tap.replays)
        runs = sum(sum(r.values()) for r in tap.runs)
    wall = time.perf_counter() - t0
    aot = {k: d.pop(k) for k in ("bundle_cold_start_ms",
                                 "bundle_cold_start_warm_ms",
                                 "bundle_cold_start_speedup",
                                 "aot_warm_loaded", "aot_cache_hits",
                                 "aot_cache_misses")}
    if (d["elastic_availability"] != 1.0
            or d["elastic_greedy_match_ref"] != 1.0
            or d["migrated_tokens"] <= 0 or d["max_compile_count"] != 1
            or d["elastic_preemptions"] != 1 or k1 != 2 * nl * captures
            or captures != aot["aot_cache_misses"] or replays != runs
            or not runs or aot["aot_warm_loaded"] != 1.0):
        raise AssertionError(f"router_elastic: {d}, {aot}, K1 launches {k1}"
                             f" captures {captures}, replays {replays} runs "
                             f"{runs}")
    emit("router_elastic", layers=nl, dtype=str(cfg.dtype), requests=n,
         prompt_len=prompt_len, new_tokens=new, wall_s=wall,
         k1_launches=k1, **d)
    emit("router_elastic_aot", captures=captures, worker_replays=replays,
         **aot)
    del sd
    free_cuda()
    check_freed("router_elastic", base)
    return k1, replays


ROUTER_CROSS_ECFG = dict(block_size=16, num_blocks=64, max_slots=4,
                         max_blocks_per_seq=8, token_budget=16)


def router_cross_side(base_cfg, dev):
    """One side of ``router_cross_check`` on ``dev``: the three drills on
    Llama-3-8B's widths at 2 layers in fp32 from weights made on the card
    from seed 0 (moved to the CPU for its side), under a ``RouterTap``:
    the drills' dicts, the fabric's handoff bytes, every router's ids and
    the seconds. The CPU side runs as a ``CpuSide`` job
    (``router_cpu_half``), after the card's router phases, whose classes
    the tap would otherwise swap under them."""
    from neuronx_distributed_tpu_torch.inference import router as rt
    from neuronx_distributed_tpu_torch.inference.engine import EngineConfig
    from neuronx_distributed_tpu_torch.models.llama import init_state_dict

    cfg = dataclasses.replace(base_cfg, num_layers=2, dtype=torch.float32)
    weights = init_state_dict(cfg, seed=0, std=0.02)
    if dev == "cpu":
        weights = {k: v.cpu() for k, v in weights.items()}
    ecfg = EngineConfig(**ROUTER_CROSS_ECFG)
    fab = dataclasses.replace(ecfg, quantized=True, max_slots=6)
    drills = (("chaos_drill", ecfg), ("sdc_serving_drill", ecfg),
              ("fabric_chaos_drill", fab))
    t0 = time.perf_counter()
    with RouterTap() as tap:
        dicts = {name: getattr(rt, name)(cfg, weights, e,
                                         clock=lambda: 0.0, device=dev)
                 for name, e in drills}
    # chunk headers carry fingerprints of each side's own K/V, whose
    # last bits differ: their digits move the byte count a little
    return dict(
        dicts={name: {k: v for k, v in d.items()
                      if "ttft" not in k and k != "handoff_bytes"}
               for name, d in dicts.items()},
        handoff_bytes=dicts["fabric_chaos_drill"]["handoff_bytes"],
        ids=[{u: r.tokens for u, r in res.items()} for res in tap.results],
        seconds=time.perf_counter() - t0)


def router_cpu_half(base_cfg):
    """``router_cross_check``'s CPU side, for the ``CpuSide`` thread."""
    out = {"side": router_cross_side(base_cfg, "cpu")}
    free_cuda()
    return out


def phase_router_cross_check(base_cfg, cpu_side=None):
    """Full width, 2 layers, fp32, on the card and on the CPU from the same
    weights under ``clock=lambda: 0.0``: ``chaos_drill``,
    ``sdc_serving_drill`` and ``fabric_chaos_drill`` (int8 pool) give the
    same ids in every router they build and the same dicts (TTFT keys left
    out); the wire codec's int8 and fp8 codes and scales made from card
    tensors (an fp32 weight slab and its bf16 cast, blocks of 256 and 7)
    equal the CPU's bit for bit. The CPU side comes from ``cpu_side``
    (:func:`router_cross_side` on its thread), or is computed here."""
    from neuronx_distributed_tpu_torch.models.llama import init_state_dict
    from neuronx_distributed_tpu_torch.parallel import wire_codec as tw

    cfg = dataclasses.replace(base_cfg, num_layers=2, dtype=torch.float32)
    sides = {"cuda": router_cross_side(base_cfg, "cuda"),
             "cpu": (cpu_side.result("router_cross_check")["side"]
                     if cpu_side is not None
                     else router_cross_side(base_cfg, "cpu"))}
    sd = init_state_dict(cfg, seed=0, std=0.02)
    hb = (sides["cuda"]["handoff_bytes"], sides["cpu"]["handoff_bytes"])
    same_dicts = (sides["cuda"]["dicts"] == sides["cpu"]["dicts"]
                  and abs(hb[0] - hb[1]) <= 1e-3 * hb[1])
    same_ids = sides["cuda"]["ids"] == sides["cpu"]["ids"]
    codes = {}
    slab = sd["embed.embedding"][:4096]
    for x in (slab, slab.bfloat16()):
        for dtype in ("int8", "fp8"):
            for block in (256, 7):
                c = tw.CompressionConfig(dtype=dtype, block_size=block)
                q, s_, _ = tw.quantize_blockwise(x, c)
                qc, sc, _ = tw.quantize_blockwise(x.cpu(), c)
                codes[f"{x.dtype}/{dtype}/{block}"] = (
                    same_bits(q.cpu(), qc) and same_bits(s_.cpu(), sc))
    if not (same_dicts and same_ids and all(codes.values())):
        raise AssertionError(
            f"router_cross_check: dicts equal {same_dicts}, ids equal "
            f"{same_ids}, codes {codes}: {sides['cuda']['dicts']} against "
            f"{sides['cpu']['dicts']}")
    emit("router_cross_check", layers=cfg.num_layers, dtype="fp32",
         drills=sides["cuda"]["dicts"], routers=len(sides["cuda"]["ids"]),
         handoff_bytes_card_cpu=hb,
         ids_equal=same_ids, dicts_equal=same_dicts, codec_bits_equal=codes,
         card_s=sides["cuda"]["seconds"], cpu_s=sides["cpu"]["seconds"])
    del sd
    free_cuda()


# ---------------------------------------------------------------------------
# phases 40-44: captured workers, the executable cache, bundles, benchmark
# ---------------------------------------------------------------------------

class SyncErrors:
    """``torch.cuda.set_sync_debug_mode("error")`` inside the block: any
    synchronizing call there raises."""

    def __enter__(self):
        torch.cuda.set_sync_debug_mode("error")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        return False


class K1Stash:
    """While on, every call of the model's K1 keeps its output tensor, in
    call order (but those of the CPU side's thread). Tensors kept during a
    capture live in the graph's pool: a replay rewrites them, so after a
    replay they hold its outputs."""

    def __init__(self):
        from neuronx_distributed_tpu_torch.models import llama

        self._llama, self._real = llama, llama.paged_attention
        self.outs = outs = []
        real = self._real

        def stash(*args, **kw):     # holds no reference to the stash
            out = real(*args, **kw)
            if not on_cpu_side():
                outs.append(out)
            return out

        self._stash = stash

    def __enter__(self):
        self._llama.paged_attention = self._stash
        return self

    def __exit__(self, *exc):
        self._llama.paged_attention = self._real
        return False


# a device kernel's profiler name -> the wrapper whose runs it counts,
# first match wins (K1's split combine is not a run of its own; serving's
# K5 is bf16, so ``glu_act`` is K5's first pass)
TRACED_KERNELS = (("grouped_glu_decode", "glu_act_wgmma<true>"),
                  ("grouped_glu", "glu_act"),
                  ("paged_attention", "paged_attention_"))


def traced_runs(prof):
    """Runs of K1, K5 and K6 in a trace, counted by kernel name."""
    from torch.autograd import DeviceType

    runs = {name: 0 for name, _ in TRACED_KERNELS}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = next((n for n, part in TRACED_KERNELS if part in e.key),
                        None)
            if name is not None:
                runs[name] += e.count
    return runs


def decode_window(eng, steps=5):
    """Wall ms a step over ``steps`` steps, then the device busy ms a step
    (the profiler's kernel time over ``steps`` more) and the idle share,
    ``1 - busy / wall``. With captured workers also the graph replays in
    the profiled steps (``profiled_replays``, by worker) and the runs of
    K1, K5 and K6 that the trace holds (``traced_kernel_runs``). A trace
    can miss kernels (ROADMAP §C, ``tools/probe_trace_loss.py``): a
    throwaway trace starts the profiler first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    before = eng.worker_replays()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    busy = sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / steps
    win = {"wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
           "device_idle_share": 1.0 - busy / wall}
    if before:
        win["profiled_replays"] = {w: n - before[w] for w, n in
                                   eng.worker_replays().items()}
        win["traced_kernel_runs"] = traced_runs(prof)
    return win


def hold_traced(label, win, nl, moe=False):
    """The runs of K1, K5 and K6 a window's trace holds against layers x
    the profiled replays of the workers that run each (K1 every worker;
    for a blockwise MoE ``moe``, K5 the packed or prefill one and K6 the
    decode one). Each kernel the
    workers ran must show in the trace, and none more often than they ran
    it; a shortfall is reported, not failed, since a trace can miss
    kernels. Returns ``{kernel: {"runs", "want"}}`` for the kernels run."""
    r = win["profiled_replays"]
    wide = r.get("packed", 0) + r.get("prefill", 0)
    want = {"paged_attention": nl * sum(r.values()),
            "grouped_glu": nl * wide if moe else 0,
            "grouped_glu_decode": nl * r.get("decode", 0) if moe else 0}
    got = win["traced_kernel_runs"]
    out = {k: {"runs": got[k], "want": w} for k, w in want.items()
           if w or got[k]}
    if not want["paged_attention"] or any(
            not 0 < v["runs"] <= v["want"] for v in out.values()):
        raise AssertionError(f"{label}: traced kernel runs {got} against "
                             f"layers x profiled replays {want} ({r})")
    return out


def serve_requests(cfg, seed=0, n=8):
    """Phase 4's prompts: 8 of 128-1024 tokens."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(128, 1025, n)
    return [rng.randint(0, cfg.vocab_size, k).tolist() for k in lens]


def drive_serve(eng, prompts, new, window=False, strict=False):
    """Phase 4's schedule: six requests, the first token, two more
    admitted mid-flight, run to the end; with ``window`` five steady
    decode steps are timed and five profiled once every request decodes;
    with ``strict`` every step outside the profiler runs under
    :class:`SyncErrors`. Returns (ids, wall s, window or None)."""
    import contextlib

    guard = SyncErrors if strict else contextlib.nullcontext
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(6):
        eng.submit(prompts[i], new, uid=f"r{i}")
    with guard():
        while eng.stats.tokens_generated == 0:
            eng.step()
    for i in (6, 7):
        eng.submit(prompts[i], new, uid=f"r{i}")
    win = None
    if window:
        with guard():
            while eng._queue or any(
                    s is not None and not s.decoding for s in eng._slots):
                eng.step()
        win = decode_window(eng)
    with guard():
        res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [u for u, r in res.items()
           if r.status != "completed" or len(r.tokens) != new]
    if len(res) != len(prompts) or bad:
        raise AssertionError(f"requests not completed: {bad}")
    return {u: r.tokens for u, r in res.items()}, wall, win


def phase_serve_graph(cfg, ecfg, new=64):
    """Phases 40 and 41: phase 4's serving, eager against captured, then
    the captured engine's warm successor. Returns K1's launches, the
    worker replays of both captured engines, and K1's runs in the traced
    window against layers x its replays (:func:`hold_traced`)."""
    from neuronx_distributed_tpu_torch.inference.aot_cache import (
        AotExecutableCache)
    from neuronx_distributed_tpu_torch.inference.engine import ServingEngine
    from neuronx_distributed_tpu_torch.models import llama
    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention)

    base = memory_base()
    sd = serving_weights(cfg)
    prompts = serve_requests(cfg)
    eng = ServingEngine(cfg, sd, ecfg)
    eager, eager_wall, eager_win = drive_serve(eng, prompts, new, True)
    eager_rep = eng.stats.report()
    del eng
    torch.cuda.empty_cache()
    cache = AotExecutableCache()
    torch.cuda.synchronize()
    paged_attention.launches = 0
    t0 = time.perf_counter()
    with K1Stash() as stash:
        eng = ServingEngine(cfg, sd, ecfg, aot_cache=cache)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    nl = cfg.num_layers
    graph_k1 = stash.outs[-nl:]     # the capture's, after the warm-up's
    capture_launches = paged_attention.launches
    got, wall, win = drive_serve(eng, prompts, new, True, strict=True)
    rep = eng.stats.report()
    launches = paged_attention.launches
    # one more captured step on fresh requests, then the eager forward on
    # the same inputs and pool: K1's outputs layer by layer
    eng.submit(prompts[0][:200], 4, uid="k1")
    eng.step()
    eng.step()
    graph_out = [t.clone() for t in graph_k1]
    ex = eng._aot_workers["packed"].executable
    tokens, positions, slot_ids = (t.clone() for t in ex.inputs)
    with K1Stash() as eager_stash, torch.no_grad():
        llama.llama_forward_with_cache(eng.model, tokens, positions,
                                       eng.cache, slot_ids=slot_ids)
    k1_equal = all(torch.equal(a, b)
                   for a, b in zip(graph_out, eager_stash.outs))
    eng.run()
    replays = eng.worker_replays()
    runs = dict(eng.worker_runs)
    traced = hold_traced("serve_graph", win, nl)
    if SERVE_RUNS.get("serve") and SERVE_RUNS["serve"][0] != eager:
        raise AssertionError("serve_graph: the eager run's ids differ from "
                             "phase serve's")
    if (got != eager or eng.compile_count() != 1
            or capture_launches != 2 * nl or launches != 2 * nl
            or replays != runs or not k1_equal
            or len(eager_stash.outs) != nl):
        raise AssertionError(
            f"serve_graph: ids equal {got == eager}, compile_count "
            f"{eng.compile_count()}, K1 launches {capture_launches}/"
            f"{launches} want {2 * nl}, replays {replays} runs {runs}, "
            f"K1 bits equal {k1_equal}")
    emit("serve_graph", layers=nl, dtype=str(cfg.dtype), requests=len(got),
         new_tokens=len(got) * new, ids_equal_eager=True,
         ids_equal_phase_serve=bool(SERVE_RUNS.get("serve")),
         compile_count=eng.compile_count(), sync_debug_mode="error",
         k1_bits_equal_eager=k1_equal, k1_capture_launches=capture_launches,
         worker_replays=replays, traced_kernel_runs=traced,
         capture_ms=cold_ms,
         graph=dict(step_latency_p50_ms=rep["step_latency_p50_ms"],
                    step_latency_p99_ms=rep["step_latency_p99_ms"],
                    output_tok_per_s=len(got) * new / wall, **win),
         eager=dict(step_latency_p50_ms=eager_rep["step_latency_p50_ms"],
                    step_latency_p99_ms=eager_rep["step_latency_p99_ms"],
                    output_tok_per_s=len(got) * new / eager_wall,
                    **eager_win),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    total = sum(replays.values())
    del eng, ex, stash, graph_k1, graph_out
    # phase 41: the engine is gone, its capture waits in the cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = ServingEngine(cfg, sd, ecfg, aot_cache=cache)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    again, _, _ = drive_serve(warm, prompts, new, strict=True)
    if not warm.aot_warm() or again != eager or cache.stats()["hits"] != 1:
        raise AssertionError(f"aot_warm: warm {warm.aot_warm()}, ids equal "
                             f"{again == eager}, {cache.stats()}")
    emit("aot_warm", aot_warm=True, ids_equal_eager=True,
         construct_cold_ms=cold_ms, construct_warm_ms=warm_ms,
         speedup=cold_ms / warm_ms, cache=cache.stats())
    total += sum(warm.worker_replays().values())
    del warm, cache, sd, eager_stash
    free_cuda()
    check_freed("serve_graph", base)
    return launches, total, traced


def phase_serve_graph_mixtral(cfg, ecfg, new=64):
    """Phase 42: phases 11 and 12 through the executable cache. Returns
    per kernel its launches, the replays of the workers that run it, and
    its runs in each run's traced window against layers x those replays
    (:func:`hold_traced`)."""
    from neuronx_distributed_tpu_torch.inference.aot_cache import (
        AotExecutableCache)
    from neuronx_distributed_tpu_torch.inference.engine import ServingEngine
    from neuronx_distributed_tpu_torch.models import mixtral
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as bm
    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention)

    base = memory_base()
    sd = mixtral.init_state_dict(dataclasses.replace(
        cfg, param_dtype=cfg.dtype), seed=0, std=0.02)
    prompts = serve_requests(cfg)
    nl = cfg.num_layers
    out = {k: {"launches": 0, "worker_replays": 0, "traced": {}}
           for k in ("paged_attention", "grouped_glu", "grouped_glu_decode")}
    runs_line = {}
    disagg = dataclasses.replace(ecfg, disaggregated=True, max_slots=4,
                                 prefill_budget=512)
    for label, e in (("serve_mixtral", ecfg),
                     ("serve_mixtral_disagg", disagg)):
        if label not in SERVE_RUNS:
            serve(cfg, e, label)
        want, want_rep = SERVE_RUNS[label]
        paged_attention.launches = 0
        bm.grouped_glu.launches = bm.grouped_glu_decode.launches = 0
        eng = ServingEngine(cfg, sd, e, aot_cache=AotExecutableCache())
        got, wall, win = drive_serve(eng, prompts, new, True, strict=True)
        launches = {"paged_attention": paged_attention.launches,
                    "grouped_glu": bm.grouped_glu.launches,
                    "grouped_glu_decode": bm.grouped_glu_decode.launches}
        replays = eng.worker_replays()
        wide = replays.get("packed", 0) + replays.get("prefill", 0)
        ran = {"paged_attention": sum(replays.values()),
               "grouped_glu": wide,
               "grouped_glu_decode": replays.get("decode", 0)}
        traced = hold_traced(f"serve_graph_mixtral/{label}", win, nl,
                             moe=True)
        want_l = {"paged_attention": 2 * nl * len(replays),
                  "grouped_glu": 2 * nl,
                  "grouped_glu_decode": 2 * nl if e.disaggregated else 0}
        if (got != want or launches != want_l or replays != eng.worker_runs
                or set(eng.worker_compile_counts().values()) != {1}
                or not ran["grouped_glu"]
                or (e.disaggregated and not ran["grouped_glu_decode"])):
            raise AssertionError(
                f"serve_graph_mixtral/{label}: ids equal {got == want}, "
                f"launches {launches} want {want_l}, replays {replays}, "
                f"runs {eng.worker_runs}")
        for k in out:
            out[k]["launches"] += launches[k]
            out[k]["worker_replays"] += ran[k]
            if k in traced:
                out[k]["traced"][label] = traced[k]
        rep = eng.stats.report()
        runs_line[label] = dict(
            ids_equal_eager=True, worker_replays=replays,
            capture_launches=launches, traced_kernel_runs=traced,
            window=win,
            step_latency_p50_ms=rep["step_latency_p50_ms"],
            eager_step_latency_p50_ms=want_rep["step_latency_p50_ms"],
            output_tok_per_s=len(got) * new / wall)
        del eng
        torch.cuda.empty_cache()
    emit("serve_graph_mixtral", layers=nl, dtype=str(cfg.dtype),
         sync_debug_mode="error", **runs_line)
    del sd
    free_cuda()
    check_freed("serve_graph_mixtral", base)
    return out


def bundle_inputs(cfg, ecfg):
    """The bundle phase's inputs, made from seed 5 on the CPU: two prompts
    (300 and 200 tokens) packed into the prefill worker's width over slots
    0 and 1, their next tokens in the decode worker's, and two contiguous
    prompts (100 and 73 tokens)."""
    from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION

    rng = np.random.RandomState(5)
    e = ecfg
    tables = np.full((e.max_slots, e.max_blocks_per_seq), -1, np.int32)
    blocks = rng.permutation(e.num_blocks)
    tables[0, :19] = blocks[:19]          # 300 tokens, block 16
    tables[1, :13] = blocks[19:32]        # 200 tokens
    width = e.prefill_budget or e.token_budget
    tokens = np.zeros((1, width), np.int32)
    positions = np.full((1, width), PAD_POSITION, np.int32)
    slots = np.full((width,), e.max_slots, np.int32)
    tokens[0, :500] = rng.randint(0, cfg.vocab_size, 500)
    positions[0, :300] = np.arange(300)
    positions[0, 300:500] = np.arange(200)
    slots[:300], slots[300:500] = 0, 1
    dtok = np.zeros((1, e.max_slots), np.int32)
    dpos = np.full((1, e.max_slots), PAD_POSITION, np.int32)
    dslots = np.full((e.max_slots,), e.max_slots, np.int32)
    dtok[0, :2] = rng.randint(0, cfg.vocab_size, 2)
    dpos[0, :2] = (300, 200)
    dslots[:2] = (0, 1)
    ids = rng.randint(0, cfg.vocab_size, (2, 100))
    t = torch.from_numpy
    return dict(tables=t(tables), prefill=(t(tokens), t(positions),
                                            t(slots)),
                decode=(t(dtok), t(dpos), t(dslots)), ids=ids,
                plen=np.array([100, 73]))


#: the contiguous bundle's prompt bucket and new tokens
BUNDLE_BUCKET, BUNDLE_NEW = 128, 16


def run_bundles(paged, contig, cfg, ecfg):
    """Each key of the two bundles on :func:`bundle_inputs`, and
    ``bundle_generate``: CPU tensors by name."""
    from neuronx_distributed_tpu_torch.inference import model_builder as mb
    from neuronx_distributed_tpu_torch.inference.kv_cache import PAD_POSITION

    dev = torch.device("cuda")
    x = bundle_inputs(cfg, ecfg)
    out = {}
    state = paged.init_state()
    state.block_tables.copy_(x["tables"])
    out["chunked_prefill"], state = paged.forward(
        "chunked_prefill", paged.params, state,
        *(a.to(dev) for a in x["prefill"]))
    out["token_decode"], _ = paged.forward(
        "token_decode", paged.params, state,
        *(a.to(dev) for a in x["decode"]))
    ids = torch.from_numpy(np.pad(x["ids"], ((0, 0), (0, BUNDLE_BUCKET
                                                      - 100)))).to(dev)
    plen = torch.from_numpy(x["plen"]).to(dev, torch.int32)
    ar = torch.arange(BUNDLE_BUCKET, dtype=torch.int32, device=dev)
    positions = torch.where(ar[None] < plen[:, None], ar[None],
                            torch.full_like(ar[None], PAD_POSITION))
    cache = contig.init_state()
    out["context_encoding"], cache = contig.forward(
        "context_encoding", contig.params, ids.to(torch.int32), positions,
        cache)
    rows = torch.arange(2, device=dev)
    tok = out["context_encoding"][rows, plen.long() - 1].argmax(-1)
    out["token_generation"], _ = contig.forward(
        "token_generation", contig.params, tok[:, None].to(torch.int32),
        plen[:, None], cache)
    out["ids"] = mb.bundle_generate(contig, x["ids"], x["plen"], BUNDLE_NEW)
    return {k: v.cpu() for k, v in out.items()}


_BUNDLE_CHILD = """
import sys, torch
import chip_smoke as cs
from neuronx_distributed_tpu_torch.inference import model_builder as mb
from neuronx_distributed_tpu_torch.inference.engine import EngineConfig
from neuronx_distributed_tpu_torch.models.llama import LLAMA3_8B
paged, contig, out = sys.argv[1:4]
cfg, ecfg = cs.bundle_configs(LLAMA3_8B, EngineConfig)
res = cs.run_bundles(mb.NxDModel.load(paged), mb.NxDModel.load(contig),
                     cfg, ecfg)
torch.save(res, out)
print("bundle child ok", flush=True)
"""


def bundle_configs(base, engine_config_cls):
    """Llama-3-8B's widths at 4 layers and phase 12's disaggregated
    geometry with 8 slots."""
    cfg = dataclasses.replace(base, num_layers=4)
    ecfg = engine_config_cls(block_size=16, num_blocks=2048, max_slots=8,
                             max_blocks_per_seq=128, token_budget=512,
                             disaggregated=True, prefill_budget=512)
    return cfg, ecfg


def phase_bundle(base, meanwhile=None):
    """Phase 43; ``meanwhile`` (phase 44) runs here while the fresh
    process loads and runs the bundles. Returns K1's launches in this
    process (the captures)."""
    import functools

    from neuronx_distributed_tpu_torch.inference import model_builder as mb
    from neuronx_distributed_tpu_torch.inference.engine import EngineConfig
    from neuronx_distributed_tpu_torch.inference.generation import generate
    from neuronx_distributed_tpu_torch.inference.kv_cache import (
        init_kv_cache)
    from neuronx_distributed_tpu_torch.models import llama
    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention)

    cfg, ecfg = bundle_configs(base, EngineConfig)
    start = memory_base()
    sd = serving_weights(cfg)
    paged_attention.launches = 0
    t0 = time.perf_counter()
    paged = mb.register_serving_workers(mb.ModelBuilder(), cfg, ecfg,
                                        sd).trace().compile()
    spec = mb.serving_state_spec(cfg, ecfg)
    paged.state_spec, paged.params = spec, sd
    paged.device = torch.device("cuda")
    b, max_len = 2, BUNDLE_BUCKET + 64       # generate's cache length
    cspec = dict(num_layers=cfg.num_layers, batch=b, max_len=max_len,
                 num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
                 dtype="bfloat16")
    cache0 = init_kv_cache(**{**cspec, "dtype": torch.bfloat16})
    fn = functools.partial(mb.cached_step, model_cfg=cfg)

    def z(*s):
        return torch.zeros(s, dtype=torch.int32, device="cuda")

    contig = (mb.ModelBuilder()
              .add("context_encoding", fn, [(sd, z(b, BUNDLE_BUCKET),
                                             z(b, BUNDLE_BUCKET), cache0)])
              .add("token_generation", fn, [(sd, z(b, 1), z(b, 1), cache0)])
              .trace().compile())
    contig.state_spec, contig.params = cspec, sd
    contig.generation_config = {"buckets": [BUNDLE_BUCKET]}
    contig.device = torch.device("cuda")
    capture_s = time.perf_counter() - t0
    here = run_bundles(paged, contig, cfg, ecfg)
    x = bundle_inputs(cfg, ecfg)
    ref = generate(llama.build_model(cfg, sd), x["ids"], x["plen"],
                   BUNDLE_NEW, buckets=(BUNDLE_BUCKET,)).cpu()
    launches = paged_attention.launches
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_bundle_", dir=build)
    try:
        paths = [os.path.join(workdir, n) for n in ("paged.nxd", "contig.nxd",
                                                      "child.pt")]
        t0 = time.perf_counter()
        paged.save(paths[0], params=sd, state_spec=spec)
        contig.save(paths[1], params=sd, state_spec=cspec,
                    generation_config={"buckets": [BUNDLE_BUCKET]})
        save_s = time.perf_counter() - t0
        sizes = [os.path.getsize(p) for p in paths[:2]]
        del paged, contig, cache0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with open(os.path.join(workdir, "child.err"), "w+") as err:
            child = subprocess.Popen(
                [sys.executable, "-c", _BUNDLE_CHILD, *paths],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=subprocess.DEVNULL, stderr=err)
            try:
                if meanwhile is not None:
                    meanwhile()
                child.wait(timeout=400)
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait()
            child_s = time.perf_counter() - t0
            if child.returncode != 0:
                err.seek(0)
                raise AssertionError(f"bundle child failed:\n"
                                     f"{err.read()[-3000:]}")
        there = torch.load(paths[2])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    same = {k: torch.equal(here[k], there[k]) for k in here}
    if (not all(same.values()) or not torch.equal(here["ids"], ref)
            or not torch.equal(there["ids"], ref) or not launches):
        raise AssertionError(f"bundle: bits equal {same}, ids equal here "
                             f"{torch.equal(here['ids'], ref)} there "
                             f"{torch.equal(there['ids'], ref)}")
    emit("bundle", layers=cfg.num_layers, dtype=str(cfg.dtype),
         keys={"paged": ["chunked_prefill", "token_decode"],
               "contiguous": ["context_encoding", "token_generation"]},
         fresh_process_bits_equal=same, generate_ids_equal=True,
         capture_s=capture_s, save_s=save_s, fresh_process_s=child_s,
         bundle_bytes=sizes, k1_capture_launches=launches)
    del sd
    free_cuda()
    check_freed("bundle", start)
    return launches


def start_benchmark():
    """Phase 44 started: the benchmark command line on the card, in a
    process of its own whose output goes to temporary files
    (:func:`finish_benchmark` takes its line, :func:`stop_process` ends
    it)."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "neuronx_distributed_tpu_torch.inference."
         "benchmark"], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=out, stderr=err)
    proc.files = (out, err)
    return proc


def stop_process(proc):
    """Ends ``proc`` if it still runs."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def phase_benchmark():
    """Phase 44: the benchmark command line on the card."""
    proc = start_benchmark()
    try:
        finish_benchmark(proc)
    finally:
        stop_process(proc)


def finish_benchmark(proc):
    """Phase 44's end: waits for the process :func:`start_benchmark`
    started and checks and prints its last line."""
    proc.wait(timeout=300)
    out, err = proc.files
    for f in proc.files:
        f.seek(0)
    if proc.returncode != 0:
        raise AssertionError(f"benchmark exited {proc.returncode}:\n"
                             f"{err.read()[-3000:]}")
    line = out.read().strip().splitlines()[-1]
    parsed = json.loads(line)
    if (parsed["metric"] != "decode_tokens_per_sec_gpu"
            or not parsed["value"] > 0):
        raise AssertionError(f"benchmark: {line}")
    print(line, flush=True)
    emit("benchmark", metric=parsed["metric"], value=parsed["value"],
         unit=parsed["unit"])


# ---------------------------------------------------------------------------
# phases 45-48: GPT-NeoX, BERT and ViT
# ---------------------------------------------------------------------------

#: (case, dtype, B, S, N, D, causal, dropout p): the families' attention
#: at their published widths (D 96 and 80 padded to the kernels' 128)
FAMILY_FLASH_CASES = (
    ("neox20b_bf16", torch.bfloat16, 1, 2048, 64, 96, True, 0.0),
    ("neox20b_fp32", torch.float32, 1, 2048, 64, 96, True, 0.0),
    ("bert_large_bf16", torch.bfloat16, 8, 512, 16, 64, False, 0.0),
    ("bert_large_bf16_dropout", torch.bfloat16, 8, 512, 16, 64, False, 0.1),
    ("vit_huge_bf16", torch.bfloat16, 32, 257, 16, 80, False, 0.0),
    ("vit_base_bf16", torch.bfloat16, 32, 197, 12, 64, False, 0.0),
)


def family_flash_run(q, k, v, g, causal, p, seed):
    """``(out, dq, dk, dv)`` of ``flash_attention`` (K2-K4, a D that is not
    64 or 128 zero-padded around them) with ``g`` as out's gradient."""
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, dropout_p=p,
                             dropout_seed=seed)
    out.backward(g)
    return (out.detach(), *(t.grad for t in leaves))


def padded_flash_inputs(q, k, v, g):
    """q, k, v and g zero-padded to the kernels' head width, as
    ``flash_attention`` pads them, and the unpadded width's scale."""
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    d = q.shape[-1]
    width = fa.kernel_head_dim(d)
    return [F.pad(t, (0, width - d)) for t in (q, k, v, g)], 1.0 / np.sqrt(d)


def family_flash_timing(q, k, v, g, causal, p, seed, flush):
    """Each kernel's ms and its plain version's on the padded tensors they
    take, SDPA's forward and backward (undropped) on the unpadded tensors,
    the bound of the useful (unpadded) work, and the forward entry's ms
    (pad, K2, slice)."""
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    (qp, kp, vp, gp), scale = padded_flash_inputs(q, k, v, g)
    outp, lsep = fa.flash_fwd_cuda(qp, kp, vp, causal, scale, p, seed)
    bwdp = (qp, kp, vp, gp, lsep, fa.attention_delta(gp, outp), causal,
            scale, p, seed)
    calls = {"flash_fwd": (
                 lambda: fa.flash_fwd_cuda(qp, kp, vp, causal, scale, p,
                                           seed),
                 lambda: fa.flash_fwd_plain(qp, kp, vp, causal, scale, p,
                                            seed)),
             "flash_bwd_dq": (lambda: fa.flash_bwd_dq_cuda(*bwdp),
                              lambda: fa.flash_bwd_dq_plain(*bwdp)),
             "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv_cuda(*bwdp),
                               lambda: fa.flash_bwd_dkv_plain(*bwdp))}
    bounds = flash_bounds(q, k, causal)
    fwd_ms, bwd_ms = sdpa_yardsticks(q, k, v, g, causal, flush)
    timing = {}
    for name, (kern, plain) in calls.items():
        t = timing[name] = dict(kernel_ms=time_ms(kern, flush=flush),
                                plain_ms=time_ms(plain, reps=3, warmup=1,
                                                 flush=flush),
                                library_ms=fwd_ms if name == "flash_fwd"
                                else bwd_ms, **bounds[name])
        t["useful_tflops"] = t["flops"] / t["kernel_ms"] / 1e9
    with torch.no_grad():
        timing["flash_fwd"]["entry_ms"] = time_ms(
            lambda: fa.flash_attention(q, k, v, causal=causal, dropout_p=p,
                                       dropout_seed=seed), flush=flush)
    return timing


def family_flash_case(i, case, dtype, b, s, n, d, causal, p, flush):
    """One ``FAMILY_FLASH_CASES`` row of phase 45: its errors, bits and
    times."""
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    q, k, v, g = flash_inputs(300 + i, b=b, s=s, n=n, kv=n, d=d, dtype=dtype)
    seed = 4321 + i
    counters = [fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv]
    before = [c.launches for c in counters]
    got = family_flash_run(q, k, v, g, causal, p, seed)
    torch.cuda.synchronize()
    launched = [c.launches - x for c, x in zip(counters, before)]
    if launched != [1, 1, 1]:
        raise AssertionError(f"flash_families {case}: K2-K4 launched "
                             f"{launched}, want once each")
    (qp, kp, vp, gp), scale = padded_flash_inputs(q, k, v, g)
    out, lse = fa.flash_fwd_plain(qp, kp, vp, causal, scale, p, seed)
    args = (qp, kp, vp, gp, lse, fa.attention_delta(gp, out), causal, scale,
            p, seed)
    ref = [t[..., :d] for t in (out, fa.flash_bwd_dq_plain(*args),
                                *fa.flash_bwd_dkv_plain(*args))]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    names = ("out", "dq", "dk", "dv")
    errs, rels = {}, {}
    for name, a, r in zip(names, got, ref):
        rel = flash_rel_err(a, r)
        if not (rel <= tol) or not torch.isfinite(a).all():
            raise AssertionError(f"flash_families {case} {name}: error "
                                 f"{rel} of |ref| + rms(row) above {tol}")
        errs[name] = (a.float() - r.float()).abs().max().item()
        rels[name] = rel
    res = dict(case=case, dtype=str(dtype), shape=[b, s, n, d],
               kernel_head_dim=fa.kernel_head_dim(d), causal=causal,
               dropout_p=p, tol=tol, max_abs_err=errs, max_rel_err=rels)
    if dtype == torch.bfloat16:
        again = family_flash_run(q, k, v, g, causal, p, seed)
        torch.cuda.synchronize()
        for name, a, c in zip(names, got, again):
            if not torch.equal(a, c):
                raise AssertionError(f"flash_families {case} {name}: two "
                                     "runs on the same inputs differ")
        res["deterministic"] = True
    res["timing"] = family_flash_timing(q, k, v, g, causal, p, seed, flush)
    return res


def neox_padding_cost(flush):
    """What the padding costs NeoX's forward: the entry at D=96 (pad, K2 at
    128, slice) against K2 on D=128 tensors of the same B, S and N."""
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = flash_inputs(399, b=1, s=2048, n=64, kv=64, d=96)
    q8, k8, v8, _ = flash_inputs(398, b=1, s=2048, n=64, kv=64, d=128)
    with torch.no_grad():
        pad = dict(
            entry_d96_ms=time_ms(lambda: fa.flash_attention(q, k, v),
                                 flush=flush),
            k2_d128_ms=time_ms(lambda: fa.flash_fwd_cuda(q8, k8, v8),
                               flush=flush),
            k2_d96_bound_ms=flash_bounds(q, k, True)["flash_fwd"]["bound_ms"],
            k2_d128_bound_ms=flash_bounds(q8, k8, True)["flash_fwd"][
                "bound_ms"])
    pad["pad_overhead_ms"] = pad["entry_d96_ms"] - pad["k2_d128_ms"]
    pad["useful_share"] = 96 / 128
    return pad


def phase_flash_families():
    """Phase 45: ``flash_attention`` at GPT-NeoX-20B's, BERT-large's,
    ViT-Huge/14's and ViT-Base's attention shapes (``FAMILY_FLASH_CASES``)
    against the plain versions on the inputs the kernels take (zero-padded
    to their width, the output sliced back), element by element
    (``flash_rel_err``: bf16 2e-2, fp32 1e-4), each of K2, K3 and K4
    launched once; in bf16 a second run equal to the first bit for bit.
    (At the unpadded width the plain delta sums 96 terms where the path's
    sums 128, and causal dq's first row, zero but for rounding, then parts
    by 3e-4 of the 1e-3 max|dq| term in fp32, as the plain fp32 version
    itself does from a float64 one; the CPU tests hold the padded against
    the unpadded plain versions within 1e-6.)
    Times each kernel, its plain version and SDPA beside the bound, and
    the cost of padding (``neox_padding_cost``)."""
    base = memory_base()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    results = [family_flash_case(i, *row, flush)
               for i, row in enumerate(FAMILY_FLASH_CASES)]
    emit("flash_families", cases=results,
         neox_padding=neox_padding_cost(flush))
    del flush
    free_cuda()
    check_freed("flash_families", base)
    return results


def phase_train_families(steps=5):
    """Phase 46: ``make_train_step`` (fp32 params, bf16 compute, flash
    attention, AdamW lr 1e-4 clipped at 1.0) for ``steps`` steps on one
    batch of each family (``scripts.workloads.family_train_workload``):
    GPT-NeoX-20B's widths at 4 layers (B=1, S=2048), BERT-large at 24
    layers with the tied MLM head (B=8, S=512, 15% labelled), ViT-Huge/14 at
    32 layers (B=32 images). Finite losses and grad norms; K2, K3 and K4
    each launched layers x steps times (K2 twice that under remat); the
    model freed by ``del``. Returns each kernel's launches per family."""
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_tpu_torch.scripts.workloads import (
        family_train_workload)

    counters = {name: getattr(fa, name) for name, _ in FLASH_KERNELS}
    out = {}
    for family in ("neox", "bert", "vit"):
        base = memory_base()
        torch.cuda.reset_peak_memory_stats()
        w = family_train_workload(family)
        cfg, state, step, batch = w.cfg, w.state, w.step, w.batch
        n_params = sum(p.numel() for p in state.params.values())
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        losses, norms, times = [], [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
        launches = {name: c.launches for name, c in counters.items()}
        if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
            raise AssertionError(f"train_families {family}: non-finite loss "
                                 f"or grad norm: {losses} {norms}")
        for name, n in launches.items():
            want = cfg.num_layers * steps * (
                2 if cfg.remat and name == "flash_fwd" else 1)
            if n != want:
                raise AssertionError(f"train_families {family}: {name} "
                                     f"launched {n} times, want {want} "
                                     "(layers x steps)")
        p50 = float(np.median(times))
        rows = next(iter(batch.values())).shape[0]
        out[family] = launches
        emit(f"train_{family}", config=type(cfg).__name__,
             layers=cfg.num_layers, params=n_params, batch=rows,
             head_dim=cfg.hidden_size // cfg.num_heads,
             compute_dtype=str(cfg.dtype), param_dtype=str(cfg.param_dtype),
             steps=steps, losses=losses, grad_norms=norms, step_ms=times,
             step_ms_p50=p50, samples_per_s=rows / (p50 / 1e3),
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             launches=launches)
        del w, cfg, state, step, batch, m
        free_cuda()
        check_freed(f"train_{family}", base)
    return out


def phase_vit_serve(buckets=(1, 8, 32), reps=20):
    """Phase 47: ViT-Huge/14 at all 32 layers in bf16 (flash attention,
    random weights, seed 0, std 0.02) through ``ModelBuilder`` with batch
    buckets 1, 8 and 32 (``register_image_encoder``, the reference's
    ``vit_serve.py``): a batch of 5 routes to bucket 8; each bucket's
    captured logits equal the eager forward's on the same (padded) batch
    bit for bit; K2 launched only by the captures (warm-up and capture: 2
    x layers a bucket), never by a replay. Prints p50 ms per bucket (CUDA
    events around ``forward``) and images/s. Returns K2's capture
    launches."""
    from neuronx_distributed_tpu_torch.inference import model_builder as mb
    from neuronx_distributed_tpu_torch.models import vit
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    base = memory_base()
    cfg = dataclasses.replace(vit.VIT_HUGE, use_flash_attention=True)
    sd = vit.init_state_dict(dataclasses.replace(cfg, param_dtype=cfg.dtype),
                             seed=0, std=0.02)
    weight_gib = sum(t.numel() * t.element_size()
                     for t in sd.values()) / 2 ** 30
    fa.flash_fwd.launches = 0
    t0 = time.perf_counter()
    served = mb.register_image_encoder(mb.ModelBuilder(), cfg, sd,
                                       buckets).trace().compile()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    captures = fa.flash_fwd.launches
    if captures != 2 * cfg.num_layers * len(buckets):
        raise AssertionError(f"vit_serve: K2 launched {captures} times by "
                             f"the captures, want 2 x {cfg.num_layers} x "
                             f"{len(buckets)}")
    gen = torch.Generator(device="cuda").manual_seed(7)
    shape = (cfg.num_channels, cfg.image_size, cfg.image_size)
    px5 = torch.randn((5,) + shape, generator=gen, device="cuda")
    routed = served.router("image_encoder", (sd, px5)).leaves[-1].shape[0]
    if routed != 8:
        raise AssertionError(f"vit_serve: a batch of 5 routed to bucket "
                             f"{routed}, want 8")
    fa.flash_fwd.launches = 0
    batches = {b: torch.randn((b,) + shape, generator=gen, device="cuda")
               for b in buckets}
    graph = {5: served.forward("image_encoder", sd, px5, pad_inputs=True)}
    p50 = {}
    for b, px in batches.items():
        graph[b] = served.forward("image_encoder", sd, px)
        p50[b] = time_ms(lambda: served.forward("image_encoder", sd, px),
                         reps=reps)
    torch.cuda.synchronize()
    replay_launches = fa.flash_fwd.launches
    if replay_launches:
        raise AssertionError(f"vit_serve: replays launched K2 "
                             f"{replay_launches} times")
    model = vit.build_model(cfg, sd)
    with torch.no_grad():
        eager = {5: model(F.pad(px5, (0, 0, 0, 0, 0, 0, 0, 3)))}
        eager.update({b: model(px) for b, px in batches.items()})
    same = {b: torch.equal(graph[b], eager[b]) for b in graph}
    finite = all(torch.isfinite(x).all().item() for x in graph.values())
    if not all(same.values()) or not finite or graph[5].shape != (
            8, cfg.num_labels):
        raise AssertionError(f"vit_serve: captured logits equal eager "
                             f"{same}, finite {finite}, batch-5 shape "
                             f"{tuple(graph[5].shape)}")
    emit("vit_serve", layers=cfg.num_layers, dtype=str(cfg.dtype),
         weight_gib=weight_gib, buckets=list(buckets), batch5_bucket=routed,
         capture_s=capture_s, k2_capture_launches=captures,
         k2_replay_launches=replay_launches, bits_equal_eager=same,
         p50_ms={str(b): v for b, v in p50.items()},
         images_per_s={str(b): b / (v / 1e3) for b, v in p50.items()})
    del served, model, sd, graph, eager, batches, px5
    free_cuda()
    check_freed("vit_serve", base)
    return captures


def family_cross_inputs(family, cfg):
    """Phase 48's inputs (numpy seed 2, on the CPU) and the loss."""
    rng = np.random.RandomState(2)
    if family == "vit":
        px = torch.from_numpy(rng.randn(2, cfg.num_channels, cfg.image_size,
                                        cfg.image_size).astype(np.float32))
        labels = torch.from_numpy(rng.randint(0, cfg.num_labels, (2,)))
        return (px,), labels
    b = 1 if family == "neox" else 2
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, 129)))
    if family == "neox":
        return (ids[:, :-1],), ids[:, 1:]
    labels = torch.where(torch.from_numpy(rng.rand(b, 128) < 0.15),
                         ids[:, :-1], -100)
    return (ids[:, :-1],), labels


def phase_families_cross_check():
    """Phase 48: fp32, full width, 1 layer, flash attention, card against
    CPU from the same weights (made on the card, seed 1): GPT-NeoX-20B and
    BERT-large (tied MLM head) at S=128, ViT-Huge/14 at B=2. Logits within
    1e-4 x max|logit|, the loss within 1e-5 relative, every gradient within
    1e-3 of its norm. Without rotary (BERT, ViT) a key bias's exact
    gradient is zero (the softmax ignores a per-query constant), so its
    scale is its key kernel's gradient norm."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import neuronx_distributed_config
    from neuronx_distributed_tpu_torch.models import bert, gpt_neox, vit

    base = memory_base()
    fp32 = dict(num_layers=1, dtype=torch.float32, param_dtype=torch.float32,
                use_flash_attention=True)
    cells = {"neox": (gpt_neox, gpt_neox.GPTNeoXForCausalLM,
                      dataclasses.replace(gpt_neox.GPT_NEOX_20B, **fp32)),
             "bert": (bert, bert.BertForPreTraining,
                      dataclasses.replace(bert.BERT_LARGE, mlm_transform=True,
                                          **fp32)),
             "vit": (vit, vit.ViTForImageClassification,
                     dataclasses.replace(vit.VIT_HUGE, **fp32))}
    report = {}
    for family, (mod, cls, cfg) in cells.items():
        inputs, labels = family_cross_inputs(family, cfg)
        sd = mod.init_state_dict(cfg, seed=1, std=0.02)
        side = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            pm, params = trainer.initialize_parallel_model(
                neuronx_distributed_config(), cfg, state_dict=sd, device=dev)
            if type(pm.module) is not cls:
                raise AssertionError(f"families_cross_check: {family} built "
                                     f"a {type(pm.module).__name__}")
            args = [x.to(dev) for x in inputs]
            with torch.no_grad():
                logits = pm.module(*args)
            loss = pm.module.loss(*args, labels.to(dev))
            loss.backward()
            side[dev] = (logits.cpu(), loss.item(),
                         {n: p.grad.cpu() for n, p in params.items()
                          if p.grad is not None},
                         time.perf_counter() - t0)
            del pm, params, args, logits, loss
        del sd
        free_cuda()
        (lg, sg, gg, tg), (lc, sc, gc, tc) = side["cuda"], side["cpu"]
        logit_err = ((lg - lc).abs().max() / lc.abs().max()).item()
        if not logit_err <= 1e-4:
            raise AssertionError(f"families_cross_check {family}: logits "
                                 f"differ by {logit_err} of max|logit|")
        if not abs(sg - sc) <= 1e-5 * abs(sc):
            raise AssertionError(f"families_cross_check {family}: loss {sg} "
                                 f"vs CPU {sc}")
        if gg.keys() != gc.keys():
            raise AssertionError(f"families_cross_check {family}: gradients "
                                 f"of {sorted(gg.keys() ^ gc.keys())} on one "
                                 "side only")
        worst, worst_name = 0.0, None
        for name, ref in gc.items():
            scale = ref
            if family != "neox" and name.endswith("k_bias"):
                scale = gc[name[:-len("k_bias")] + "k_kernel"]
            rel = ((gg[name] - ref).norm() / scale.norm()).item()
            if rel > worst:
                worst, worst_name = rel, name
            if not rel <= 1e-3:
                raise AssertionError(f"families_cross_check {family}: "
                                     f"{name}'s gradient differs by {rel} of "
                                     "its norm")
        report[family] = dict(
            config=type(cfg).__name__, loss_card=sg, loss_cpu=sc,
            logit_rel_err=logit_err, max_grad_rel_diff=worst,
            max_grad_rel_diff_param=worst_name, card_s=tg, cpu_s=tc,
            params=sum(t.numel() for t in gc.values()))
        del side, gg, gc
    emit("families_cross_check", layers=1, dtype="float32", **report)
    free_cuda()
    check_freed("families_cross_check", base)


# ---------------------------------------------------------------------------
# phases 49-51: LoRA fine-tuning at full depth, merged and served
# ---------------------------------------------------------------------------

def lora_config():
    """The LoRA of phases 49-50: r=16, alpha 32 on qkv, o_proj, gate_up and
    down."""
    from neuronx_distributed_tpu_torch.lora import LoraConfig

    return LoraConfig(r=16, alpha=32.0,
                      target_modules=("qkv", "o_proj", "gate_up", "down"))


def hf_llama_state_dict(cfg, seed, dtype=torch.bfloat16, device="cuda"):
    """An HF-layout Llama state dict of ``cfg``'s widths made on
    ``device`` from a generator seeded with ``seed``: normal(0, 0.02)
    projections, embedding and head (``[out, in]``), unit norm scales."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim_, cfg.num_kv_heads * cfg.head_dim_
    shapes = {"model.embed_tokens.weight": (v, h)}
    for n in range(cfg.num_layers):
        pre = f"model.layers.{n}."
        shapes.update({
            pre + "self_attn.q_proj.weight": (q, h),
            pre + "self_attn.k_proj.weight": (kv, h),
            pre + "self_attn.v_proj.weight": (kv, h),
            pre + "self_attn.o_proj.weight": (h, q),
            pre + "mlp.gate_proj.weight": (i, h),
            pre + "mlp.up_proj.weight": (i, h),
            pre + "mlp.down_proj.weight": (h, i),
            pre + "input_layernorm.weight": (h,),
            pre + "post_attention_layernorm.weight": (h,)})
    shapes.update({"model.norm.weight": (h,), "lm_head.weight": (v, h)})
    return {name: (torch.ones(s, dtype=dtype, device=device)
                   if len(s) == 1 else
                   torch.randn(s, generator=gen, dtype=dtype,
                               device=device).mul_(0.02))
            for name, s in shapes.items()}


def converted_base(cfg, seed=0):
    """Phase 49's base: an HF bf16 Llama made on the card (``seed``),
    converted by ``scripts.checkpoint_converter``; the round trip back to
    HF must give every tensor bit for bit. The HF dict is freed. Returns
    (state dict, seconds to make, seconds to convert)."""
    from neuronx_distributed_tpu_torch.scripts import checkpoint_converter

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hf = hf_llama_state_dict(cfg, seed)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sd = checkpoint_converter.convert_hf_llama_to_nxd(hf, cfg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    back = checkpoint_converter.convert_nxd_to_hf_llama(sd, cfg)
    if back.keys() != hf.keys() or not all(torch.equal(back[k], t)
                                           for k, t in hf.items()):
        raise AssertionError("lora: the converter's round trip to HF is "
                             "not bit for bit")
    del hf, back
    return sd, t1 - t0, t2 - t1


def lora_batch(workdir, vocab, seq):
    """One ``[1, seq]`` batch through the data path: numpy seed 0 documents
    packed by ``scripts.prepare_dataset.pack_tokens`` into a uint32
    ``.bin``, read by the native ``TokenBatchLoader``."""
    from neuronx_distributed_tpu_torch.data import TokenBatchLoader
    from neuronx_distributed_tpu_torch.scripts.prepare_dataset import (
        pack_tokens)

    rng = np.random.RandomState(0)
    docs = [rng.randint(0, vocab, rng.randint(500, 3000)) for _ in range(40)]
    path = os.path.join(workdir, "lora_tokens.bin")
    pack_tokens(docs, seq, np.dtype(np.uint32)).tofile(path)
    loader = TokenBatchLoader(path, batch=1, seqlen=seq, seed=0,
                              dtype="uint32", nthreads=2)
    try:
        if not loader.native:
            raise AssertionError("lora_train: the native loader did not "
                                 "build")
        return next(iter(loader))
    finally:
        loader.close()


def phase_lora_train(workdir, steps=5, seq=4096, lr=1e-4):
    """Phase 49: LoRA fine-tuning of ``LLAMA3_8B`` at all 32 layers on one
    card. The base is an HF bf16 checkpoint made on the card, converted
    (round trip bit for bit) and held in fp32; fresh adapters
    (``init_lora_state``, seed 1) of :func:`lora_config`;
    ``make_lora_optimizer`` over AdamW (lr ``lr``, clipped at 1.0), bf16
    compute, flash attention, remat with ``save_attention``,
    ``loss_chunk=512``; ``steps`` steps on one native-loader batch inside a
    ``utils.timeline.Timeline`` saved under ``workdir``. Asserts finite
    and falling losses, every frozen tensor's ``fingerprint_array``
    unchanged, every B moved off zero, K2-K4 each launched layers x steps,
    the timeline's step events. Saves the adapters with ``torch.save``
    under ``workdir`` for phase 50; returns (path, launches)."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import neuronx_distributed_config
    from neuronx_distributed_tpu_torch.lora import (extract_lora_state,
                                                    is_lora_path,
                                                    make_lora_optimizer,
                                                    merge_lora_state)
    from neuronx_distributed_tpu_torch.models.llama import (LLAMA3_8B,
                                                            init_lora_state)
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_tpu_torch.resilience.integrity import (
        fingerprint_array)
    from neuronx_distributed_tpu_torch.utils.timeline import Timeline

    base_mem = memory_base()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(
        LLAMA3_8B, param_dtype=torch.float32, use_flash_attention=True,
        remat=True, remat_policy="save_attention", loss_chunk=512,
        lora=lora_config())
    sd, make_s, convert_s = converted_base(cfg)
    sd = merge_lora_state(sd, init_lora_state(cfg, seed=1))
    ncfg = neuronx_distributed_config()
    pm, params = trainer.initialize_parallel_model(ncfg, cfg, state_dict=sd)
    del sd
    free_cuda()
    tx = make_lora_optimizer(trainer.make_optimizer(ncfg, learning_rate=lr),
                             params)
    state = trainer.TrainState(0, params, tx.init(trainer.trainable(params)))
    step = trainer.make_train_step(pm, tx)
    frozen = {n: fingerprint_array(p.detach()) for n, p in params.items()
              if not is_lora_path(n)}
    n_train = sum(p.numel() for p in trainer.trainable(params))
    n_frozen = sum(p.numel() for n, p in params.items() if n in frozen)
    batch = lora_batch(workdir, cfg.vocab_size, seq)
    counters = {name: getattr(fa, name) for name, _ in FLASH_KERNELS}
    load_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    timeline = Timeline(os.path.join(workdir, "lora_timeline.json"))
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    losses, norms, times = [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        with timeline.event(f"lora_step_{i}"):
            state, m = step(state, batch)
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    launches = {name: c.launches for name, c in counters.items()}
    saved = json.load(open(timeline.save()))["traceEvents"]
    events = [e["name"] for e in saved if e["ph"] == "X"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = [n for n, p in params.items() if n.endswith("lora_b")
             and bool((p.detach() != 0).any())]
    n_b = sum(n.endswith("lora_b") for n in params)
    changed = [n for n, fp in frozen.items()
               if not torch.equal(fingerprint_array(params[n].detach()), fp)]
    want = cfg.num_layers * steps
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"lora_train: losses {losses}, norms {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"lora_train: loss did not fall: {losses}")
    if changed:
        raise AssertionError(f"lora_train: frozen tensors changed: "
                             f"{changed[:5]} ({len(changed)})")
    if len(moved) != n_b:
        raise AssertionError(f"lora_train: {n_b - len(moved)} of {n_b} B "
                             "adapters still zero")
    if any(n != want for n in launches.values()):
        raise AssertionError(f"lora_train: launches {launches}, want "
                             f"layers x steps = {want} each")
    if events != [f"lora_step_{i}" for i in range(steps)]:
        raise AssertionError(f"lora_train: timeline events {events}")
    path = os.path.join(workdir, "lora_adapters.pt")
    torch.save(extract_lora_state({n: p.detach()
                                   for n, p in params.items()}), path)
    p50 = float(np.median(times))
    emit("lora_train", layers=cfg.num_layers, seq=seq, steps=steps,
         lora=dataclasses.asdict(cfg.lora), lr=lr,
         remat_policy=cfg.remat_policy, loss_chunk=cfg.loss_chunk,
         compute_dtype=str(cfg.dtype), param_dtype=str(cfg.param_dtype),
         trainable_params=n_train, frozen_params=n_frozen,
         frozen_tensors=len(frozen), frozen_fingerprints_unchanged=True,
         b_adapters_moved=len(moved), hf_make_s=make_s, convert_s=convert_s,
         converter_round_trip_bitwise=True, losses=losses, grad_norms=norms,
         step_ms=times, step_ms_p50=p50, tokens_per_s=seq / (p50 / 1e3),
         peak_mem_gib=peak, load_peak_mem_gib=load_peak, launches=launches,
         timeline_events=len(events),
         adapter_bytes=os.path.getsize(path))
    del pm, params, state, step, tx, m, frozen
    free_cuda()
    check_freed("lora_train", base_mem)
    return path, launches


def lora_prefill_logits(model, ids, lens):
    """Last-prompt-token logits of ``generation.prefill`` over a fresh bf16
    contiguous cache, in fp32."""
    from neuronx_distributed_tpu_torch.inference import generation, kv_cache

    cfg = model.cfg
    cache = kv_cache.init_kv_cache(cfg.num_layers, ids.shape[0],
                                   ids.shape[1], cfg.num_kv_heads,
                                   cfg.head_dim_, dtype=cfg.dtype,
                                   device="cuda")
    with torch.no_grad():
        logits, _ = generation.prefill(model, ids, lens, cache)
    return logits.float()


def phase_lora_serve(adapter_path, ecfg, new=32, n=4, bf16_layers=1):
    """Phase 50: phase 49's adapters through ``torch.save`` /
    ``torch.load(weights_only=True)`` and ``merge_lora_state`` into a
    freshly converted bf16 base (the adapters bit for bit); the unmerged
    LoRA model's ``generate``; ``merge_lora_params`` into the base config,
    served on ``n`` requests by an eager ``ServingEngine`` and by one with
    an ``AotExecutableCache`` (K1 launched at the capture, twice a layer,
    then replayed), whose ids must equal the eager engine's.

    The merge is held at full depth in fp32: merged and unmerged prefill
    logits within 1e-4 of max|logit|, while the base model (what a merge
    that dropped every adapter would serve) lies more than ten times that
    from them. bf16 cannot hold the merge at 32 random layers: the two
    forms round differently (o_proj and down add their adapters in
    activation space, a merged kernel re-rounds), and the depth amplifies
    any rounding to about 6% of max|logit|, as far as the trained
    adapters' own effect (``scripts/lora_bf16_floor.py``). So bf16 is held
    at ``bf16_layers`` layers of the same base, every target at full
    width, with adapters drawn normal(0, 0.02) (seed 1): merged within
    2e-2 of max|logit| of the unmerged logits, the base beyond 2e-2. On an
    H100 ``lora_bf16_floor`` read 0.0128 and 0.62 for these at 1 layer,
    0.0173 and 0.79 at 2 (the merged gap is bf16's own floor, 0.0124 and
    0.0157, whatever the adapters' size). Returns (K1 launches, worker
    replays)."""
    from neuronx_distributed_tpu_torch.inference import generation
    from neuronx_distributed_tpu_torch.inference.aot_cache import (
        AotExecutableCache)
    from neuronx_distributed_tpu_torch.inference.engine import ServingEngine
    from neuronx_distributed_tpu_torch.lora import (is_lora_path,
                                                    merge_lora_params,
                                                    merge_lora_state)
    from neuronx_distributed_tpu_torch.models.llama import (LLAMA3_8B,
                                                            build_model)
    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention)

    base_mem = memory_base()
    torch.cuda.reset_peak_memory_stats()
    lora = lora_config()
    scfg = dataclasses.replace(LLAMA3_8B, use_flash_attention=True)
    lcfg = dataclasses.replace(scfg, lora=lora)
    fp32 = dict(dtype=torch.float32)
    adapters = torch.load(adapter_path, map_location="cuda",
                          weights_only=True)
    base, _, _ = converted_base(scfg)
    sd = merge_lora_state(base, adapters)
    if not all(torch.equal(sd[k], t) for k, t in adapters.items()):
        raise AssertionError("lora_serve: merged adapters differ")
    rng = np.random.RandomState(5)
    lens = np.array([200, 137])
    ids = np.zeros((2, 256), np.int64)
    for r, k in enumerate(lens):
        ids[r, :k] = rng.randint(0, scfg.vocab_size, k)
    ids_t, lens_t = torch.from_numpy(ids).cuda(), torch.from_numpy(lens).cuda()

    def prefill(cfg, weights):
        model = build_model(cfg, weights)
        out = lora_prefill_logits(model, ids_t, lens_t)
        del model
        free_cuda()
        return out

    def gap(a, b):
        return ((logits[a] - logits[b]).abs().max()
                / logits[b].abs().max()).item()

    # bf16 at bf16_layers layers of the same base, adapters of a size
    # that bf16 can see
    gen = torch.Generator(device="cuda").manual_seed(1)
    shallow = {k: t for k, t in base.items()
               if not k.startswith("layers.")
               or int(k.split(".")[1]) < bf16_layers}
    shallow.update({k: torch.randn(t.shape, generator=gen, device="cuda")
                    * 0.02 for k, t in adapters.items()
                    if int(k.split(".")[1]) < bf16_layers})
    c2 = dataclasses.replace(scfg, num_layers=bf16_layers)
    lc2 = dataclasses.replace(c2, lora=lora)
    logits = {"base_bf16": prefill(c2, {k: t for k, t in shallow.items()
                                        if not is_lora_path(k)}),
              "base_fp32": prefill(dataclasses.replace(c2, **fp32),
                                   {k: t for k, t in shallow.items()
                                    if not is_lora_path(k)}),
              "unmerged_bf16": prefill(lc2, shallow)}
    logits["merged_bf16"] = prefill(c2, {
        k: t.to(scfg.dtype)
        for k, t in merge_lora_params(shallow, lora).items()})
    shallow_gaps = {"merged_vs_unmerged_bf16": gap("merged_bf16",
                                                   "unmerged_bf16"),
                    "dropped_merge_vs_unmerged_bf16": gap("base_bf16",
                                                          "unmerged_bf16"),
                    "bf16_floor_base": gap("base_bf16", "base_fp32")}
    finite = all(torch.isfinite(t).all() for t in logits.values())
    del shallow
    # fp32 at full depth
    model = build_model(lcfg, sd)
    unmerged_ids = generation.generate(model, ids, lens, 8, buckets=(256,))
    del model
    logits = {"unmerged_fp32": prefill(dataclasses.replace(lcfg, **fp32),
                                       sd),
              "base_fp32": prefill(dataclasses.replace(scfg, **fp32), base)}
    t0 = time.perf_counter()
    merged = merge_lora_params(sd, lora)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    del sd, base, adapters
    logits["merged_fp32"] = prefill(dataclasses.replace(scfg, **fp32),
                                    merged)
    for k in list(merged):        # bf16 one tensor at a time
        merged[k] = merged[k].to(scfg.dtype)
    free_cuda()
    # the merged model served, eager then captured
    prompts = [p[:512] for p in serve_requests(scfg, seed=3, n=n)]
    served = {}
    for name in ("eager", "graph"):
        cache = AotExecutableCache() if name == "graph" else None
        torch.cuda.synchronize()
        paged_attention.launches = 0
        eng = ServingEngine(scfg, merged, ecfg, aot_cache=cache)
        capture_launches = paged_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r, p in enumerate(prompts):
            eng.submit(p, new, uid=f"r{r}")
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bad = [u for u, r in res.items()
               if r.status != "completed" or len(r.tokens) != new]
        if bad or len(res) != n:
            raise AssertionError(f"lora_serve: {name} requests incomplete: "
                                 f"{bad}")
        served[name] = {u: r.tokens for u, r in res.items()}
        if name == "eager":
            del eng
            free_cuda()
    replays = sum(eng.worker_replays().values())
    logits["merged_bf16"] = lora_prefill_logits(eng.model, ids_t, lens_t)
    merged_ids = generation.generate(eng.model, ids, lens, 8, buckets=(256,))
    gaps = {"merged_vs_unmerged_fp32": gap("merged_fp32", "unmerged_fp32"),
            "adapter_effect_fp32": gap("base_fp32", "unmerged_fp32"),
            "merged_bf16_vs_unmerged_fp32": gap("merged_bf16",
                                                "unmerged_fp32")}
    nl = scfg.num_layers
    emit("lora_serve", layers=nl, requests=n, new_tokens=n * new,
         adapters_bitwise=True, merge_s=merge_s,
         k1_capture_launches=capture_launches, worker_replays=replays,
         ids_equal_eager=served["graph"] == served["eager"],
         logit_gaps_of_max=gaps, bf16_layers=bf16_layers,
         bf16_logit_gaps_of_max=shallow_gaps,
         unmerged_ids=unmerged_ids.tolist(), merged_ids=merged_ids.tolist(),
         greedy_match_share_bf16_vs_unmerged=match_share(
             dict(enumerate(merged_ids.tolist())),
             dict(enumerate(unmerged_ids.tolist()))),
         output_tok_per_s=n * new / wall,
         step_latency_p50_ms=eng.stats.report()["step_latency_p50_ms"],
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if (capture_launches != 2 * nl or paged_attention.launches != 2 * nl
            or not replays):
        raise AssertionError(
            f"lora_serve: K1 launches {capture_launches}/"
            f"{paged_attention.launches} want {2 * nl}, replays {replays}")
    if served["graph"] != served["eager"]:
        raise AssertionError("lora_serve: the captured engine's ids differ "
                             "from the eager engine's")
    if not (finite and all(torch.isfinite(t).all()
                           for t in logits.values())):
        raise AssertionError("lora_serve: non-finite logits")
    if not (gaps["merged_vs_unmerged_fp32"] <= 1e-4
            and gaps["adapter_effect_fp32"] > 1e-3):
        raise AssertionError(
            f"lora_serve: fp32 merged logits differ by "
            f"{gaps['merged_vs_unmerged_fp32']} of max (limit 1e-4), the "
            f"adapters' effect {gaps['adapter_effect_fp32']} (above 1e-3)")
    if not (shallow_gaps["merged_vs_unmerged_bf16"] <= 2e-2
            < shallow_gaps["dropped_merge_vs_unmerged_bf16"]):
        raise AssertionError(
            f"lora_serve: at {bf16_layers} layers bf16 merged logits differ "
            f"by {shallow_gaps['merged_vs_unmerged_bf16']} of max (limit "
            "2e-2), the base by "
            f"{shallow_gaps['dropped_merge_vs_unmerged_bf16']} (above it)")
    launches = paged_attention.launches
    del eng, cache, merged, logits
    free_cuda()
    check_freed("lora_serve", base_mem)
    return launches, replays


def lora_cross_inputs(layers, seq):
    """``(cfg, sd, batch)`` of ``lora_cross_check``: Llama-3-8B's widths at
    ``layers`` layers, fp32, LoRA on all six targets with B made nonzero
    (seed 2), the weights made on the CPU from seed 1, a batch at
    ``seq``."""
    from neuronx_distributed_tpu_torch.lora import LoraConfig, is_lora_path
    from neuronx_distributed_tpu_torch.models.llama import (LLAMA3_8B,
                                                            init_state_dict)
    from neuronx_distributed_tpu_torch.scripts.workloads import train_batch

    cfg = dataclasses.replace(
        LLAMA3_8B, num_layers=layers, dtype=torch.float32,
        param_dtype=torch.float32, use_flash_attention=True,
        lora=LoraConfig(r=16, alpha=32.0, target_modules=(
            "qkv", "o_proj", "gate_up", "down", "embed", "lm_head")))
    sd = init_state_dict(cfg, seed=1, std=0.02, device="cpu")
    gen = torch.Generator().manual_seed(2)
    for n, t in sd.items():
        if is_lora_path(n) and not t.any():
            sd[n] = torch.randn(t.shape, generator=gen) * 0.02
    return cfg, sd, train_batch(cfg.vocab_size, seq, seed=1)


def lora_side(dev, cfg, sd, batch, steps):
    """One side of ``lora_cross_check`` on ``dev`` from
    :func:`lora_cross_inputs`: ``(metrics, adapter gradients, updates,
    captured intermediates, seconds)``, on the host. The CPU side runs as a
    ``CpuSide`` job (``lora_cpu_half``)."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import neuronx_distributed_config
    from neuronx_distributed_tpu_torch.lora import make_lora_optimizer
    from neuronx_distributed_tpu_torch.utils.tensor_capture import (
        capture_intermediates)

    t0 = time.perf_counter()
    ncfg = neuronx_distributed_config()
    pm, params = trainer.initialize_parallel_model(ncfg, cfg, state_dict=sd,
                                                   device=dev)
    tx = make_lora_optimizer(trainer.make_optimizer(
        ncfg, learning_rate=1e-3), params)
    ids = batch["input_ids"].to(dev)
    with torch.no_grad():
        _, caps = capture_intermediates(
            pm.module, ids, filter_fn=lambda m, p: p.count(".") <= 2)
    caps = {k: tuple(t.cpu() if torch.is_tensor(t) else t for t in v)
            for k, v in caps.items() if all(torch.is_tensor(t) for t in v)}
    pm.module.loss(ids, batch["labels"].to(dev)).backward()
    grads = {n: p.grad.cpu() for n, p in params.items()
             if p.grad is not None}
    for p in params.values():
        p.grad = None
    state = trainer.TrainState(0, params, tx.init(trainer.trainable(params)))
    step = trainer.make_train_step(pm, tx)
    metrics = [step(state, batch)[1] for _ in range(steps)]
    out = ([(m["loss"].item(), m["grad_norm"].item()) for m in metrics],
           grads, {n: p.detach().cpu() - sd[n] for n, p in params.items()},
           caps, time.perf_counter() - t0)
    del pm, params, tx, state, step, metrics
    return out


def lora_cpu_half(layers, seq, steps):
    """``lora_cross_check``'s inputs and its CPU side, for the
    ``CpuSide`` thread."""
    cfg, sd, batch = lora_cross_inputs(layers, seq)
    return {"inputs": (cfg, sd, batch),
            "side": lora_side("cpu", cfg, sd, batch, steps)}


def phase_lora_cross_check(cpu_side, layers=2, seq=256, steps=2):
    """Phase 51: ``LLAMA3_8B``'s widths at 2 layers, fp32, LoRA on all six
    targets (B made nonzero, seed 2), S=256: one backward and ``steps``
    steps of ``make_lora_optimizer`` on the card and on the CPU (the CPU
    side computed beforehand on the ``CpuSide`` thread, :func:`lora_side`)
    from the same state: each loss within 1e-4 relative and ``grad_norm``
    within 1e-3, each adapter gradient and each adapter's update within
    1e-3 of its norm, the base unchanged on both. Prints the largest
    per-module gaps of one forward through
    ``tensor_capture.capture_intermediates`` and ``max_diff``. Then one
    conv LoRA pair (Output- then InputChannelParallelConv2d, 3x3, 64 ->
    128 -> 64 channels, rank 8, bf16 compute) on the card against the CPU,
    within 2e-2 of max|y|."""
    from neuronx_distributed_tpu_torch.lora import is_lora_path
    from neuronx_distributed_tpu_torch.parallel import layers as pl
    from neuronx_distributed_tpu_torch.utils.tensor_capture import max_diff

    base_mem = memory_base()
    half = (cpu_side.result("lora_cross_check") if cpu_side is not None
            else lora_cpu_half(layers, seq, steps))
    side = {"cuda": lora_side("cuda", *half["inputs"], steps),
            "cpu": half["side"]}
    free_cuda()
    (mg, gg, ug, cg, tg), (mc, gc, uc, cc, tc) = side["cuda"], side["cpu"]
    for i, ((lg, ng), (lc, nc)) in enumerate(zip(mg, mc)):
        if not (abs(lg - lc) <= 1e-4 * abs(lc)
                and abs(ng - nc) <= 1e-3 * abs(nc)):
            raise AssertionError(f"lora_cross_check: step {i + 1} loss/norm "
                                 f"{lg}/{ng} vs CPU {lc}/{nc}")
    if gg.keys() != gc.keys() or not all(is_lora_path(n) for n in gc):
        raise AssertionError("lora_cross_check: gradients of "
                             f"{sorted(gg.keys() ^ gc.keys())[:4]} on one "
                             "side, or of a frozen tensor")
    worst = {}
    for what, card, cpu in (("grad", gg, gc), ("update", ug, uc)):
        w = (0.0, None)
        for name, ref in cpu.items():
            if not is_lora_path(name):
                if ref.any() or card[name].any():
                    raise AssertionError(f"lora_cross_check: frozen {name} "
                                         "moved")
                continue
            rel = ((card[name] - ref).norm() / ref.norm()).item()
            if rel >= w[0]:
                w = (rel, name)
            if not rel <= 1e-3:
                raise AssertionError(f"lora_cross_check: {name}'s {what} "
                                     f"differs by {rel} of its norm")
        worst[what] = w
    gaps = max_diff(cg, cc)
    top = dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:6])
    # the conv LoRA pair, card against CPU, bf16 compute
    x = torch.from_numpy(np.random.RandomState(3).randn(
        2, 32, 32, 64).astype(np.float32))
    conv = {}
    for dev in ("cpu", "cuda"):
        kw = dict(kernel_size=(3, 3), dtype=torch.bfloat16, device=dev,
                  param_dtype=torch.float32, lora_rank=8)
        col = pl.OutputChannelParallelConv2d(64, 128, **kw)
        row = pl.InputChannelParallelConv2d(128, 64, **kw)
        cgen = torch.Generator().manual_seed(4)
        for layer in (col, row):
            for name, p in layer.named_parameters():
                p.data = (torch.randn(p.shape, generator=cgen)
                          * 0.05).to(dev)
        with torch.no_grad():
            conv[dev] = row(col(x.to(dev))).float().cpu()
    conv_gap = ((conv["cuda"] - conv["cpu"]).abs().max()
                / conv["cpu"].abs().max()).item()
    if not conv_gap <= 2e-2:
        raise AssertionError(f"lora_cross_check: the conv pair differs by "
                             f"{conv_gap} of max|y|")
    emit("lora_cross_check", layers=layers, seq=seq, steps=steps,
         loss_card=[m[0] for m in mg], loss_cpu=[m[0] for m in mc],
         grad_norm_card=[m[1] for m in mg], grad_norm_cpu=[m[1] for m in mc],
         max_adapter_grad_rel_diff=worst["grad"][0],
         max_adapter_grad_rel_diff_param=worst["grad"][1],
         max_adapter_update_rel_diff=worst["update"][0],
         max_adapter_update_rel_diff_param=worst["update"][1],
         adapters=sum(is_lora_path(n) for n in gc),
         module_max_abs_gaps=top, conv_pair_gap_of_max=conv_gap,
         card_s=tg, cpu_s=tc)
    del side, half, gg, gc, ug, uc, cg, cc
    free_cuda()
    check_freed("lora_cross_check", base_mem)


# ---------------------------------------------------------------------------
# phases 52-53: tensor, sequence and data parallelism, four ranks on one card
# ---------------------------------------------------------------------------

TP_WORLD, TP_SIZE = 4, 2     # tp=2 x dp=2


def tp_batch(vocab, seq, rows, seed):
    """A global ``[rows, seq]`` batch from numpy's ``RandomState(seed)``,
    labels shifted by one."""
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, vocab, (rows, seq + 1)))
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def tp_holds(k2, k3, k4):
    """The first launch of K2, K3 and K4 a rank made on the path, each
    held element by element (``flash_rel_err``) to its plain version on
    the inputs the path gave it."""
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    errs = {}
    for name, cap, plain in (("flash_fwd", k2, fa.flash_fwd_plain),
                             ("flash_bwd_dq", k3, fa.flash_bwd_dq_plain),
                             ("flash_bwd_dkv", k4, fa.flash_bwd_dkv_plain)):
        args, kw, out = cap.calls[0]
        ref = plain(*args, **kw)
        out = out if isinstance(out, tuple) else (out,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        errs[name] = max(flash_rel_err(a, r) for a, r in zip(out, ref))
    return errs, k2.calls[0][0][:3], k3.calls[0][0][3]


def tp_local_timing(q, k, v, g, drop=()):
    """K2-K4 at a rank's local shape, each against its plain version, its
    bound and SDPA (without dropout), timed by one rank while the others
    wait; ``drop`` = ``(scale, dropout_p, seed, offsets)`` as the path
    passed them, or nothing."""
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out, lse = fa.flash_fwd_cuda(q, k, v, True, *drop)
    delta = fa.attention_delta(g, out)
    bwd = (q, k, v, g, lse, delta, True, *drop)
    bounds = flash_bounds(q, k, True)
    fwd_ms, bwd_ms = sdpa_yardsticks(q, k, v, g, True, flush)
    timing = {}
    for name, cuda, plain, args in (
            ("flash_fwd", fa.flash_fwd_cuda, fa.flash_fwd_plain,
             (q, k, v, True, *drop)),
            ("flash_bwd_dq", fa.flash_bwd_dq_cuda, fa.flash_bwd_dq_plain,
             bwd),
            ("flash_bwd_dkv", fa.flash_bwd_dkv_cuda, fa.flash_bwd_dkv_plain,
             bwd)):
        timing[name] = dict(
            kernel_ms=time_ms(lambda: cuda(*args), flush=flush),
            plain_ms=time_ms(lambda: plain(*args), reps=3, warmup=1),
            library_ms=fwd_ms if name == "flash_fwd" else bwd_ms,
            **bounds[name])
    return timing


def tp_rank(specs):
    """One rank of phases 52-63, in a process of its own
    (``utils.cpu_mesh.run_ranks``; this module is imported by name there):
    for each spec in turn, by its ``kind``, :func:`wait_for_go`,
    :func:`tp_rank_once`, :func:`tp_loop_rank`, :func:`mixtral_tp_rank`,
    :func:`mixtral_tp_cross_rank`, :func:`mixtral_ep_rank`,
    :func:`mixtral_ep_cross_rank` or a pipeline part, each at its
    own layout of the same ranks, the previous one's memory freed first;
    each result carries its seconds from the rank's start."""
    start = time.perf_counter()
    kinds = {"step": tp_rank_once, "loop": tp_loop_rank,
             "mixtral": mixtral_tp_rank,
             "mixtral_cross": mixtral_tp_cross_rank,
             "mixtral_ep": mixtral_ep_rank,
             "mixtral_ep_cross": mixtral_ep_cross_rank,
             "wait": wait_for_go,
             "pp_train": pp_train_rank, "pp_cross": pp_cross_rank,
             "pp_mixtral": pp_mixtral_rank, "pp_resume": pp_resume_rank}
    out = []
    for spec in specs:
        print(json.dumps({"rank_part": spec.get("kind", "step"),
                          "start_s": time.perf_counter() - start}),
              flush=True)
        res = kinds[spec.get("kind", "step")](spec)
        res["done_s"] = time.perf_counter() - start
        out.append(res)
        torch.cuda.empty_cache()
    return out


def tp_rank_once(spec):
    """The public path at tp=2 with ``sequence_parallel`` and ZeRO-1 on
    ``cuda:0``, the whole weights made from ``spec["seed"]`` on the card,
    then ``spec["steps"]`` steps on the global batch. The flash kernels'
    counts are set to 0 just before the steps and read just after; their
    first launches are held to their plain versions."""
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import (
        MixedPrecisionConfig, OptimizerConfig, configure_model,
        neuronx_distributed_config)
    from neuronx_distributed_tpu_torch.models.llama import LLAMA3_8B
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_tpu_torch.parallel import comm, mesh
    from neuronx_distributed_tpu_torch.resilience.integrity import \
        fingerprint_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    ref = (reference_on_rank0(tp_reference, spec["layers"], spec["batch"],
                              spec["steps"]) if spec["reference"] else None)
    ncfg = neuronx_distributed_config(
        tensor_parallel_size=TP_SIZE, sequence_parallel=True,
        optimizer_config=OptimizerConfig(zero_one_enabled=True),
        mixed_precision_config=MixedPrecisionConfig(
            compute_dtype=spec["compute"]))
    cfg = configure_model(ncfg, dataclasses.replace(
        LLAMA3_8B, num_layers=spec["layers"], use_flash_attention=True,
        param_dtype=torch.float32))
    torch.cuda.reset_peak_memory_stats()
    pm, params = trainer.initialize_parallel_model(
        ncfg, cfg, seed=spec["seed"], std=0.02, device="cuda")
    load_peak = torch.cuda.max_memory_allocated()
    start = ({n: p.detach().cpu() for n, p in params.items()}
             if ref is not None else None)
    tx, state = trainer.initialize_parallel_optimizer(pm, params, 1e-4)
    step = trainer.make_train_step(pm, tx)
    counters = {name: getattr(fa, name) for name, _ in FLASH_KERNELS}
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    comm.collective_bytes.clear()
    comm.host_staged_bytes.clear()
    init_s = time.perf_counter() - t0
    for c in counters.values():
        c.launches = 0
    losses, norms, times = [], [], []
    with Capture(fa, "flash_fwd_cuda") as k2, \
            Capture(fa, "flash_bwd_dq_cuda") as k3, \
            Capture(fa, "flash_bwd_dkv_cuda") as k4:
        for _ in range(spec["steps"]):
            t_step = time.perf_counter()
            _, m = step(state, spec["batch"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t_step) * 1e3)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    moved = dict(comm.collective_bytes)
    staged = dict(comm.host_staged_bytes)
    ring = tp_ppermute_ring(comm, mesh)
    holds, (q, k, v), g = tp_holds(k2, k3, k4)
    del k2, k3, k4
    timing = None
    dist.barrier()
    if spec["time_kernels"] and dist.get_rank() == 0:
        timing = tp_local_timing(q, k, v, g)
    dist.barrier()
    coords = mesh.coords()
    compared = None
    if ref is not None:
        # the moments go first: the comparison gathers whole updates
        del state, step, tx
        free_cuda()
        compared = gather_compare("train_tp_cross_check", pm, params, start,
                                  ref["updates"])
        ref = dict(metrics=ref["metrics"], seconds=ref["seconds"])
    return dict(coords=coords, losses=losses, grad_norms=norms,
                init_s=init_s, run_s=time.perf_counter() - t0,
                step_ms=times, launches=launches, holds=holds,
                local_shape=dict(zip("bsnd", q.shape), kv=k.shape[2]),
                timing=timing, load_peak_gib=load_peak / 2 ** 30,
                peak_gib=peak / 2 ** 30, collective_bytes=moved,
                host_staged_bytes=staged, ppermute_ring=ring,
                fingerprint=fingerprint_tree(params), reference=ref,
                update_rel_diff=compared)


def reference_on_rank0(fn, *args):
    """``fn(*args)`` (a tp=1 reference step on the card) on world rank 0
    while the other ranks wait, before any rank builds its shards: its
    metrics on every rank (broadcast), its updates on rank 0's host.
    Keeps the reference's updates out of the files ranks return."""
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.parallel import mesh

    out = None
    if dist.get_rank() == 0:
        # a world of one in this process: the layout is forgotten here (no
        # collective), and the reference builds no groups
        mesh.destroy_model_parallel()
        t0 = time.perf_counter()
        out = fn(*args)
        out["seconds"] = time.perf_counter() - t0
        free_cuda()
    box = [None if out is None else dict(metrics=out["metrics"],
                                          seconds=out["seconds"])]
    dist.broadcast_object_list(box, src=0)
    res = dict(box[0], updates=None if out is None else out["updates"])
    dist.barrier()
    return res


def gather_whole(pm, tensors):
    """Each of ``tensors`` (this rank's tp shards, by parameter name) made
    whole over its tp group (``comm.all_gather`` along its spec's tp dim);
    returned on world rank 0's host (empty elsewhere). Every rank calls
    it, in the same order."""
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.parallel import comm
    from neuronx_distributed_tpu_torch.parallel import mesh as ps

    out = {}
    for name, t in tensors.items():
        d = next((i for i, a in enumerate(pm.specs[name]) if a == ps.TP_AXIS),
                 None)
        if d is not None:
            t = comm.all_gather(t.contiguous(), ps.TP_AXIS, d)
        if dist.get_rank() == 0:
            out[name] = t.cpu()
        del t
    return out


def gather_compare(phase, pm, params, start, want):
    """Each parameter's update (this rank's tp shard of ``params`` less its
    host copy in ``start``) made whole over its tp group and, on world rank
    0, held on the card to ``want`` (rank 0's host copy of the reference's
    whole update), a parameter at a time: each within 1e-3 of its norm
    (:func:`update_rel_diffs`'s limit), computed where the tensors are
    rather than after a copy of them all to the host. Every rank calls it,
    in the same order; the worst and its name on rank 0, None
    elsewhere."""
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.parallel import comm
    from neuronx_distributed_tpu_torch.parallel import mesh as ps

    rels = {}
    for name, p in params.items():
        t = p.detach() - start[name].to(p.device)
        d = next((i for i, a in enumerate(pm.specs[name]) if a == ps.TP_AXIS),
                 None)
        if d is not None:
            t = comm.all_gather(t.contiguous(), ps.TP_AXIS, d)
        if dist.get_rank() == 0:
            upd = want[name].to(t.device)
            rels[name] = ((t - upd).norm() / upd.norm()).item()
            del upd
        del t
    if dist.get_rank() != 0:
        return None
    for name, rel in rels.items():
        if not rel <= 1e-3:
            raise AssertionError(f"{phase}: {name}'s update differs by {rel} "
                                 "of its norm, above 1e-3")
    worst = max(rels, key=rels.get)
    return rels[worst], worst


def tp_ppermute_ring(comm, mesh, n=1 << 20):
    """``comm.ppermute`` of a CUDA tensor around the tp ring, the one op
    ``comm`` stages through the host on gloo (off the train path): whether
    each rank got its left neighbour's tensor on the card, and the bytes
    staged against the two copies of the payload it should take."""
    tp = mesh.axis_size(mesh.TP_AXIS)
    me = mesh.axis_rank(mesh.TP_AXIS)
    base = torch.arange(n, dtype=torch.float32, device="cuda")
    comm.host_staged_bytes.clear()
    got = comm.ppermute(base + 1e7 * me, mesh.TP_AXIS,
                        [(i, (i + 1) % tp) for i in range(tp)])
    staged = comm.host_staged_bytes["ppermute"]
    comm.host_staged_bytes.clear()
    return dict(right=bool(got.is_cuda and torch.equal(
                    got, base + 1e7 * ((me - 1) % tp))),
                staged_bytes=staged, want_bytes=2 * n * 4)


def wait_for_go(spec):
    """A world's first part: leave the file ``spec["ready"]`` + ``_<rank>``
    (this rank has started), wait until the file ``spec["go"]`` exists
    (raise once ``spec["abort"]`` does), then meet the other ranks; the
    seconds waited."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    open(f"{spec['ready']}_{dist.get_rank()}", "w").close()
    while not os.path.exists(spec["go"]):
        if os.path.exists(spec["abort"]):
            raise RuntimeError("the world was aborted before its turn")
        time.sleep(0.05)
    dist.barrier()
    return dict(waited_s=time.perf_counter() - t0)


class TpWorld:
    """``tp_rank`` on ``TP_WORLD`` ranks sharing ``cuda:0`` over gloo with
    CUDA tensors (NCCL refuses two ranks on one device), through a
    ``file://`` store under ``build/``, removed after. :meth:`start` runs
    the processes from a thread of this process, their first part waiting
    (:func:`wait_for_go`) until :meth:`result` leaves the file it polls:
    so the processes' start (interpreter, torch, the CUDA context, gloo)
    runs beside earlier phases, which the waiting ranks leave the card
    to; :meth:`wait_ready` returns once every rank waits. :meth:`result`
    returns, per spec, each rank's result; :meth:`abort` makes the waiting
    ranks raise."""

    def __init__(self, specs):
        build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
        os.makedirs(build, exist_ok=True)
        self.workdir = tempfile.mkdtemp(prefix="chip_smoke_tp_", dir=build)
        self.go_file = os.path.join(self.workdir, "go")
        self.abort_file = os.path.join(self.workdir, "abort")
        self.ready = os.path.join(self.workdir, "ready")
        self.ready_wait_s = None
        self.specs = [dict(kind="wait", go=self.go_file,
                           abort=self.abort_file,
                           ready=self.ready)] + list(specs)
        self.box = {}
        self.thread = threading.Thread(target=self._run, name="tp-world")

    def start(self):
        self.thread.start()
        return self

    def _run(self):
        import importlib

        from neuronx_distributed_tpu_torch.utils.cpu_mesh import run_ranks

        me = importlib.import_module("chip_smoke")
        try:
            self.box["ranks"] = run_ranks(
                me.tp_rank, TP_WORLD, backend="gloo", device="cuda:0",
                store_dir=self.workdir, args=(self.specs,), timeout=1150,
                threads=2)
        except BaseException as e:   # raised by result()
            self.box["error"] = e

    def wait_ready(self, timeout=300):
        """Block until every rank has started and waits for its turn (or
        the world failed, which :meth:`result` raises): the seconds
        waited."""
        t0 = time.perf_counter()
        while (self.thread.is_alive()
               and time.perf_counter() - t0 < timeout
               and not all(os.path.exists(f"{self.ready}_{r}")
                           for r in range(TP_WORLD))):
            time.sleep(0.05)
        self.ready_wait_s = time.perf_counter() - t0
        return self.ready_wait_s

    def abort(self):
        open(self.abort_file, "w").close()
        self.thread.join()
        shutil.rmtree(self.workdir, ignore_errors=True)

    def result(self):
        open(self.go_file, "w").close()
        self.thread.join()
        try:
            if "error" in self.box:
                # each rank's own output: where a slow or stuck rank was
                for r in range(TP_WORLD):
                    log = os.path.join(self.workdir, f"rank_{r}.log")
                    if os.path.exists(log):
                        with open(log, errors="replace") as f:
                            print(f"rank {r}'s output:\n{f.read()[-3000:]}",
                                  file=sys.stderr, flush=True)
                raise self.box["error"]
            ranks = self.box["ranks"]
        finally:
            shutil.rmtree(self.workdir, ignore_errors=True)
        emit("tp_world_start", waited_s=[r[0]["waited_s"] for r in ranks],
             ready_wait_s=self.ready_wait_s)
        return [[r[i] for r in ranks] for i in range(1, len(self.specs))]


def check_tp_ranks(phase, outs, steps, layers):
    """What every rank must show: finite metrics equal across ranks, each
    flash kernel launched layers x steps times and held within 2e-2 (bf16,
    ``train_tp``) or 1e-4 (fp32), nothing staged through the host by
    ``comm`` on the train path, ``comm.ppermute`` of a CUDA tensor right
    and staged at twice its payload, and the data-parallel twins'
    parameters equal bit for bit."""
    ref = outs[0]
    for r, out in enumerate(outs):
        if not (np.isfinite(out["losses"]).all()
                and np.isfinite(out["grad_norms"]).all()):
            raise AssertionError(f"{phase}: rank {r} non-finite: {out}")
        for key in ("losses", "grad_norms"):
            if not np.allclose(out[key], ref[key], rtol=1e-6, atol=0):
                raise AssertionError(f"{phase}: rank {r} {key} "
                                     f"{out[key]} vs rank 0 {ref[key]}")
        for name, n in out["launches"].items():
            if n != layers * steps:
                raise AssertionError(f"{phase}: rank {r} launched {name} "
                                     f"{n} times, want {layers * steps}")
        tol = 2e-2 if phase == "train_tp" else 1e-4
        for name, err in out["holds"].items():
            if not err <= tol:
                raise AssertionError(f"{phase}: rank {r} {name} differs "
                                     f"from its plain version by {err}")
        if any(out["host_staged_bytes"].values()):
            raise AssertionError(f"{phase}: rank {r} staged "
                                 f"{out['host_staged_bytes']}")
        ring = out["ppermute_ring"]
        if not (ring["right"] and ring["staged_bytes"] == ring["want_bytes"]):
            raise AssertionError(f"{phase}: rank {r} ppermute {ring}")
        twin = next(o for o in outs if o["coords"]["tp"] == out["coords"][
            "tp"] and o["coords"]["dp"] == 0)
        if not torch.equal(out["fingerprint"], twin["fingerprint"]):
            raise AssertionError(f"{phase}: rank {r}'s parameters differ "
                                 "from its data-parallel twin's")


def tp_summary(outs):
    """The fields of a phase line common to both phases."""
    return dict(
        world=TP_WORLD, tp=TP_SIZE, dp=TP_WORLD // TP_SIZE,
        losses=outs[0]["losses"], grad_norms=outs[0]["grad_norms"],
        step_ms_by_rank=[o["step_ms"] for o in outs],
        peak_gib_by_rank=[o["peak_gib"] for o in outs],
        load_peak_gib_by_rank=[o["load_peak_gib"] for o in outs],
        launches_by_rank=[o["launches"] for o in outs],
        held_err_by_rank=[o["holds"] for o in outs],
        local_shape=outs[0]["local_shape"],
        gloo_bytes_by_rank=[o["collective_bytes"] for o in outs],
        gloo_bytes_total=sum(sum(o["collective_bytes"].values())
                             for o in outs),
        host_staged_bytes_total=sum(sum(o["host_staged_bytes"].values())
                                    for o in outs),
        ppermute_staged_bytes_by_rank=[o["ppermute_ring"]["staged_bytes"]
                                       for o in outs],
        rank_init_s=[o["init_s"] for o in outs],
        rank_run_s=[o["run_s"] for o in outs],
        rank_done_s=[o["done_s"] for o in outs])


def ep_specs(seq=4096, layers=2, cross_seq=256, cross_steps=2, steps=2):
    """The parts of phases 62 and 63 (:func:`mixtral_ep_rank`,
    :func:`mixtral_ep_cross_rank`): one sequence a data rank."""
    from neuronx_distributed_tpu_torch.models.mixtral import MIXTRAL_8X7B

    vocab = MIXTRAL_8X7B.vocab_size
    rows = TP_WORLD // TP_SIZE
    return [dict(kind="mixtral_ep", layers=layers, steps=steps,
                 batch=tp_batch(vocab, seq, rows, 50)),
            dict(kind="mixtral_ep_cross", layers=1, steps=cross_steps,
                 batch=tp_batch(vocab, cross_seq, rows, 51))]


def start_train_tp(steps=2, seq=4096, layers=2, cross_layers=2,
                   cross_seq=256, cross_steps=2, pp_layers=4, pp_steps=3):
    """Phases 52-63's world, started ahead of its turn
    (:class:`TpWorld`): the parts' specs, the directory of the loop's tag
    under ``build/`` and part D's thread (:func:`merged_tag_side`), which
    waits for the loop's part A. :func:`phase_train_tp` lets the world go
    and checks it."""
    from neuronx_distributed_tpu_torch.models.llama import LLAMA3_8B
    from neuronx_distributed_tpu_torch.models.mixtral import MIXTRAL_8X7B

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_tp_ckpt_", dir=build)
    vocab = LLAMA3_8B.vocab_size
    rows = TP_WORLD // TP_SIZE
    cross_batches = tp_batches(vocab, cross_seq, rows, 4, 20)
    path = os.path.join(workdir, "tag")
    a_done, d_done = (os.path.join(workdir, f"{p}_done") for p in "ad")
    stop, merged = threading.Event(), {}
    side = threading.Thread(target=merged_tag_side, name="part-d", args=(
        path, a_done, d_done, cross_batches, 1, stop, merged))
    specs = [
        dict(compute="bfloat16", layers=layers, seed=0, steps=steps,
             reference=False, time_kernels=True,
             batch=tp_batch(vocab, seq, rows, 0)),
        dict(compute="float32", layers=cross_layers, seed=1,
             steps=cross_steps, reference=True, time_kernels=False,
             batch=tp_batch(vocab, cross_seq, rows, 1)),
        dict(kind="loop", layers=1, dir=path, a_done=a_done,
             d_done=d_done, cross_batches=cross_batches,
             batches=tp_batches(vocab, seq, rows, 2, 10)),
        dict(kind="mixtral", layers=layers, steps=steps,
             batch=tp_batch(MIXTRAL_8X7B.vocab_size, seq, 1, 30)),
        dict(kind="mixtral_cross", layers=1, steps=cross_steps,
             batch=tp_batch(MIXTRAL_8X7B.vocab_size, cross_seq, 1, 3)),
        *ep_specs(seq, layers, cross_seq, cross_steps, steps),
        dict(kind="pp_train", layers=pp_layers, steps=pp_steps,
             microbatches=4, batch=tp_batch(vocab, seq, 4, 40)),
        dict(kind="pp_cross", layers=pp_layers, steps=cross_steps,
             microbatches=4, batch=tp_batch(vocab, cross_seq, 4, 41)),
        dict(kind="pp_mixtral", layers=layers, steps=pp_steps,
             microbatches=2,
             batch=tp_batch(MIXTRAL_8X7B.vocab_size, seq, 2, 42)),
        dict(kind="pp_resume", dir=path, cross_batches=cross_batches)]
    side.start()
    try:
        world = TpWorld(specs).start()
    except BaseException:
        stop.set()
        side.join()
        shutil.rmtree(workdir, ignore_errors=True)
        raise
    return dict(world=world, side=side, stop=stop, merged=merged,
                workdir=workdir, sizes=dict(
                    steps=steps, seq=seq, layers=layers,
                    cross_layers=cross_layers, cross_seq=cross_seq,
                    cross_steps=cross_steps, pp_layers=pp_layers,
                    pp_steps=pp_steps))


def abort_train_tp(started):
    """Stop a world :func:`start_train_tp` started (an earlier phase
    failed): its ranks leave their wait by raising, and part D's thread
    ends; the tag's directory goes."""
    started["world"].abort()
    started["stop"].set()
    started["side"].join()
    shutil.rmtree(started["workdir"], ignore_errors=True)


def phase_train_tp(smi, started=None):
    """Phases 52-63 in one world of ranks (one start of the processes,
    :func:`start_train_tp`), each part at its own layout of the same four
    ranks: ``train_tp``, its cross check's path (the tp=1 reference on
    rank 0 first), ``train_tp_loop`` and its cross check's paths around
    one tag (:func:`tp_loop_rank`; part D, the merge and the tp=1 step,
    runs on a thread here beside the ranks, :func:`merged_tag_side`),
    ``train_mixtral_tp`` and its cross check's path (the tp=1 reference on
    rank 0 first), ``train_mixtral_ep`` and its cross check's path (ep=1
    then ep=2), then the pipeline phases at pp=2 x tp=2: ``train_pp``,
    ``train_pp_cross_check``, ``train_mixtral_pp`` and
    ``train_pp_resume`` (from the loop's tag), in turn; the tag's
    directory under ``build/`` is removed at the end. Each cross check's
    comparison runs on the ranks, so they return no weights. Returns
    each path's launches summed over the ranks."""
    if started is None:
        started = start_train_tp()
    z = started["sizes"]
    steps, seq, layers = z["steps"], z["seq"], z["layers"]
    cross_seq, cross_steps = z["cross_seq"], z["cross_steps"]
    free_cuda()
    t0 = time.perf_counter()
    try:
        (main, cross, loop, moe, moe_cross, ep, ep_cross, pp_main, pp_cross,
         pp_moe, pp_resume) = started["world"].result()
        wall = time.perf_counter() - t0
        started["side"].join()
        merged = started["merged"]
        launches = {"train_tp": check_train_tp(smi, main, steps, seq,
                                               layers)}
        check_train_tp_cross(smi, cross, z["cross_layers"], cross_seq,
                             cross_steps, wall)
        launches["train_tp_loop"] = check_train_tp_loop(smi, loop, seq, 1)
        check_train_tp_loop_cross(smi, loop, merged, 1, cross_seq)
        launches["train_mixtral_tp"] = check_train_mixtral_tp(
            smi, moe, steps, seq, layers)
        check_train_mixtral_tp_cross(smi, moe_cross, 1, cross_seq,
                                     cross_steps)
        launches["train_mixtral_ep"] = check_train_mixtral_ep(
            smi, ep, steps, seq, layers)
        check_train_mixtral_ep_cross(smi, ep_cross, 1, cross_seq,
                                     cross_steps)
        launches["train_pp"] = check_train_pp(smi, pp_main, z["pp_steps"],
                                              seq, z["pp_layers"], 4)
        check_train_pp_cross(smi, pp_cross, z["pp_layers"], cross_seq,
                             cross_steps)
        launches["train_mixtral_pp"] = check_train_mixtral_pp(
            smi, pp_moe, z["pp_steps"], seq, layers, 2)
        check_train_pp_resume(smi, pp_resume, loop)
    finally:
        started["stop"].set()
        started["side"].join()
        shutil.rmtree(started["workdir"], ignore_errors=True)
    return launches


def phase_train_ep(smi, seq=4096, layers=2, cross_seq=256, cross_steps=2,
                   steps=2):
    """``--only train_mixtral_ep``: phases 62 and 63 in a world of their
    own."""
    free_cuda()
    ep, ep_cross = TpWorld(ep_specs(seq, layers, cross_seq, cross_steps,
                                    steps)).start().result()
    launches = check_train_mixtral_ep(smi, ep, steps, seq, layers)
    check_train_mixtral_ep_cross(smi, ep_cross, 1, cross_seq, cross_steps)
    return launches


def check_train_tp(smi, outs, steps, seq, layers):
    """``train_tp``: Llama-3-8B widths at 2 layers, bf16 compute over fp32
    parameters, 4 ranks on the one card (tp=2 x dp=2, sequence parallel,
    ZeRO-1), global batch 2 at S=4096, 2 steps; each rank's K2-K4 counts
    and held launches, its step times and peak memory, the bytes gloo's
    collectives moved (gloo passes CUDA tensors through pinned host
    buffers) and what ``comm`` staged itself; rank 0 timed K2-K4 at the
    local shape while the others waited."""
    check_tp_ranks("train_tp", outs, steps, layers)
    if not outs[0]["losses"][-1] < outs[0]["losses"][0]:
        raise AssertionError(f"train_tp: loss did not fall: "
                             f"{outs[0]['losses']}")
    launches = {name: sum(o["launches"][name] for o in outs)
                for name, _ in FLASH_KERNELS}
    p50 = float(np.median([t for o in outs for t in o["step_ms"][1:]]))
    emit("train_tp", card=smi, layers=layers, seq=seq, steps=steps,
         global_batch=TP_WORLD // TP_SIZE, compute_dtype="bfloat16",
         step_ms_p50=p50, timing_local_shape=outs[0]["timing"],
         **tp_summary(outs))
    TP_RESULTS["train_tp"] = dict(launches=launches, outs=outs)
    return launches


def tp_reference(layers, batch, steps):
    """The port's tp=1 step on the card: full width, ``layers`` layers,
    fp32, the weights made on the card from seed 1, ``steps`` steps on the
    global ``batch``; each step's loss and grad norm, and each parameter's
    update on the host."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import (
        neuronx_distributed_config)
    from neuronx_distributed_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LLAMA3_8B, num_layers=layers,
                              dtype=torch.float32, param_dtype=torch.float32,
                              use_flash_attention=True)
    pm, params = trainer.initialize_parallel_model(
        neuronx_distributed_config(init_mesh=False), cfg, seed=1, std=0.02,
        device="cuda")
    start = {n: t.detach().cpu() for n, t in params.items()}
    tx, state = trainer.initialize_parallel_optimizer(pm, params, 1e-4)
    step = trainer.make_train_step(pm, tx)
    metrics = [step(state, batch)[1] for _ in range(steps)]
    metrics = [(m["loss"].item(), m["grad_norm"].item()) for m in metrics]
    upd = {n: p.detach().cpu() - start[n] for n, p in params.items()}
    del pm, params, tx, state, step, start
    free_cuda()
    return dict(metrics=metrics, updates=upd)


def check_train_tp_cross(smi, outs, layers, seq, steps, wall):
    """``train_tp_cross_check``: full width, 2 layers, S=256, fp32: the
    world-4 path (tp=2 x dp=2, sequence parallel, ZeRO-1) against the
    port's tp=1 step on the card (:func:`tp_reference`, run on rank 0
    before the ranks build their shards), from the same weights (both made
    on the card from seed 1) and the same global batch of 2, for 2 steps:
    each loss within 1e-4 relative, each grad norm within 1e-3, each
    parameter's update (the tp shards gathered on rank 0) within 1e-3 of
    its norm."""
    check_tp_ranks("train_tp_cross_check", outs, steps, layers)
    ref = outs[0]["reference"]
    for i, ((lc, nc), lw, nw) in enumerate(zip(ref["metrics"],
                                               outs[0]["losses"],
                                               outs[0]["grad_norms"])):
        if not abs(lw - lc) <= 1e-4 * abs(lc):
            raise AssertionError(f"train_tp_cross_check: step {i + 1} loss "
                                 f"{lw} vs tp=1 {lc}")
        if not abs(nw - nc) <= 1e-3 * abs(nc):
            raise AssertionError(f"train_tp_cross_check: step {i + 1} grad "
                                 f"norm {nw} vs tp=1 {nc}")
    worst, worst_name = outs[0]["update_rel_diff"]
    emit("train_tp_cross_check", card=smi, layers=layers, seq=seq,
         steps=steps, loss_tp1=[m[0] for m in ref["metrics"]],
         grad_norm_tp1=[m[1] for m in ref["metrics"]],
         max_update_rel_diff=worst, max_update_rel_diff_param=worst_name,
         tp1_s=ref["seconds"], wall_s_world=wall, **tp_summary(outs))


# ---------------------------------------------------------------------------
# phases 54-57: the Trainer loop, sharded checkpoints and Mixtral across
# ranks, in the same start of the four processes
# ---------------------------------------------------------------------------

def tp_parts(model_cfg, tp, compute, seed, zero1=True, ep=1, **step_kw):
    """``(cfg, pm, state, step)`` of the public path at ``tp`` (and ``ep``
    of expert parallelism) over the four ranks with sequence parallelism
    (ZeRO-1 when ``zero1``), the whole weights made from ``seed`` on the
    card a tensor at a time, AdamW lr 1e-4; ``step_kw`` go to
    ``make_train_step``."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import (
        MixedPrecisionConfig, OptimizerConfig, configure_model,
        neuronx_distributed_config)

    ncfg = neuronx_distributed_config(
        tensor_parallel_size=tp, expert_parallel_size=ep,
        sequence_parallel=True,
        optimizer_config=OptimizerConfig(zero_one_enabled=zero1),
        mixed_precision_config=MixedPrecisionConfig(compute_dtype=compute))
    cfg = configure_model(ncfg, model_cfg)
    pm, params = trainer.initialize_parallel_model(ncfg, cfg, seed=seed,
                                                   std=0.02, device="cuda")
    tx, state = trainer.initialize_parallel_optimizer(pm, params, 1e-4)
    return cfg, pm, state, trainer.make_train_step(pm, tx, **step_kw)


def tp_batches(vocab, seq, rows, n, seed):
    """``n`` global batches (:func:`tp_batch`) from seeds ``seed, seed +
    1, ...``."""
    return [tp_batch(vocab, seq, rows, seed + i) for i in range(n)]


def flash_counters():
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    return {name: getattr(fa, name) for name, _ in FLASH_KERNELS}


def tag_bytes(path, tag):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(os.path.join(path, str(tag)))
               for f in fs)


class LiveFingerprints(StepFingerprints):
    """Each step's loss and the whole parameters' fingerprint after it
    (``step.fingerprint``, from the shards), keyed by step."""

    def __init__(self):
        super().__init__()
        self.losses = {}

    def on_step_end(self, trainer, metrics):
        self.losses[trainer.host_step] = metrics["loss"].item()
        self.fps[trainer.host_step] = trainer.step_fn.fingerprint(
            trainer.state.params).cpu()


class RewindProbe:
    """A ``Trainer`` callback after the integrity monitor: the step a
    rewind went back to and the whole parameters' fingerprint there."""

    def __init__(self, watchdog):
        self.watchdog, self.seen, self.at, self.fp = watchdog, 0, None, None

    def on_train_start(self, trainer):
        pass

    def on_step_end(self, trainer, metrics):
        if self.watchdog.anomalies > self.seen:
            self.seen = self.watchdog.anomalies
            self.at = trainer.host_step
            self.fp = trainer.step_fn.fingerprint(trainer.state.params).cpu()

    def on_eval_end(self, trainer, metrics):
        pass

    def on_train_end(self, trainer):
        pass


def loop_cfg(layers):
    """Llama-3-8B's widths at ``layers`` layers with the tied head (the
    checkpoint's size, see :func:`tp_loop_rank`), fp32 parameters."""
    from neuronx_distributed_tpu_torch.models.llama import LLAMA3_8B

    return dataclasses.replace(LLAMA3_8B, num_layers=layers,
                               use_flash_attention=True, tie_embeddings=True,
                               param_dtype=torch.float32)


def tp_loop_rank(spec):
    """Phases 54 and 55 on one rank, around one sharded tag (the card's
    machine caps what a run writes to its disk at 45 GiB, and a tag of
    Llama-3-8B's widths holds 12 bytes a parameter; so both phases share
    it, at 1 layer with the tied head: 743 M parameters, 8.9 GB a tag).

    ``train_tp_loop_cross_check``, A: ``Trainer.fit`` of 4 fp32 steps at
    S=256 (global batch 2) at tp=2 x dp=2 with sequence parallelism and
    ZeRO-1, an async sharded save at step 2 into ``spec["dir"]`` (timed:
    the loop's block, the commit, the bytes); B: the same model resumes
    from the tag through ``Trainer(resume_path=...)`` and trains steps 3-4
    again, bit for bit A's. ``train_tp_loop``: a bf16-compute model over
    fp32 parameters with attention dropout 0.1 (a generator seeded alike
    on every rank) and ``integrity_every=2`` resumes from the tag and
    trains steps 3-4 at S=4096; an ``IntegrityMonitor`` whose chaos plan
    flips a bit of data rank 1, tp rank 0's largest shard at the step-4
    boundary sees it on every rank, and its ``Watchdog(policy="rewind")``
    restores the tag on every rank, whose fingerprint must be A's step 2.
    Then ``train_tp_loop_cross_check``, C: a model at tp=4 x dp=1 without
    ZeRO-1 resumes from the tag, trains steps 3-4 in fp32, and its update
    over them is held to A's on rank 0 (both gathered whole there).

    Rank 0 leaves the file ``spec["a_done"]`` once A is done, which starts
    part D in the parent (:func:`merged_tag_side`) beside B, the loop and
    C, and at the end waits for ``spec["d_done"]`` before it times K2-K4
    at the loop's inputs with dropout."""
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.resilience.chaos import FaultPlan
    from neuronx_distributed_tpu_torch.resilience.integrity import (
        IntegrityMonitor)
    from neuronx_distributed_tpu_torch.resilience.watchdog import Watchdog
    from neuronx_distributed_tpu_torch.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    path, layers = spec["dir"], spec["layers"]
    fp32 = dataclasses.replace(loop_cfg(layers), dtype=torch.float32)
    cross = spec["cross_batches"]
    # A: four fp32 steps, the tag at step 2
    _, pm, state, step = tp_parts(fp32, TP_SIZE, "float32", seed=1)
    coords = mesh.coords()
    a, snap = LiveFingerprints(), {}
    saver = timed_checkpoint(path, every=2, num_kept=1)

    class Snap:
        def on_train_start(self, trainer):
            pass

        def on_step_end(self, trainer, metrics):
            if trainer.host_step == 2:
                snap.update({n: p.detach().cpu() for n, p in
                             trainer.state.params.items()})

        def on_eval_end(self, trainer, metrics):
            pass

        def on_train_end(self, trainer):
            pass

    class OnlyStep2:
        """The timed saver, saving at step 2 only."""

        def __getattr__(self, name):
            return getattr(saver, name)

        def on_step_end(self, trainer, metrics):
            if trainer.host_step == 2:
                saver.on_step_end(trainer, metrics)

        def on_train_end(self, trainer):
            from neuronx_distributed_tpu_torch.trainer import checkpoint

            checkpoint.finalize_checkpoint()

    Trainer(step, state, callbacks=[a, Snap(), OnlyStep2()]).fit(
        iter(cross), max_steps=4)
    for waiter in saver.waiters:
        waiter.join(timeout=600)
    upd_a = gather_whole(pm, {n: p.detach() - snap[n].to(p.device)
                              for n, p in state.params.items()})
    del snap
    a_s = time.perf_counter() - t0
    print(json.dumps({"loop_part": "A", "s": a_s}), flush=True)
    if dist.get_rank() == 0:
        # the tag is committed, and the layouts that resume it next hold
        # little of the card: part D may start beside them
        # (:func:`merged_tag_side`)
        open(spec["a_done"], "w").close()
    # B: the same layout, resumed from the tag
    b = LiveFingerprints()
    trainer = Trainer(step, state, callbacks=[b], resume_path=path)
    b_start = trainer.host_step
    trainer.fit(iter(cross[2:]), max_steps=4)
    del pm, state, step, trainer
    free_cuda()
    print(json.dumps({"loop_part": "B", "s": time.perf_counter() - t0}),
          flush=True)
    # the loop: bf16 over fp32, dropout, integrity, the drill
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    _, pm, state, step = tp_parts(
        dataclasses.replace(loop_cfg(layers), attention_dropout=0.1),
        TP_SIZE, "bfloat16", seed=2,
        dropout_generator=torch.Generator().manual_seed(7),
        integrity_every=2)
    watchdog = Watchdog(policy="rewind", checkpoint_path=path)
    flipper = coords["dp"] == 1 and coords["tp"] == 0
    monitor = IntegrityMonitor(every=2, watchdog=watchdog, chaos=(
        FaultPlan.parse("seed=5; integrity|params : bitflip, times=1")
        if flipper else None))
    probe, clock = RewindProbe(watchdog), StepClock()
    counters = flash_counters()
    torch.cuda.synchronize()
    dist.barrier()
    for c in counters.values():
        c.launches = 0
    with Capture(fa, "flash_fwd_cuda") as k2, \
            Capture(fa, "flash_bwd_dq_cuda") as k3, \
            Capture(fa, "flash_bwd_dkv_cuda") as k4:
        trainer = Trainer(step, state, callbacks=[clock, monitor, probe],
                          resume_path=path)
        loop_start = trainer.host_step
        trainer.fit(iter(spec["batches"]), max_steps=4)
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    holds, (q, k, v), g = tp_holds(k2, k3, k4)
    drop = tuple(k2.calls[0][0][4:8])
    del k2, k3, k4
    loop_s = time.perf_counter() - t1
    loop = dict(losses=clock.losses, step_ms=clock.ms, launches=launches,
                holds=holds, timing=None,
                dropout=dict(p=drop[1], offsets=list(drop[3])),
                local_shape=dict(zip("bsnd", q.shape), kv=k.shape[2]),
                peak_gib=peak / 2 ** 30, start=loop_start,
                host_step=trainer.host_step, flips=monitor.flips_injected,
                mismatches=monitor.mismatches, checks=monitor.checks,
                rewinds=watchdog.anomalies, rewound_to=probe.at,
                divergent_replicas=monitor.divergent_replicas,
                rewound_is_step_2s=bool(probe.fp is not None and torch.equal(
                    probe.fp, a.fps[2])), seconds=loop_s)
    del pm, state, step, trainer
    free_cuda()
    print(json.dumps({"loop_part": "loop", "s": time.perf_counter() - t0}),
          flush=True)
    # C: tp=4 x dp=1, resumed from the tag
    t2 = time.perf_counter()
    _, pm, state, step = tp_parts(fp32, 4, "float32", seed=3, zero1=False)
    c = LiveFingerprints()
    trainer = Trainer(step, state, callbacks=[c], resume_path=path)
    c_start = trainer.host_step
    at2 = {n: p.detach().cpu() for n, p in state.params.items()}
    trainer.fit(iter(cross[2:]), max_steps=4)
    upd_c = gather_whole(pm, {n: p.detach() - at2[n].to(p.device)
                              for n, p in state.params.items()})
    compared = (update_rel_diffs("train_tp_loop_cross_check", upd_c, upd_a)
                if dist.get_rank() == 0 else None)
    del pm, state, step, trainer, at2, upd_a, upd_c
    free_cuda()
    c_s = time.perf_counter() - t2
    # rank 0 times K2-K4 at the loop's inputs once part D is done, so that
    # nothing else runs on the card meanwhile
    dist.barrier()
    if dist.get_rank() == 0:
        wait_for_file(spec["d_done"])
        loop["part_d_wait_s"] = time.perf_counter() - t2 - c_s
        loop["timing"] = tp_local_timing(q, k, v, g, drop)
    dist.barrier()
    del q, k, v, g
    tags = sorted(t for t in os.listdir(path) if t.isdigit())
    return dict(coords=coords, loop=loop, a_losses=a.losses,
                a_fps=a.fps, b_losses=b.losses, b_fps=b.fps,
                c_losses=c.losses, b_start=b_start, c_start=c_start,
                tags=tags, update_rel_diff=compared,
                save_block_s=saver.block_s, commit_s=saver.commit_s,
                tag_bytes=tag_bytes(path, "2"), a_s=a_s, c_s=c_s)


def mixtral_tp_rank(spec):
    """``train_mixtral_tp`` on one rank: Mixtral 8x7B's widths at 2
    layers, tp=4 x dp=1 with sequence parallelism, blockwise dispatch
    (block 64), bf16 compute over fp32 parameters, the experts at I/tp =
    3584, S=4096, ``spec["steps"]`` steps on one batch. K2-K5, K7 and K8
    counted from 0 over the steps; the first launch of each held to its
    plain version on the path's inputs; rank 0 times K5, K7 and K8 there
    (kernel, plain version, bound, cuBLAS per expert) while the others
    wait."""
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.models.mixtral import MIXTRAL_8X7B
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as tbm
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _, pm, state, step = tp_parts(
        dataclasses.replace(MIXTRAL_8X7B, num_layers=spec["layers"],
                            use_flash_attention=True,
                            param_dtype=torch.float32,
                            moe_dispatch="blockwise", moe_block_size=64),
        4, "bfloat16", seed=0, zero1=False)
    load_peak = torch.cuda.max_memory_allocated()
    counters = dict(flash_counters(), grouped_glu=tbm.grouped_glu,
                    grouped_glu_dx=tbm.grouped_glu_dx,
                    grouped_glu_dw=tbm.grouped_glu_dw)
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    init_s = time.perf_counter() - t0
    for c in counters.values():
        c.launches = 0
    losses, norms, times = [], [], []
    with Capture(fa, "flash_fwd_cuda") as k2, \
            Capture(fa, "flash_bwd_dq_cuda") as k3, \
            Capture(fa, "flash_bwd_dkv_cuda") as k4, \
            Capture(tbm, "grouped_glu_cuda", by_ref=(1, 2)) as k5, \
            Capture(tbm, "grouped_glu_bwd_cuda", by_ref=(1, 2)) as k78:
        for _ in range(spec["steps"]):
            t_step = time.perf_counter()
            m = step(state, spec["batch"])[1]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t_step) * 1e3)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    # the plain versions at these widths need the room the training state
    # held: the state goes, and the ranks hold their launches one at a
    # time (four share the card)
    del pm, state, step, m
    free_cuda()
    (xs, gu, dn, be, dy, bs, bi), _, got = k78.calls[0]
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            holds, _, _ = tp_holds(k2, k3, k4)
            holds["grouped_glu"] = hold_glu(
                k5.calls[0], tbm.grouped_glu_plain)["max_rel_err"]
            ref = tbm.grouped_glu_bwd_plain(xs.float(), gu.float(),
                                            dn.float(), be, dy.float(), bs,
                                            bi)
            for name, a, want in (("grouped_glu_dx", got[0], ref[0]),
                                  ("grouped_glu_dw", got[1], ref[1]),
                                  ("grouped_glu_dw.down", got[2], ref[2])):
                holds[name] = flash_rel_err(a, want.to(a.dtype))
            del ref
            free_cuda()
        dist.barrier()
    fwd_args = k5.calls[0][0]
    del k2, k3, k4, k5, k78
    run_s = time.perf_counter() - t0
    timing = None
    dist.barrier()
    if dist.get_rank() == 0:
        timing = moe_tp_local_timing(fwd_args, (xs, gu, dn, be, dy, bs, bi))
    dist.barrier()
    return dict(coords=mesh.coords(), losses=losses, grad_norms=norms,
                step_ms=times, launches=launches, holds=holds,
                timing=timing, init_s=init_s, run_s=run_s,
                load_peak_gib=load_peak / 2 ** 30, peak_gib=peak / 2 ** 30,
                local_shape=dict(rows=xs.shape[0], h=xs.shape[1],
                                 experts=gu.shape[0], i_local=gu.shape[-1],
                                 block=bs))


def moe_tp_local_timing(fwd_args, bwd_args):
    """K5, K7 and K8 at a rank's local width on the path's inputs, each
    against its plain version, its bound and cuBLAS expert by expert."""
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as tbm

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    xs, gu, dn, be, bs, bi = fwd_args
    _, _, _, _, dy, _, _ = bwd_args
    timing = {}
    for name, cuda, plain, args, lib in (
            ("grouped_glu", tbm.grouped_glu_cuda, tbm.grouped_glu_plain,
             fwd_args, moe_library(xs, gu, dn, be, bs)),
            ("grouped_glu_dx", tbm.grouped_glu_dx_cuda,
             tbm.grouped_glu_dx_plain, bwd_args,
             moe_bwd_library(xs, gu, dn, be, bs, dy, "grouped_glu_dx")),
            ("grouped_glu_dw", tbm.grouped_glu_dw_cuda,
             tbm.grouped_glu_dw_plain, bwd_args,
             moe_bwd_library(xs, gu, dn, be, bs, dy, "grouped_glu_dw"))):
        # the plain version ran on these inputs for the holds: one timed
        # run of its second or more (a Python loop over the blocks)
        timing[name] = dict(
            kernel_ms=time_ms(lambda: cuda(*args), flush=flush),
            plain_ms=time_ms(lambda: plain(*args), reps=1, warmup=0),
            library_ms=time_ms(lib, flush=flush),
            **moe_bound(xs, gu, dn, be, bs, kind=name))
    return timing


def mixtral_tp_cross_rank(spec):
    """``train_mixtral_tp_cross_check`` on one rank: first the port's tp=1
    Mixtral step on the card on rank 0 (:func:`mixtral_tp_reference`)
    while the others wait; then Mixtral 8x7B's full width at
    ``spec["layers"]`` layers, fp32, blockwise (block 64), tp=4 x dp=1
    with sequence parallelism, the weights made on the card from seed 1,
    ``spec["steps"]`` steps on the global batch; each step's loss and
    grad norm, and on rank 0 each parameter's update (gathered whole)
    against the reference's."""
    from neuronx_distributed_tpu_torch.models.mixtral import MIXTRAL_8X7B
    from neuronx_distributed_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    ref = reference_on_rank0(mixtral_tp_reference, spec["layers"],
                             spec["batch"], spec["steps"])
    _, pm, state, step = tp_parts(
        dataclasses.replace(MIXTRAL_8X7B, num_layers=spec["layers"],
                            use_flash_attention=True, dtype=torch.float32,
                            param_dtype=torch.float32,
                            moe_dispatch="blockwise", moe_block_size=64),
        4, "float32", seed=1, zero1=False)
    start = {n: p.detach().cpu() for n, p in state.params.items()}
    metrics = [step(state, spec["batch"])[1] for _ in range(spec["steps"])]
    metrics = [(m["loss"].item(), m["grad_norm"].item()) for m in metrics]
    params = state.params
    del state, step
    free_cuda()
    compared = gather_compare("train_mixtral_tp_cross_check", pm, params,
                              start, ref["updates"])
    del pm, params, start, ref["updates"]
    free_cuda()
    return dict(coords=mesh.coords(), metrics=metrics,
                reference=ref["metrics"], tp1_s=ref["seconds"],
                update_rel_diff=compared, run_s=time.perf_counter() - t0)


def mixtral_tp_reference(layers, batch, steps):
    """The port's tp=1 Mixtral step on the card: full width, ``layers``
    layers, fp32, blockwise (block 64), the weights made on the card from
    seed 1, ``steps`` steps on ``batch``; each step's loss and grad norm
    and each parameter's update on the host."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import (
        neuronx_distributed_config)
    from neuronx_distributed_tpu_torch.models import mixtral

    cfg = dataclasses.replace(mixtral.MIXTRAL_8X7B, num_layers=layers,
                              dtype=torch.float32, param_dtype=torch.float32,
                              use_flash_attention=True,
                              moe_dispatch="blockwise", moe_block_size=64)
    pm, params = trainer.initialize_parallel_model(
        neuronx_distributed_config(init_mesh=False), cfg, seed=1, std=0.02,
        device="cuda")
    start = {n: p.detach().cpu() for n, p in params.items()}
    tx, state = trainer.initialize_parallel_optimizer(pm, params, 1e-4)
    step = trainer.make_train_step(pm, tx)
    metrics = [step(state, batch)[1] for _ in range(steps)]
    metrics = [(m["loss"].item(), m["grad_norm"].item()) for m in metrics]
    upd = {n: p.detach().cpu() - start[n] for n, p in params.items()}
    del pm, params, tx, state, step, start
    free_cuda()
    return dict(metrics=metrics, updates=upd)


def update_rel_diffs(phase, got, want):
    """Each parameter's ``|got - want| / |want|`` (updates, whole), raising
    above 1e-3; the worst and its name."""
    worst, worst_name = 0.0, None
    for name, upd in want.items():
        rel = ((got[name] - upd).norm() / upd.norm()).item()
        if rel > worst:
            worst, worst_name = rel, name
        if not rel <= 1e-3:
            raise AssertionError(f"{phase}: {name}'s update differs by {rel} "
                                 "of its norm, above 1e-3")
    return worst, worst_name


# ---------------------------------------------------------------------------
# phases 62-63: expert parallelism, in the same start of the four processes
# ---------------------------------------------------------------------------

EP_SIZE = 2      # tp=2 x dp=2 with ep=2: each ep group is a dp pair


def ep_cfg(layers, dtype=None):
    """Mixtral 8x7B's widths at ``layers`` layers, fp32 parameters,
    blockwise dispatch (block 64), flash attention; ``dtype`` sets the
    compute dtype in the config too (the cross check's fp32)."""
    from neuronx_distributed_tpu_torch.models.mixtral import MIXTRAL_8X7B

    kw = {} if dtype is None else {"dtype": dtype}
    return dataclasses.replace(MIXTRAL_8X7B, num_layers=layers,
                               use_flash_attention=True,
                               param_dtype=torch.float32,
                               moe_dispatch="blockwise", moe_block_size=64,
                               **kw)


def glu_holds(k5_call, k78_call):
    """The first K5 launch and the first K7+K8 launch a rank made on the
    path, held to their plain versions in fp32 on the same inputs (1e-2,
    ``flash_rel_err``), with the sentinel blocks (expert id ``E`` of the
    rank's bank) shown: K5's rows of them exactly zero (``hold_glu``),
    K7's dx rows of them exactly zero, and K8's dW of the last local
    expert, whose run the sentinel blocks follow, held on its own (it must
    not be zeroed again after its run). Returns ``(holds, sentinel)``."""
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as tbm

    k5 = hold_glu(k5_call, tbm.grouped_glu_plain)
    holds = {"grouped_glu": k5["max_rel_err"]}
    (xs, gu, dn, be, dy, bs, bi), _, got = k78_call
    e = gu.shape[0]
    ref = tbm.grouped_glu_bwd_plain(xs.float(), gu.float(), dn.float(), be,
                                    dy.float(), bs, bi)
    for name, a, want in (("grouped_glu_dx", got[0], ref[0]),
                          ("grouped_glu_dw", got[1], ref[1]),
                          ("grouped_glu_dw.down", got[2], ref[2])):
        holds[name] = flash_rel_err(a, want.to(a.dtype))
    sentinel_blocks = int((be >= e).sum())
    first = int(torch.nonzero(be >= e)[0, 0]) if sentinel_blocks else -1
    sent = torch.repeat_interleave(be >= e, bs)
    # K5's own launch (a forward) has metadata of its own
    be5, bs5 = k5_call[0][3], k5_call[0][4]
    sent5 = torch.repeat_interleave(be5 >= e, bs5)
    info = dict(experts=e, blocks=be.numel(), sentinel_blocks=sentinel_blocks,
                sentinel_rows=int(sent.sum()),
                k5_sentinel_blocks=int((be5 >= e).sum()),
                k5_sentinel_rows_zero=not bool(k5_call[2][sent5].any()),
                k7_sentinel_rows_zero=not bool(got[0][sent].any()),
                last_run_expert=int(be[first - 1]) if first > 0 else -1)
    if first > 0:
        holds["grouped_glu_dw.last_expert"] = max(
            flash_rel_err(got[1][e - 1], ref[1][e - 1].to(got[1].dtype)),
            flash_rel_err(got[2][e - 1], ref[2][e - 1].to(got[2].dtype)))
    del ref
    if not (sentinel_blocks and info["k5_sentinel_blocks"]
            and info["k5_sentinel_rows_zero"]
            and info["k7_sentinel_rows_zero"]
            and info["last_run_expert"] == e - 1):
        raise AssertionError(f"grouped GLU at the EP shape: {info}")
    return holds, info


def mixtral_ep_rank(spec):
    """``train_mixtral_ep`` on one rank: Mixtral 8x7B's widths at 2 layers,
    tp=2 x dp=2 with ep=2 (dp_exp=1), sequence parallelism, ZeRO-1,
    blockwise dispatch (block 64), bf16 compute over fp32 parameters, one
    sequence of S=4096 a data rank, ``spec["steps"]`` steps, the fp32 wire
    and auto overlap (off at ep=2: the monolithic gather and
    reduce-scatter). Each rank holds 4 of the 8 experts at I/tp = 7168 and
    gathers both data ranks' tokens: the pairs of the other rank's experts
    go to the sentinel expert, whose blocks K5, K7 and K8 see inside the
    step. K2-K5, K7 and K8 counted from 0 over the steps; the ranks hold
    the first launch of each to its plain version one at a time (the state
    freed first; :func:`glu_holds` for the sentinel blocks); rank 0 times K5, K7
    and K8 on the path's inputs (kernel, plain, bound, cuBLAS per
    expert). Also the gloo bytes of the steps and the bytes staged through
    the host."""
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.ops import blockwise_moe as tbm
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_tpu_torch.parallel import comm, mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _, pm, state, step = tp_parts(ep_cfg(spec["layers"]), TP_SIZE,
                                  "bfloat16", seed=0, ep=EP_SIZE)
    load_peak = torch.cuda.max_memory_allocated()
    bank = pm.module.layers[0].moe.experts
    local_bank = tuple(bank.gate_up.shape)
    counters = dict(flash_counters(), grouped_glu=tbm.grouped_glu,
                    grouped_glu_dx=tbm.grouped_glu_dx,
                    grouped_glu_dw=tbm.grouped_glu_dw)
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    comm.collective_bytes.clear()
    comm.host_staged_bytes.clear()
    init_s = time.perf_counter() - t0
    for c in counters.values():
        c.launches = 0
    losses, norms, times = [], [], []
    # K5's and K7/K8's first launches kept on the host: four ranks' states
    # leave little room on the card for copies of an expert bank's dW
    with Capture(fa, "flash_fwd_cuda") as k2, \
            Capture(fa, "flash_bwd_dq_cuda") as k3, \
            Capture(fa, "flash_bwd_dkv_cuda") as k4, \
            Capture(tbm, "grouped_glu_cuda", host=True) as k5, \
            Capture(tbm, "grouped_glu_bwd_cuda", host=True) as k78:
        for _ in range(spec["steps"]):
            t_step = time.perf_counter()
            m = step(state, spec["batch"])[1]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t_step) * 1e3)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    moved = dict(comm.collective_bytes)
    staged = dict(comm.host_staged_bytes)
    del pm, state, step, m, bank
    free_cuda()
    run_s = time.perf_counter() - t0
    # one rank at a time: the fp64 comparisons of an expert bank's dW take
    # about 11 GB a rank, which four ranks at once leave no room for
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            holds, _, _ = tp_holds(k2, k3, k4)
            k5.calls, k78.calls = k5.on_card(), k78.on_card()
            glu, sentinel = glu_holds(k5.calls[0], k78.calls[0])
            holds.update(glu)
            free_cuda()
        dist.barrier()
    fwd_args = k5.calls[0][0]
    bwd_args = k78.calls[0][0]
    del k2, k3, k4, k5, k78
    free_cuda()
    holds_s = time.perf_counter() - t0 - run_s
    timing = None
    dist.barrier()
    t_timing = time.perf_counter()
    if dist.get_rank() == 0:
        timing = moe_tp_local_timing(fwd_args, bwd_args)
    timing_s = time.perf_counter() - t_timing
    dist.barrier()
    xs, gu = fwd_args[0], fwd_args[1]
    return dict(coords=mesh.coords(), losses=losses, grad_norms=norms,
                step_ms=times, launches=launches, holds=holds,
                sentinel=sentinel, timing=timing, init_s=init_s,
                run_s=run_s, holds_s=holds_s, timing_s=timing_s,
                load_peak_gib=load_peak / 2 ** 30, peak_gib=peak / 2 ** 30,
                collective_bytes=moved, host_staged_bytes=staged,
                local_bank=local_bank,
                local_shape=dict(rows=xs.shape[0], h=xs.shape[1],
                                 experts=gu.shape[0], i_local=gu.shape[-1],
                                 block=fwd_args[4]))


def ep_bank_variants(bank, x, gates, idx, gy):
    """The expert bank of one layer (its weights copied) on the inputs the
    path gave it, forward and backward from the cotangent ``gy``, for each
    dispatch of :mod:`neuronx_distributed_tpu_torch.parallel.ep_dispatch`:
    the fp32 and int8 wires, monolithic and as the ``ppermute`` ring. Per
    variant ``(y, dx, dgates, dgate_up, ddown)`` on the card, and the bytes
    the ring staged through the host."""
    from neuronx_distributed_tpu_torch.modules.moe import ExpertMLPs
    from neuronx_distributed_tpu_torch.parallel import comm

    out = {}
    for wire in ("fp32", "int8"):
        for ring in (False, True):
            m = ExpertMLPs(
                bank.num_experts, bank.gate_up.shape[1],
                bank.gate_up.shape[-1] * TP_SIZE, dispatch_mode="blockwise",
                block_size=bank.block_size, block_i=bank.block_i,
                dtype=bank.dtype, device=x.device, tp_size=TP_SIZE,
                ep_size=EP_SIZE, ep_wire_dtype=wire, ep_overlap=ring)
            with torch.no_grad():
                m.gate_up.copy_(bank.gate_up)
                m.down.copy_(bank.down)
            xg = x.detach().clone().requires_grad_(True)
            gg = gates.detach().clone().requires_grad_(True)
            comm.host_staged_bytes.clear()
            y, _ = m(xg, gg, idx)
            (y * gy).sum().backward()
            torch.cuda.synchronize()
            out[(wire, ring)] = dict(
                tensors=(y.detach(), xg.grad, gg.grad, m.gate_up.grad,
                         m.down.grad),
                staged=dict(comm.host_staged_bytes))
            del m, xg, gg, y
    return out


def ep_chunk_checks(variants, on_card=True):
    """What the per-chunk dispatch must show on the path's inputs: the
    fp32 ring equals the monolithic path bit for bit forward and in the
    gradients of the tokens and gates (the experts' dW sums the two chunks'
    products one chunk at a time: within 1e-5 of its max); int8 ring equals
    int8 monolithic bit for bit in every output and gradient; the ring
    stages its hops through the host (gloo's send/recv take no CUDA
    pointer) where the tensors are on the card, the monolithic forms
    nothing."""
    names = ("y", "dx", "dgates", "dgate_up", "ddown")
    fr, fm = variants[("fp32", True)], variants[("fp32", False)]
    qr, qm = variants[("int8", True)], variants[("int8", False)]
    res = dict(
        fp32_ring_bitwise={n: bool(torch.equal(a, b)) for n, a, b in zip(
            names, fr["tensors"], fm["tensors"])},
        int8_ring_bitwise={n: bool(torch.equal(a, b)) for n, a, b in zip(
            names, qr["tensors"], qm["tensors"])},
        fp32_ring_dw_rel={n: ((a - b).abs().max() / b.abs().max()).item()
                          for n, a, b in zip(names[3:], fr["tensors"][3:],
                                             fm["tensors"][3:])},
        int8_vs_fp32_y_rel=((qm["tensors"][0] - fm["tensors"][0]).abs().max()
                            / fm["tensors"][0].abs().max()).item(),
        staged_ring={w: variants[(w, True)]["staged"] for w in ("fp32",
                                                                "int8")},
        staged_monolithic={w: variants[(w, False)]["staged"]
                           for w in ("fp32", "int8")})
    ok = (all(res["fp32_ring_bitwise"][n] for n in names[:3])
          and all(v <= 1e-5 for v in res["fp32_ring_dw_rel"].values())
          and all(res["int8_ring_bitwise"].values())
          and all((sum(v.values()) > 0) == on_card
                  for v in res["staged_ring"].values())
          and not any(sum(v.values())
                      for v in res["staged_monolithic"].values()))
    if not ok:
        raise AssertionError(f"train_mixtral_ep_cross_check per chunk: {res}")
    return res


def mixtral_ep_cross_rank(spec):
    """``train_mixtral_ep_cross_check`` on one rank: Mixtral 8x7B's widths
    at ``spec["layers"]`` layer, fp32, blockwise (block 64), tp=2 x dp=2
    with sequence parallelism (no ZeRO-1), the weights made on the card
    from seed 1, ``spec["steps"]`` steps on the global batch: first at
    ep=1, keeping on the host the updates of the part of each parameter
    this rank holds at ep=2; then at ep=2 from the same weights and batch:
    each step's loss and grad norm, and each parameter's update against
    the kept one over every rank's part (its squares summed over the axes
    its spec shards it on). Then, on layer 0's inputs as the ep=2 path
    gave them, its bank through each EP dispatch
    (:func:`ep_bank_variants`, :func:`ep_chunk_checks`)."""
    from neuronx_distributed_tpu_torch.models import convert
    from neuronx_distributed_tpu_torch.modules.moe import expert_mlps
    from neuronx_distributed_tpu_torch.parallel import comm, grads, mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = ep_cfg(spec["layers"], torch.float32)
    batch, steps = spec["batch"], spec["steps"]

    def run(step, state):
        metrics = [step(state, batch)[1] for _ in range(steps)]
        return [(m["loss"].item(), m["grad_norm"].item()) for m in metrics]

    # without ZeRO-1 at both layouts: at ep=1 its reduce-scatter of a whole
    # 8-expert bank takes about 4 GB of transients a rank, which four
    # ranks at full width leave no room for (the main phase runs ZeRO-1)
    _, pm, state, step = tp_parts(cfg, TP_SIZE, "float32", seed=1,
                                  zero1=False)
    start = {n: p.detach().to("cpu", copy=True)
             for n, p in state.params.items()}
    comm.collective_bytes.clear()
    ref = run(step, state)
    ref_bytes = dict(comm.collective_bytes)
    # this rank's ep index at ep=2 is its data index (one dp_exp group)
    ep_rank = mesh.axis_rank(mesh.DATA_AXES)
    kept = {}
    for n, p in state.params.items():
        u = p.detach().cpu() - start[n]
        if "experts" in n:
            u = convert.shard_tensor(n, u, (mesh.EP_AXIS,),
                                     {mesh.EP_AXIS: EP_SIZE},
                                     {mesh.EP_AXIS: ep_rank})
        kept[n] = u
    del pm, state, step, start
    free_cuda()
    ref_s = time.perf_counter() - t0
    _, pm, state, step = tp_parts(cfg, TP_SIZE, "float32", seed=1,
                                  zero1=False, ep=EP_SIZE)
    start = {n: p.detach().clone() for n, p in state.params.items()}
    comm.collective_bytes.clear()
    with Capture(expert_mlps.ExpertMLPs, "_forward_blockwise_ep",
                 by_ref=(0,)) as bank_in:
        metrics = run(step, state)
    ep_bytes = dict(comm.collective_bytes)
    worst, worst_name = 0.0, None
    for n, p in state.params.items():
        diff = ((p.detach() - start[n]).cpu() - kept[n]).double()
        sums = torch.stack([diff.pow(2).sum(),
                            kept[n].double().pow(2).sum()]).to(p.device)
        for ax in sorted(grads.spec_axes(pm.specs[n])):
            sums = comm.all_reduce(sums, ax)
        rel = float(torch.sqrt(sums[0] / sums[1]))
        if rel > worst:
            worst, worst_name = rel, n
    if not worst <= 1e-3:
        raise AssertionError(f"train_mixtral_ep_cross_check: {worst_name}'s "
                             f"update differs by {worst} of its norm")
    (bank, x, gates, idx, *_), _, _ = bank_in.calls[0]
    del kept, start, pm, state, step, bank_in
    free_cuda()
    gy = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        7 + mesh.axis_rank(mesh.EP_AXIS)), dtype=x.dtype).to(x.device)
    chunk = ep_chunk_checks(ep_bank_variants(bank, x, gates, idx, gy),
                            x.is_cuda)
    del bank, x, gates, idx, gy
    free_cuda()
    return dict(coords=mesh.coords(), metrics=metrics, reference=ref,
                update_rel_diff=(worst, worst_name), per_chunk=chunk,
                gloo_bytes_ep1=ref_bytes, gloo_bytes_ep2=ep_bytes,
                ep1_s=ref_s, run_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phases 58-61: pipeline parallelism, in the same start of the four
# processes
# ---------------------------------------------------------------------------

PP_SIZE = 2      # pp=2 x tp=2 over the four ranks


def pp_parts(model_cfg, compute, seed=None, state_dict=None, pp=PP_SIZE,
             microbatches=4, schedule="1f1b", chunks=1, **step_kw):
    """``(cfg, pm, state, step, grad_fn)`` of the public path at ``pp`` x
    ``tp=2`` over the four ranks with sequence parallelism: each rank
    builds its stage from the whole weights made from ``seed`` on the
    card a tensor at a time (or ``state_dict``'s, a mapping or anything
    with ``items()``), AdamW lr 1e-4, and ``make_train_step`` over the
    pipeline grad function of ``schedule`` (Mixtral's for a Mixtral
    config) with ``microbatches`` microbatches and ``chunks`` chunks a
    stage."""
    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import (
        MixedPrecisionConfig, PipelineConfig, configure_model,
        neuronx_distributed_config)
    from neuronx_distributed_tpu_torch.models import llama_pipeline as lpp
    from neuronx_distributed_tpu_torch.models import mixtral_pipeline as mpp

    ncfg = neuronx_distributed_config(
        tensor_parallel_size=TP_SIZE, pipeline_parallel_size=pp,
        sequence_parallel=True,
        pipeline_config=PipelineConfig(num_microbatches=microbatches,
                                       schedule=schedule),
        mixed_precision_config=MixedPrecisionConfig(compute_dtype=compute))
    cfg = configure_model(ncfg, model_cfg)
    pm, params = trainer.initialize_parallel_model(
        ncfg, cfg, seed=seed or 0, state_dict=state_dict, std=0.02,
        device="cuda")
    tx, state = trainer.initialize_parallel_optimizer(pm, params, 1e-4)
    if hasattr(cfg, "router_aux_coef"):
        gf = mpp.make_moe_1f1b_grad_fn(cfg, microbatches, pm,
                                       num_chunks=chunks)
    else:
        gf = lpp.make_pipeline_grad_fn(cfg, microbatches, pm,
                                       schedule=schedule, num_chunks=chunks)
    return cfg, pm, state, trainer.make_train_step(pm, tx, grad_fn=gf), gf


class InterleavedDraw:
    """The whole weights ``draw_state_dict`` makes from ``seed`` (those of
    ``initialize_parallel_model(seed=...)``), a tensor at a time, the
    layers renamed into the interleaved storage order of ``stages`` x
    ``chunks`` (``llama_pipeline.interleave_pipeline_params``)."""

    def __init__(self, cfg, seed, stages, chunks):
        self.cfg, self.seed = cfg, seed
        self.stages, self.chunks = stages, chunks

    def items(self):
        from neuronx_distributed_tpu_torch.models import llama
        from neuronx_distributed_tpu_torch.pipeline.engine_1f1b import (
            interleaved_layer_order)

        order = interleaved_layer_order(self.cfg.num_layers, self.stages,
                                        self.chunks)
        slot = {int(c): j for j, c in enumerate(order)}
        for name, t in llama.draw_state_dict(self.cfg, self.seed, 0.02,
                                             "cuda"):
            if name.startswith("layers."):
                _, i, rest = name.split(".", 2)
                name = f"layers.{slot[int(i)]}.{rest}"
            yield name, t


def pp_canonical(name, chunks, layers):
    """The canonical name of a parameter a pipeline stage holds under the
    interleaved storage order of ``chunks`` chunks (itself at 1)."""
    if chunks == 1 or not name.startswith("layers."):
        return name
    from neuronx_distributed_tpu_torch.pipeline.engine_1f1b import (
        interleaved_layer_order)

    order = interleaved_layer_order(layers, PP_SIZE, chunks)
    _, i, rest = name.split(".", 2)
    return f"layers.{int(order[int(i)])}.{rest}"


def pp_staged_want(act_shape, itemsize, microbatches, chunks=1,
                   stages=PP_SIZE):
    """The bytes one 1F1B / interleaved step stages through the host on a
    rank: every tick of ``T = M·C + S·C + S - 2`` passes an activation
    (or its gradient) of ``act_shape`` around each of two rings, and
    ``comm.ppermute`` counts the copy down of what a rank sends and the
    copy up of what it receives: four activations a tick."""
    ticks = microbatches * chunks + stages * chunks + stages - 2
    return 4 * ticks * int(np.prod(act_shape)) * itemsize


def pp_train_rank(spec):
    """``train_pp`` on one rank: Llama-3-8B's widths at 4 layers (2 a
    stage) with the untied head, pp=2 x tp=2 with sequence parallelism,
    1F1B with M=4 microbatches of one row at S=4096, bf16 compute over
    fp32 parameters, AdamW lr 1e-4 clipped at 1.0, ``spec["steps"]``
    steps. K2-K4 counted from 0 over the steps (each rank runs its 2
    layers for each of the 4 microbatches: 8 each a step), their first
    launches held to their plain versions; the bytes staged through the
    host by the stage rings against :func:`pp_staged_want`."""
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.models.llama import LLAMA3_8B
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_tpu_torch.parallel import comm, mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, pm, state, step, gf = pp_parts(
        dataclasses.replace(LLAMA3_8B, num_layers=spec["layers"],
                            use_flash_attention=True,
                            param_dtype=torch.float32),
        "bfloat16", seed=0, microbatches=spec["microbatches"])
    load_peak = torch.cuda.max_memory_allocated()
    counters = flash_counters()
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    comm.collective_bytes.clear()
    comm.host_staged_bytes.clear()
    init_s = time.perf_counter() - t0
    for c in counters.values():
        c.launches = 0
    losses, norms, times = [], [], []
    with Capture(fa, "flash_fwd_cuda") as k2, \
            Capture(fa, "flash_bwd_dq_cuda") as k3, \
            Capture(fa, "flash_bwd_dkv_cuda") as k4:
        for _ in range(spec["steps"]):
            t_step = time.perf_counter()
            _, m = step(state, spec["batch"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t_step) * 1e3)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    staged = dict(comm.host_staged_bytes)
    moved = dict(comm.collective_bytes)
    holds, (q, k, v), g = tp_holds(k2, k3, k4)
    del k2, k3, k4, q, k, v, g
    seq = spec["batch"]["input_ids"].shape[1]
    act = (spec["batch"]["input_ids"].shape[0] // spec["microbatches"],
           seq // TP_SIZE, cfg.hidden_size)
    want_staged = spec["steps"] * pp_staged_want(
        act, torch.finfo(torch.bfloat16).bits // 8, spec["microbatches"])
    out = dict(coords=mesh.coords(), losses=losses, grad_norms=norms,
               step_ms=times, launches=launches, holds=holds,
               init_s=init_s, run_s=time.perf_counter() - t0,
               load_peak_gib=load_peak / 2 ** 30, peak_gib=peak / 2 ** 30,
               host_staged_bytes=staged, want_staged_bytes=want_staged,
               collective_bytes=moved, stats=dict(gf.last_stats),
               held_params=sum(p.numel() for p in state.params.values()))
    del pm, state, step, gf
    free_cuda()
    return out


def pp_keep(name, stage, layers):
    """Whether rank-local reference updates of ``name`` are kept for a
    stage of :func:`pp_cross_rank`'s pipelines: the layers stage ``stage``
    holds under 1F1B or the interleaved order (C=2), and its end of the
    model."""
    from neuronx_distributed_tpu_torch.models.llama_pipeline import (
        stage_layers)
    from neuronx_distributed_tpu_torch.pipeline.engine_1f1b import (
        interleaved_layer_order)

    if name.startswith("layers."):
        i = int(name.split(".")[1])
        order = interleaved_layer_order(layers, PP_SIZE, 2)
        held = set(stage_layers(layers, PP_SIZE, stage)) | {
            int(order[j]) for j in stage_layers(layers, PP_SIZE, stage)}
        return i in held
    return name.startswith("embed.") if stage == 0 else not \
        name.startswith("embed.")


def pp_update_diffs(updates, want, group_names):
    """Each parameter's ``|update - want| / |want|`` over the whole tensor
    (the sums of squares of a stage's tp shards added over tp), the worst
    over the world and its name."""
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.parallel import comm, mesh

    names = sorted(group_names)
    sums = torch.tensor([[float(torch.linalg.vector_norm(
        updates[n] - want[n], dtype=torch.float64) ** 2),
        float(torch.linalg.vector_norm(want[n], dtype=torch.float64) ** 2)]
        for n in names], dtype=torch.float64)
    sums = comm.all_reduce(sums, mesh.TP_AXIS)
    rel = (sums[:, 0] / sums[:, 1].clamp_min(1e-300)).sqrt()
    i = int(rel.argmax())
    worst = [float(rel[i]), names[i]]
    box = [None] * dist.get_world_size()
    dist.all_gather_object(box, worst)
    return max(box, key=lambda w: w[0])


def pp_cross_rank(spec):
    """``train_pp_cross_check`` on one rank: Llama-3-8B's widths at 4
    layers with the untied head, fp32, S=256, global batch of 4, 2 steps:
    first at tp=2 x dp=2 (sequence parallel, ZeRO-1; the layout
    ``train_tp_cross_check`` holds to tp=1), each rank keeping on its host
    the updates of the parameters its stage will hold; then at pp=2 x tp=2
    under ``1f1b``, ``interleaved`` (C=2, the stack in the interleaved
    order) and ``gpipe`` from the same weights (made from seed 1) and
    batch, one layout's state live at a time: each step's loss and grad
    norm, and each parameter's update against the kept one."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    layers, steps, batch = spec["layers"], spec["steps"], spec["batch"]
    model = dataclasses.replace(loop_cfg(layers), tie_embeddings=False,
                                dtype=torch.float32)

    def run(step, state, keep=lambda name: True):
        # the kept parameters' updates, on the host: the card has no room
        # for a copy of them beside the reference layout's state
        start = {n: p.detach().cpu() for n, p in state.params.items()
                 if keep(n)}
        metrics = [step(state, batch)[1] for _ in range(steps)]
        metrics = [(m["loss"].item(), m["grad_norm"].item())
                   for m in metrics]
        return metrics, {n: state.params[n].detach().cpu() - s0
                         for n, s0 in start.items()}

    from neuronx_distributed_tpu_torch.parallel import mesh

    _, pm, state, step = tp_parts(model, TP_SIZE, "float32", seed=1)
    stage = mesh.axis_rank(mesh.DP_AXIS)     # the same rank's stage below
    ref_metrics, kept = run(step, state,
                            lambda n: pp_keep(n, stage, layers))
    del pm, state, step
    free_cuda()
    out = dict(reference=ref_metrics, ref_s=time.perf_counter() - t0)
    for name, schedule, chunks in (("1f1b", "1f1b", 1),
                                   ("interleaved", "interleaved", 2),
                                   ("gpipe", "gpipe", 1)):
        t1 = time.perf_counter()
        source = (InterleavedDraw(model, 1, PP_SIZE, chunks) if chunks > 1
                  else None)
        _, pm, state, step, gf = pp_parts(
            model, "float32", seed=1, state_dict=source,
            microbatches=spec["microbatches"], schedule=schedule,
            chunks=chunks)
        metrics, upd = run(step, state)
        upd = {pp_canonical(n, chunks, layers): u for n, u in upd.items()}
        worst = pp_update_diffs(upd, kept, upd)
        out[name] = dict(metrics=metrics, update_rel_diff=worst,
                         stats=dict(gf.last_stats),
                         seconds=time.perf_counter() - t1)
        del pm, state, step, gf, upd
        free_cuda()
    return out


def pp_mixtral_rank(spec):
    """``train_mixtral_pp`` on one rank: Mixtral 8x7B's widths at 2 layers
    (1 a stage), pp=2 x tp=2 with sequence parallelism, blockwise
    dispatch (block 64), the experts at I/tp = 7168, 1F1B with M=2
    microbatches of one row at S=4096 and the router's aux, bf16 over fp32
    parameters, ``spec["steps"]`` steps. K2-K5, K7 and K8 counted from 0
    over the steps, the first launch of each held to its plain version
    (one rank at a time, the state freed first); rank 0 times K5, K7 and
    K8 on the path's inputs (kernel, plain, bound, cuBLAS per expert)."""
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.models.mixtral import MIXTRAL_8X7B
    from neuronx_distributed_tpu_torch.ops import blockwise_moe as tbm
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_tpu_torch.parallel import comm, mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _, pm, state, step, gf = pp_parts(
        dataclasses.replace(MIXTRAL_8X7B, num_layers=spec["layers"],
                            use_flash_attention=True,
                            param_dtype=torch.float32,
                            moe_dispatch="blockwise", moe_block_size=64),
        "bfloat16", seed=0, microbatches=spec["microbatches"])
    load_peak = torch.cuda.max_memory_allocated()
    counters = dict(flash_counters(), grouped_glu=tbm.grouped_glu,
                    grouped_glu_dx=tbm.grouped_glu_dx,
                    grouped_glu_dw=tbm.grouped_glu_dw)
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    comm.host_staged_bytes.clear()
    init_s = time.perf_counter() - t0
    for c in counters.values():
        c.launches = 0
    losses, norms, times = [], [], []
    # the first launches kept on the host: at I/tp = 7168 a copy of the
    # experts' dW alone is 2.8 GB a rank, which four ranks' states leave
    # no room for on the card
    with Capture(fa, "flash_fwd_cuda") as k2, \
            Capture(fa, "flash_bwd_dq_cuda") as k3, \
            Capture(fa, "flash_bwd_dkv_cuda") as k4, \
            Capture(tbm, "grouped_glu_cuda", host=True) as k5, \
            Capture(tbm, "grouped_glu_bwd_cuda", host=True) as k78:
        for _ in range(spec["steps"]):
            t_step = time.perf_counter()
            m = step(state, spec["batch"])[1]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t_step) * 1e3)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    staged = dict(comm.host_staged_bytes)
    del pm, state, step, m, gf
    free_cuda()
    k5.calls, k78.calls = k5.on_card(), k78.on_card()
    (xs, gu, dn, be, dy, bs, bi), _, got = k78.calls[0]
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            holds, _, _ = tp_holds(k2, k3, k4)
            holds["grouped_glu"] = hold_glu(
                k5.calls[0], tbm.grouped_glu_plain)["max_rel_err"]
            ref = tbm.grouped_glu_bwd_plain(xs.float(), gu.float(),
                                            dn.float(), be, dy.float(), bs,
                                            bi)
            for name, a, want in (("grouped_glu_dx", got[0], ref[0]),
                                  ("grouped_glu_dw", got[1], ref[1]),
                                  ("grouped_glu_dw.down", got[2], ref[2])):
                holds[name] = flash_rel_err(a, want.to(a.dtype))
            del ref
            free_cuda()
        dist.barrier()
    fwd_args = k5.calls[0][0]
    del k2, k3, k4, k5, k78
    timing = None
    dist.barrier()
    if dist.get_rank() == 0:
        timing = moe_tp_local_timing(fwd_args, (xs, gu, dn, be, dy, bs, bi))
    dist.barrier()
    return dict(coords=mesh.coords(), losses=losses, grad_norms=norms,
                step_ms=times, launches=launches, holds=holds,
                timing=timing, init_s=init_s,
                run_s=time.perf_counter() - t0, host_staged_bytes=staged,
                load_peak_gib=load_peak / 2 ** 30, peak_gib=peak / 2 ** 30,
                local_shape=dict(rows=xs.shape[0], h=xs.shape[1],
                                 experts=gu.shape[0], i_local=gu.shape[-1],
                                 block=bs))


def tag_pieces_equal(path, tag, state):
    """Whether every tensor of a stage's ``state`` (params and optimizer
    state) equals, bit for bit, the part of the saved pieces of tag
    ``tag`` it covers at this rank's layout, read straight from the tag's
    files (memory-mapped), and the count of elements compared."""
    from neuronx_distributed_tpu_torch.trainer import checkpoint as ck

    table = ck.saved_shard_table(path, tag)
    lay = ck._layout()
    files = {}
    compared, same = 0, True
    tree = ck.state_to_tree(state, lambda t: t)
    for p, t in ck.tree_leaves(tree):
        g = state.global_paths[p][0]
        entry = table["leaves"][g]
        _, box = ck._box(t.shape, ck._norm_spec(state.shard_specs.get(p),
                                                 t.dim()), lay)
        for rel, pbox in entry["pieces"]:
            lo = [max(a, q[0]) for (a, _), q in zip(box, pbox)]
            hi = [min(b, q[1]) for (_, b), q in zip(box, pbox)]
            if any(h <= l for l, h in zip(lo, hi)):
                continue
            if rel not in files:
                files[rel] = torch.load(os.path.join(path, str(tag), rel),
                                        map_location="cpu",
                                        weights_only=True, mmap=True)
            piece = files[rel][g][tuple(slice(l - q[0], h - q[0]) for l, h, q
                                        in zip(lo, hi, pbox))]
            mine = t.detach()[tuple(slice(l - b[0], h - b[0]) for l, h, b
                                    in zip(lo, hi, box))].cpu()
            same = same and torch.equal(mine, piece)
            compared += mine.numel()
    return same, compared


def pp_resume_rank(spec):
    """``train_pp_resume`` on one rank: ``train_tp_loop``'s tag (1 layer,
    the tied head, saved at tp=2 x dp=2 with ZeRO-1) loaded at pp=2 x
    tp=2: stage 0 holds the embedding and the layer, stage 1 only the
    final norm and the tied table. Every tensor held to the tag's pieces
    bit for bit, the parameters' fingerprint (of the whole model, from
    the stages) against the one the tag's parameters had when saved; then
    steps 3-4 of ``train_tp_loop_cross_check``'s fp32 batches at S=256
    through ``Trainer`` (1F1B, M=2), whose losses the caller holds to the
    tp=2 x dp=2 resume's. Writes nothing."""
    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.trainer import Trainer
    from neuronx_distributed_tpu_torch.trainer import checkpoint as ck

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _, pm, state, step, gf = pp_parts(
        dataclasses.replace(loop_cfg(1), dtype=torch.float32), "float32",
        seed=5, microbatches=2)
    t1 = time.perf_counter()
    ck.load_checkpoint(spec["dir"], tag="2", target=state)
    load_s = time.perf_counter() - t1
    same, compared = tag_pieces_equal(spec["dir"], "2", state)
    fp = step.fingerprint(state.params).cpu()
    held = sorted(state.params)
    clock = StepClock()
    Trainer(step, state, callbacks=[clock]).fit(
        iter(spec["cross_batches"][2:]), max_steps=4)
    out = dict(coords=mesh.coords(), same=same, compared=compared,
               fingerprint=fp, held=[n for n in held
                                     if not n.startswith("layers.")]
               + sorted({".".join(n.split(".")[:2]) for n in held
                         if n.startswith("layers.")}),
               losses=clock.losses, step=state.step, load_s=load_s,
               run_s=time.perf_counter() - t0)
    del pm, state, step, gf
    free_cuda()
    return out


def check_train_pp(smi, outs, steps, seq, layers, microbatches):
    """``train_pp``: finite losses equal on every rank and falling; each
    rank's K2-K4 launched (layers / pp) x M x steps times, their first
    launches within 2e-2 of their plain versions; the bytes the stage
    rings staged through the host equal to :func:`pp_staged_want`'s; at
    most S - s graphs live on stage s."""
    want = layers // PP_SIZE * microbatches * steps
    for r, out in enumerate(outs):
        if not (np.isfinite(out["losses"]).all()
                and np.isfinite(out["grad_norms"]).all()
                and np.allclose(out["losses"], outs[0]["losses"], rtol=1e-6,
                                atol=0)):
            raise AssertionError(f"train_pp: rank {r} losses {out['losses']}"
                                 f" vs {outs[0]['losses']}")
        for name, n in out["launches"].items():
            if n != want:
                raise AssertionError(f"train_pp: rank {r} launched {name} "
                                     f"{n} times, want {want}")
        for name, err in out["holds"].items():
            if not err <= 2e-2:
                raise AssertionError(f"train_pp: rank {r} {name} differs "
                                     f"from its plain version by {err}")
        staged = out["host_staged_bytes"].get("ppermute", 0)
        if staged != out["want_staged_bytes"] or len(
                out["host_staged_bytes"]) != 1:
            raise AssertionError(f"train_pp: rank {r} staged "
                                 f"{out['host_staged_bytes']}, want "
                                 f"{out['want_staged_bytes']}")
        if out["stats"]["max_live"] > PP_SIZE - out["coords"]["pp"]:
            raise AssertionError(f"train_pp: rank {r} held "
                                 f"{out['stats']} graphs")
    if not outs[0]["losses"][-1] < outs[0]["losses"][0]:
        raise AssertionError(f"train_pp: loss did not fall: "
                             f"{outs[0]['losses']}")
    launches = {name: sum(o["launches"][name] for o in outs)
                for name, _ in FLASH_KERNELS}
    p50 = float(np.median([t for o in outs for t in o["step_ms"][1:]]))
    emit("train_pp", card=smi, layers=layers, seq=seq, steps=steps,
         world=TP_WORLD, pp=PP_SIZE, tp=TP_SIZE, schedule="1f1b",
         microbatches=microbatches, compute_dtype="bfloat16",
         losses=outs[0]["losses"], grad_norms=outs[0]["grad_norms"],
         step_ms_p50=p50, step_ms_by_rank=[o["step_ms"] for o in outs],
         peak_gib_by_rank=[o["peak_gib"] for o in outs],
         load_peak_gib_by_rank=[o["load_peak_gib"] for o in outs],
         held_params_by_rank=[o["held_params"] for o in outs],
         launches_by_rank=[o["launches"] for o in outs],
         held_err_by_rank=[o["holds"] for o in outs],
         live_graphs_by_rank=[o["stats"] for o in outs],
         host_staged_bytes_by_rank=[o["host_staged_bytes"] for o in outs],
         gloo_bytes_by_rank=[o["collective_bytes"] for o in outs],
         rank_init_s=[o["init_s"] for o in outs],
         rank_run_s=[o["run_s"] for o in outs],
         rank_done_s=[o["done_s"] for o in outs])
    TP_RESULTS["train_pp"] = dict(launches=launches, outs=outs)
    return launches


def check_train_pp_cross(smi, outs, layers, seq, steps):
    """``train_pp_cross_check``: each pipeline schedule's losses within
    1e-5 relative and grad norms within 1e-4 of the tp=2 x dp=2 step's,
    equal on every rank; every parameter's update within 1e-3 of its
    norm."""
    ref = outs[0]["reference"]
    line = {}
    for name in ("1f1b", "interleaved", "gpipe"):
        for r, out in enumerate(outs):
            if out[name]["metrics"] != outs[0][name]["metrics"]:
                raise AssertionError(f"train_pp_cross_check: {name} rank "
                                     f"{r} {out[name]['metrics']}")
        for i, ((l, n), (lw, nw)) in enumerate(zip(outs[0][name]["metrics"],
                                                   ref)):
            if not (abs(l - lw) <= 1e-5 * abs(lw)
                    and abs(n - nw) <= 1e-4 * abs(nw)):
                raise AssertionError(
                    f"train_pp_cross_check: {name} step {i + 1} ({l}, {n})"
                    f" vs tp=2 x dp=2 ({lw}, {nw})")
        worst = outs[0][name]["update_rel_diff"]
        if not worst[0] <= 1e-3:
            raise AssertionError(f"train_pp_cross_check: {name} update of "
                                 f"{worst[1]} differs by {worst[0]}")
        line[name] = dict(metrics=outs[0][name]["metrics"],
                          max_update_rel_diff=worst,
                          live_graphs_by_rank=[o[name]["stats"]
                                               for o in outs],
                          seconds=outs[0][name]["seconds"])
    emit("train_pp_cross_check", card=smi, layers=layers, seq=seq,
         steps=steps, reference_tp2_dp2=ref, ref_s=outs[0]["ref_s"],
         rank_done_s=[o["done_s"] for o in outs], **line)


def check_train_mixtral_pp(smi, outs, steps, seq, layers, microbatches):
    """``train_mixtral_pp``: finite losses equal on every rank; each
    rank's K2-K4, K5, K7 and K8 launched (layers / pp) x M x steps times,
    the first launch of each within 2e-2 (K2-K4) or 1e-2 (K5, K7, K8) of
    its plain version."""
    want = layers // PP_SIZE * microbatches * steps
    for r, out in enumerate(outs):
        if not (np.isfinite(out["losses"]).all() and np.allclose(
                out["losses"], outs[0]["losses"], rtol=1e-6, atol=0)):
            raise AssertionError(f"train_mixtral_pp: rank {r} losses "
                                 f"{out['losses']}")
        for name, n in out["launches"].items():
            if n != want:
                raise AssertionError(f"train_mixtral_pp: rank {r} launched "
                                     f"{name} {n} times, want {want}")
        for name, err in out["holds"].items():
            tol = 2e-2 if name.startswith("flash") else 1e-2
            if not err <= tol:
                raise AssertionError(f"train_mixtral_pp: rank {r} {name} "
                                     f"differs from plain by {err}")
    launches = {name: sum(o["launches"][name] for o in outs)
                for name in outs[0]["launches"]}
    emit("train_mixtral_pp", card=smi, layers=layers, seq=seq, steps=steps,
         pp=PP_SIZE, tp=TP_SIZE, schedule="1f1b", microbatches=microbatches,
         compute_dtype="bfloat16", losses=outs[0]["losses"],
         grad_norms=outs[0]["grad_norms"],
         step_ms_by_rank=[o["step_ms"] for o in outs],
         peak_gib_by_rank=[o["peak_gib"] for o in outs],
         load_peak_gib_by_rank=[o["load_peak_gib"] for o in outs],
         launches_by_rank=[o["launches"] for o in outs],
         held_err_by_rank=[o["holds"] for o in outs],
         host_staged_bytes_by_rank=[o["host_staged_bytes"] for o in outs],
         local_shape=outs[0]["local_shape"], timing=outs[0]["timing"],
         rank_run_s=[o["run_s"] for o in outs],
         rank_done_s=[o["done_s"] for o in outs])
    TP_RESULTS["train_mixtral_pp"] = dict(launches=launches, outs=outs)
    return launches


def check_train_pp_resume(smi, outs, loop_outs):
    """``train_pp_resume``: every rank's tensors equal the tag's pieces
    bit for bit, the stages' fingerprint of the whole parameters equals
    the one the tag's had when saved (``train_tp_loop_cross_check``'s A at
    step 2), stage 1 holds only the norm and the tied table, and steps 3-4
    from the tag at pp=2 x tp=2 hold the tp=2 x dp=2 resume's losses
    within 1e-5."""
    want_fp = loop_outs[0]["a_fps"][2]
    want = [loop_outs[0]["b_losses"][s] for s in (3, 4)]
    for r, out in enumerate(outs):
        if not (out["same"] and out["compared"] > 0):
            raise AssertionError(f"train_pp_resume: rank {r} differs from "
                                 "the tag's pieces")
        if not torch.equal(out["fingerprint"], want_fp):
            raise AssertionError(f"train_pp_resume: rank {r}'s fingerprint "
                                 "is not the tag's")
        if out["coords"]["pp"] == 1 and out["held"] != [
                "embed.embedding", "norm.scale"]:
            raise AssertionError(f"train_pp_resume: stage 1 holds "
                                 f"{out['held']}")
        if not (out["step"] == 4 and all(
                abs(a - b) <= 1e-5 * abs(b)
                for a, b in zip(out["losses"], want))):
            raise AssertionError(f"train_pp_resume: rank {r} losses "
                                 f"{out['losses']} vs {want}")
    emit("train_pp_resume", card=smi, pp=PP_SIZE, tp=TP_SIZE, layers=1,
         tied=True, held_by_rank=[o["held"] for o in outs],
         elements_compared_by_rank=[o["compared"] for o in outs],
         losses=outs[0]["losses"], losses_tp2_dp2=want,
         load_s_by_rank=[o["load_s"] for o in outs],
         rank_run_s=[o["run_s"] for o in outs],
         rank_done_s=[o["done_s"] for o in outs])


def check_train_tp_loop(smi, outs, seq, layers):
    """``train_tp_loop``: every rank resumed at step 2 and trained steps
    3-4 with losses finite and equal to rank 0's; K2-K4 launched layers x
    2 times with dropout at the rank's offsets, their first launches held
    to their plain versions within 2e-2; the flip seen on data rank 1, tp
    rank 0 alone, the mismatch and the rewind on every rank at the step-4
    boundary (checks 1, mismatches 1, rewinds 1, back at step 2), the
    rewound parameters' fingerprint the tag's (A's step 2), one tag on
    disk."""
    for r, out in enumerate(outs):
        o = out["loop"]
        if not (np.isfinite(o["losses"]).all() and np.allclose(
                o["losses"], outs[0]["loop"]["losses"], rtol=1e-6, atol=0)):
            raise AssertionError(f"train_tp_loop: rank {r} losses "
                                 f"{o['losses']}")
        for name, n in o["launches"].items():
            if n != layers * 2:
                raise AssertionError(f"train_tp_loop: rank {r} launched "
                                     f"{name} {n} times, want {layers * 2}")
        for name, err in o["holds"].items():
            if not err <= 2e-2:
                raise AssertionError(f"train_tp_loop: rank {r} {name} "
                                     f"differs from plain by {err}")
        c = out["coords"]
        flipper = c["dp"] == 1 and c["tp"] == 0
        got = (o["start"], o["flips"], o["mismatches"], o["checks"],
               o["rewinds"], o["rewound_to"], o["rewound_is_step_2s"])
        if got != (2, int(flipper), 1, 1, 1, 2, True):
            raise AssertionError(f"train_tp_loop: rank {r} start, flips, "
                                 f"mismatches, checks, rewinds, rewound "
                                 f"to, rewound = step 2: {got}")
        if o["dropout"]["p"] != 0.1 or o["dropout"]["offsets"] != [
                c["dp"], 32, 16 * c["tp"]]:
            raise AssertionError(f"train_tp_loop: rank {r} dropout "
                                 f"{o['dropout']}")
        if out["tags"] != ["2"]:
            raise AssertionError(f"train_tp_loop: tags {out['tags']}")
    loops = [o["loop"] for o in outs]
    launches = {name: sum(o["launches"][name] for o in loops)
                for name, _ in FLASH_KERNELS}
    emit("train_tp_loop", card=smi, layers=layers, tie_embeddings=True,
         seq=seq, steps=[3, 4], resumed_from_tag=2, world=TP_WORLD,
         tp=TP_SIZE, dp=TP_WORLD // TP_SIZE, compute_dtype="bfloat16",
         attention_dropout=0.1, integrity_every=2,
         losses=loops[0]["losses"],
         step_ms_by_rank=[o["step_ms"] for o in loops],
         peak_gib_by_rank=[o["peak_gib"] for o in loops],
         launches_by_rank=[o["launches"] for o in loops],
         held_err_by_rank=[o["holds"] for o in loops],
         dropout_offsets_by_rank=[o["dropout"]["offsets"] for o in loops],
         local_shape=loops[0]["local_shape"],
         timing_local_shape_dropout=loops[0]["timing"],
         save_block_s_by_rank=[o["save_block_s"] for o in outs],
         commit_s=outs[0]["commit_s"], tag_bytes=outs[0]["tag_bytes"],
         bitflip_rank=next(r for r, o in enumerate(loops) if o["flips"]),
         bitflip_detected_at=4, rewound_to_tag=2,
         divergent_replicas=loops[0]["divergent_replicas"],
         loop_s_by_rank=[o["seconds"] for o in loops],
         part_d_wait_s_rank0=loops[0]["part_d_wait_s"],
         rank_done_s=[o["done_s"] for o in outs])
    TP_RESULTS["train_tp_loop"] = dict(launches=launches, outs=loops)
    return launches


def wait_for_file(path, timeout=900):
    """Block until ``path`` exists (another process or thread leaves it)."""
    deadline = time.perf_counter() + timeout
    while not os.path.exists(path):
        if time.perf_counter() > deadline:
            raise AssertionError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)


def merged_tag_side(path, go, done, batches, layers, stop, out):
    """Phase 55's part D, on a thread of this process while the ranks run
    B, the loop and part C: once the file ``go`` exists (left by rank 0
    after part A), ``scripts/reshard_checkpoint.py`` merges tag 2 of
    ``path`` on the card into ``path + "_merged"`` (timed), and the port's
    tp=1 step resumes from the merged tag and trains step 3 on
    ``batches[2]``. Puts the resumed step, its loss and the seconds into
    ``out`` (or the traceback under ``"error"``), removes the merged tag
    and leaves the file ``done`` in any case; ``stop`` (set when the world
    failed) ends the wait for ``go``."""
    import traceback

    from neuronx_distributed_tpu_torch import trainer
    from neuronx_distributed_tpu_torch.config import (
        neuronx_distributed_config)
    from neuronx_distributed_tpu_torch.scripts import reshard_checkpoint
    from neuronx_distributed_tpu_torch.trainer import Trainer

    merged = path + "_merged"
    try:
        while not os.path.exists(go):
            if stop.wait(0.2):
                return
        t0 = time.perf_counter()
        reshard_checkpoint.main(["--input", path, "--tag", "2", "--output",
                                 merged])
        out["reshard_s"] = time.perf_counter() - t0
        cfg = dataclasses.replace(loop_cfg(layers), dtype=torch.float32)
        pm, params = trainer.initialize_parallel_model(
            neuronx_distributed_config(), cfg, seed=3, std=0.02,
            device="cuda")
        tx, state = trainer.initialize_parallel_optimizer(pm, params, 1e-4)
        clock = StepClock()
        one = Trainer(trainer.make_train_step(pm, tx), state,
                      callbacks=[clock], resume_path=merged)
        out["start"] = one.host_step
        one.fit(iter(batches[2:3]), max_steps=3)
        out["loss"] = clock.losses[0]
        out["seconds"] = time.perf_counter() - t0
        del pm, params, tx, state, one
        free_cuda()
    except BaseException:  # raised by the phase's check, after the world
        out["error"] = traceback.format_exc()
    finally:
        shutil.rmtree(merged, ignore_errors=True)
        open(done, "w").close()


def check_train_tp_loop_cross(smi, outs, merged, layers, seq):
    """``train_tp_loop_cross_check``: B (the same layout, resumed from tag
    2) equals A's steps 3-4 bit for bit, losses and every leaf's
    fingerprint; C (tp=4 x dp=1) holds A's losses within 1e-5 and each
    parameter's update over steps 3-4 within 1e-3 of its norm (checked on
    rank 0); then ``reshard_checkpoint`` merges tag 2 on the card and the
    port's tp=1 step, resumed from the merged tag, gives step 3's loss
    within 1e-4 (``merged``: :func:`merged_tag_side`'s results)."""
    ref = outs[0]
    for r, o in enumerate(outs):
        if o["b_start"] != 2 or o["c_start"] != 2:
            raise AssertionError(f"train_tp_loop_cross_check: rank {r} "
                                 f"resumed at {o['b_start']}, "
                                 f"{o['c_start']}")
        for s in (3, 4):
            if o["b_losses"][s] != o["a_losses"][s] or not torch.equal(
                    o["b_fps"][s], o["a_fps"][s]):
                raise AssertionError(f"train_tp_loop_cross_check: rank {r} "
                                     f"step {s} resumed at the same layout "
                                     "is not bit for bit")
            if not abs(o["c_losses"][s] - ref["a_losses"][s]) <= 1e-5 * abs(
                    ref["a_losses"][s]):
                raise AssertionError(f"train_tp_loop_cross_check: step {s} "
                                     f"at tp=4 {o['c_losses'][s]} vs "
                                     f"{ref['a_losses'][s]}")
    worst, worst_name = ref["update_rel_diff"]
    if "error" in merged:
        raise AssertionError(f"train_tp_loop_cross_check: part D failed:\n"
                             f"{merged['error']}")
    tp1, start = merged["loss"], merged["start"]
    if start != 2 or not abs(tp1 - ref["a_losses"][3]) <= 1e-4 * abs(
            ref["a_losses"][3]):
        raise AssertionError(f"train_tp_loop_cross_check: the tp=1 step "
                             f"from the merged tag (at {start}) gave "
                             f"{tp1}, want {ref['a_losses'][3]}")
    emit("train_tp_loop_cross_check", card=smi, layers=layers,
         tie_embeddings=True, seq=seq,
         losses=[ref["a_losses"][s] for s in (1, 2, 3, 4)],
         resumed_same_layout_bitwise=True,
         losses_tp4=[ref["c_losses"][s] for s in (3, 4)],
         max_update_rel_diff_tp4=worst,
         max_update_rel_diff_param_tp4=worst_name,
         loss_tp1_from_merged=tp1, reshard_s=merged["reshard_s"],
         part_d_s=merged["seconds"],
         part_s_by_rank=[dict(a=o["a_s"], c=o["c_s"]) for o in outs],
         rank_done_s=[o["done_s"] for o in outs])


def check_train_mixtral_tp(smi, outs, steps, seq, layers):
    """``train_mixtral_tp``: every rank's losses finite and equal, K2-K5,
    K7 and K8 each launched layers x steps times, the first launch of
    each held to its plain version within 2e-2 (K2-K4) and 1e-2 (K5, K7,
    K8, bf16)."""
    for r, o in enumerate(outs):
        for key in ("losses", "grad_norms"):
            if not (np.isfinite(o[key]).all()
                    and np.allclose(o[key], outs[0][key], rtol=1e-6,
                                    atol=0)):
                raise AssertionError(f"train_mixtral_tp: rank {r} {key} "
                                     f"{o[key]} vs {outs[0][key]}")
        for name, n in o["launches"].items():
            if n != layers * steps:
                raise AssertionError(f"train_mixtral_tp: rank {r} launched "
                                     f"{name} {n} times, want "
                                     f"{layers * steps}")
        for name, err in o["holds"].items():
            tol = 1e-2 if name.startswith("grouped") else 2e-2
            if not err <= tol:
                raise AssertionError(f"train_mixtral_tp: rank {r} {name} "
                                     f"differs from plain by {err}")
    launches = {name: sum(o["launches"][name] for o in outs)
                for name in outs[0]["launches"]}
    emit("train_mixtral_tp", card=smi, layers=layers, seq=seq, steps=steps,
         world=TP_WORLD, tp=TP_WORLD, dp=1, compute_dtype="bfloat16",
         moe_dispatch="blockwise", moe_block_size=64,
         losses=outs[0]["losses"], grad_norms=outs[0]["grad_norms"],
         step_ms_by_rank=[o["step_ms"] for o in outs],
         peak_gib_by_rank=[o["peak_gib"] for o in outs],
         load_peak_gib_by_rank=[o["load_peak_gib"] for o in outs],
         launches_by_rank=[o["launches"] for o in outs],
         held_err_by_rank=[o["holds"] for o in outs],
         local_shape=outs[0]["local_shape"],
         timing_local_shape=outs[0]["timing"],
         rank_init_s=[o["init_s"] for o in outs],
         rank_run_s=[o["run_s"] for o in outs],
         rank_done_s=[o["done_s"] for o in outs])
    TP_RESULTS["train_mixtral_tp"] = dict(launches=launches, outs=outs)
    return launches


def check_train_mixtral_tp_cross(smi, outs, layers, seq, steps):
    """``train_mixtral_tp_cross_check``: the tp=4 Mixtral step against the
    port's tp=1 Mixtral step on the card (run on rank 0 first) under
    ``train_tp_cross_check``'s limits: losses 1e-4 relative, grad norms
    1e-3, each parameter's update within 1e-3 of its norm (on rank 0)."""
    for r, o in enumerate(outs):
        for i, ((lw, nw), (lc, nc)) in enumerate(zip(o["metrics"],
                                                     o["reference"])):
            if not abs(lw - lc) <= 1e-4 * abs(lc):
                raise AssertionError(f"train_mixtral_tp_cross_check: rank "
                                     f"{r} step {i + 1} loss {lw} vs {lc}")
            if not abs(nw - nc) <= 1e-3 * abs(nc):
                raise AssertionError(f"train_mixtral_tp_cross_check: rank "
                                     f"{r} step {i + 1} norm {nw} vs {nc}")
    worst, worst_name = outs[0]["update_rel_diff"]
    emit("train_mixtral_tp_cross_check", card=smi, layers=layers, seq=seq,
         steps=steps, loss_tp4=[m[0] for m in outs[0]["metrics"]],
         loss_tp1=[m[0] for m in outs[0]["reference"]],
         grad_norm_tp4=[m[1] for m in outs[0]["metrics"]],
         grad_norm_tp1=[m[1] for m in outs[0]["reference"]],
         max_update_rel_diff=worst, max_update_rel_diff_param=worst_name,
         tp1_s=outs[0]["tp1_s"], rank_done_s=[o["done_s"] for o in outs])


def check_train_mixtral_ep(smi, outs, steps, seq, layers):
    """``train_mixtral_ep``: every rank's losses finite and equal, its
    bank ``[E/ep, H, 2, I/tp]``, K2-K5, K7 and K8 each launched layers x
    steps times, the first launch of each held to its plain version within
    2e-2 (K2-K4) and 1e-2 (K5, K7, K8, bf16), the sentinel blocks seen
    and exact (:func:`glu_holds`), nothing staged through the host."""
    from neuronx_distributed_tpu_torch.models.mixtral import MIXTRAL_8X7B

    for r, o in enumerate(outs):
        for key in ("losses", "grad_norms"):
            if not (np.isfinite(o[key]).all()
                    and np.allclose(o[key], outs[0][key], rtol=1e-6,
                                    atol=0)):
                raise AssertionError(f"train_mixtral_ep: rank {r} {key} "
                                     f"{o[key]} vs {outs[0][key]}")
        want = (MIXTRAL_8X7B.num_experts // EP_SIZE,
                MIXTRAL_8X7B.intermediate_size // TP_SIZE)
        if (o["local_bank"][0], o["local_bank"][-1]) != want:
            raise AssertionError(f"train_mixtral_ep: rank {r} bank "
                                 f"{o['local_bank']}")
        for name, n in o["launches"].items():
            if n != layers * steps:
                raise AssertionError(f"train_mixtral_ep: rank {r} launched "
                                     f"{name} {n} times, want "
                                     f"{layers * steps}")
        for name, err in o["holds"].items():
            tol = 1e-2 if name.startswith("grouped") else 2e-2
            if not err <= tol:
                raise AssertionError(f"train_mixtral_ep: rank {r} {name} "
                                     f"differs from plain by {err}")
        if any(o["host_staged_bytes"].values()):
            raise AssertionError(f"train_mixtral_ep: rank {r} staged "
                                 f"{o['host_staged_bytes']}")
    launches = {name: sum(o["launches"][name] for o in outs)
                for name in outs[0]["launches"]}
    emit("train_mixtral_ep", card=smi, layers=layers, seq=seq, steps=steps,
         world=TP_WORLD, tp=TP_SIZE, dp=TP_WORLD // TP_SIZE, ep=EP_SIZE,
         dp_exp=TP_WORLD // TP_SIZE // EP_SIZE, zero1=True,
         compute_dtype="bfloat16", moe_dispatch="blockwise",
         moe_block_size=64, ep_wire_dtype="fp32", ep_overlap=False,
         losses=outs[0]["losses"], grad_norms=outs[0]["grad_norms"],
         step_ms_by_rank=[o["step_ms"] for o in outs],
         peak_gib_by_rank=[o["peak_gib"] for o in outs],
         load_peak_gib_by_rank=[o["load_peak_gib"] for o in outs],
         launches_by_rank=[o["launches"] for o in outs],
         held_err_by_rank=[o["holds"] for o in outs],
         sentinel_by_rank=[o["sentinel"] for o in outs],
         local_bank=outs[0]["local_bank"], local_shape=outs[0]["local_shape"],
         timing_local_shape=outs[0]["timing"],
         gloo_bytes_by_rank=[o["collective_bytes"] for o in outs],
         gloo_bytes_total=sum(sum(o["collective_bytes"].values())
                              for o in outs),
         host_staged_bytes_total=sum(sum(o["host_staged_bytes"].values())
                                     for o in outs),
         rank_init_s=[o["init_s"] for o in outs],
         rank_run_s=[o["run_s"] for o in outs],
         rank_holds_s=[o["holds_s"] for o in outs],
         timing_s_rank0=outs[0]["timing_s"],
         rank_done_s=[o["done_s"] for o in outs])
    TP_RESULTS["train_mixtral_ep"] = dict(launches=launches, outs=outs)
    return launches


def check_train_mixtral_ep_cross(smi, outs, layers, seq, steps):
    """``train_mixtral_ep_cross_check``: the ep=2 step against the ep=1
    step at the same tp=2 x dp=2 layout, from the same weights and batch:
    the first loss within 1e-6 relative, later losses 1e-4, grad norms
    1e-3, each parameter's update within 1e-3 of its norm (checked on the
    ranks); the per-chunk dispatch on layer 0's inputs
    (:func:`ep_chunk_checks`, on every rank)."""
    for r, o in enumerate(outs):
        for i, ((le, ne), (l1, n1)) in enumerate(zip(o["metrics"],
                                                     o["reference"])):
            tol = 1e-6 if i == 0 else 1e-4
            if not abs(le - l1) <= tol * abs(l1):
                raise AssertionError(f"train_mixtral_ep_cross_check: rank "
                                     f"{r} step {i + 1} loss {le} vs {l1}")
            if not abs(ne - n1) <= 1e-3 * abs(n1):
                raise AssertionError(f"train_mixtral_ep_cross_check: rank "
                                     f"{r} step {i + 1} norm {ne} vs {n1}")
        if not o["update_rel_diff"][0] <= 1e-3:
            raise AssertionError(f"train_mixtral_ep_cross_check: rank {r} "
                                 f"update {o['update_rel_diff']}")
    emit("train_mixtral_ep_cross_check", card=smi, layers=layers, seq=seq,
         steps=steps, tp=TP_SIZE, dp=TP_WORLD // TP_SIZE, ep=EP_SIZE,
         loss_ep2=[m[0] for m in outs[0]["metrics"]],
         loss_ep1=[m[0] for m in outs[0]["reference"]],
         grad_norm_ep2=[m[1] for m in outs[0]["metrics"]],
         grad_norm_ep1=[m[1] for m in outs[0]["reference"]],
         max_update_rel_diff=max(o["update_rel_diff"][0] for o in outs),
         max_update_rel_diff_param=max(
             (o["update_rel_diff"] for o in outs))[1],
         per_chunk_by_rank=[o["per_chunk"] for o in outs],
         gloo_bytes_ep1_by_rank=[o["gloo_bytes_ep1"] for o in outs],
         gloo_bytes_ep2_by_rank=[o["gloo_bytes_ep2"] for o in outs],
         ep1_s=outs[0]["ep1_s"], rank_run_s=[o["run_s"] for o in outs],
         rank_done_s=[o["done_s"] for o in outs])


TP_RESULTS = {}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    from neuronx_distributed_tpu_torch.models.llama import LLAMA3_8B
    from neuronx_distributed_tpu_torch.models.mixtral import MIXTRAL_8X7B
    from neuronx_distributed_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         kernels=sorted(libs))
    cpu_side = CpuSide(cpu_side_jobs(LLAMA3_8B, MIXTRAL_8X7B))
    emit("cpu_side", threads=cpu_side.threads, main_threads=cpu_side.full)
    try:
        run_phases(smi, kind, cpu_side)
    finally:
        cpu_side.close()


def run_phases(smi, kind, cpu_side):
    """Every phase after the build, then the kernels' summary and the
    result line; the cross checks' CPU halves from ``cpu_side``."""
    from neuronx_distributed_tpu_torch.inference.engine import EngineConfig
    from neuronx_distributed_tpu_torch.models.llama import LLAMA3_8B
    from neuronx_distributed_tpu_torch.models.mixtral import (DBRX,
                                                              MIXTRAL_8X7B)

    cases = phase_kernel_vs_plain()

    ecfg = EngineConfig(block_size=16, num_blocks=2048, max_slots=8,
                        max_blocks_per_seq=128, token_budget=512)
    # the room for phases 58-61 under the call's limit: the serving
    # phases run Llama-3-8B's widths at 16 layers (phases 4 and 40, whose
    # ids are held to each other's, and the replica router's elastic
    # drill), at 8 or at 4 (a layer's work is the same at any depth)
    half = dataclasses.replace(LLAMA3_8B, num_layers=16)
    quarter = dataclasses.replace(LLAMA3_8B, num_layers=8)
    eighth = dataclasses.replace(LLAMA3_8B, num_layers=4)
    launches = serve(half, ecfg, "serve")["paged_attention"]
    serve(dataclasses.replace(LLAMA3_8B, num_layers=4),
          dataclasses.replace(ecfg, quantized=True), "serve_int8")
    graph_k1 = phase_serve_graph(half, ecfg)
    phase_cross_check(LLAMA3_8B)
    moe_cases = phase_moe_vs_plain()
    mixtral = dataclasses.replace(MIXTRAL_8X7B, num_layers=4,
                                  moe_dispatch="blockwise", moe_block_size=64)
    moe_launches = {
        "grouped_glu": serve(mixtral, ecfg, "serve_mixtral")["grouped_glu"],
        "grouped_glu_decode": serve(
            mixtral, dataclasses.replace(ecfg, disaggregated=True,
                                         max_slots=4, prefill_budget=512),
            "serve_mixtral_disagg")["grouped_glu_decode"]}
    graph_moe = phase_serve_graph_mixtral(mixtral, ecfg)
    phase_mixtral_cross_check(MIXTRAL_8X7B)
    tier_launches = phase_serve_quant_tiers(eighth, ecfg)
    phase_quant_cross_check(cpu_side)
    dbrx = dataclasses.replace(DBRX, num_layers=8, moe_dispatch="blockwise",
                               moe_block_size=64)
    dbrx_launches = serve(dbrx, ecfg, "serve_dbrx")
    dbrx_disagg_launches = serve(
        dbrx, dataclasses.replace(ecfg, disaggregated=True, max_slots=4,
                                  prefill_budget=512), "serve_dbrx_disagg")
    phase_moe_variants_cross_check(cpu_side)
    # after the CPU halves' first six results are taken, which frees the
    # thread's queue sooner
    int8_launches = serve(dataclasses.replace(
        MIXTRAL_8X7B, num_layers=16, weight_quant="int8"), ecfg,
        "serve_mixtral_int8", probe=expert_step_probe)["paged_attention"]
    bwd_cases = phase_moe_bwd_vs_plain()
    flash_cases = phase_flash_vs_plain()
    flash_launches = phase_train()
    train_launches = phase_train(mixtral=True)
    remat_launches = phase_train(mixtral=True, remat=True)
    phase_mixtral_remat_bitwise()
    phase_generate(quarter)
    phase_generate_cross_check(LLAMA3_8B)
    gen_moe_launches = phase_generate_mixtral(mixtral)
    prefix_launches = phase_serve_prefix(quarter, ecfg)
    phase_prefix_cross_check(LLAMA3_8B)
    # the train cross checks come after the serving phases above, which
    # gives the thread's CPU halves (the longest of its jobs) time to be
    # ready
    phase_train_cross_check(LLAMA3_8B, cpu_side)
    phase_train_cross_check(MIXTRAL_8X7B, cpu_side, layers=1,
                            phase="mixtral_train_cross_check",
                            moe_dispatch="blockwise", moe_block_size=64)
    spec_launches, spec_held = phase_serve_spec(eighth, ecfg)
    phase_spec_cross_check(LLAMA3_8B, cpu_side)
    spec_moe_launches = phase_serve_mixtral_spec(mixtral, ecfg)
    # the benchmark's process runs beside migrate and the bundle's phase
    benchmark = start_benchmark()
    try:
        migrate_launches = phase_migrate(quarter, ecfg)
        bundle_launches = phase_bundle(
            LLAMA3_8B, meanwhile=lambda: finish_benchmark(benchmark))
    finally:
        stop_process(benchmark)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_trainer_", dir=build)
    try:
        loop_launches = phase_train_loop(workdir)
        integrity_launches = phase_train_integrity(workdir)
        phase_train_resume(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    phase_train_loop_cross_check(LLAMA3_8B, cpu_side)
    family_flash = phase_flash_families()
    family_launches = phase_train_families()
    vit_captures = phase_vit_serve()
    phase_families_cross_check()
    # the world of phases 52-63 starts its processes beside the LoRA
    # phases (its ranks wait for their turn, the card left to the phases)
    tp_started = start_train_tp()
    try:
        workdir = tempfile.mkdtemp(prefix="chip_smoke_lora_", dir=build)
        try:
            adapters, lora_launches = phase_lora_train(workdir)
            lora_k1, lora_replays = phase_lora_serve(adapters, ecfg)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        phase_lora_cross_check(cpu_side)
        # the router phases run on the host's clock (replica health) and
        # with the router module's own classes: the thread, whose
        # router_cross_check half (its last job) swaps them under its tap,
        # is idle before they start, and so is the world's start; they
        # come last, so that the thread's jobs never hold them up
        cpu_side.wait_idle()
        tp_started["world"].wait_ready()
        router_launches = phase_router(quarter, ecfg)
        fabric_launches = phase_fabric(eighth, ecfg)
        elastic_launches, elastic_replayed = phase_router_elastic(half,
                                                                  ecfg)
        phase_router_cross_check(LLAMA3_8B, cpu_side)
    except BaseException:
        abort_train_tp(tp_started)
        raise
    tp_launches = phase_train_tp(smi, tp_started)

    main_case = next(c for c in cases if c["case"] == "bf16")
    summary = [{
        "name": "paged_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max([c["max_err"] for c in cases] + [
            h["max_abs_err"] for run in spec_held.values()
            for h in run.values()]),
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "kernel_ms": main_case["kernel_ms"],
        "max_err": max(c["max_err"] for c in cases),
        "design": K1_DESIGN["tensor_cores"] + "; other types: "
                  + K1_DESIGN["cuda_cores"],
        "cases_ms": {c["case"]: c["kernel_ms"] for c in cases
                     if "kernel_ms" in c},
        "spec_cases": {f"{run}/{worker}": {
            key: h[key] for key in ("tokens", "head_dim", "kernel_ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "max_abs_err")}
            for run, workers in spec_held.items()
            for worker, h in workers.items()},
        "path_launches": {"serve": launches,
                          "serve_spec": spec_launches,
                          "serve_mixtral_spec":
                              spec_moe_launches["paged_attention"],
                          "migrate": migrate_launches,
                          "router": router_launches,
                          "fabric": fabric_launches,
                          "router_elastic": elastic_launches,
                          "serve_prefix": prefix_launches,
                          "serve_mixtral_int8": int8_launches,
                          "serve_quant_tiers": tier_launches,
                          "serve_dbrx": dbrx_launches["paged_attention"],
                          "serve_dbrx_disagg":
                              dbrx_disagg_launches["paged_attention"],
                          "serve_graph": graph_k1[0],
                          "lora_serve": lora_k1,
                          "serve_graph_mixtral":
                              graph_moe["paged_attention"]["launches"],
                          "bundle": bundle_launches},
        # captured paths: a replay adds to no launch count. The graph
        # replays of the workers that run the kernel, counted by each
        # AotWorker, and the kernel's runs in a traced window of replays
        # against layers x the replays in it
        "path_worker_replays": {
            "serve_graph": graph_k1[1],
            "serve_graph_mixtral":
                graph_moe["paged_attention"]["worker_replays"],
            "router_elastic": elastic_replayed,
            "lora_serve": lora_replays},
        "path_traced_runs": {
            "serve_graph": graph_k1[2]["paged_attention"],
            **{f"serve_graph_mixtral/{label}": v for label, v in
               graph_moe["paged_attention"]["traced"].items()}}}]
    flash_main = next(c for c in flash_cases if c["case"] == "bf16")
    outputs = {"flash_fwd": ("out", "lse"), "flash_bwd_dq": ("dq",),
               "flash_bwd_dkv": ("dk", "dv")}
    for name, replaces in FLASH_KERNELS:
        t = flash_main["timing"][name]
        err = max([c["max_abs_err"][o] for c in flash_cases
                   for o in outputs[name]]
                  + [c["max_abs_err"][o] for c in family_flash
                     for o in outputs[name] if o != "lse"])
        family_paths = {f"train_{f}": n[name]
                        for f, n in family_launches.items()}
        tp_outs = TP_RESULTS["train_tp"]["outs"]
        loop_outs = TP_RESULTS["train_tp_loop"]["outs"]
        tp_local = tp_outs[0]["timing"][name]
        if name == "flash_fwd":
            family_paths["vit_serve"] = vit_captures
        summary.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": replaces, "launches": flash_launches[name],
            "max_abs_err": err, "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "kernel_ms": t["kernel_ms"], "max_err": err,
            "design": f"bf16: {FLASH_DESIGN[torch.bfloat16]}; fp32: "
                      f"{FLASH_DESIGN[torch.float32]}",
            "path_launches": {"train": flash_launches[name],
                              "train_loop": loop_launches[name],
                              "train_mixtral_remat": remat_launches[name],
                              "train_integrity": integrity_launches[name],
                              "lora_train": lora_launches[name],
                              "train_tp": tp_launches["train_tp"][name],
                              "train_tp_loop":
                                  tp_launches["train_tp_loop"][name],
                              "train_mixtral_tp":
                                  tp_launches["train_mixtral_tp"][name],
                              "train_mixtral_ep":
                                  tp_launches["train_mixtral_ep"][name],
                              "train_pp": tp_launches["train_pp"][name],
                              "train_mixtral_pp":
                                  tp_launches["train_mixtral_pp"][name],
                              **family_paths},
            "train_pp_by_rank": [o["launches"][name]
                                 for o in TP_RESULTS["train_pp"]["outs"]],
            "train_pp_max_rel_err": max(
                o["holds"][name] for o in TP_RESULTS["train_pp"]["outs"]),
            "train_tp_loop_local_case_dropout": {
                "shape": loop_outs[0]["local_shape"],
                "dropout_offsets_rank0": loop_outs[0]["dropout"][
                    "offsets"],
                **{key: loop_outs[0]["timing"][name][key] for key in (
                    "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by")}},
            "train_tp_by_rank": [o["launches"][name] for o in tp_outs],
            "train_tp_max_rel_err": max(o["holds"][name] for o in tp_outs),
            "train_tp_local_case": {
                "shape": tp_outs[0]["local_shape"],
                **{key: tp_local[key] for key in (
                    "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by")}},
            "family_cases": {c["case"]: {
                key: c["timing"][name][key] for key in (
                    "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by")} for c in family_flash}})
    for name, replaces in MOE_KERNELS:
        main_case = next(c for c in moe_cases
                         if c["kernel"] == name and c["case"].endswith("bf16"))
        err = max(c["max_abs_err"] for c in moe_cases if c["kernel"] == name)
        summary.append({
            "name": name, "route": "cuda", "source": MOE_SOURCE,
            "replaces": replaces, "launches": moe_launches[name],
            "max_abs_err": err, "ms": main_case["kernel_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "kernel_ms": main_case["kernel_ms"], "max_err": err,
            "design": main_case["design"],
            "cases_ms": {c["case"]: c["kernel_ms"] for c in moe_cases
                         if c["kernel"] == name},
            "path_launches": {
                "serve_mixtral_disagg" if name.endswith("decode")
                else "serve_mixtral": moe_launches[name],
                "serve_dbrx_disagg" if name.endswith("decode")
                else "serve_dbrx": (dbrx_disagg_launches
                                    if name.endswith("decode")
                                    else dbrx_launches)[name],
                "generate_mixtral": gen_moe_launches[name],
                "serve_mixtral_spec": spec_moe_launches[name],
                "train_mixtral": train_launches[name],
                "train_mixtral_remat": remat_launches[name],
                "serve_graph_mixtral": graph_moe[name]["launches"],
                **({"train_mixtral_tp": tp_launches["train_mixtral_tp"][
                    name], "train_mixtral_ep": tp_launches[
                        "train_mixtral_ep"][name], "train_mixtral_pp":
                    tp_launches["train_mixtral_pp"][name]}
                   if name == "grouped_glu" else {})},
            **({"train_mixtral_tp_local_case": moe_tp_case(name),
                "train_mixtral_ep_local_case": moe_tp_case(
                    name, "train_mixtral_ep"),
                "train_mixtral_pp_local_case": moe_tp_case(
                    name, "train_mixtral_pp")}
               if name == "grouped_glu" else {}),
            "path_worker_replays": {
                "serve_graph_mixtral": graph_moe[name]["worker_replays"]},
            "path_traced_runs": {
                f"serve_graph_mixtral/{label}": v for label, v in
                graph_moe[name]["traced"].items()}})
    bwd_main = next(c for c in bwd_cases if c["case"] == "bf16")
    for name, replaces in MOE_BWD_KERNELS:
        t = bwd_main["timing"][name]
        err = max(v for c in bwd_cases for k, v in c["max_abs_err"].items()
                  if k.startswith(f"{name}."))
        summary.append({
            "name": name, "route": "cuda", "source": MOE_SOURCE,
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": err, "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "kernel_ms": t["kernel_ms"], "max_err": err,
            "design": bwd_main["design"],
            "path_launches": {"train_mixtral": train_launches[name],
                              "train_mixtral_remat": remat_launches[name],
                              "train_mixtral_tp":
                                  tp_launches["train_mixtral_tp"][name],
                              "train_mixtral_ep":
                                  tp_launches["train_mixtral_ep"][name],
                              "train_mixtral_pp":
                                  tp_launches["train_mixtral_pp"][name]},
            "train_mixtral_tp_local_case": moe_tp_case(name),
            "train_mixtral_ep_local_case": moe_tp_case(name,
                                                       "train_mixtral_ep"),
            "train_mixtral_pp_local_case": moe_tp_case(name,
                                                       "train_mixtral_pp")})
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def moe_tp_case(name, phase="train_mixtral_tp"):
    """The grouped-GLU entry ``name`` timed at ``phase``'s local width by
    rank 0 (``train_mixtral_tp``: I/tp at tp=4; ``train_mixtral_pp``: at
    tp=2; ``train_mixtral_ep``: E/ep = 4 experts and the sentinel's blocks
    at tp=2), with its launches by rank and its first launch's error
    against plain on every rank."""
    outs = TP_RESULTS[phase]["outs"]
    t = outs[0]["timing"][name]
    return dict(shape=outs[0]["local_shape"],
                launches_by_rank=[o["launches"][name] for o in outs],
                max_rel_err=max(o["holds"][name] for o in outs),
                **{key: t[key] for key in ("kernel_ms", "plain_ms",
                                           "library_ms", "bound_ms",
                                           "bound_by")})


def run_only(names) -> None:
    """``--only a,b``: the device line, the build and the named phases of
    the speculation, migration, router, captured-serving, model-family,
    LoRA and tensor-parallel groups alone (``lora`` is phases 49 and 50
    together, any of the tensor-parallel names but the expert-parallel
    ones phases 52-63 in one world, ``train_mixtral_ep`` or
    ``train_mixtral_ep_cross_check`` phases 62 and 63 in a world of their
    own), for a short run while such a phase is worked on; no summary and
    no result line."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from neuronx_distributed_tpu_torch.inference.engine import EngineConfig
    from neuronx_distributed_tpu_torch.models.llama import LLAMA3_8B
    from neuronx_distributed_tpu_torch.models.mixtral import MIXTRAL_8X7B
    from neuronx_distributed_tpu_torch.ops import _build

    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    emit("build", seconds=time.perf_counter() - t0,
         kernels=sorted(_build.build()))
    ecfg = EngineConfig(block_size=16, num_blocks=2048, max_slots=8,
                        max_blocks_per_seq=128, token_budget=512)
    mixtral = dataclasses.replace(MIXTRAL_8X7B, num_layers=4,
                                  moe_dispatch="blockwise", moe_block_size=64)
    half = dataclasses.replace(LLAMA3_8B, num_layers=16)
    quarter = dataclasses.replace(LLAMA3_8B, num_layers=8)
    eighth = dataclasses.replace(LLAMA3_8B, num_layers=4)
    phases = {"serve_spec": lambda: phase_serve_spec(eighth, ecfg),
              "spec_cross_check": lambda: phase_spec_cross_check(LLAMA3_8B),
              "serve_mixtral_spec":
                  lambda: phase_serve_mixtral_spec(mixtral, ecfg),
              "migrate": lambda: phase_migrate(quarter, ecfg),
              "router": lambda: phase_router(quarter, ecfg),
              "fabric": lambda: phase_fabric(eighth, ecfg),
              "router_elastic": lambda: phase_router_elastic(half, ecfg),
              "serve_graph": lambda: phase_serve_graph(half, ecfg),
              "serve_graph_mixtral":
                  lambda: phase_serve_graph_mixtral(mixtral, ecfg),
              "bundle": lambda: phase_bundle(LLAMA3_8B),
              "benchmark": phase_benchmark,
              "router_cross_check":
                  lambda: phase_router_cross_check(LLAMA3_8B),
              "flash_families": phase_flash_families,
              "train_families": phase_train_families,
              "vit_serve": phase_vit_serve,
              "families_cross_check": phase_families_cross_check,
              "lora": lambda: run_lora(ecfg),
              "lora_cross_check": lambda: phase_lora_cross_check(None),
              "train_tp": lambda: phase_train_tp(smi),
              "train_mixtral_ep": lambda: phase_train_ep(smi)}
    # one world of ranks runs every tensor-parallel phase
    phases["train_mixtral_ep_cross_check"] = phases["train_mixtral_ep"]
    for name in ("train_tp_cross_check", "train_tp_loop",
                 "train_tp_loop_cross_check", "train_mixtral_tp",
                 "train_mixtral_tp_cross_check", "train_pp",
                 "train_pp_cross_check", "train_mixtral_pp",
                 "train_pp_resume"):
        phases[name] = phases["train_tp"]
    done = []
    for name in names:
        if phases[name] not in done:
            phases[name]()
            done.append(phases[name])


def run_lora(ecfg):
    """``--only lora``: phases 49 and 50 in a temporary directory under
    ``build/``, removed at the end."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_lora_", dir=build)
    try:
        adapters, _ = phase_lora_train(workdir)
        phase_lora_serve(adapters, ecfg)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--only":
        run_only(sys.argv[2].split(","))
    else:
        main()

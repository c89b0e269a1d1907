"""On-card smoke check of the PyTorch/CUDA port (``torchkafka_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: every CUDA kernel built from ``torchkafka_tpu_torch/csrc/`` with
   nvcc for sm_90a (one nvcc per source, started together);
3. flash_fwd: the flash-attention forward (K1) against its plain PyTorch
   version, each case through the kernel that ``_route`` picks (its
   route printed): at the 1b prefill and training shapes in bf16 (the
   tensor-core kernel), at the 1b prefill shape in f32 (the CUDA-core kernel), the 8b prefill shape (32 q / 8
   kv heads), a ragged S, k_offsets with fully masked rows (o = 0, lse <
   -1e29, no NaN), and bf16 at D=64/16, rep 1 and 4, S=17, S=200,
   non-causal and a q_offset; D=40 and D=160 take the CUDA cores in bf16;
   the warm-resume prefill's shape (B=1, S=143). Two launches bitwise
   equal; the tensor-core kernel's registers and spill bytes (0
   required); timings (CUDA events, median of 25, L2 flushed before each
   timed launch) and TFLOP/s at the 1b prefill and training shapes and at
   B=1, S = 128 + g - 1 for the resume lengths ``RESUME_S``, beside the
   CUDA-core kernel on the same bf16 inputs, the plain version and SDPA's
   forward;
4. flash_bwd: the backward kernels, dQ (K2) and dK/dV (K3), against their
   plain versions at the 1b training shape (B=8, S=512, 16 q / 8 kv heads,
   D=128, bf16: the tensor-core kernels), in f32 (the CUDA-core kernels),
   and in bf16 at the 8b heads, D=64/32/16, non-causal, S=17, a ragged
   S=200 and a k_offset with fully masked rows (dq = 0 there, no NaN
   anywhere); D=160 and D=256 in bf16 and f32 through the CUDA-core
   kernels; K3 bitwise equal across two launches; each tensor-core
   kernel's registers and spill bytes (0 required); timings and TFLOP/s,
   beside the CUDA-core kernels on the same bf16 inputs, with SDPA's
   backward as the pair's yardstick;
5. kvattn_dynlen: the split-K int8 decode kernel (K4) against its plain
   version at the 1b decode shape with pools of 192 and 2048 positions, at
   the serving watermarks and at span and tile edges (0, L-1, L, L+1, ...;
   where the planner keeps one span, also under forced spans of 64, so the
   merge runs at the serving pool), and at rep 1, 4 (the 8b decode shape)
   and 8 on the 192 pool; each case's span L and n_split; the kernels' int8
   conversion exact for all 256 values; where the read splits, two
   launches bitwise equal, and launches on two streams (each with its own
   merge counter buffer) bitwise equal to them; registers and spill bytes
   at rep 2 and 8 (0 required); timings at the planner's split, forced to
   one span and to spans of 64, 128 and 256, beside the plain version and
   the bound, and what the same events give a one-element add (the launch
   in every event time);
5b. kvattn_paged: the split-K block-table int8 decode kernel (K5) the same
   way at block size 16, logical views of 192 and 2048 positions (shared
   prefix blocks, sink entries, unreferenced garbage blocks), and at block
   sizes 16, 32 and 64 with table entries outside [0, NB) past the live
   range; K4's time on the same fills laid out dense;
5c. qmatmul: the int8 weight matmul (K6) against its plain version on
   int8 weights drawn by the zoo at the 8b shapes (w_gate, w_down, lm_head)
   with 16 decode rows, w_gate and w_down with 2048 prefill rows, and w_gate
   with 8, 24, 64 and 200 rows, in bf16 (the tensor-core kernel) and, on
   w_gate's 16 rows, f32 (the CUDA-core kernel); each case's route and plan
   (BM, BN, BK, K splits); tc_launches == the bf16 calls; where K splits,
   two launches and two streams bitwise equal; the int8 -> bf16 conversion
   exact for all 256 values; registers and spill bytes (0 required);
   timings of the tensor-core kernel beside the CUDA-core kernel on the
   same bf16 inputs, forced K splits, the plain version and the library's int8
   matmul, with the bound, TFLOP/s and GB/s (and, for information only,
   a dense bf16 matmul on a weight dequantised beforehand);
5d. kvattn_full: the full-pool masked int8 reads, K-major (K7) and M-major
   (K8), on the split-K body in its mask mode, at the 8b decode shape
   (B=16, K=8, rep=4, Dh=128) with pools of 192 and 2048, at the planner's
   split and, at 192, under forced spans of 64: on prefix masks K7, K8 (on
   the transposed pool), K4 and the plain version agree (K7 against K4 at
   the same span, bitwise or not, printed); on masks with holes, an
   all-false row and a row whose only readable position is the last, K7
   and K8 agree with the plain version; where the read splits, two
   launches and two streams bitwise; registers and spill bytes at rep 4
   and 8 (0 required); timings at the planner's split, one span and spans
   of 64, 128, 256 and 512, beside the plain version and the bound, K4
   reading every position on K7's spans, and K7 at rep 1, 2, 4 and 8;
5e. prng: the keyed sampler's threefry (``utils.prng``) against known
   answers of ``jax.random`` (jax 0.9.0, partitionable threefry), bit for
   bit on CUDA and on the CPU: key data, the JAX server's record keys
   (offset 0x7FFFFFFF included), split, bits over the [16, 32000] serving
   draw and per-key bits (first, last and strided samples), uniforms; CUDA
   against the CPU path over 16 keys x 32000: bits and uniforms bit for
   bit, Gumbels within 2 ulp (at the scale of max(|g|, 1)); the time of
   one slot draw (``serve._pick_slots``, temperature 0.9, top_k 16, top_p
   0.95) beside greedy argmax, by events and by the host's wall; the
   uniform at the largest CUDA-vs-CPU Gumbel gap is printed;
6. train_grad: one training loss and backward at 1b width, 2 layers,
   S=512, B=2, through the kernels and through dense attention: the loss
   and every parameter's gradient must agree within bf16 tolerance;
7. train: the streaming train loop at the 1b scale, full width and depth,
   f32 master weights (the zoo's 1b stores bf16 for serving; training keeps
   f32 masters, ``TransformerConfig``'s default), made on the card by
   ``init_params`` from a seed: 48 records of 512 tokens on four partitions
   → ``KafkaStream`` → ``make_train_step`` with AdamW(1e-3), 6 steps of 8,
   each ``token.commit(wait_for=loss)``. Every loss finite, every
   partition's watermark advanced, Σ watermarks == 48, and K1/K2/K3 each
   launched 24 × 6 times, every time on the tensor cores (the main path:
   the counts are zeroed just before the loop and read just after);
8. serve: the 1b model at full width and depth, random bf16 weights made on
   the card from a seed, 32 prompts of 128 tokens on two partitions served
   by ``StreamingGenerator`` with the int8 pool (a main path: every kernel
   launch count is zeroed just before it and read just after; every K1
   launch on the tensor cores), then again with the bf16 pool;
8t. serve_traced: the int8 serve run untraced, then traced with
   ``obs.RecordTracer(capacity=1 << 16)`` (token events on; the second
   in-turn pair was cut for the harness phase's time): the traced run's
   tokens and commits equal the untraced run's, K1 and K4 follow the
   serve phase's rule, and each of the 32 records is polled, active,
   finished and committed exactly once with nothing left open. Printed: TTFT, inter-token latency, queue wait and end-to-end
   p50/p99 from the tracer's histograms (the tracer's clock is the
   host's: a record is "active" once its first token is enqueued), tok/s
   traced against untraced. One ``MetricsExporter`` on 127.0.0.1 serves
   the server's and the tracer's expositions; one scrape must parse under
   ``tests/test_obs.py``'s exposition grammar with no family twice;
8a. serve_sampled: the serve phase's model and 32 prompts plus one poison
   record (7 bytes, which ``decode_prompt`` rejects), sampled (temperature
   0.9, top_k 16, top_p 0.95, ``rng=prng.key(11)``) over the TCP broker:
   the topic in an ``InMemoryBroker`` behind a ``BrokerServer`` on
   localhost, consumed through ``MemoryConsumer(BrokerClient(...))``, the
   int8 pool on K4, ``quarantine=PoisonQuarantine(MemoryProducer(broker),
   "prompts.dlq", budget=2)``. 32/32 completions of 64 tokens, committed ==
   end offsets (the poison's included), exactly one DLQ record with the
   quarantine's provenance headers, K1 = 24 x prefills, K4 = 24 x decode
   ticks; run twice, with identical tokens, commits and DLQ record;
8a'. serve_resume: the serve phase's model, 32 prompts and the poison
   record in an ``InMemoryBroker``, sampled as in 8a, over the bf16
   compute-dtype dense pool (warm resume needs it), exactly-once: output
   through a ``TransactionalProducer`` with ``exactly_once=True``, the
   ``PoisonQuarantine`` over the same producer, a ``DecodeJournal`` of
   cadence 8, 4 ticks a block. Five runs: uncut; A, killed without a
   close, commit or flush once the first wave retired and the second sits
   between two cadence writes; B warm (a producer of the same
   transactional id fences A; hints from ``DecodeJournal.load``); A again
   on a second broker and B cold with no hints. Held: A commits nothing;
   both recoveries publish each completion and the poison's DLQ copy
   exactly once in the read_committed views and commit the end offsets;
   A's journal equals the uncut run's tokens; B warm serves A's finished
   entries from the journal, resumes each partial one and decodes
   sum(64 - g) + 64 per cold admission, fewer than B cold; K1 = 24 x
   (prefills + resumes), all on the tensor cores; K4 = K5 = 0;
   transactions committed. Printed: the post-prefix agreement with the
   uncut run, time to recover warm and cold, each resume prefill's event
   time by S and the prefill's device time at ``RESUME_S``, journal flush
   host ms and transaction commit ms (p50, p99);
8b. serve_paged: the same 1b model through the PAGED pool (int8, block
   size 16, radix prefix reuse, chunked prefill, K5 on decode-only ticks):
   48 prompts of 128 tokens from three tenants, each a fixed 96-token
   system prompt plus 32 random tokens, produced keyed by tenant onto four
   partitions (scenario 12's stream shape). 48/48 completions of 64 tokens,
   committed == end offset on every partition, prefix hits, fewer prefill
   tokens than 48 × 128, and K5 launched n_layers × (decode ticks − chunk
   ticks) times (counts zeroed just before the run, read just after). Then
   the same stream through the gathered read (no K5 launch): identical
   commits and token 0;
8t'. serve_tiered: the same 1b model, pool and chunked prefill over a
   stream that thrashes HBM: 384 prompts from 64 tenants (each a fixed
   96-token system prompt, 6 whole blocks, plus 32 random tokens), each
   tenant drawn with Zipf(1.1) weights from a fixed seed, keyed by tenant
   onto 4 partitions, polled 16 at a time (``benchmarks/bench_tiered.py``'s
   stream at the 1b scale); odd tenants get a 32-token budget
   (``max_new_of``). The pool keeps about 20 tenants' prefixes (in-flight
   slots share their tenant's 6 prefix blocks), so the Zipf tail's
   revisits find their prefix evicted; a block's int8 payload is 811,008
   bytes. Runs: (HBM only, ``kv_tier={"capacity_bytes": 1 << 30}``) x
   ``--tier-rounds`` (default 1; two of each in turns before the fleet
   phases took their time); every run traced. Held: every run commits
   the end offsets; the tier runs make
   more prefix hits and prefill fewer tokens than the HBM-only runs,
   demote and promote (tier hits == promotions) within capacity; each odd
   tenant's completion has exactly 32 tokens and ``output_capped`` counts
   them; K5 = layers x (decode ticks - chunk ticks), K1 = K4 = 0 (a
   promotion launches no kernel); a cached block read by
   ``_tier_read_block`` and written by ``_tier_write_block`` into a fresh
   block is bitwise equal on all four pools. Printed: hit rates (overall
   and for the 4 most and 4 least frequent tenants), prefill tokens,
   TTFT p50/p99, host ms per demotion and promotion, tok/s and the token
   agreement between the tier and HBM-only runs. Then the witness of that
   agreement, over the first 128 prompts: HBM only against the tier with
   K5 and again with the gathered read on every tick, and whether a decode
   row's q/k/v, MLP and head outputs are bitwise the same at M = 16 (a
   decode-only tick) and inside M = 272 (a chunk tick);
8c. serve_paged_f32: 1b width, 2 layers, f32 weights, the same stream
   through K5 and through the gathered read: every token identical;
8c'. serve_sampled_f32: the tenant stream of 8b plus the poison record,
   sampled as in 8a over the TCP broker, at 1b width, 2 layers, f32, in six
   runs: the dense and paged compute-dtype pools, the dense int8 pool
   through K4 and through the plain M-major read, the paged int8 pool
   through K5 and through the gathered read. Every token, the commits and
   the DLQ record identical within each pair; the K4 and K5 runs commit
   the same offsets and DLQ record (their tokens differ where the dense
   prefill's exact prompt k/v and the paged prefill's quantized pool
   round apart; the agreement is printed);
8c''. serve_resume_f32: 8a' at 1b width, 2 layers, f32, on the dense and
   the chunked paged compute-dtype pools (the paged resume rides the
   chunk queue), greedy and sampled: both recoveries equal the uncut run
   token for token and in committed watermarks;
8t''. serve_tiered_f32: 8t' at 1b width, 2 layers, f32, over its first
   128 prompts: HBM only against the tier, greedy and sampled on the
   compute-dtype pool, greedy on the int8 pool (K5) and greedy through a
   disk-spill tier (``capacity_bytes=0`` under a temporary directory):
   every token and watermark of each tiered run equals its HBM-only
   run's;
8s. serve_spec: the serve phase's model and 32 prompts over the bf16 dense
   pool, served plainly (63 ticks a block) and by
   ``SpecStreamingGenerator`` (k = 4, 13 rounds a block: harness scenario
   7 ``--spec``) with the perfect draft (the target itself) and the
   half-depth self-draft: plain, perfect, self (the closing plain run was
   cut for the harness phase's time); then the self-draft's layers served
   plainly. Each run:
   32/32 completions of 64 tokens, committed == end offsets and equal to
   the first plain run's, token 0 identical to it, K1 = (layers + draft
   layers) x prefills all on the tensor cores, K4 = K5 = 0, proposals
   made. Printed: tok/s, the speculation counters and α, tokens a
   slot-round, host ms a tick block and a round, the token agreement with
   plain (bf16: the verify runs the target's GEMMs at 80 rows, plain
   decode at 16), and bench_spec's terms t_target, t_draft, c =
   t_draft / t_target, t_round and v = (t_round - 5 t_draft) / t_target
   from the tick-block times;
8s'. serve_spec_paged: serve_paged's tenant stream through the bf16
   compute-dtype paged chunked pool, plain and then speculative
   (self-draft, k = 4): 48/48 completions, committed == end offsets and
   equal, prefix hits and fewer prefill tokens than 48 x 128, K1 = K4 =
   K5 = 0, token 0 identical, proposals made;
8s''. serve_spec_f32: 1b width, 2 layers, f32, 32 prompts: plain dense,
   then speculative with the perfect and the 1-layer self-draft on the
   dense, the legacy paged (``prefill_chunk=0``) and the chunked paged
   pool, every token and watermark equal to the plain run's and the
   perfect draft's α 1.0; then serve_resume's killed-and-resumed
   exactly-once run, greedy, through the speculative server on the dense
   and the chunked paged pool: both recoveries equal the uncut run;
8f. serve_fleet: harness scenario 10 at 1b on the card: 64 prompts of
   128 tokens keyed ``throttled`` (lane batch, every third) and ``open``
   (lane interactive), which keyed production puts on partitions 3 and 0
   of 4; a 2-replica ``fleet.ServingFleet`` of 8 slots each on the int8
   pool (K1 + K4), ``QoSConfig(tenant_rates={"throttled": 4.0},
   burst=1.0, max_queue_depth=64, resume_queue_depth=16)``, commits every
   4 completions, 8 ticks a block, a ``journal_dir`` and one seeded
   ``ReplicaChaos`` kill, every commit audited against the completions
   the fleet registered; the QoS clock is synthetic (0.4 s a scheduling
   round, about what a round of two 1b replicas takes), so the schedule
   and the kill repeat exactly. After a 16-slot single server on the same
   stream: single, fleet (the second in-turn pair was cut for the harness
   phase's time). Held: every prompt
   served at least once, committed == end offsets and equal to the
   single server's, the merged ``watermarks()`` equal to the broker's,
   at least one duplicate and one journal handoff, the survivor served
   or resumed at least one record from the victim's journal, token 0 of
   every copy equal to the single server's, K1 = layers x (prefills +
   warm resumes) and K4 = layers x decode ticks summed over the replicas. Then a
   drain after 32 completions and a second fleet on the same group:
   every prompt once, none by both. Memory: one 8-slot server's bytes
   against a 2-replica fleet's (the second replica adds its pool, not a
   copy of the weights). Printed: tok/s of each run, per-replica
   completions, duplicates, tokens restored and decoded again, lane
   waits (synthetic seconds), backpressure pauses, commit p50/p99;
8f'. serve_fleet_rollout: the same fleet without the kill and an output
   topic whose values name their prompt: (a) an in-process rollout to
   version 1 = the same weights (canary slice 8, no diff allowed) must
   promote on both replicas; (b) version 1 = weights of another seed
   (canary slice 2) must roll back with no output of version 1 ever
   produced; two thirds
   of the stream arrive before the rollout, the rest after it is done.
   (c) The weights of another seed published with ``publish_checkpoint``
   (~0.64 GB at 4 layers), fetched CRC-checked by a ``RolloutWorker`` on each replica
   under a ``BrokerRolloutDriver`` (canary gate open) and rebuilt onto
   the card bitwise equal; served after the swap. Every commit is
   recorded with the version live on its replica, and in every run each
   output record's ``mv`` header is the version of the commit that closed
   its prompt's window; K1/K4 hold over the replicas and the canary
   shadows. Printed: publish and
   fetch+rebuild seconds, ``swap_params`` ms, and first a
   ``batch_invariance`` line: whether a record's prefill logits and k/v
   are bitwise the same alone as in a batch of 8, and a head GEMM row at
   M = 1 as at M = 8;
8f''. serve_fleet_f32: 1b width, 2 layers, f32: the single server against
   the killed, journaled fleet on the compute-dtype pool (partial hints
   resume warm): every token of every copy equal; a clean rollout's
   outputs equal the fleet's without one; a speculative fleet (k = 4, the
   perfect draft) publishing each committed completion to a distill topic
   (frames == completions, each its prompt and tokens), then a draft
   refresh through ``start_distill`` during a kill: every completion
   equal; a ``FleetAutoscaler`` loop driven by ``WorkloadGenerator``
   under a ``ManualClock`` scales up and down and replays byte for byte;
8d. serve_8b: harness scenario 7 at the 8b scale with an output topic
   (BASELINE config 5), full width at 16 of its 32 layers, random int8
   weights made on the card from a seed: 48 prompts of 128 tokens produced round-robin on
   two partitions, 16 slots, 64 new tokens, the dense int8 pool, each
   completion published to "completions" keyed by its prompt before its
   offset commits. Run twice, with the K4 read and then with the plain
   M-major read (kv_kernel=False); each run serves 48/48 completions of 64
   tokens, commits the end offsets, publishes exactly 48 records equal to
   the completions, and launches K1 = layers × prefills (all on the tensor
   cores; none in the f32 run below), K4 = layers × decode ticks
   (0 in the second run) and K6-K8 never (counts zeroed just before each
   run, read just after); the two runs commit the same offsets and agree
   on token 0;
8e. serve_8b_f32: the same stream and checks at 8b width, 2 layers, f32
   compute over the int8 weights, through K4 and through the plain M-major
   read: every token identical;
8g. serve_disagg (after serve_fleet_rollout): disaggregated prefill at
   serve_paged's model and pool (1b bf16, int8 chunked paged, blocks of
   16, all 24 layers) over its 48-prompt tenant stream: a ``ServingFleet``
   of two 8-slot decode replicas with ``handoff_consumer_factory`` (one
   private handoff group each, ``route_patience`` 2 rounds) and one
   ``PrefillPool`` worker in its own group, pumped every round and closed
   once 6 handoffs are published (harness scenario 21's mid-storm loss of
   the prefill worker); the rest fall back to local prefills. Held: every
   prompt served once, committed == end offsets == the monolithic paged
   serve's, >= 6 slots adopted, the prefill group's commits covering only
   published handoffs, no adopted record queued for a local prefill and
   the replicas' prefill tokens exactly the fallbacks' (from the fleet's
   trace), K5 = 24 x decode-only ticks over every server, K1 = K4 = 0,
   token 0 equal to the monolithic serve's. Printed: handoff bytes,
   publish-to-adopt ms (trace clock), decode tick p50/p99 with the
   prefill worker beside the monolithic serve's, the token agreement;
8h. serve_procfleet (lane ``procfleet``): the process fleet (``fleet.ProcessFleet``, worker
   processes ``python -m torchkafka_tpu_torch.fleet.proc`` on the card)
   at the 1b widths, 4 of its 24 layers, f32 as ``fleet.proc.build_model`` gives
   (weights drawn on the CPU from the seed in every process): serve_fleet's
   64 prompts of 128 (two tenants, each record keyed by tenant and index,
   prompt i on partition i % 4) over the ``BrokerServer`` TCP broker; 2
   replica processes of 8 slots (dense f32 pools, a journal, respawn), one
   SIGKILLed mid-round while its journal holds generations with tokens
   (wave 1); the same processes on wave 2; one after ``scale(1)`` on
   wave 3. Held: ``fully_committed``, the duplicates over the three
   waves at most the group's rebalances from wave 1 to the drain x 2 x
   (4 + 8) (harness scenario 17's bound, replicas x (commit_every +
   slots), a rebalance), every copy byte-identical to the port's in-process 8-slot server on the same
   weights, the victim fenced (its generation refused a commit) with its
   journal handed over and resumes counted, each dumping child's K1 = 4 x
   (prefills + warm resumes) from its own counters. Printed: tok/s from the
   produce (worker start excluded), each child's tick p50/p99,
   duplicates, kill to respawn-ready seconds, 2 processes over 1 (waves 2
   and 3);
8i. serve_procfleet_f32 (lane ``procfleet``, after serve_procfleet): 1b width, 2 layers, f32,
   real processes: (a) scenario 21's shape, ``ProcessFleet(replicas=2,
   prefill_replicas=1)`` over a paged compute-dtype pool, the prefill
   worker SIGKILLed after 6 handoffs: every completion byte-identical to
   the in-process monolithic paged server, nothing lost, adoptions, the
   prefill group's commits covering only published handoffs; (b) the
   distill role: one replica and a ``DistillTrainer`` worker training the
   1-layer draft on the card (K1-K3 = steps in its dump), versions 1 and 2
   fetchable, ``kill_distill`` respawns it and it trains again;
8j. harness (lane ``harness``): the port's harness entry point
   (``harness.run_scenario``, what ``python -m torchkafka_tpu_torch.harness``
   calls) on the card: scenario 7 at the 1b, 24 layers, on the int8 pool
   read by K4, with ``decode_roofline`` (replays of one CUDA graph of the
   63-tick decode block between CUDA events, windows of 8 and 24 blocks,
   three of each), scenario 5 at the 1b (lockstep generate, the device
   split by CUDA events) and scenarios 1, 2, 6 and 9 at tiny size. Held:
   committed == records, no commit failure or drop; the roofline timed
   from the graph with its slope held and 0 < hbm_roofline_pct <= 105;
   the captured block's K4 = 24 x ticks_per_sync; the eager K4 = 24 x
   the eager decode ticks (serving plus warmup's block); K1 = 24 x
   prefills on the tensor cores; scenario 9's K1 = K2 = K3. Then a
   2-layer f32 server probed by the roofline serves the same tokens and
   commits as one never probed;
8k. harness_fleet (lane ``harness``, after harness): the harness's in-process fleet
   scenarios 10, 11, 12, 13, 14, 15, 16, 22 and 25 through
   ``harness.run_scenario(n, "full")`` on the card, at their full size
   (``TransformerConfig``'s defaults: d_model 512, 4 layers, 8 q / 8 kv
   heads, head dim 64, bf16, weights from seed 0): the QoS fleet with a
   drain and restart, the chaos soak, the prefix-cache fleet, the warm
   failover, the chunked-prefill storm, the traced fleet with one scrape
   of a ``MetricsExporter``, the Zipf storm on a ``ManualClock``, the
   autoscaled step storm (run twice, replayed identically) and the
   speculative fleet distilling its own draft through a hot-set rotation
   (beside a never-distilled fleet). Every count is zeroed just before a
   scenario and read just after. Held: ``tests/test_harness.py``'s
   assertions for each (for 25 its safety half: committed tokens
   byte-identical to the never-distilled fleet, no duplicate, everything
   arrived, the trainer stepped and published; its alpha phases are
   printed); K1 = layers x (dense prefills + warm resumes + dense
   warm-ups), plus a speculative server's draft layers x (prefills + warm
   resumes) and 25's trainer's draft layers x steps, all on the tensor
   cores; K2 = K3 = the trainer's draft layers x steps, on the tensor
   cores; K4 = K5 = 0 (compute-dtype pools);
8l. harness_procfleet (lane ``procfleet``, after serve_procfleet_f32): the harness's process-fleet
   scenarios 17, 18, 19, 21, 23 and 24 through ``harness.run_scenario(n,
   "full")`` on the card, at ``TransformerConfig``'s widths (d_model 512,
   4 layers, 8 q / 8 kv heads, head dim 64, d_ff 1,376, vocab 32,000), in
   f32 as ``fleet.proc.build_model`` gives the worker processes and the
   in-process reference: the SIGKILL storm, the exactly-once storm, the
   broker crashed and recovered from its WAL, the killed prefill worker,
   the quorum cell's leader killed, the rollback-then-complete rollouts.
   Held: ``tests/test_harness.py``'s assertions for each; this process's
   K1 = layers x the reference servers' dense prefills, resumes and
   warm-ups; each dumping worker's K1 = layers x (prefills + warm resumes
   + canary shadow prefills) on a dense pool and 0 on scenario 21's
   paged pools; no tensor-core launch (f32), K2 = K3 = K4 = K5 = 0.
   Printed: each scenario's seconds, ready_s and elapsed_s, duplicates
   and their bound, WAL replays, breaker opens and closes, adoptions and
   fallback prefill tokens with the decode tick p99, the rollouts' phases
   and checkpoint publish seconds, each worker's counts;
8m. train_moe (lane ``procfleet``, after harness_procfleet): mixture-of-
   experts training at the 1b widths with Mixtral-8x7B's routing (8
   SwiGLU experts of d_ff 5632, top-2), ``CUT_LAYERS`` layers, f32
   masters, bf16 compute, ``moe_dispatch="capacity"`` (factor 1.25, groups
   of 256): the train phase's path (48 records of 512 tokens → KafkaStream
   → make_train_step → token.commit), 6 steps of 8. Held: finite losses,
   the watermarks, K1 = K2 = K3 = layers x steps on the tensor cores;
   before it, at f32 on 2 layers, capacity dispatch at an ample factor (no
   drop) gives dense dispatch's loss within 1e-4;
8n. serve_moe (the main sequence, after serve_8b_f32; then pod_tp_sp ends
   it, see 8r): MoE serving at the
   same widths, all 24 layers (~7.1B parameters, random bf16 weights from
   the seed), scenario 7's traffic (32 prompts of 128, 16 slots, 64 new):
   greedy on the bf16 pool (its tick block replayed from a CUDA graph),
   on the int8 pool read by K4, and with ``quantize_params`` int8 weights
   on the int8 pool, each held as the serve phase (K1 = 24 x prefills on
   the tensor cores, K4 = 24 x decode ticks on the int8 pools), token 0
   equal between the pools; then an f32 pair at 2 layers, dense and
   capacity dispatch (groups of one prompt, factor 1.0): the server's
   every token equal to the lockstep ``generate``'s on the same waves;
8o. harness_models (lane ``harness``, after harness_fleet): harness
   scenarios 4 (8,192 PNGs of 64x64 → native decode → resize to 224 →
   ResNet-50 in bf16, batch 64; the chained device time by CUDA events and
   its conv MFU against 989 TFLOP/s) and 8 (the DLRM, 8 tables of 100k x
   64, 40 steps of 4,096, adam) at ``"full"``, with their own assertions;
8p. examples (lane ``harness``, after harness_models): the three
   ``examples/*_torch.py`` as subprocesses on the card at their defaults,
   started together: exit 0, the serving and CTR examples committing their
   topics' end offsets, the streaming trainer its 50 steps of 32;
8q. pod_train (lane ``procfleet``, after train_moe): data- and
   fsdp-parallel training across processes, ``check_pod_train``: two
   ranks (``chip_smoke.py --pod-rank``) in one process group on
   ``cuda:0`` under gloo, the 1b widths with f32 masters, bf16 compute,
   B=8 a rank, S=512: ``{"data": 2}`` and ``{"fsdp": 2}`` at
   ``CUT_LAYERS`` (the data run was 24 layers until pod_serve joined), 3 steps each through pod_consumer →
   KafkaStream(mesh=) → make_train_step(cfg, mesh) → token.commit (step
   ms by CUDA events, collective ms and bytes, peak memory per rank; K1 =
   K2 = K3 = layers x steps on each rank, on the tensor cores; committed
   == end offsets; data replicas' checksums equal); an f32 pair at 2
   layers against the single-process step (split over the ranks' halves:
   losses and parameters within 1e-5; unsplit: losses within 1e-5,
   parameters within ``POD_UNSPLIT_PARAM_REL``; data replicas bit-equal);
   a pod checkpoint at step 2 restored by this process, which trains on to
   the topic's end; harness scenario 3 at full size under two ranks
   through ``torch.distributed.run``;
8r. pod_tp_sp (the main sequence's end, after serve_moe: in the harness
   lane, before pod_serve, it made that lane outlast the other two
   sequences): tensor and sequence
   parallelism across processes, ``check_pod_tp_sp``: two ranks
   (``chip_smoke.py --pod-rank N --pod-mode tp_sp``) on ``cuda:0`` under
   gloo, the 1b widths at ``CUT_LAYERS``, f32 masters, bf16 compute, 8
   rows of 512 (the same seeded batches on both ranks), AdamW, 3 steps on
   each of ``{"tp": 2}`` (Megatron), ``{"sp": 2}`` ring and ``{"sp": 2}``
   Ulysses (step ms by CUDA events, collective ms, bytes and calls, peak
   memory per rank; K1 = K2 = K3 = layers x steps on each rank, ring
   layers x 2 x steps, on the tensor cores); f32 pairs at 2 layers
   against the single-process step (first loss and every gradient within
   1e-5 relative, parameters after 3 steps within
   ``POD_UNSPLIT_PARAM_REL``); bf16 ring and Ulysses attention against
   ``flash_attention`` on the whole sequence (the flash phases' bounds);
8s. pod_pp_ep (lane ``procfleet``, after pod_train, so its two ranks never
   run beside pod_train's): pipeline and expert parallelism across
   processes, ``check_pod_pp_ep``: two ranks (``chip_smoke.py --pod-rank N
   --pod-mode pp_ep``, started once for all four runs) on ``cuda:0`` under
   gloo, the 1b widths, f32 masters, bf16 compute, AdamW, 3 steps on
   ``{"pp": 2}`` (``CUT_LAYERS`` layers, 8 rows of 512, 4 microbatches),
   ``{"ep": 2}`` with train_moe's 8 experts top-2 at 2 layers on 4 rows of
   512, dense and capacity dispatch (step ms by CUDA events, collective
   ms, bytes and calls, peak memory per rank; K1 = K2 = K3 = (layers / pp)
   x M x steps under pp and layers x steps under ep, on the tensor cores);
   f32 pairs at 2 layers against the single-process step (first loss and
   every gradient within 1e-5 relative, parameters within
   ``POD_UNSPLIT_PARAM_REL``); the DLRM (8 tables of 100k x 64) on
   ``{"tp": 2}`` with row-sharded tables, batch 1,024, against the
   single-process step (losses within 1e-5);
8u. pod_serve (lane ``harness``, after examples): sharded serving across
   processes, ``check_pod_serve``: two ranks (``chip_smoke.py --pod-rank N
   --pod-mode serve``) on ``cuda:0`` under gloo, the 1b widths at
   ``CUT_LAYERS`` in bf16, each rank's server on the mesh (rank 0 owns the
   broker and the consumer, the other passes ``consumer=None``):
   ``{"tp": 2}`` on the dense int8 pool (K4, the serve phase's stream),
   ``{"tp": 2}`` on the paged int8 pool (K5, radix cache, serve_paged's
   tenant stream), ``{"data": 2}`` on the dense bf16 pool (8 slots a
   rank); per rank tick-block p50/p99, collective calls, bytes and ms a
   decode tick, peak memory; K1 = layers x prefills on the tensor cores,
   K4 = layers x decode ticks, K5 = layers x (decode ticks - chunk
   ticks); both ranks' completions equal; committed == end offsets; then
   f32 at 2 layers, each run's tokens and committed offsets equal to the
   single-process server's; then layer-sharded serving on ``{"pp": 2}``
   (each rank its stage's layers and their pools only): the 8b widths at
   ``CUT_LAYERS_8B`` with int8 weights on K4 (serve_8b's stream and output
   topic), the paged int8 pool on K5 at ``CUT_LAYERS`` (bit-equal to one
   process), K1/K4/K5 = (layers / pp) x their events, the collective
   calls and bytes as worked out, and f32 pairs at 2 layers (1 a stage);
9. kernels: one line for every ported kernel (all eight; K1 and K4 with
   the fleet runs' launches, ``fleet_launches``; K1-K3 with the worker
   processes' dumped counts, ``process_launches``; K5 with serve_disagg's,
   ``disagg_launches``; K1-K4 with the harness phase's by scenario,
   ``harness_launches``, K4 with the captured block's and the replays;
   K1-K3 with the fleet scenarios', ``harness_fleet_launches``; K1 with
   the process scenarios', ``harness_procfleet_launches``; K1-K4 with the
   MoE phases', ``moe_train_launches`` and ``moe_serve_launches``; K1-K3
   with pod_train's ranks', ``pod_launches``, pod_tp_sp's,
   ``pod_tp_sp_launches``, and pod_pp_ep's, ``pod_pp_ep_launches``; K1,
   K4 and K5 with pod_serve's ranks', ``pod_serve_launches``);
then the card's nvidia-smi line and, last, ``{"ok": true, "device": ...}``.

Lanes: once the kernel phases (3-5d) have timed the kernels alone on the
card, the script starts two processes of its own, ``chip_smoke.py --lane
harness`` (8j, 8k, 8o, 8p, 8u) and ``--lane procfleet`` (8h, 8i, 8l, 8m, 8q,
8s),
and runs the
other phases meanwhile; their time is mostly host work and worker
start-ups with the card idle. Each lane zeroes and reads its own
counts around each path, as the main sequence does; its rows print after
the main sequence's, before the kernels line. A lane that fails fails
the script; a failing script stops its lanes (SIGTERM, on which a lane
closes its worker processes). Times on the host's clock (tok/s, step
times, seconds) are taken beside the lanes; the kernel timings are not.
``--lane <phase>`` runs one lane phase alone (e.g. ``--lane serve_moe``),
for its numbers without the other sequences beside it.

Depth cuts (the time of phases 8g-8l): serve_traced, serve_sampled,
serve_resume (its ``resume_prefill_device_ms`` stays at 24 layers),
serve_tiered, serve_spec, serve_spec_paged, serve_fleet,
serve_fleet_rollout, serve_procfleet and train_moe run the 1b widths at ``CUT_LAYERS`` = 4 of its 24
layers (views of the first 4 layers' weights; their rows carry
``"layers": 4``, and their launch checks use 4); serve_8b runs the 8b
widths at ``CUT_LAYERS_8B`` = 16 of its 32 layers (K1 and K4 = 16 x ...).
Every
phase row carries ``phase_s`` (seconds since the previous line: the first
row of a phase carries the phase) and ``at_s`` (seconds since the start).

Float32 matmuls run in full precision (TF32 off for matmul and cuDNN).
Any failure raises and exits non-zero without the last line; so does a
machine without CUDA, or a directory without the package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
SEED = 0
MAX_NEW = 64  # scenario 7's full size: 64 new tokens per prompt
CUT_LAYERS = 4  # depth of the traced, sampled, resumed, tiered, speculative, fleet and process-fleet paths
CUT_LAYERS_8B = 16  # depth of the 8b path (of 32; its widths unchanged)


_CLOCK = {"start": time.perf_counter()}
_CLOCK["last"] = _CLOCK["start"]


def cut_depth(cfg, params):
    """(cfg, params) at ``CUT_LAYERS`` layers: the first layers' weights as
    views, every width the model's."""
    from torchkafka_tpu_torch.models.spec_decode import truncated_draft

    params_cut, cfg_cut = truncated_draft(params, cfg, CUT_LAYERS)
    return cfg_cut, params_cut


def emit(obj) -> None:
    """Print one JSON line. A phase row (a dict with "phase") also gets
    ``phase_s``, the seconds since the previous line (the rows of one
    phase print together, so its first row carries the phase's time), and
    ``at_s``, the seconds since the script started."""
    now = time.perf_counter()
    if isinstance(obj, dict) and "phase" in obj:
        obj = {**obj, "phase_s": now - _CLOCK["last"], "at_s": now - _CLOCK["start"]}
    _CLOCK["last"] = now
    print(json.dumps(obj), flush=True)


# The phases that run in a process of their own (``--lane``), started
# beside the main sequence once the kernel phases have timed the kernels
# alone on the card: most of their time is worker start-ups and host work.
LANES = {
    "harness": ("harness", "harness_fleet", "harness_models", "examples", "pod_serve"),
    "procfleet": ("serve_procfleet", "serve_procfleet_f32", "harness_procfleet",
                  "train_moe", "pod_train", "pod_pp_ep"),
}


# Card memory the script's heaviest phases may hold at once across its
# processes (the main sequence and the lanes share the one card), and what
# each holds (GB: its measured peaks, both ranks for a pod phase, with
# room for the allocator's cache). The phases not listed peak under ~6 GB
# and run beside them unreserved. pod_train (2 x 28.7 GB while its data
# run had 24 layers) ran out of memory once beside serve_moe and pod_tp_sp
# when the sequences' timing shifted; at CUT_LAYERS its runs peak at
# 2 x 7.1-7.8 GB (PERF.md).
CARD_BUDGET_GB = 66.0
PHASE_GB = {"train": 30.0, "serve_8b": 17.0, "serve_moe": 24.0, "train_moe": 27.0,
            "pod_train": 18.0, "pod_tp_sp": 14.0, "pod_pp_ep": 26.0, "pod_serve": 18.0}


@contextlib.contextmanager
def card_memory(phase: str):
    """Hold ``PHASE_GB[phase]`` of ``CARD_BUDGET_GB`` while the body runs:
    wait (first come, first served) until the phases holding memory in the
    script's other processes leave room. The reservations are files in
    ``TK_SMOKE_MEM_DIR`` (set by the script for its lanes) under an
    ``flock``; a process that died gives its up. Without the directory (a
    lane run alone) nothing is shared and nothing waits."""
    import fcntl

    root = os.environ.get("TK_SMOKE_MEM_DIR")
    if root is None or phase not in PHASE_GB:
        yield
        return
    mine = os.path.join(root, f"{time.time_ns():020d}-{os.getpid()}.json")

    def write(held: bool) -> None:
        with open(mine + ".tmp", "w") as f:
            json.dump({"gb": PHASE_GB[phase], "pid": os.getpid(), "held": held}, f)
        os.replace(mine + ".tmp", mine)

    def alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
            return True
        except OSError:
            return False

    write(False)
    try:
        while True:
            with open(os.path.join(root, "lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                held, ahead = 0.0, False
                for name in sorted(n for n in os.listdir(root) if n.endswith(".json")):
                    path = os.path.join(root, name)
                    if path == mine:
                        continue
                    with open(path) as f:
                        other = json.load(f)
                    if not alive(other["pid"]):
                        continue
                    if other["held"]:
                        held += other["gb"]
                    elif name < os.path.basename(mine):
                        ahead = True
                if not ahead and held + PHASE_GB[phase] <= CARD_BUDGET_GB:
                    write(True)
                    break
            time.sleep(0.5)
        yield
    finally:
        os.remove(mine)


def run_lane(torch, lane: str) -> None:
    """Run one lane's phases (or the one lane phase named ``lane``) in this
    process, printing each phase's rows as it ends (the caller reads them
    back from this process's output)."""
    from torchkafka_tpu_torch.models.zoo import zoo_config

    cfg = zoo_config("1b")
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32,
                                param_dtype=torch.float32)
    phases = {
        "harness": lambda: check_harness(torch),
        "harness_fleet": lambda: check_harness_fleet(torch),
        "harness_models": lambda: check_harness_models(torch),
        "examples": lambda: check_examples(torch),
        "serve_procfleet": lambda: check_serve_procfleet(
            torch, dataclasses.replace(cfg, n_layers=CUT_LAYERS)),
        "serve_procfleet_f32": lambda: check_serve_procfleet_f32(torch, cfg32),
        "harness_procfleet": lambda: check_harness_procfleet(torch),
        "train_moe": lambda: check_train_moe(torch),
        "serve_moe": lambda: check_serve_moe(torch),
        "pod_train": lambda: check_pod_train(torch),
        "pod_tp_sp": lambda: check_pod_tp_sp(torch),
        "pod_pp_ep": lambda: check_pod_pp_ep(torch),
        "pod_serve": lambda: check_pod_serve(torch),
    }
    for name in LANES.get(lane, (lane,)):
        with card_memory(name):
            for row in phases[name]():
                emit(row)
            torch.cuda.empty_cache()


def start_lane(lane: str):
    """Start ``chip_smoke.py --lane <lane>`` beside this process, on the
    same clock; its rows go to a temporary file, its errors to this
    process's standard error."""
    out = tempfile.TemporaryFile(mode="w+")
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(here, "chip_smoke.py"), "--lane", lane,
         "--clock-start", repr(_CLOCK["start"])],
        stdout=out, cwd=here,
    )
    return lane, proc, out


def finish_lane(job) -> list:
    """Wait for a lane, print its rows here and return them; raise if it
    failed."""
    lane, proc, out = job
    rc = proc.wait()
    out.seek(0)
    text = out.read()
    out.close()
    sys.stdout.write(text)
    sys.stdout.flush()
    if rc != 0:
        raise AssertionError(f"lane {lane} ({', '.join(LANES[lane])}) exited with {rc}")
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def stop_lanes(jobs) -> None:
    """Stop every lane still running (SIGTERM, on which a lane closes its
    worker processes; SIGKILL after 60 s)."""
    for _, proc, _ in jobs:
        if proc.poll() is None:
            proc.terminate()
    for _, proc, _ in jobs:
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, flush, n: int = 25, warm: int = 3,
            sleep_cycles: int = 2_000_000) -> float:
    """Median device time of one call of ``fn`` in ms, L2 flushed first.
    A device sleep of ``sleep_cycles`` (~1 ms by default) ahead of the
    start event keeps the card busy while the host enqueues ``fn``'s
    kernels, so the events time the kernels and not the host's launch
    latency; a call that takes the host longer to enqueue needs more."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_flash(torch, F, flash, flush, gen) -> dict:
    """K1 against its plain version, each case through the kernel that
    ``_route`` picks (the route of each is printed and its tensor-core
    count checked): bf16 at the 1b prefill shape and at the training shape
    (B=8, S=512; the tensor cores), a
    ragged S, k_offsets whose fully masked rows lie in a skipped tile (64)
    and inside a computed one (40; o = 0 and lse < -1e29 there, no NaN),
    f32 for a tight check (the CUDA cores), bf16 and f32 at the 8b prefill
    shape (32 q / 8 kv heads), and bf16 at D=64 and D=16 with rep 1 and 4,
    S=17, a ragged S=200, non-causal and a q_offset; D=40 and D=160 take
    the CUDA cores in bf16. Two launches at the training shape must agree
    bitwise; the tensor-core kernel's registers and spill bytes (0
    required). Timings at the 1b prefill shape and the training shape
    (B=8, S=512), beside the CUDA-core kernel on the same bf16 inputs, the
    plain version and SDPA's forward, and at the warm-resume prefill's
    shapes (B=1, S = 128 + g - 1 for ``RESUME_S``)."""
    B, S, H, K, D = 16, 128, 16, 8, 128
    H8 = 32  # the 8b scale's q heads: H/K = 4
    tol = {"bf16_o": 4e-2, "lse": 1e-3, "f32_o": 1e-4}
    bf16, f32 = torch.bfloat16, torch.float32

    def make(b, s, dtype, h=H, kh=K, d=D):
        mk = lambda n: torch.randn((n, s, d), generator=gen, device="cuda",  # noqa: E731
                                   dtype=torch.float32).to(dtype)
        return mk(b * h), mk(b * kh), mk(b * kh)

    cases = {  # b, s, dtype, q_offset, k_offset, H, K, D, causal
        "main_bf16": (B, S, bf16, 0, 0, H, K, D, True),
        "train_bf16": (8, 512, bf16, 0, 0, H, K, D, True),
        "ragged_s200_bf16": (B, 200, bf16, 0, 0, H, K, D, True),
        "resume_b1_s143_bf16": (1, 143, bf16, 0, 0, H, K, D, True),
        "k_offset64_bf16": (B, S, bf16, 0, 64, H, K, D, True),
        "main_f32": (B, S, f32, 0, 0, H, K, D, True),
        "main_8b_bf16": (B, S, bf16, 0, 0, H8, K, D, True),
        "main_8b_f32": (B, S, f32, 0, 0, H8, K, D, True),
        "k_offset40_bf16": (2, S, bf16, 0, 40, H, K, D, True),
        "d64_rep1_bf16": (2, 256, bf16, 0, 0, 8, 8, 64, True),
        "d64_rep4_s200_bf16": (2, 200, bf16, 0, 0, H8, K, 64, True),
        "d16_rep4_s17_bf16": (2, 17, bf16, 0, 0, 16, 4, 16, True),
        "d16_rep1_noncausal_bf16": (2, 77, bf16, 0, 0, 8, 8, 16, False),
        "d64_q_offset32_bf16": (2, 100, bf16, 32, 0, H, K, 64, True),
        "noncausal_s200_bf16": (2, 200, bf16, 0, 0, H, K, D, False),
        "d40_simt_bf16": (2, 96, bf16, 0, 0, H, K, 40, True),
        "d160_simt_bf16": (2, 96, bf16, 0, 0, H, K, 160, True),
    }
    fwd = flash.flash_fwd_bhsd
    errs, routes = {}, {}
    for name, (b, s, dtype, qo, ko, h, kh, d, causal) in cases.items():
        q, k, v = make(b, s, dtype, h, kh, d)
        kw = dict(causal=causal, q_offset=qo, k_offset=ko, n_q_heads=h, n_kv_heads=kh)
        before = fwd.tc_launches
        o, lse = fwd(q, k, v, **kw)
        tc = fwd.tc_launches - before
        po, plse = flash.flash_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        route = flash._route(dtype, d)
        if tc != (route == "tc"):
            raise AssertionError(f"flash_fwd {name}: route {route} but tc launches {tc}")
        routes[name] = route
        e_o, e_l = max_err(torch, o, po), max_err(torch, lse, plse)
        limit = tol["f32_o"] if dtype == torch.float32 else tol["bf16_o"]
        if not (e_o <= limit and e_l <= tol["lse"]):
            raise AssertionError(f"flash_fwd {name}: o err {e_o}, lse err {e_l}")
        if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
                and o.shape == po.shape):
            raise AssertionError(f"flash_fwd {name}: bad output")
        if causal and ko > qo:  # rows before the first key: o = 0, lse ≈ -1e30
            rows = slice(0, ko - qo)
            if o[:, rows].abs().max().item() != 0.0 or lse[:, rows].max().item() >= -1e29:
                raise AssertionError(f"flash_fwd {name}: fully masked rows not 0 / -1e30")
        errs[name] = {"o": e_o, "lse": e_l}

    resources = {f"d{d}": flash.fwd_tc_attrs(d) for d in (64, 128)}
    if any(r["local_bytes"] for r in resources.values()):
        raise AssertionError(f"flash_fwd: the tensor-core kernel spills {resources}")

    def timed(b, s, check_bits: bool) -> dict:
        q, k, v = make(b, s, bf16)
        kw = dict(causal=True, n_q_heads=H, n_kv_heads=K)
        if check_bits:  # no atomics: the same inputs give the same bits
            o1, l1 = fwd(q, k, v, **kw)
            o2, l2 = fwd(q, k, v, **kw)
            if not (torch.equal(o1, o2) and torch.equal(l1, l2)):
                raise AssertionError("flash_fwd: two launches differ")
        ms = cuda_ms(torch, lambda: fwd(q, k, v, **kw), flush)
        # The CUDA-core kernel on the same bf16 inputs, which the route
        # rule sends to the tensor cores: launched directly, not counted.
        simt_ms = cuda_ms(torch, lambda: flash._launch_fwd(q, k, v, "simt", **kw), flush)
        plain_ms = cuda_ms(torch, lambda: flash.flash_fwd_plain(q, k, v, **kw), flush, n=5)
        # The library yardstick, in its own [B, H, S, D] layout (views of
        # the same inputs); never called by the port.
        qs, ks, vs = (x.reshape(b, -1, s, D) for x in (q, k, v))
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True), flush)
        pairs = s * (s + 1) // 2  # allowed (q, k) pairs per head, causal
        flops = 4.0 * D * pairs * b * H  # q·k and p·v multiply-adds
        nbytes = 2 * D * s * (2 * b * H + 2 * b * K) + 4 * b * H * s
        bms, by = bound(flops, nbytes)
        return {"shape": {"B": b, "S": s, "H": H, "K": K, "D": D},
                "route": flash._route(bf16, D), "kernel_ms": ms,
                "tflops": flops / ms / 1e9, "simt_bf16_ms": simt_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": bms, "bound_by": by}

    prefill = timed(B, S, check_bits=False)
    train_shape = timed(8, 512, check_bits=True)
    # A warm resume prefills one sequence of S = P + g - 1 positions.
    resume = {str(s): timed(1, s, check_bits=False) for s in RESUME_S}
    return {"phase": "flash_fwd", "shape": prefill["shape"], "tolerance": tol,
            "max_abs_err": errs, "routes": routes, "deterministic": True,
            "tc_resources": resources, "kernel_ms": prefill["kernel_ms"],
            "plain_ms": prefill["plain_ms"], "library_ms": prefill["library_ms"],
            "bound_ms": prefill["bound_ms"], "bound_by": prefill["bound_by"],
            "prefill": prefill, "train_shape": train_shape, "resume_prefill": resume,
            "err_main": errs["main_bf16"]["o"]}


def check_flash_bwd(torch, F, flash, flush, gen) -> dict:
    """K2 (dQ) and K3 (dK/dV) against their plain versions: at the 1b
    training shape in bf16 (the tensor-core kernels) and f32 (the CUDA-core
    kernels), and in bf16 at the 8b heads (rep 4), D=64, D=32 with rep 8
    and a q_offset, D=16, non-causal, S=17, a ragged S=200 and a k_offset
    with fully masked rows (dq = 0 there, no NaN anywhere); D=40, D=160 and
    D=256 take the CUDA-core kernels (D=160 and 256 in bf16 and f32, the
    32-row tiles past D=128). K3 twice on the same inputs must agree
    bitwise. Timings at the training shape beside the CUDA-core kernels on
    the same bf16 inputs, the plain versions and SDPA's backward."""
    B, S, H, K, D = 8, 512, 16, 8, 128
    # Relative to the largest |plain value| of each output: bf16 about one
    # ulp (2^-7 = 7.8e-3) at the top of the range, f32 sums of 512 terms.
    tol = {"bf16_rel": 1e-2, "f32_rel": 1e-5}
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {  # b, s, dtype, q_offset, k_offset, H, K, D, causal
        "main_bf16": (B, S, bf16, 0, 0, H, K, D, True),
        "main_f32": (B, S, f32, 0, 0, H, K, D, True),
        "ragged_s200_bf16": (2, 200, bf16, 0, 0, H, K, D, True),
        "k_offset64_f32": (2, 256, f32, 0, 64, H, K, D, True),
        "k_offset64_bf16": (2, 256, bf16, 0, 64, H, K, D, True),
        "heads_8b_bf16": (2, S, bf16, 0, 0, 32, K, D, True),
        "d64_bf16": (2, 256, bf16, 0, 0, H, K, 64, True),
        "noncausal_bf16": (2, 256, bf16, 0, 0, H, K, D, False),
        "s17_bf16": (2, 17, bf16, 0, 0, H, K, D, True),
        "d32_rep8_q_offset32_bf16": (2, 100, bf16, 32, 0, H, 2, 32, True),
        "d16_s77_noncausal_bf16": (2, 77, bf16, 0, 0, 8, 4, 16, False),
        "d40_simt_bf16": (2, 96, bf16, 0, 0, H, K, 40, True),
        # Past the tensor cores' D <= 128: the CUDA-core kernels' 32-row tiles.
        "d160_s200_simt_bf16": (2, 200, bf16, 0, 0, H, K, 160, True),
        "d160_s200_simt_f32": (2, 200, f32, 0, 0, H, K, 160, True),
        "d256_simt_bf16": (2, 256, bf16, 0, 0, H, K, 256, True),
        "d256_k_offset32_simt_f32": (2, 256, f32, 0, 32, H, K, 256, True),
    }

    def make(b, s, dtype, h=H, kh=K, d=D):
        mk = lambda n: torch.randn((n, s, d), generator=gen, device="cuda",  # noqa: E731
                                   dtype=torch.float32).to(dtype)
        return mk(b * h), mk(b * kh), mk(b * kh), mk(b * h)

    kernels = (flash.flash_dq_bhsd, flash.flash_dkv_bhsd)
    errs, routes = {}, {}
    for name, (b, s, dtype, qo, ko, h, kh, d, causal) in cases.items():
        q, k, v, do = make(b, s, dtype, h, kh, d)
        kw = dict(causal=causal, q_offset=qo, k_offset=ko, n_q_heads=h, n_kv_heads=kh)
        o, lse = flash.flash_fwd_bhsd(q, k, v, **kw)
        before = [fn.tc_launches for fn in kernels]
        got = flash.flash_bwd_bhsd(q, k, v, o, lse, do, **kw)
        tc = [fn.tc_launches - n for fn, n in zip(kernels, before)]
        ref = flash.flash_bwd_plain(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        route = flash._route(dtype, d)
        if tc != ([1, 1] if route == "tc" else [0, 0]):
            raise AssertionError(f"flash_bwd {name}: route {route} but tc launches {tc}")
        routes[name] = route
        rel = tol["f32_rel"] if dtype == torch.float32 else tol["bf16_rel"]
        row = {}
        for label, a, r in zip(("dq", "dk", "dv"), got, ref):
            e = max_err(torch, a, r)
            limit = rel * float(r.float().abs().max())
            if not (e <= limit and torch.isfinite(a.float()).all()):
                raise AssertionError(f"flash_bwd {name} {label}: err {e} > {limit}")
            row[label] = e
        if ko > qo:  # rows before the first key: no allowed key, dq = 0
            masked = got[0][:, : ko - qo]
            if masked.abs().max().item() != 0.0:
                raise AssertionError(f"flash_bwd {name}: fully masked rows have dq != 0")
        errs[name] = row

    q, k, v, do = make(B, S, torch.bfloat16)
    kw = dict(causal=True, n_q_heads=H, n_kv_heads=K)
    o, lse = flash.flash_fwd_bhsd(q, k, v, **kw)
    delta = flash.flash_delta(o, do)
    args = (q, k, v, do, lse, delta)
    # No atomics: the same inputs give the same bits.
    first, second = flash.flash_dkv_bhsd(*args, **kw), flash.flash_dkv_bhsd(*args, **kw)
    dq1, dq2 = flash.flash_dq_bhsd(*args, **kw), flash.flash_dq_bhsd(*args, **kw)
    deterministic = {"dkv": all(torch.equal(a, b) for a, b in zip(first, second)),
                     "dq": torch.equal(dq1, dq2)}
    if not all(deterministic.values()):
        raise AssertionError(f"flash_bwd: two launches differ {deterministic}")
    resources = {f"{w}_d{d}": flash.bwd_tc_attrs(w, d) for w in ("dq", "dkv") for d in (64, 128)}
    if any(r["local_bytes"] for r in resources.values()):
        raise AssertionError(f"flash_bwd: a tensor-core kernel spills {resources}")

    dq_ms = cuda_ms(torch, lambda: flash.flash_dq_bhsd(*args, **kw), flush)
    dkv_ms = cuda_ms(torch, lambda: flash.flash_dkv_bhsd(*args, **kw), flush)
    simt_dq_ms, simt_dkv_ms = (cuda_ms(torch, fn, flush)
                               for fn in _simt_bwd_calls(torch, flash, args, kw))
    dq_plain = cuda_ms(torch, lambda: flash.flash_dq_plain(*args, **kw), flush, n=5)
    dkv_plain = cuda_ms(torch, lambda: flash.flash_dkv_plain(*args, **kw), flush, n=5)
    # The library yardstick: SDPA's backward at the same shape, in its own
    # [B, H, S, D] layout, as (forward + backward) - forward; never called
    # by the port.
    qs, ks, vs, dos = (x.reshape(B, -1, S, D).detach() for x in (q, k, v, do))
    for x in (qs, ks, vs):
        x.requires_grad_(True)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qs, ks, vs), dos)

    lib_ms = cuda_ms(torch, sdpa_fwd_bwd, flush) - cuda_ms(torch, sdpa_fwd, flush)
    pairs = S * (S + 1) // 2 * B * H  # allowed (q, k) pairs, causal
    io = 2 * D * S * (2 * B * H + 2 * B * K) + 2 * 4 * B * H * S  # q,do,k,v + lse,delta
    dq_flops, dkv_flops = 6.0 * D * pairs, 8.0 * D * pairs
    dq_bound = bound(dq_flops, io + 2 * D * S * B * H)
    dkv_bound = bound(dkv_flops, io + 2 * 2 * D * S * B * K)
    return {"phase": "flash_bwd", "shape": {"B": B, "S": S, "H": H, "K": K, "D": D},
            "tolerance": tol, "max_abs_err": errs, "routes": routes,
            "deterministic": deterministic, "tc_resources": resources,
            "dq": {"kernel_ms": dq_ms, "tflops": dq_flops / dq_ms / 1e9,
                   "simt_bf16_ms": simt_dq_ms, "plain_ms": dq_plain,
                   "bound_ms": dq_bound[0], "bound_by": dq_bound[1]},
            "dkv": {"kernel_ms": dkv_ms, "tflops": dkv_flops / dkv_ms / 1e9,
                    "simt_bf16_ms": simt_dkv_ms, "plain_ms": dkv_plain,
                    "bound_ms": dkv_bound[0], "bound_by": dkv_bound[1]},
            "library_ms_sdpa_bwd": lib_ms}


def _simt_bwd_calls(torch, flash, args, kw):
    """The CUDA-core dQ and dK/dV kernels on bf16 inputs that the route
    rule sends to the tensor cores: launched through the C entry points
    directly, for a timing beside the tensor-core kernels in the same run
    (not counted: no path launches them this way)."""
    import ctypes

    q, k, v, do, lse, delta = args
    lib = flash._bwd_lib()
    _, dtype, *scalars = flash._launch_args("flash_bwd", args, q_offset=0, k_offset=0, **kw)
    ptrs = [t.data_ptr() for t in args]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def dq_call():
        flash._native.check(lib.tk_flash_dq(*ptrs, dq.data_ptr(), dtype, q.shape[0],
                                            *scalars, stream), "simt dq")

    def dkv_call():
        flash._native.check(lib.tk_flash_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), dtype,
                                             k.shape[0], *scalars, stream), "simt dkv")

    return dq_call, dkv_call


KV_TOL = {"bf16": 3e-2, "f32": 1e-4}


def _kv_errs(torch, kernel, plain, make_q, what: str) -> dict:
    """The kernel against its plain version on the same inputs, bf16 and
    f32 q (``make_q(dtype)``): max |difference| of each, within KV_TOL."""
    row = {}
    for dtype, dn in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q = make_q(dtype)
        got, ref = kernel(q), plain(q)
        torch.cuda.synchronize()
        err = max_err(torch, got, ref)
        if not (err <= KV_TOL[dn] and torch.isfinite(got.float()).all()):
            raise AssertionError(f"{what} {dn}: err {err}")
        row[dn] = err
    return row


@contextlib.contextmanager
def _span(kvattn, span):
    """Force the span length of the split reads (None: the planner's)."""
    kvattn._forced_span = span
    try:
        yield
    finally:
        kvattn._forced_span = None


def _kv_bitwise(torch, kvattn, call, what: str) -> dict:
    """Two launches bitwise equal; one launch on each of two side streams,
    queued together, each stream with its own merge counter buffer, bitwise
    equal to them; every counter buffer back at zero afterwards. Run where
    the read splits (n_split > 1), so that the merge runs."""
    a, b = call(), call()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(s1):
        c = call()
    with torch.cuda.stream(s2):
        d = call()
    torch.cuda.synchronize()
    dev = torch.cuda.current_device()
    res = {"two_launches_equal": torch.equal(a, b),
           "two_streams_equal": torch.equal(a, c) and torch.equal(a, d),
           "own_counter_per_stream": {(dev, s1.cuda_stream), (dev, s2.cuda_stream)}
           <= set(kvattn._counters),
           "counters_zero_after": all(int(t.count_nonzero()) == 0
                                      for t in kvattn._counters.values())}
    if not all(res.values()):
        raise AssertionError(f"{what}: {res}")
    return res


def _kv_times(torch, kvattn, kernel, plain, flush, m_len: int, sweep=()) -> dict:
    """The kernel at the planner's split, forced to one span (the old
    single-block schedule) and to each span length of ``sweep``, and the
    plain version, on the same inputs."""
    row = {"kernel_ms": cuda_ms(torch, kernel, flush)}
    for key, span in (("one_span_ms", m_len), *((f"span{L}_ms", L) for L in sweep)):
        with _span(kvattn, span):
            row[key] = cuda_ms(torch, kernel, flush)
    row["plain_ms"] = cuda_ms(torch, plain, flush)
    return row


def _kv_bound(torch, pos, K: int, REP: int, DH: int, extra_bytes: int = 0):
    """(bound ms, by) of one read: the positions this run's watermarks need,
    K and V rows with their scales, q and the output in bf16, pos."""
    B = pos.shape[0]
    n_read = int((pos.long() + 1).sum())
    nbytes = n_read * K * 2 * (DH + 4) + 2 * (2 * B * K * REP * DH) + 4 * B + extra_bytes
    return bound(4.0 * n_read * K * REP * DH, nbytes)


def _spans(row: dict) -> dict:
    """The forced span lengths' times of a timed row: {"64": ms, ...}."""
    return {key[4:-3]: v for key, v in row.items() if key.startswith("span") and key.endswith("_ms")}


def check_i8_convert(torch, kvattn) -> dict:
    """The kernels' int8 -> f32 and -> bf16 conversion run on the card for
    all 256 int8 values, against the exact (float)x."""
    f32, b16 = kvattn.i8_convert_table()
    want = torch.arange(-128, 128, device="cuda").to(torch.int8).float()
    ok = {"f32": torch.equal(f32, want), "bf16": torch.equal(b16.float(), want)}
    if not all(ok.values()):
        raise AssertionError(f"int8 conversion not exact: {ok}")
    return {"values": 256, "exact": ok}


SPAN_SWEEP = (64, 128, 256)  # span lengths timed beside the planner's


def _edge_pos(torch, M: int, L: int):
    """16 watermarks at span and tile edges: 0 (one position), L-1, L,
    L+1, 2L-1, 2L, 2L+1, 63, 64, 65, 127, 128, 129, M/2, M-2 and M-1,
    clamped into the pool."""
    edges = (0, L - 1, L, L + 1, 2 * L - 1, 2 * L, 2 * L + 1, 63, 64, 65, 127, 128, 129,
             M // 2, M - 2, M - 1)
    return torch.tensor([min(p, M - 1) for p in edges], dtype=torch.int32, device="cuda")


def check_kvattn(torch, kvattn, flush, gen) -> dict:
    """K4 against its plain version at the 1b decode shape (B=16, K=8,
    rep=2, Dh=128) with pools of 192 (the serve phase's) and 2048, at the
    serving watermarks and at span edges; rep 1, 4 (the 8b decode shape)
    and 8 at a pool of 192; two launches and two streams bitwise; the
    kernel's registers and spills; timings at the planner's split and at
    one span."""
    B, K, REP, DH = 16, 8, 2, 128
    out = {"phase": "kvattn_dynlen", "shape": {"B": B, "K": K, "rep": REP, "Dh": DH},
           "tolerance": KV_TOL, "pools": {}, "reps": {},
           "i8_convert": check_i8_convert(torch, kvattn)}
    # What cuda_ms gives a one-element add: the launch in every event time.
    one = torch.zeros(1, device="cuda")
    out["event_floor_ms"] = cuda_ms(torch, lambda: one.add_(1), flush)
    attrs = {f"rep{r}": kvattn.dynlen_attrs(torch.bfloat16, r) for r in (2, 8)}
    attrs["rep8_f32"] = kvattn.dynlen_attrs(torch.float32, 8)
    if any(a["local_bytes"] for a in attrs.values()):
        raise AssertionError(f"kvattn_dynlen spills: {attrs}")
    out["attrs"] = attrs

    def pool(M):
        kq, vq = (torch.randint(-127, 127, (B, K, M, DH), generator=gen,
                                device="cuda", dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((B, K, M), generator=gen, device="cuda") * 0.02 + 1e-3
                  for _ in range(2))
        return kq, ks, vq, vs

    def make_q(rep):
        return lambda dtype: torch.randn((B, 1, K * rep, DH), generator=gen,
                                         device="cuda").to(dtype)

    def case(kv, pos, rep, what):
        return _kv_errs(torch, lambda q: kvattn.int8_decode_attention_dynlen(q, *kv, pos),
                        lambda q: kvattn.int8_decode_attention_plain(q, *kv, pos),
                        make_q(rep), what)

    for M in (192, 2048):
        L, n_split = kvattn._split_plan(M)
        base = [0, 63, 64, 127, 128, M // 2 + 5, M - 2, M - 1]
        pos = torch.tensor((base * 2)[:B], dtype=torch.int32, device="cuda")
        kv = pool(M)
        row = {"L": L, "n_split": n_split, "watermarks": pos.tolist(),
               "max_abs_err": case(kv, pos, REP, f"kvattn M={M}"), "split": {}}
        # The planner's spans and, where it does not split, forced spans of
        # 64: the merge at this pool's span edges.
        q = make_q(REP)(torch.bfloat16)
        for span in ((None, 64) if n_split == 1 else (None,)):
            with _span(kvattn, span):
                Ls, ns = kvattn._split_plan(M, span=span)
                edges = _edge_pos(torch, M, Ls)
                row["split"][f"L{Ls}"] = {
                    "L": Ls, "n_split": ns, "edge_watermarks": edges.tolist(),
                    "edge_max_abs_err": case(kv, edges, REP, f"kvattn M={M} L={Ls} edges")}
                if ns > 1:
                    row["split"][f"L{Ls}"]["bitwise"] = _kv_bitwise(
                        torch, kvattn, lambda: kvattn.int8_decode_attention_dynlen(q, *kv, pos),
                        f"kvattn M={M} L={Ls}")
        row.update(_kv_times(torch, kvattn,
                             lambda: kvattn.int8_decode_attention_dynlen(q, *kv, pos),
                             lambda: kvattn.int8_decode_attention_plain(q, *kv, pos), flush,
                             M, [x for x in SPAN_SWEEP if x < M]))
        row["bound_ms"], row["bound_by"] = _kv_bound(torch, pos, K, REP, DH)
        row["library_ms"] = None
        out["pools"][str(M)] = row
        if M == 192:
            edges = _edge_pos(torch, M, 64)
            for rep in (1, 4, 8):
                r = {"L": L, "n_split": n_split,
                     "max_abs_err": case(kv, pos, rep, f"kvattn rep={rep}"),
                     "edge_max_abs_err": case(kv, edges, rep, f"kvattn rep={rep} edges")}
                with _span(kvattn, 64):
                    r["span64_edge_max_abs_err"] = case(kv, edges, rep,
                                                        f"kvattn rep={rep} L=64 edges")
                q = make_q(rep)(torch.bfloat16)
                r.update(_kv_times(
                    torch, kvattn, lambda: kvattn.int8_decode_attention_dynlen(q, *kv, pos),
                    lambda: kvattn.int8_decode_attention_plain(q, *kv, pos), flush, M, (64,)))
                r["bound_ms"], r["bound_by"] = _kv_bound(torch, pos, K, rep, DH)
                out["reps"][str(rep)] = r
    return out


def paged_case(np, B: int, M: int, bs: int, rng):
    """Block tables for B slots over logical views of M positions: slots
    0..B/2-1 share one prefix run of blocks and the rest share another
    (the radix shape), every other block is private, entries past a slot's
    watermark point at the sink (block 0), and a few garbage blocks stay
    unreferenced. Returns (table [B, nblk] int32, pos [B] int32, NB)."""
    nblk = M // bs
    shared = max(1, nblk // 4)
    n_priv = B * (nblk - shared)
    nb = 1 + 2 * shared + n_priv + 8  # + sink and 8 garbage blocks
    ids = rng.permutation(np.arange(1, nb)).astype(np.int32)
    prefix = (ids[:shared], ids[shared:2 * shared])
    priv = ids[2 * shared:2 * shared + n_priv].reshape(B, nblk - shared)
    table = np.concatenate(
        [np.stack([prefix[b >= B // 2] for b in range(B)]), priv], axis=1)
    base = [0, 63, 64, 127, 128, M // 2 + 5, M - 2, M - 1]
    pos = np.asarray((base * 2)[:B], np.int32)
    live = np.arange(nblk)[None, :] <= (pos // bs)[:, None]
    table = np.where(live, table, 0).astype(np.int32)
    return table, pos, nb


def check_kvattn_paged(torch, kvattn, flush, gen) -> dict:
    """K5 against its plain version at the 1b decode shape (B=16, K=8,
    rep=2, Dh=128), block size 16, logical views of 192 (the serve_paged
    phase's) and 2048 positions, at the serving watermarks and at span
    edges; block sizes 16, 32 and 64 at the 192 view with table entries
    outside [0, NB) past the live range (the reference reads the clamped
    table, as the kernel does); two launches and two streams bitwise; the
    kernel's registers and spills; timings at the planner's split and at
    one span, and K4's time on the same fills laid out dense as context."""
    import numpy as np

    B, K, REP, DH, BS = 16, 8, 2, 128, 16
    out = {"phase": "kvattn_paged", "shape": {"B": B, "K": K, "rep": REP, "Dh": DH,
                                              "bs": BS},
           "tolerance": KV_TOL, "views": {}, "block_sizes": {}}
    attrs = {f"rep{r}": kvattn.paged_attrs(torch.bfloat16, r) for r in (2, 8)}
    attrs["rep8_f32"] = kvattn.paged_attrs(torch.float32, 8)
    if any(a["local_bytes"] for a in attrs.values()):
        raise AssertionError(f"kvattn_paged spills: {attrs}")
    out["attrs"] = attrs
    rng = np.random.default_rng(SEED + 5)

    def make_q(dtype):
        return torch.randn((B, 1, K * REP, DH), generator=gen, device="cuda").to(dtype)

    def pools(nb, bs):
        kq, vq = (torch.randint(-127, 127, (nb, K, bs, DH), generator=gen,
                                device="cuda", dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((nb, K, bs), generator=gen, device="cuda") * 0.02 + 1e-3
                  for _ in range(2))
        return kq, ks, vq, vs

    def case(kv, table, pos, what, ref_table=None):
        ref_table = table if ref_table is None else ref_table
        return _kv_errs(
            torch, lambda q: kvattn.int8_paged_decode_attention(q, *kv, table, pos),
            lambda q: kvattn.int8_paged_decode_attention_plain(q, *kv, ref_table, pos),
            make_q, what)

    for M in (192, 2048):
        L, n_split = kvattn._split_plan(M, BS)
        table_np, pos_np, NB = paged_case(np, B, M, BS, rng)
        table = torch.from_numpy(table_np).cuda()
        pos = torch.from_numpy(pos_np).cuda()
        kv = pools(NB, BS)
        # The edge watermarks on the same pool: every table entry live.
        full = torch.from_numpy(paged_case(np, B, M, BS, rng)[0]).cuda()
        full = torch.where(full == 0, torch.randint(1, NB, full.shape, generator=gen,
                                                    device="cuda", dtype=torch.int32), full)
        row = {"L": L, "n_split": n_split, "watermarks": pos_np.tolist(), "pool_blocks": NB,
               "max_abs_err": case(kv, table, pos, f"kvattn_paged M={M}"), "split": {}}
        q = make_q(torch.bfloat16)
        for span in ((None, 64) if n_split == 1 else (None,)):
            with _span(kvattn, span):
                Ls, ns = kvattn._split_plan(M, BS, span=span)
                edges = _edge_pos(torch, M, Ls)
                row["split"][f"L{Ls}"] = {
                    "L": Ls, "n_split": ns, "edge_watermarks": edges.tolist(),
                    "edge_max_abs_err": case(kv, full, edges, f"kvattn_paged M={M} L={Ls} edges")}
                if ns > 1:
                    row["split"][f"L{Ls}"]["bitwise"] = _kv_bitwise(
                        torch, kvattn,
                        lambda: kvattn.int8_paged_decode_attention(q, *kv, table, pos),
                        f"kvattn_paged M={M} L={Ls}")
        row.update(_kv_times(
            torch, kvattn, lambda: kvattn.int8_paged_decode_attention(q, *kv, table, pos),
            lambda: kvattn.int8_paged_decode_attention_plain(q, *kv, table, pos), flush,
            M, [x for x in SPAN_SWEEP if x < M]))
        # K4 on the same fills, laid out dense K-major [B, K, M, Dh].
        dense = [kvattn.paged_gather_kmajor(t, table).transpose(1, 2).contiguous()
                 for t in kv]
        row["k4_dense_same_fill_ms"] = cuda_ms(
            torch, lambda: kvattn.int8_decode_attention_dynlen(q, *dense, pos), flush)
        n_ent = int(((pos.long() + BS) // BS).sum())  # table entries it reads
        row["bound_ms"], row["bound_by"] = _kv_bound(torch, pos, K, REP, DH, 4 * n_ent)
        row["library_ms"] = None
        out["views"][str(M)] = row

    M = 192
    for bs in (16, 32, 64):
        L, n_split = kvattn._split_plan(M, bs)
        table_np, pos_np, NB = paged_case(np, B, M, bs, rng)
        # Entries past the live range outside [0, NB): clamped, never read.
        table_np[0, -1], table_np[1, -1] = NB + 7, -3
        table = torch.from_numpy(table_np).cuda()
        pos = torch.from_numpy(pos_np).cuda()
        kv = pools(NB, bs)
        clamped = table.clamp(0, NB - 1)
        row = {"L": L, "n_split": n_split, "pool_blocks": NB,
               "max_abs_err": case(kv, table, pos, f"kvattn_paged bs={bs}", clamped)}
        with _span(kvattn, 64):
            row["span64_max_abs_err"] = case(kv, table, pos, f"kvattn_paged bs={bs} L=64",
                                             clamped)
        q = make_q(torch.bfloat16)
        row.update(_kv_times(
            torch, kvattn, lambda: kvattn.int8_paged_decode_attention(q, *kv, table, pos),
            lambda: kvattn.int8_paged_decode_attention_plain(q, *kv, clamped, pos), flush,
            M, (64,)))
        n_ent = int(((pos.long() + bs) // bs).sum())
        row["bound_ms"], row["bound_by"] = _kv_bound(torch, pos, K, REP, DH, 4 * n_ent)
        out["block_sizes"][str(bs)] = row
    return out


def _library_int8_mm(torch, x, q, scale):
    """The library yardstick for one int8 weight matmul: PyTorch's
    ``_weight_int8pack_mm`` (q as [N, K], scales [N] in x's dtype) where
    this build has a CUDA implementation of it, else ``x @ load_weight(q)``
    (the dequantized bf16 matmul). Returns (label, zero-argument call);
    the operands are prepared here, outside any timed region."""
    from torchkafka_tpu_torch.models.quant import QTensor, load_weight

    qt, st = q.t().contiguous(), scale.reshape(-1).to(x.dtype)
    if hasattr(torch, "_weight_int8pack_mm"):
        try:  # a feature probe: does this build run it on the card?
            torch._weight_int8pack_mm(x[:1], qt, st)
            torch.cuda.synchronize()
            return "torch._weight_int8pack_mm", lambda: torch._weight_int8pack_mm(x, qt, st)
        except (RuntimeError, NotImplementedError):
            pass
    w = QTensor(q, scale)
    return "x @ load_weight(q)", lambda: x @ load_weight(w, x.dtype)


def check_qmatmul(torch, kvattn, flush, gen) -> dict:
    """K6 against its plain version on int8 weights drawn by the zoo
    (``_rand_q``) at the 8b shapes: 16 decode rows on w_gate, w_down and
    lm_head, 2048 prefill rows (16 × 128) on w_gate and w_down, and on
    w_gate 8, 24, 64 and 200 rows (200: a ragged last tile); x bf16 (the
    tensor-core kernel), and f32 on w_gate's decode rows (the CUDA-core
    kernel). Every shape tiles, so every call must launch a kernel, by the
    route ``_route`` names; each case prints its route and plan. Where the
    plan splits K, two launches and two streams bitwise equal. The
    tensor-core kernel's int8 conversion exact for all 256 values, its
    registers and spill bytes (0 required). At the 8b shapes, timings of
    the tensor-core kernel beside the CUDA-core kernel on the same bf16
    inputs, the plain version, ``torch._weight_int8pack_mm``, forced
    splits of 1, 2, 4, 8 and 16 (decode rows), the bound, TFLOP/s and
    GB/s; at 2048 rows, how many outputs a sequential f32 GEMM puts
    outside the tolerance of the plain version's exact f32 sum."""
    from torchkafka_tpu_torch.models.quant import QTensor, load_weight
    from torchkafka_tpu_torch.models.zoo import _rand_q
    from torchkafka_tpu_torch.ops import qmatmul as qmm

    quantized_matmul, plain = qmm.quantized_matmul, qmm.quantized_matmul_plain
    # bf16: one bf16 ulp of the plain value (the plain version rounds the
    # exact sum once to f32, the kernel's f32 sums differ from it by their
    # own rounding, so the two bf16 roundings land at most one step apart);
    # f32: the f32 sum order over up to 14,336 terms, on outputs of unit
    # scale.
    tol = {"bf16_ulp_rel": 2.0 ** -7, "f32_abs": 1e-4}
    shapes = {"w_gate": (4096, 14336), "w_down": (14336, 4096), "lm_head": (4096, 128256)}
    weights = {nm: _rand_q(gen, s, (0,), "cuda") for nm, s in shapes.items()}
    bf16 = torch.bfloat16
    timed = {("w_gate", 16), ("w_down", 16), ("lm_head", 16), ("w_gate", 2048),
             ("w_down", 2048)}
    cases = [("w_gate", 16, bf16), ("w_down", 16, bf16), ("lm_head", 16, bf16),
             ("w_gate", 2048, bf16), ("w_gate", 16, torch.float32),
             ("w_gate", 8, bf16), ("w_gate", 24, bf16), ("w_gate", 64, bf16),
             ("w_gate", 200, bf16), ("w_down", 2048, bf16)]
    table = qmm.i8_convert_table()
    want = torch.arange(256, dtype=torch.int32, device="cuda").to(torch.uint8).view(
        torch.int8).to(bf16)
    if not torch.equal(table.view(torch.int16), want.view(torch.int16)):
        raise AssertionError("qmatmul: the int8 -> bf16 conversion is not exact")
    attrs = {f"bm{bm}": qmm.tc_attrs(bm) for bm in (16, 32, 64, 128)}
    if any(a["local_bytes"] for a in attrs.values()):
        raise AssertionError(f"qmatmul: the tensor-core kernel spills {attrs}")
    out = {"phase": "qmatmul", "tolerance": tol, "i8_convert_exact": True,
           "tc_resources": attrs, "cases": {}}
    quantized_matmul.launches = quantized_matmul.tc_launches = 0
    inputs = {}
    for name, m, dtype in cases:  # one counted call a case: the checks
        w = weights[name]
        k, n = shapes[name]
        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        inputs[(name, m, dtype)] = x
        before = (quantized_matmul.launches, quantized_matmul.tc_launches)
        got = quantized_matmul(x, w.q, w.scale)
        route = qmm._route(dtype, k, n)
        after = (quantized_matmul.launches, quantized_matmul.tc_launches)
        if after != (before[0] + 1, before[1] + (route == "tc")):
            raise AssertionError(f"qmatmul {name} M={m}: launches {before} -> {after}, "
                                 f"route {route}")
        ref = plain(x, w.q, w.scale)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if dtype == bf16:
            ok = bool((err <= tol["bf16_ulp_rel"] * ref.float().abs() + 1e-6).all())
        else:
            ok = float(err.max()) <= tol["f32_abs"]
        if not (ok and torch.isfinite(got.float()).all() and got.shape == (m, n)):
            raise AssertionError(f"qmatmul {name} M={m} {dtype}: max err {float(err.max())}")
        row = {"shape": {"M": m, "K": k, "N": n}, "route": route,
               "max_abs_err": float(err.max())}
        if route == "tc":
            bm, bn, bk, n_split = qmm._qmm_plan(m, k, n)
            row["plan"] = {"BM": bm, "BN": bn, "BK": bk, "n_split": n_split,
                           "split_rows": qmm._split_rows(k, bk, n_split)}
        out["cases"][f"{name}_m{m}_{str(dtype).replace('torch.', '')}"] = row
    bf16_calls = sum(dtype == bf16 for _, _, dtype in cases)
    out["launches"] = quantized_matmul.launches
    out["tc_launches"] = quantized_matmul.tc_launches
    out["bf16_calls"] = bf16_calls
    if (out["launches"], out["tc_launches"]) != (len(cases), bf16_calls):
        raise AssertionError(f"qmatmul: {out['launches']} launches, {out['tc_launches']} "
                             f"on the tensor cores, for {len(cases)} calls, {bf16_calls} bf16")

    for (name, m, dtype), x in inputs.items():  # bitwise repeats and timings
        w = weights[name]
        k, n = shapes[name]
        row = out["cases"][f"{name}_m{m}_{str(dtype).replace('torch.', '')}"]
        call = lambda: quantized_matmul(x, w.q, w.scale)  # noqa: E731
        if row.get("plan", {}).get("n_split", 1) > 1:
            row["bitwise"] = _kv_bitwise(torch, kvattn, call, f"qmatmul {name} M={m}")
        if (name, m) not in timed or dtype != bf16:
            continue
        row["kernel_ms"] = cuda_ms(torch, call, flush)
        # The CUDA-core kernel on the same bf16 inputs, launched uncounted
        # through the wrapper's own launcher (no path runs it on bf16).
        simt_out = torch.empty((m, n), dtype=bf16, device="cuda")
        scale32 = w.scale.reshape(-1).float().contiguous()
        row["simt_bf16_ms"] = cuda_ms(torch, lambda: qmm._native.check(
            qmm._launch("simt", x, w.q, scale32, simt_out), "simt qmatmul"), flush)
        if m <= 64:  # forced split counts beside the plan's
            row["split_ms"] = {}
            try:
                for ns in (1, 2, 4, 8, 16):
                    qmm._forced_split = ns
                    row["split_ms"][str(ns)] = cuda_ms(torch, call, flush)
            finally:
                qmm._forced_split = None
        row["plain_ms"] = cuda_ms(torch, lambda: plain(x, w.q, w.scale), flush, n=5)
        lib, lib_fn = _library_int8_mm(torch, x, w.q, w.scale)
        row["library"] = lib
        row["library_ms"] = cuda_ms(torch, lib_fn, flush, n=5 if m > 64 else 25)
        nbytes = k * n + 2 * m * k + 2 * m * n + 4 * n
        flops = 2.0 * m * k * n
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
        row["tflops"] = flops / row["kernel_ms"] / 1e9
        row["gb_per_s"] = nbytes / row["kernel_ms"] / 1e6
        row["tc_faster_than_simt"] = row["kernel_ms"] < row["simt_bf16_ms"]
        if m > 64:  # why the plain version sums bf16 x in f64
            ref = plain(x, w.q, w.scale).float()
            f32_gemm = ((x.float() @ w.q.float()) * w.scale.float()).to(bf16).float()
            row["f32_gemm_outputs_off_plain"] = int(
                ((f32_gemm - ref).abs() > tol["bf16_ulp_rel"] * ref.abs() + 1e-6).sum())
            del ref, f32_gemm
        # For information only, NOT K6's function (a bf16 weight rounded
        # from q·scale, twice the bytes): the dense bf16 GEMM on a weight
        # dequantised beforehand.
        wd = load_weight(QTensor(w.q, w.scale), bf16)
        row["info_dense_bf16_matmul_ms_not_k6"] = cuda_ms(torch, lambda: x @ wd, flush)
        del wd
    return out


def check_kvattn_full(torch, kvattn, flush, gen) -> dict:
    """K7 (K-major) and K8 (M-major) against their plain version at the 8b
    decode shape (B=16, K=8, rep=4, Dh=128), pools of 192 and 2048, each
    pool's L and n_split, at the planner's split and, where it keeps one
    span, under forced spans of 64 (the merge at this pool). Prefix masks
    from ``check_kvattn``'s watermarks: K7, K8 on the transposed pool, K4
    and the plain version agree with each other, and K7 against K4 at the
    same span (the difference, and whether it is bitwise). Masks with
    holes, one all-false row and one row whose only readable position is
    the pool's last: K7 and K8 against the plain version. Where the read
    splits, two launches and two streams bitwise for K7 and K8. Registers
    and spills at rep 4 and 8 (0 required); timings at the planner's
    split, one span and spans of 64/128/256/512, beside the plain version,
    K4 reading every position on the same spans, and K7 at rep 1/2/4/8."""
    B, K, REP, DH = 16, 8, 4, 128
    out = {"phase": "kvattn_full", "shape": {"B": B, "K": K, "rep": REP, "Dh": DH},
           "tolerance": KV_TOL, "pools": {}}
    attrs = {}
    for kmajor, name in ((True, "k7"), (False, "k8")):
        for rep in (4, 8):
            attrs[f"{name}_rep{rep}"] = kvattn.full_attrs(torch.bfloat16, rep, kmajor)
        attrs[f"{name}_rep8_f32"] = kvattn.full_attrs(torch.float32, 8, kmajor)
    if any(a["local_bytes"] for a in attrs.values()):
        raise AssertionError(f"kvattn_full spills: {attrs}")
    out["attrs"] = attrs
    kvattn.int8_decode_attention_kmajor.launches = 0
    kvattn.int8_decode_attention.launches = 0
    for M in (192, 2048):
        L, n_split = kvattn._split_plan(M, max_split=kvattn._MAX_SPLIT_FULL)
        base = [0, 63, 64, 127, 128, M // 2 + 5, M - 2, M - 1]
        pos = torch.tensor((base * 2)[:B], dtype=torch.int32, device="cuda")
        kq, vq = (torch.randint(-127, 127, (B, K, M, DH), generator=gen,
                                device="cuda", dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((B, K, M), generator=gen, device="cuda") * 0.02 + 1e-3
                  for _ in range(2))
        km = (kq, ks, vq, vs)
        mm = tuple(t.transpose(1, 2).contiguous() for t in km)  # M-major copies
        prefix = torch.arange(M, device="cuda")[None, :] <= pos[:, None].long()
        holes = torch.rand((B, M), generator=gen, device="cuda") < 0.6
        holes[3] = False  # an all-false row: the uniform average over all M
        holes[5] = False
        holes[5, M - 1] = True  # the only readable position in the last span
        row = {"L": L, "n_split": n_split, "watermarks": pos.tolist(), "split": {}}
        # The planner's spans and, where it keeps one span, forced spans of
        # 64. Each is forced on K4 as well, so that K7 and K4 split alike.
        for Ls in ((L, 64) if n_split == 1 else (L,)):
            with _span(kvattn, Ls):
                ns = kvattn._split_plan(M, span=Ls)[1]
                errs_by, k7_k4 = {}, {}
                for dtype, dn in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                    q = torch.randn((B, 1, K * REP, DH), generator=gen, device="cuda").to(dtype)
                    k7 = kvattn.int8_decode_attention_kmajor(q, *km, prefix)
                    k8 = kvattn.int8_decode_attention(q, *mm, prefix)
                    k4 = kvattn.int8_decode_attention_dynlen(q, *km, pos)
                    ref = kvattn.int8_decode_attention_kmajor_plain(q, *km, prefix)
                    h7 = kvattn.int8_decode_attention_kmajor(q, *km, holes)
                    h8 = kvattn.int8_decode_attention(q, *mm, holes)
                    href = kvattn.int8_decode_attention_mmajor_plain(q, *mm, holes)
                    torch.cuda.synchronize()
                    errs = {"k7_vs_plain": max_err(torch, k7, ref),
                            "k8_vs_plain": max_err(torch, k8, ref),
                            "k4_vs_plain": max_err(torch, k4, ref),
                            "k7_vs_k8": max_err(torch, k7, k8),
                            "k7_vs_k4": max_err(torch, k7, k4),
                            "holes_k7_vs_plain": max_err(torch, h7, href),
                            "holes_k8_vs_plain": max_err(torch, h8, href)}
                    finite = all(torch.isfinite(t.float()).all() for t in (k7, k8, h7, h8))
                    if not (finite and max(errs.values()) <= KV_TOL[dn]):
                        raise AssertionError(f"kvattn_full M={M} L={Ls} {dn}: {errs}")
                    errs_by[dn] = errs
                    k7_k4[dn] = torch.equal(k7, k4)
                split = {"L": Ls, "n_split": ns, "max_abs_err": errs_by,
                         "k7_bitwise_equals_k4": k7_k4}
                if ns > 1:
                    q = torch.randn((B, 1, K * REP, DH), generator=gen,
                                    device="cuda").to(torch.bfloat16)
                    split["bitwise_k7"] = _kv_bitwise(
                        torch, kvattn,
                        lambda: kvattn.int8_decode_attention_kmajor(q, *km, holes),
                        f"kvattn_full K7 M={M} L={Ls}")
                    split["bitwise_k8"] = _kv_bitwise(
                        torch, kvattn, lambda: kvattn.int8_decode_attention(q, *mm, holes),
                        f"kvattn_full K8 M={M} L={Ls}")
                row["split"][f"L{Ls}"] = split
        row["max_abs_err"] = row["split"][f"L{L}"]["max_abs_err"]
        q = torch.randn((B, 1, K * REP, DH), generator=gen, device="cuda").to(torch.bfloat16)
        sweep = [x for x in (*SPAN_SWEEP, 512) if x < M]
        row["k7"] = _kv_times(
            torch, kvattn, lambda: kvattn.int8_decode_attention_kmajor(q, *km, prefix),
            lambda: kvattn.int8_decode_attention_kmajor_plain(q, *km, prefix), flush, M, sweep)
        row["k8"] = _kv_times(
            torch, kvattn, lambda: kvattn.int8_decode_attention(q, *mm, prefix),
            lambda: kvattn.int8_decode_attention_mmajor_plain(q, *mm, prefix), flush, M, sweep)
        row.update({"k7_ms": row["k7"]["kernel_ms"], "k8_ms": row["k8"]["kernel_ms"],
                    "k4_same_fill_ms": cuda_ms(
                        torch, lambda: kvattn.int8_decode_attention_dynlen(q, *km, pos), flush),
                    "plain_kmajor_ms": row["k7"]["plain_ms"],
                    "plain_mmajor_ms": row["k8"]["plain_ms"]})
        # What the body costs when it reads every position: K4 at watermarks
        # M-1 on K7's spans, and K7 at other q rows per kv head (the bytes
        # stay, the arithmetic scales with rep).
        last = torch.full((B,), M - 1, dtype=torch.int32, device="cuda")
        with _span(kvattn, L):
            row["k4_full_fill_ms"] = cuda_ms(
                torch, lambda: kvattn.int8_decode_attention_dynlen(q, *km, last), flush)
        row["k7_rep_ms"] = {}
        for rep in (1, 2, 4, 8):
            qr = torch.randn((B, 1, K * rep, DH), generator=gen, device="cuda").to(torch.bfloat16)
            row["k7_rep_ms"][str(rep)] = cuda_ms(
                torch, lambda: kvattn.int8_decode_attention_kmajor(qr, *km, prefix), flush)
        # The full pool is read whatever the mask: payloads, scales, the
        # mask, q and the output once each.
        nbytes = B * K * M * 2 * (DH + 4) + B * M + 2 * (2 * B * K * REP * DH)
        row["bound_ms"], row["bound_by"] = bound(4.0 * B * M * K * REP * DH, nbytes)
        row["library_ms"] = None
        out["pools"][str(M)] = row
    out["launches"] = {"kvattn_kmajor": kvattn.int8_decode_attention_kmajor.launches,
                       "kvattn_mmajor": kvattn.int8_decode_attention.launches}
    return out


def train_config(torch, **overrides):
    """The 1b scale for training: the zoo's shapes with f32 master weights
    (its bf16 params are the serving footprint)."""
    from torchkafka_tpu_torch.models.zoo import zoo_config

    return dataclasses.replace(
        zoo_config("1b", max_seq_len=512), param_dtype=torch.float32, **overrides
    )


def check_train_grads(torch) -> dict:
    """One loss + backward at 1b width, 2 layers, S=512, B=2, through the
    flash kernels (K1, K2, K3) and through dense attention, from the same
    f32 master weights: the loss and every gradient must agree. Both run
    the bf16 compute path; the tolerance is a few bf16 roundings (2^-8
    relative each) compounded through two layers. A dense run in f32
    compute is printed beside them, to show how far each bf16 path sits
    from exact arithmetic."""
    import numpy as np

    from torchkafka_tpu_torch.models.transformer import Transformer, init_params

    tol = {"loss_abs": 2e-2, "grad_rel_l2": 2e-2}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    base = init_params(gen, train_config(torch, n_layers=2), device="cuda")
    toks = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, 32_000, (2, 512), dtype=np.int32)).cuda()
    out = {}
    for name, impl, dtype in (("flash", "flash", torch.bfloat16),
                              ("dense", "dense", torch.bfloat16),
                              ("dense_f32", "dense", torch.float32)):
        params = _clone_tree(torch, base)
        cfg = train_config(torch, n_layers=2, attn_impl=impl, dtype=dtype)
        loss = Transformer(cfg).loss(params, toks)
        loss.backward()
        out[name] = (loss.item(), _grads(params))

    def rel_l2(a, b):
        ga, gb = out[a][1], out[b][1]
        return {n: float((ga[n] - gb[n]).norm() / gb[n].norm().clamp_min(1e-30)) for n in gb}

    rel = rel_l2("flash", "dense")
    worst = max(rel, key=rel.get)
    l_f, l_d = out["flash"][0], out["dense"][0]
    if not (abs(l_f - l_d) <= tol["loss_abs"] and rel[worst] <= tol["grad_rel_l2"]
            and np.isfinite(l_f)):
        raise AssertionError(f"train_grad: loss {l_f} vs {l_d}, worst grad {worst} {rel[worst]}")
    return {"phase": "train_grad", "model": "1b width, 2 layers", "B": 2, "S": 512,
            "tolerance": tol, "loss_flash": l_f, "loss_dense": l_d,
            "loss_dense_f32": out["dense_f32"][0], "grad_rel_l2": rel, "worst": worst,
            "worst_vs_f32": {n: max(rel_l2(n, "dense_f32").values())
                             for n in ("flash", "dense")}}


def _clone_tree(torch, tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(torch, v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def _grads(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_grads(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.grad.float()
    return out


def train(torch, steps: int = 6, batch: int = 8, seq: int = 512, parts: int = 4,
          prof=None, cfg=None, phase: str = "train") -> dict:
    """The main training path: broker → MemoryConsumer → KafkaStream
    (fixed_width decode, pinned side-stream H2D) → make_train_step (K1
    forward, fused CE, K2+K3 backward, AdamW) → token.commit(wait_for=loss)
    → consumer.commit. K1/K2/K3 launch counts (and their tensor-core
    counts) are zeroed just before the loop and read just after. ``prof``:
    an optional profiler context wrapped around one extra step after the
    run. ``cfg``: the model (the 1b with f32 masters by default);
    ``phase``: the row's phase name."""
    import numpy as np

    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.ops.flash import flash_dkv_bhsd, flash_dq_bhsd, flash_fwd_bhsd

    cfg = train_config(torch) if cfg is None else cfg
    init_fn, step_fn = tk.make_train_step(cfg, optimizer=tk.adamw(1e-3), device="cuda")
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(t.numel() for t in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "ln_f", "lm_head"))
    broker = tk.InMemoryBroker()
    broker.create_topic("train", partitions=parts)
    rng = np.random.default_rng(SEED)
    for i in range(steps * batch):  # exactly what the steps consume
        toks = rng.integers(0, cfg.vocab_size, seq, dtype=np.int32)
        broker.produce("train", toks.tobytes(), partition=i % parts)
    consumer = tk.MemoryConsumer(
        broker, "train", group_id="train-group",
        assignment=tk.partitions_for_process("train", parts, 0, 1),
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (flash_fwd_bhsd, flash_dq_bhsd, flash_dkv_bhsd):
        fn.launches = 0
        fn.tc_launches = 0
    losses, step_ms, wall_ms = [], [], []
    t0 = time.perf_counter()
    with tk.KafkaStream(consumer, tk.fixed_width(seq, np.int32), batch_size=batch,
                        idle_timeout_ms=2000, owns_consumer=True, device="cuda") as stream:
        it = iter(stream)
        for _ in range(steps):
            b, token = next(it)
            if tuple(b.data.shape) != (batch, seq):
                raise AssertionError(f"batch shape {tuple(b.data.shape)}")
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            s_ev.record()
            params, opt, loss = step_fn(params, opt, b.data, None)
            e_ev.record()
            if not token.commit(wait_for=loss):
                raise AssertionError("offset commit failed")
            wall_ms.append((time.perf_counter() - h0) * 1e3)
            step_ms.append(s_ev.elapsed_time(e_ev))
            losses.append(loss.item())
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {"flash_fwd": flash_fwd_bhsd.launches, "flash_dq": flash_dq_bhsd.launches,
                    "flash_dkv": flash_dkv_bhsd.launches}
        tc_launches = {"flash_fwd": flash_fwd_bhsd.tc_launches,
                       "flash_dq": flash_dq_bhsd.tc_launches,
                       "flash_dkv": flash_dkv_bhsd.tc_launches}
        peak = torch.cuda.max_memory_allocated() / 1e9
        if prof is not None:  # one more step on the last batch, traced
            with prof:
                step_fn(params, opt, b.data, None)
                torch.cuda.synchronize()
    committed = {p: broker.committed("train-group", tk.TopicPartition("train", p))
                 for p in range(parts)}
    if not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss {losses}")
    if not all(o is not None and o > 0 for o in committed.values()):
        raise AssertionError(f"a partition's watermark did not advance: {committed}")
    if sum(committed.values()) != steps * batch:
        raise AssertionError(f"Σ watermarks {committed} != {steps * batch} rows consumed")
    want = cfg.n_layers * steps
    if any(n != want for n in launches.values()):
        raise AssertionError(f"launches {launches}, want {want} each")
    if any(n != want for n in tc_launches.values()):  # bf16, D=128: the tensor cores
        raise AssertionError(f"tensor-core launches {tc_launches}, want {want} each")
    steady = statistics.median(step_ms[1:])
    return {"phase": phase, "model": "1b", "layers": cfg.n_layers,
            "n_experts": cfg.n_experts, "moe_dispatch": cfg.moe_dispatch if cfg.is_moe else None,
            "params": n_params,
            "param_dtype": "float32", "compute_dtype": "bfloat16",
            "batch": batch, "seq": seq, "steps": steps, "losses": losses,
            "step_ms": step_ms, "step_ms_median_after_first": steady,
            "host_step_wall_ms": wall_ms,
            "trained_tokens_per_s": batch * seq / (steady / 1e3),
            "records_per_s_loop": steps * batch / elapsed, "loop_s": elapsed,
            "committed": committed, "launches": launches, "tc_launches": tc_launches,
            "peak_mem_gb": peak}


def serve(torch, cfg, params, prompts, kv_dtype, prof=None, tracer=None, on_done=None,
          server_cls=None, **server_kw):
    """Serve ``prompts`` once through the port's StreamingGenerator (or
    ``server_cls``, with ``server_kw`` over the defaults: 16 slots,
    ``MAX_NEW`` - 1 ticks a block); the kernel launch counts are zeroed
    just before ``run`` and read after. ``prof``: an optional profiler
    context wrapped around ``run``; ``tracer``: the server's
    ``obs.RecordTracer``; ``on_done(server)`` is called after the run.
    Hard checks: every record once with ``MAX_NEW`` tokens, committed ==
    end offsets, K1 = (layers + draft layers) x prefills on the dense
    pool (0 on a paged one), all on the tensor cores in bf16, K4 = layers
    x decode ticks on the int8 pool (0 otherwise)."""
    from torchkafka_tpu_torch.ops.flash import flash_fwd_bhsd
    from torchkafka_tpu_torch.ops.kvattn import (
        int8_decode_attention_dynlen,
        int8_paged_decode_attention,
    )
    from torchkafka_tpu_torch.serve import StreamingGenerator
    from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer
    from torchkafka_tpu_torch.source.records import TopicPartition

    n, plen = prompts.shape
    broker = InMemoryBroker()
    broker.create_topic("t7", partitions=2)
    for i in range(n):
        broker.produce("t7", prompts[i].tobytes(), partition=i % 2)
    consumer = MemoryConsumer(broker, "t7", group_id="s7")
    max_new = MAX_NEW
    kw = dict(slots=16, prompt_len=plen, max_new=max_new, commit_every=16,
              ticks_per_sync=max_new - 1, kv_dtype=kv_dtype,
              kv_kernel=True if kv_dtype else "auto", tracer=tracer, device="cuda")
    server = (server_cls or StreamingGenerator)(consumer, params, cfg, **{**kw, **server_kw})
    server.warmup()
    torch.cuda.reset_peak_memory_stats()
    kernels = (flash_fwd_bhsd, int8_decode_attention_dynlen, int8_paged_decode_attention)
    for fn in kernels:
        fn.launches = 0
    flash_fwd_bhsd.tc_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        outs = {(r.partition, r.offset): out for r, out in server.run(max_records=n)}
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"flash_fwd": flash_fwd_bhsd.launches,
                "flash_fwd_tc": flash_fwd_bhsd.tc_launches,
                "kvattn_dynlen": int8_decode_attention_dynlen.launches,
                "kvattn_paged": int8_paged_decode_attention.launches}
    consumer.close()
    if on_done is not None:
        on_done(server)
    tps = [TopicPartition("t7", p) for p in (0, 1)]
    committed = [broker.committed("s7", tp) for tp in tps]
    ends = [broker.end_offset(tp) for tp in tps]
    m = server.metrics.summary()
    if len(outs) != n or any(len(o) != max_new for o in outs.values()):
        raise AssertionError(f"{len(outs)} completions, lengths {sorted({len(o) for o in outs.values()})}")
    if committed != ends:
        raise AssertionError(f"committed {committed} != end offsets {ends}")
    if any(int(o.min()) < 0 or int(o.max()) >= cfg.vocab_size for o in outs.values()):
        raise AssertionError("token out of the vocabulary")
    nl = cfg.n_layers
    draft_cfg = getattr(server, "_draft_cfg", None)
    k1_layers = nl + (draft_cfg.n_layers if draft_cfg is not None else 0)
    paged = server._kv_pages is not None
    if paged:
        if launches["flash_fwd"]:
            raise AssertionError(f"flash launches {launches} on the paged pool")
    elif launches["flash_fwd"] != k1_layers * m["prefills"] or m["prefills"] == 0:
        raise AssertionError(f"flash launches {launches} vs {m['prefills']} prefills")
    if (cfg.dtype == torch.bfloat16  # bf16, D=128: the tensor cores
            and launches["flash_fwd_tc"] != launches["flash_fwd"]):
        raise AssertionError(f"flash tensor-core launches {launches}")
    want_k4 = nl * m["decode_ticks"] if kv_dtype else 0
    if launches["kvattn_dynlen"] != want_k4 or (kv_dtype and want_k4 == 0):
        raise AssertionError(f"kvattn launches {launches} vs {m['decode_ticks']} ticks")
    if launches["kvattn_paged"]:
        raise AssertionError(f"K5 launched {launches}")
    tokens = sum(len(o) for o in outs.values())
    row = {"phase": "serve", "model": "1b", "kv_dtype": kv_dtype or "bf16",
           "completions": len(outs), "tokens": tokens, "elapsed_s": elapsed,
           "tokens_per_s": tokens / elapsed, "committed": committed,
           "end_offsets": ends, "prefills": m["prefills"],
           "decode_ticks": m["decode_ticks"], "launches": launches,
           "tick_block_ms_p50": m["step_time"]["p50_ms"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if hasattr(server, "spec_stats"):
        row["spec"] = server.spec_stats()
        row["decoded_tokens"] = m["decoded_tokens"]
        row["tick_blocks"] = m["ticks"]
    return outs, row


TENANTS = ("alpha", "beta", "gamma")
PAGED_BS = 16  # vLLM's default page size


def tenant_prompts(np, vocab: int, n: int = 48, plen: int = 128, sys_len: int = 96):
    """Scenario 12's stream shape at the serve phase's lengths: three tenants,
    each with a fixed system prompt of ``sys_len`` tokens (whole blocks of
    16) followed by random tokens. Returns (prompts [n, plen], keys)."""
    rng = np.random.default_rng(SEED + 12)
    system = rng.integers(0, vocab, (len(TENANTS), sys_len), dtype=np.int32)
    prompts = rng.integers(0, vocab, (n, plen), dtype=np.int32)
    prompts[:, :sys_len] = system[np.arange(n) % len(TENANTS)]
    return prompts, [TENANTS[i % len(TENANTS)].encode() for i in range(n)]


def serve_paged(torch, cfg, params, prompts, keys, kv_kernel: bool = True, parts: int = 4,
                prof=None, *, kv_dtype="int8", kv_tier=None, tracer=None, budget_of=None,
                max_poll_records: int = 512, sampled: bool = False, server_cls=None,
                **server_kw):
    """Serve a tenant stream once through the port's paged
    StreamingGenerator (blocks of 16, 16 slots' worth of blocks + 24 + 1;
    radix prefix reuse; chunked prefill), produced keyed by tenant onto
    ``parts`` partitions. ``kv_dtype`` "int8": the int8 pool, read by K5
    on decode-only ticks when ``kv_kernel``; None: the compute-dtype
    pool. ``kv_tier``: the host-RAM tier (None: HBM only), its block reads
    and writes timed on the host; ``tracer``: the server's
    ``obs.RecordTracer``; ``budget_of(key)``: a record's output budget
    (``max_new_of``; None = ``MAX_NEW``); ``sampled``: ``SAMPLING`` with
    key(11). Every kernel launch count is zeroed just before ``run`` and
    read just after; the peak of live pool blocks is sampled around every
    tick block. ``prof``: an optional profiler context wrapped around
    ``run``. Hard checks: every record served once at its budget's length,
    committed == end offsets, ``output_capped`` == the records cut short,
    prefix reuse, K5 = layers x (decode ticks - chunk ticks) (0 without
    the kernel), K1 = K4 = 0, a traced run balanced, the tier within its
    capacity. ``server_cls``: another server class (the speculative one),
    given ``server_kw``; its pool covers a slot's ``plen + MAX_NEW + k``
    positions. Returns (outputs, row, server)."""
    import numpy as np

    from torchkafka_tpu_torch.kvcache import PagedKVConfig
    from torchkafka_tpu_torch.ops.flash import flash_fwd_bhsd
    from torchkafka_tpu_torch.ops.kvattn import (
        int8_decode_attention_dynlen,
        int8_paged_decode_attention,
    )
    from torchkafka_tpu_torch.serve import StreamingGenerator
    from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer
    from torchkafka_tpu_torch.source.records import TopicPartition
    from torchkafka_tpu_torch.utils import prng

    n, plen = prompts.shape
    slots, ticks = 16, 8
    nblk = -(-(plen + MAX_NEW + server_kw.get("k", 0)) // PAGED_BS)
    pages = PagedKVConfig(block_size=PAGED_BS, num_blocks=slots * nblk + 24 + 1)
    broker = InMemoryBroker()
    broker.create_topic("t12", partitions=parts)
    for i in range(n):
        broker.produce("t12", prompts[i].tobytes(), key=keys[i])
    consumer = MemoryConsumer(broker, "t12", group_id="s12")
    sampling = dict(SAMPLING, rng=prng.key(11)) if sampled else {}
    server = (server_cls or StreamingGenerator)(
        consumer, params, cfg, slots=slots, prompt_len=plen, max_new=MAX_NEW,
        commit_every=16, max_poll_records=max_poll_records, ticks_per_sync=ticks,
        kv_dtype=kv_dtype, kv_kernel=kv_kernel if kv_dtype else "auto", kv_pages=pages,
        kv_tier=kv_tier, tracer=tracer,
        max_new_of=None if budget_of is None else (lambda rec: budget_of(rec.key)),
        device="cuda", **sampling, **server_kw,
    )
    server.warmup()
    peak_blocks = [0, 0]  # allocated (slot-held + cached), slot-held
    step = server.step

    def sample():
        tbl = server._table_np
        held = len(np.unique(tbl[tbl != 0]))
        peak_blocks[0] = max(peak_blocks[0], server._kv_alloc.allocated())
        peak_blocks[1] = max(peak_blocks[1], held)

    def sampled_step():
        sample()
        out = step()
        sample()
        return out

    server.step = sampled_step
    io = {"demote": [], "promote": []}
    if kv_tier is not None:
        radix = server._kv_radix
        read, write = radix._read_block, radix._write_block

        def timed_read(block):
            t0 = time.perf_counter()
            out = read(block)
            io["demote"].append(time.perf_counter() - t0)
            return out

        def timed_write(block, payload):
            t0 = time.perf_counter()
            write(block, payload)
            io["promote"].append(time.perf_counter() - t0)

        radix._read_block, radix._write_block = timed_read, timed_write
    kernels = (flash_fwd_bhsd, int8_decode_attention_dynlen, int8_paged_decode_attention)
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        outs = {(r.partition, r.offset): out for r, out in server.run(max_records=n)}
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"flash_fwd": kernels[0].launches, "kvattn_dynlen": kernels[1].launches,
                "kvattn_paged": kernels[2].launches}
    consumer.close()
    tps = [TopicPartition("t12", p) for p in range(parts)]
    committed = [broker.committed("s12", tp) or 0 for tp in tps]
    ends = [broker.end_offset(tp) for tp in tps]
    want_len = {}
    for tp in tps:
        for r in broker.fetch(tp, 0, 10 * n):
            budget = budget_of(r.key) if budget_of is not None else None
            want_len[(r.partition, r.offset)] = max(1, min(budget or MAX_NEW, MAX_NEW))
    capped = sum(length < MAX_NEW for length in want_len.values())
    m = server.metrics.summary()
    cache, chunks = m["prefix_cache"], m["chunked_prefill"]
    what = "paged" + ("" if kv_tier is None else " (tier)")
    if len(outs) != n or any(len(o) != want_len[k] for k, o in outs.items()):
        raise AssertionError(f"{what}: {len(outs)} completions, lengths "
                             f"{sorted({len(o) for o in outs.values()})}")
    if m["output_capped"] != capped:
        raise AssertionError(f"{what}: output_capped {m['output_capped']} vs {capped}")
    if committed != ends:
        raise AssertionError(f"{what}: committed {committed} != end offsets {ends}")
    if any(int(o.min()) < 0 or int(o.max()) >= cfg.vocab_size for o in outs.values()):
        raise AssertionError(f"{what}: token out of the vocabulary")
    if not (cache["hits"] > 0 and cache["prefill_tokens"] < n * plen):
        raise AssertionError(f"{what}: no prefix reuse {cache}")
    kernel = kv_kernel is True and kv_dtype == "int8"
    want_k5 = cfg.n_layers * (m["decode_ticks"] - chunks["chunk_ticks"]) if kernel else 0
    if launches["kvattn_paged"] != want_k5 or (kernel and want_k5 <= 0):
        raise AssertionError(f"{what}: K5 launches {launches} vs {m['decode_ticks']} decode "
                             f"ticks, {chunks['chunk_ticks']} chunk ticks")
    if launches["flash_fwd"] or launches["kvattn_dynlen"]:
        raise AssertionError(f"{what}: dense-path kernels launched {launches}")
    tier = cache["tier"]
    if kv_tier is not None and tier["occupancy_bytes"] > server._kv_tier.config.capacity_bytes:
        raise AssertionError(f"{what}: tier over its capacity {tier}")

    def ms(xs):
        xs = sorted(x * 1e3 for x in xs)
        return ({"count": len(xs), "p50": xs[len(xs) // 2],
                 "p99": xs[min(len(xs) - 1, int(0.99 * len(xs)))], "total": sum(xs)}
                if xs else {"count": 0})

    tokens = sum(len(o) for o in outs.values())
    kv_row = cfg.n_kv_heads * 2 * (cfg.head_dim + 4) * cfg.n_layers  # int8 k+v, f32 scales
    row = {"phase": "serve_paged", "model": f"1b width, {cfg.n_layers} layers",
           "dtype": str(cfg.dtype).replace("torch.", ""), "kv_dtype": kv_dtype or "compute",
           "kv_kernel": kernel, "sampled": sampled,
           "kv_tier": None if kv_tier is None else {
               k: v for k, v in dict(kv_tier).items() if k != "spill_dir"},
           "block_size": PAGED_BS, "num_blocks": pages.num_blocks,
           "prompts": n, "prompt_len": plen, "max_new": MAX_NEW, "slots": slots,
           "max_poll_records": max_poll_records,
           "ticks_per_sync": ticks, "completions": len(outs), "tokens": tokens,
           "elapsed_s": elapsed, "tokens_per_s": tokens / elapsed,
           "committed": committed, "end_offsets": ends, "output_capped": m["output_capped"],
           "prefix_hits": cache["hits"], "prefix_misses": cache["misses"],
           "hit_rate": cache["hit_rate"], "prefix_tokens_saved": cache["prefix_tokens_saved"],
           "prefill_tokens": cache["prefill_tokens"], "prefill_tokens_no_cache": n * plen,
           "evictions": cache["evictions"], "deferrals": cache["deferrals"], "tier": tier,
           "tier_io_ms": {"demote": ms(io["demote"]), "promote": ms(io["promote"])},
           "decode_ticks": m["decode_ticks"], "chunk_ticks": chunks["chunk_ticks"],
           "chunk_summary": chunks, "launches": launches,
           "tick_block_ms_p50": m["step_time"]["p50_ms"],
           "tick_block_ms_p99": m["step_time"]["p99_ms"],
           "peak_allocated_blocks": peak_blocks[0], "peak_slot_blocks": peak_blocks[1],
           "dense_block_equivalents": slots * nblk,
           "pool_bytes_paged": pages.num_blocks * PAGED_BS * kv_row,
           "pool_bytes_dense_equivalent": slots * (plen + MAX_NEW) * kv_row,
           "tenant_cache": m["tenant_cache"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if hasattr(server, "spec_stats"):
        row["spec"] = server.spec_stats()
        row["decoded_tokens"] = m["decoded_tokens"]
    if tracer is not None:
        row["trace"] = _balanced(tracer, n, what)
        row["slo_ms"] = _slo_ms(tracer.slo.summary())
        row["ttft_ms_min_q1_median_q3_max"] = _ttft_spread(tracer)
    return outs, row, server


def check_serve_paged(torch, cfg, params, name: str, exact: bool) -> tuple[dict, dict, dict]:
    """The tenant stream through the block-table kernel (K5) and again
    through the gathered read: committed offsets and token 0 must be
    identical; ``exact`` (f32) requires every token identical. → (K5 row,
    gathered row, the K5 run's outputs)."""
    import numpy as np

    prompts, keys = tenant_prompts(np, cfg.vocab_size)
    outs_k, row_k, _ = serve_paged(torch, cfg, params, prompts, keys, kv_kernel=True)
    outs_g, row_g, _ = serve_paged(torch, cfg, params, prompts, keys, kv_kernel=False)
    if row_g["committed"] != row_k["committed"]:
        raise AssertionError(f"{name}: the gathered read committed other offsets")
    tok0_same = all(int(outs_g[k][0]) == int(outs_k[k][0]) for k in outs_k)
    agree = float(np.mean([np.mean(outs_g[k] == outs_k[k]) for k in outs_k]))
    for row in (row_k, row_g):
        row["phase"] = name
    row_g["token0_identical_to_kernel_run"] = tok0_same
    row_g["token_agreement_with_kernel_run"] = agree
    if not tok0_same:
        raise AssertionError(f"{name}: token 0 differs between the kernel and gathered reads")
    if exact and agree != 1.0:
        raise AssertionError(f"{name}: f32 tokens differ (agreement {agree})")
    return row_k, row_g, outs_k


# --------------------------------------------------- observability and tiers

_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_LABEL = r'[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\["\\n])*"'


def conformant(text: str) -> int:
    """The exposition grammar of ``tests/test_obs.py`` (``_assert_conformant``):
    every sample parses, carries HELP and TYPE, counters end in _total,
    values are floats; and no family is defined twice. Returns the sample
    count."""
    import re

    sample_re = re.compile(rf"^({_NAME})(\{{{_LABEL}(?:,{_LABEL})*\}})? (\S+)$")
    helped, typed, samples = set(), {}, 0
    for line in text.strip().split("\n"):
        if line.startswith("# HELP "):
            name, sep, help_text = line[len("# HELP "):].partition(" ")
            if not (re.fullmatch(_NAME, name) and sep and help_text.strip()):
                raise AssertionError(f"exposition: bad HELP {line!r}")
            helped.add(name)
            continue
        if line.startswith("# TYPE "):
            name, _, mtype = line[len("# TYPE "):].partition(" ")
            if mtype not in ("counter", "gauge") or name in typed:
                raise AssertionError(f"exposition: bad or repeated TYPE {line!r}")
            typed[name] = mtype
            continue
        if line.startswith("#"):
            raise AssertionError(f"exposition: unknown comment {line!r}")
        m = sample_re.match(line)
        if not m:
            raise AssertionError(f"exposition: unparsable sample {line!r}")
        name = m.group(1)
        float(m.group(3))
        if name not in helped or name not in typed:
            raise AssertionError(f"exposition: {name} lacks HELP or TYPE")
        if typed[name] == "counter" and not name.endswith("_total"):
            raise AssertionError(f"exposition: counter {name} does not end in _total")
        samples += 1
    if not samples:
        raise AssertionError("exposition: no sample")
    return samples


def np_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def _slo_ms(slo: dict) -> dict:
    """p50/p99 (ms) and counts of the tracer's cumulative SLO histograms."""
    return {metric: {key: slo[metric]["all"][key] for key in ("count", "p50_ms", "p99_ms")}
            for metric in ("ttft", "itl", "queue_wait", "e2e")}


def _ttft_spread(tr) -> list:
    """Each record's poll-to-active time (ms) from the trace events: the
    minimum, quartiles and maximum (the histograms' p50 and p99 both fall
    in the last wave when waves queue behind each other)."""
    polled, active = {}, {}
    for e in tr.events:
        if e.stage == "polled":
            polled.setdefault(e.key, e.t)
        elif e.stage == "slot_active":
            active.setdefault(e.key, e.t)
    xs = sorted((active[k] - polled[k]) * 1e3 for k in active)
    return [xs[min(len(xs) - 1, int(q * len(xs)))] for q in (0, 0.25, 0.5, 0.75, 1)]


def _balanced(tr, n: int, what: str) -> dict:
    """Every record polled, active, finished and committed exactly once;
    nothing left open."""
    from collections import Counter

    per = {stage: Counter(e.key for e in tr.events if e.stage == stage)
           for stage in ("polled", "slot_active", "finished", "committed")}
    s = tr.summary()
    for stage, c in per.items():
        if len(c) != n or set(c.values()) != {1}:
            raise AssertionError(f"{what}: {stage} {len(c)} records, counts {set(c.values())}")
    if s["open_records"] != 0 or s["ring_dropped"] != 0:
        raise AssertionError(f"{what}: tracer {s['open_records']} open, "
                             f"{s['ring_dropped']} dropped")
    return {"events": s["events"], "stages": s["stages"]}


def check_serve_traced(torch, cfg, params, prompts) -> tuple[list, dict]:
    """The serve phase's int8 run untraced, then traced with
    ``RecordTracer(capacity=1 << 16)`` (token events on). The traced run's
    tokens and commits equal the untraced run's; it polls, activates,
    finishes and commits every record exactly once. One
    ``MetricsExporter`` on 127.0.0.1 (port 0) serves the traced run's
    server and tracer expositions; one scrape must parse under the
    exposition grammar with no family defined twice."""
    import urllib.request

    from torchkafka_tpu_torch.obs import MetricsExporter, RecordTracer

    n = prompts.shape[0]
    rows, runs = [], []
    for traced in (False, True):
        tr = RecordTracer(capacity=1 << 16) if traced else None
        held = []
        outs, row = serve(torch, cfg, params, prompts, "int8", tracer=tr,
                          on_done=held.append)
        row["phase"], row["traced"] = "serve_traced", traced
        if traced:
            row["trace"] = _balanced(tr, n, "serve_traced")
            row["slo_ms"] = _slo_ms(tr.slo.summary())
            row["ttft_ms_min_q1_median_q3_max"] = _ttft_spread(tr)
        runs.append((outs, row, tr, held[0]))
        rows.append(row)
    base_outs, base_row = runs[0][0], runs[0][1]
    for outs, row, _, _ in runs[1:]:
        if row["committed"] != base_row["committed"]:
            raise AssertionError("serve_traced: commits differ between runs")
        if set(outs) != set(base_outs) or any(
                not np_equal(outs[k], base_outs[k]) for k in base_outs):
            raise AssertionError("serve_traced: tokens differ between runs")
    _, _, tr, server = runs[1]
    with MetricsExporter([server.metrics, tr], host="127.0.0.1", port=0) as exporter:
        with urllib.request.urlopen(exporter.url, timeout=30) as resp:
            status, body = resp.status, resp.read().decode()
    if status != 200 or "# source error" in body:
        raise AssertionError(f"serve_traced: scrape status {status}")
    samples = conformant(body)
    untraced = [r["tokens_per_s"] for r in rows if not r["traced"]]
    traced = [r["tokens_per_s"] for r in rows if r["traced"]]
    summary = {"phase": "serve_traced", "runs": "untraced, traced",
               "tokens_and_commits_identical": True, "records": n,
               "tokens_per_s_untraced": untraced, "tokens_per_s_traced": traced,
               "traced_over_untraced": statistics.mean(traced) / statistics.mean(untraced),
               "slo_ms": [r["slo_ms"] for r in rows if r["traced"]],
               "scrape": {"bytes": len(body), "samples": samples,
                          "families": body.count("# TYPE ")},
               "nvidia_smi": smi_line()}
    return rows, summary


TIER_TENANTS = 64
TIER_PROMPTS = 384  # six records a tenant: enough revisits after eviction
TIER_WITNESS_PROMPTS = 128
TIER_BUDGET = 32  # odd tenants' per-record output budget
TIER = {"capacity_bytes": 1 << 30}


def zipf_tenant_prompts(np, vocab: int, n: int = TIER_PROMPTS, tenants: int = TIER_TENANTS,
                        plen: int = 128, sys_len: int = 96):
    """``benchmarks/bench_tiered.py``'s stream at the 1b scale: ``tenants``
    tenants, each with a fixed ``sys_len``-token system prompt (whole
    blocks of 16) followed by random tokens; each prompt's tenant drawn
    with Zipf(1.1) weights from a fixed seed. Returns (prompts [n, plen],
    keys, the tenant index of each prompt)."""
    rng = np.random.default_rng(SEED + 64)
    system = rng.integers(0, vocab, (tenants, sys_len), dtype=np.int32)
    w = np.arange(1, tenants + 1, dtype=np.float64) ** -1.1
    picks = rng.choice(tenants, size=n, p=w / w.sum())
    prompts = rng.integers(0, vocab, (n, plen), dtype=np.int32)
    prompts[:, :sys_len] = system[picks]
    return prompts, [b"tenant-%02d" % t for t in picks], picks


def odd_tenant(key: bytes) -> bool:
    return int(key.rsplit(b"-", 1)[1]) % 2 == 1


def tier_budget(key: bytes):
    """A record's output budget by its key: odd tenants get ``TIER_BUDGET``
    tokens."""
    return TIER_BUDGET if odd_tenant(key) else None


def _tier_run(torch, cfg, params, prompts, keys, kv_tier=None, **kw):
    """One traced run of the Zipf tenant stream through ``serve_paged``
    (polls of 16 records, ``tier_budget``), HBM only or with ``kv_tier``."""
    from torchkafka_tpu_torch.obs import RecordTracer

    # Polls of one pool's worth of records: one poll of 512 would hand the
    # records over partition after partition, each tenant's together, and
    # its prefix would never leave HBM between its visits.
    outs, row, server = serve_paged(
        torch, cfg, params, prompts, keys, tracer=RecordTracer(capacity=1 << 18),
        budget_of=tier_budget, max_poll_records=16,
        kv_tier=kv_tier, **kw)
    row.update({"phase": "serve_tiered", "tenants": TIER_TENANTS,
                "budget_odd_tenants": TIER_BUDGET})
    return outs, row, server


def _agreement(np, a: dict, b: dict) -> float:
    return float(np.mean([np.mean(a[k] == b[k]) for k in a]))


def matmul_rows_witness(torch, cfg, params) -> dict:
    """Whether a decode row's arithmetic depends on the tick it lands on:
    layer 0's q/k/v projections and MLP, and the f32 head, over the 16
    decode rows alone (a decode-only tick, M = 16) and over those rows
    with the 256 chunk rows below them (a chunk tick, M = 272). Per
    output: the 16 rows bitwise equal or not, and the largest gap."""
    from torchkafka_tpu_torch.models.generate import _project_qkv
    from torchkafka_tpu_torch.models.transformer import _mlp, layer_at, matmul_f32

    gen = torch.Generator(device="cuda").manual_seed(SEED + 272)
    x = torch.randn((272, 1, cfg.d_model), generator=gen, device="cuda").to(cfg.dtype)
    layer = layer_at(params["layers"], 0)
    ops = {"q": lambda h: _project_qkv(h, layer, cfg)[0],
           "k": lambda h: _project_qkv(h, layer, cfg)[1],
           "v": lambda h: _project_qkv(h, layer, cfg)[2],
           "mlp": lambda h: _mlp(h, layer, cfg),
           "head": lambda h: matmul_f32(h[:, 0], params["lm_head"], cfg.dtype)}
    out = {}
    with torch.inference_mode():
        for name, op in ops.items():
            chunk, alone = op(x)[:16], op(x[:16])
            out[name] = {"rows_bitwise_equal": bool(torch.equal(chunk, alone)),
                         "max_abs_gap": float((chunk.float() - alone.float()).abs().max())}
    return out


def check_serve_tiered(torch, cfg, params, rounds: int = 1) -> tuple[list, dict]:
    """The 1b tiered serve: (HBM only, tier) x ``rounds``
    in one call over ``TIER_PROMPTS`` records. Every run commits the same
    offsets; the tier runs hit the prefix cache more often and prefill
    fewer tokens than the HBM-only runs, demote and promote (tier hits ==
    promotions) within capacity; and a direct tier round trip is bitwise
    on all four pools. Then the witness of why bf16 tier and HBM-only
    tokens differ: over the first ``TIER_WITNESS_PROMPTS`` records, HBM
    against tier with K5 and again with the gathered read on every tick,
    and ``matmul_rows_witness``."""
    import numpy as np

    prompts, keys, picks = zipf_tenant_prompts(np, cfg.vocab_size)
    rows, outs = [], []
    round_trip = None
    for tiered in (False, True) * rounds:
        o, row, server = _tier_run(torch, cfg, params, prompts, keys,
                                   kv_tier=TIER if tiered else None)
        if tiered and round_trip is None:
            round_trip = tier_round_trip(torch, server)
        del server
        row["per_tenant_hit_rate"] = _tenant_hit_rates(np, row.pop("tenant_cache"), picks)
        rows.append(row)
        outs.append(o)
    hbm = [r for r in rows if r["kv_tier"] is None]
    tier = [r for r in rows if r["kv_tier"] is not None]
    if any(r["committed"] != rows[0]["committed"] for r in rows):
        raise AssertionError("serve_tiered: commits differ between runs")
    for t in tier:
        for h in hbm:
            if not (t["prefix_hits"] > h["prefix_hits"]
                    and t["prefill_tokens"] < h["prefill_tokens"]):
                raise AssertionError(f"serve_tiered: tier {t['prefix_hits']} hits, "
                                     f"{t['prefill_tokens']} prefill tokens vs HBM "
                                     f"{h['prefix_hits']}, {h['prefill_tokens']}")
        ti = t["tier"]
        if not (ti["demotions"] > 0 and ti["promotions"] > 0
                and ti["hits"] == ti["promotions"]):
            raise AssertionError(f"serve_tiered: tier counters {ti}")
    for h in hbm:
        if h["tier"]["demotions"] or h["tier"]["promotions"]:
            raise AssertionError(f"serve_tiered: HBM-only run used a tier {h['tier']}")
    ih = [i for i, r in enumerate(rows) if r["kv_tier"] is None]
    it = [i for i, r in enumerate(rows) if r["kv_tier"] is not None]
    witness_prompts = prompts[:TIER_WITNESS_PROMPTS]
    witness_keys = keys[:TIER_WITNESS_PROMPTS]
    witness = {}
    for kernel in (True, False):
        pair = [_tier_run(torch, cfg, params, witness_prompts, witness_keys, kv_tier=t,
                          kv_kernel=kernel)[0] for t in (None, TIER)]
        witness["k5" if kernel else "gathered"] = _agreement(np, *pair)
    summary = {"phase": "serve_tiered", "runs": f"(HBM, tier) x {rounds}",
               "prompts": len(keys), "commits_identical": True,
               "hit_rate": {"hbm": [r["hit_rate"] for r in hbm],
                            "tier": [r["hit_rate"] for r in tier]},
               "prefix_hits": {"hbm": [r["prefix_hits"] for r in hbm],
                               "tier": [r["prefix_hits"] for r in tier]},
               "prefill_tokens": {"hbm": [r["prefill_tokens"] for r in hbm],
                                  "tier": [r["prefill_tokens"] for r in tier]},
               "tier_counters": tier[0]["tier"],
               "ttft_ms": {"hbm": [r["slo_ms"]["ttft"] for r in hbm],
                           "tier": [r["slo_ms"]["ttft"] for r in tier]},
               "tokens_per_s": {"hbm": [r["tokens_per_s"] for r in hbm],
                                "tier": [r["tokens_per_s"] for r in tier]},
               "tick_block_ms_p50": {"hbm": [r["tick_block_ms_p50"] for r in hbm],
                                     "tier": [r["tick_block_ms_p50"] for r in tier]},
               "tier_io_ms": [r["tier_io_ms"] for r in tier],
               "token_agreement_tier_vs_hbm": _agreement(np, outs[it[0]], outs[ih[0]]),
               "tier_runs_identical": all(all(np_equal(outs[i][k], outs[it[0]][k])
                                              for k in outs[i]) for i in it),
               "hbm_runs_identical": all(all(np_equal(outs[i][k], outs[ih[0]][k])
                                             for k in outs[i]) for i in ih),
               "witness": {"prompts": TIER_WITNESS_PROMPTS,
                           "token_agreement_tier_vs_hbm": witness,
                           "matmul_rows": matmul_rows_witness(torch, cfg, params)},
               "k5_launches": {"hbm": [r["launches"]["kvattn_paged"] for r in hbm],
                               "tier": [r["launches"]["kvattn_paged"] for r in tier]},
               "round_trip": round_trip, "nvidia_smi": smi_line()}
    return rows, summary


def check_serve_tiered_f32(torch, cfg, params) -> list:
    """The tiered stream at 1b width, 2 layers, f32, over its first
    ``TIER_WITNESS_PROMPTS`` records: HBM only against the tier, greedy and
    sampled on the compute-dtype pool, greedy on the int8 pool (K5), and
    greedy through a disk-spill tier (``capacity_bytes=0``, every demotion
    to a temporary directory). Every token and watermark of each tiered
    run must equal its HBM-only run's."""
    import tempfile

    import numpy as np

    prompts, keys, _ = zipf_tenant_prompts(np, cfg.vocab_size)
    prompts, keys = prompts[:TIER_WITNESS_PROMPTS], keys[:TIER_WITNESS_PROMPTS]
    rows = []
    base = {}
    with tempfile.TemporaryDirectory() as spill:
        cases = (("greedy", None, False, TIER), ("sampled", None, True, TIER),
                 ("int8", "int8", False, TIER),
                 ("disk_spill", None, False, {"capacity_bytes": 0, "spill_dir": spill}))
        for name, kv_dtype, sampled, tier in cases:
            key = (kv_dtype, sampled)
            if key not in base:
                base[key] = _tier_run(torch, cfg, params, prompts, keys,
                                      kv_dtype=kv_dtype, sampled=sampled)[:2]
            b_outs, b_row = base[key]
            outs, row, server = _tier_run(torch, cfg, params, prompts, keys, kv_tier=tier,
                                          kv_dtype=kv_dtype, sampled=sampled)
            spills = (server._kv_tier.spills, server._kv_tier.spill_loads)
            del server
            same = row["committed"] == b_row["committed"] and all(
                np_equal(outs[k], b_outs[k]) for k in b_outs)
            differ = [f"{k}" for k in b_outs if not np_equal(outs[k], b_outs[k])]
            ti = row["tier"]
            row.pop("tenant_cache")
            row.update({"phase": "serve_tiered_f32", "case": name,
                        "hbm_only": {key2: b_row[key2] for key2 in (
                            "prefix_hits", "prefill_tokens", "tokens_per_s")},
                        "identical_to_hbm_only": same, "records_differing": differ[:8],
                        "spills": spills[0], "spill_loads": spills[1]})
            rows.append(row)
            if not same:
                raise AssertionError(f"serve_tiered_f32 {name}: tiered run differs from "
                                     f"HBM-only at {len(differ)} records {differ[:8]}")
            if not (ti["promotions"] > 0 and ti["hits"] == ti["promotions"]):
                raise AssertionError(f"serve_tiered_f32 {name}: tier counters {ti}")
            if name == "disk_spill" and not (spills[0] > 0 and spills[1] > 0):
                raise AssertionError(f"serve_tiered_f32: no disk spill {spills}")
    return rows


def tier_round_trip(torch, server) -> dict:
    """A cached block's payload read to the host by ``_tier_read_block``
    and written by ``_tier_write_block`` into a freshly allocated block:
    every pool's slice must be bitwise the original's."""
    stack, block = [server._kv_radix._root], None
    while stack and block is None:
        node = stack.pop()
        stack.extend(node.children.values())
        if node.block > 0:
            block = node.block
    if block is None:
        raise AssertionError("tier round trip: the radix tree holds no block")
    (fresh,) = server._kv_alloc.alloc(1)
    server._tier_write_block(fresh, server._tier_read_block(block))
    torch.cuda.synchronize()
    same = [torch.equal(p[:, fresh].view(torch.uint8), p[:, block].view(torch.uint8))
            for p in server._pools]
    server._kv_alloc.decref([fresh])
    if len(same) != 4 or not all(same):
        raise AssertionError(f"tier round trip: pools equal {same}")
    return {"block": block, "fresh_block": fresh, "pools": len(same), "bitwise": True,
            "payload_bytes": sum(p[:, block].numel() * p.element_size()
                                 for p in server._pools)}


def _tenant_hit_rates(np, rows_tenant: dict, picks, k: int = 4) -> dict:
    """Per-tenant hit rates of the ``k`` most and ``k`` least frequent
    tenants of the stream."""
    counts = np.bincount(picks, minlength=TIER_TENANTS)
    seen = [t for t in np.argsort(-counts, kind="stable") if counts[t]]
    pick = {"most": seen[:k], "least": seen[-k:]}
    return {side: [{"tenant": int(t), "records": int(counts[t]),
                    "hit_rate": rows_tenant.get("tenant-%02d" % t, {}).get("hit_rate")}
                   for t in ts] for side, ts in pick.items()}


# Known answers of jax.random under jax 0.9.0 (jax_threefry_partitionable
# True, its default): key data of key(0) and key(11); the JAX server's
# record keys (`_record_key_data`) under base key(11); split(key(11), 3);
# and, at the flat indices `flat_idx` of a [16, 32000] draw (the 1b serving
# draw: 16 slots over the vocabulary), bits(key(11)), the bits of
# uniform(key(11), minval=tiny) as uint32, and the per-key bits of
# split(key(11), 16), each key over 32000.
PRNG_KAT = {
    "key0": [0, 0], "key11": [0, 11],
    "records": [["prompts", 0, 0, [2218655383, 2356092170]],
                ["prompts", 1, 17, [727883379, 2431539275]],
                ["prompts", 1, 2147483647, [563890496, 913402334]]],
    "split11": [[1943334310, 1180745302], [3947986621, 4020105687],
                [3467837548, 1955229632]],
    "flat_idx": [0, 1, 2, 31999, 32000, 40009, 80018, 120027, 160036, 200045,
                 240054, 280063, 320072, 360081, 400090, 440099, 480108, 511998,
                 511999],
    "bits11": [901010416, 80514922, 3124326316, 1573991069, 595980571, 2444963827,
               3500984093, 2921708605, 570804211, 3373407160, 824124538, 234308450,
               723895684, 731956787, 2909875870, 738004407, 770609159, 2667640778,
               3360031820],
    "uniform11_u32": [1045877064, 1016697280, 1060780398, 1052484196, 1041110976,
                      1058126638, 1062251718, 1059988924, 1040717592, 1061753370,
                      1044675728, 1029665824, 1043109648, 1043235608, 1059942702,
                      1043330096, 1043839552, 1058996470, 1061701124],
    "rowbits": [1624905595, 1216879637, 4200566959, 995084349, 2621320021, 3267088429,
                2861103198, 3802529438, 2174557446, 3095848150, 2180222523, 3478286239,
                2161572422, 2435701894, 2635158808, 3802216401, 2132219889, 3078280026,
                2662959436],
}
SAMPLING = {"temperature": 0.9, "top_k": 16, "top_p": 0.95}  # base key: key(11)
RESUME_S = (129, 136, 144, 160, 190)  # 128 + g - 1 for g = 2, 9, 17, 33, 63
POISON = b"\xff" * 7  # not a whole number of int32 tokens: decode_prompt raises


def _u32(t) -> list:
    return [int(x) & 0xFFFFFFFF for x in t.reshape(-1).cpu().tolist()]


def prng_known_answers(torch, device) -> int:
    """The port's threefry (``utils.prng``) on ``device`` against
    ``PRNG_KAT``, bit for bit; raises on any difference. Returns the number
    of 32-bit words held."""
    import zlib

    from torchkafka_tpu_torch.utils import prng

    k11 = prng.key(11, device)
    records = []
    for topic, part, off, _ in PRNG_KAT["records"]:
        k = k11
        for d in (zlib.crc32(topic.encode()) & 0x7FFFFFFF, part & 0x7FFFFFFF,
                  off & 0x7FFFFFFF):
            k = prng.fold_in(k, d)
        records.append([topic, part, off, _u32(k)])
    idx = torch.tensor(PRNG_KAT["flat_idx"], device=device)
    got = {
        "key0": _u32(prng.key(0, device)), "key11": _u32(k11), "records": records,
        "split11": [_u32(k) for k in prng.split(k11, 3)],
        "flat_idx": PRNG_KAT["flat_idx"],
        "bits11": _u32(prng.random_bits(k11, (16, 32000)).reshape(-1)[idx]),
        "uniform11_u32": _u32(
            prng.uniform(k11, (16, 32000)).view(torch.int32).reshape(-1)[idx]),
        "rowbits": _u32(prng.random_bits(prng.split(k11, 16), (32000,)).reshape(-1)[idx]),
    }
    bad = [name for name in PRNG_KAT if got[name] != PRNG_KAT[name]]
    if bad:
        raise AssertionError(f"prng on {device}: {bad} differ from jax.random's")
    return 4 + 2 * len(records) + 2 * 3 + 3 * len(PRNG_KAT["flat_idx"])


def check_prng(torch, flush) -> dict:
    """The keyed sampler on the card: known answers on CUDA and on the CPU;
    CUDA against the CPU path over the serving draw (16 keys x 32000): bits
    and uniforms bit for bit, Gumbels within 2 ulp at the scale of max(|g|,
    1) (both logs in f64 on either device, rounded to f32 once), with the
    uniform at the largest gap printed; then the
    time of one slot draw (``serve._pick_slots`` with ``SAMPLING``) beside
    greedy argmax: device time by events (behind a ~40 ms device sleep:
    the host takes several ms to enqueue the draw's launches), and the
    host's wall per call (the 1b tick is host-bound)."""
    import numpy as np

    from torchkafka_tpu_torch.serve import _pick_slots
    from torchkafka_tpu_torch.utils import prng

    words = prng_known_answers(torch, "cuda")
    prng_known_answers(torch, "cpu")
    B, V = 16, 32000
    keys = prng.split(prng.key(11, "cuda"), B)
    bits_eq = torch.equal(prng.random_bits(keys, (V,)).cpu(),
                          prng.random_bits(keys.cpu(), (V,)))
    u_dev, u_cpu = prng.uniform(keys, (V,)).cpu(), prng.uniform(keys.cpu(), (V,))
    u_eq = torch.equal(u_dev.view(torch.int32), u_cpu.view(torch.int32))
    g_dev = prng.gumbel(keys, (V,)).cpu().numpy()
    g_cpu = prng.gumbel(keys.cpu(), (V,)).numpy()
    scale = np.maximum(np.maximum(np.abs(g_dev), np.abs(g_cpu)), 1).astype(np.float32)
    gap = np.abs(g_dev.astype(np.float64) - g_cpu) / np.spacing(scale)
    ulps = float(gap.max())
    at = np.unravel_index(int(gap.argmax()), gap.shape)
    u_at = u_cpu.numpy()[at]
    worst = {"index": [int(x) for x in at], "uniform": float(u_at),
             "uniform_u32": int(np.float32(u_at).view(np.uint32)),
             "gumbel_cuda": float(g_dev[at]), "gumbel_cpu": float(g_cpu[at]),
             "differing": int((g_dev != g_cpu).sum())}
    if not (bits_eq and u_eq):
        raise AssertionError(f"prng: CUDA bits {bits_eq}, uniforms {u_eq} vs the CPU path")
    if not np.isfinite(g_dev).all() or ulps > 2.0:
        raise AssertionError(f"prng: CUDA Gumbels {ulps} ulp from the CPU path")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    logits = torch.randn((B, V), generator=gen, device="cuda") * 3
    idx = torch.arange(B, dtype=torch.int32, device="cuda")

    def pick():
        return _pick_slots(logits, keys, idx, **SAMPLING)

    def greedy():
        return torch.argmax(logits, dim=-1)

    tok_dev = pick().cpu()
    tok_cpu = _pick_slots(logits.cpu(), keys.cpu(), idx.cpu(), **SAMPLING)

    def host_ms(fn, n=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    return {"phase": "prng", "known_answer_words": words, "known_answers": "cuda, cpu",
            "draw": {"keys": B, "vocab": V}, "bits_cuda_eq_cpu": bits_eq,
            "uniform_cuda_eq_cpu": u_eq, "gumbel_max_ulp_cuda_vs_cpu": ulps,
            "gumbel_tolerance_ulp": 2.0, "gumbel_largest_gap": worst,
            "pick_tokens_cuda_eq_cpu": bool(torch.equal(tok_dev, tok_cpu)),
            "sampling": SAMPLING,
            "pick_slots_ms": cuda_ms(torch, pick, flush, sleep_cycles=80_000_000),
            "argmax_ms": cuda_ms(torch, greedy, flush),
            "pick_slots_host_ms": host_ms(pick), "argmax_host_ms": host_ms(greedy)}


def serve_sampled(torch, cfg, params, prompts, keys=None, *, pages=None, ticks=None,
                  kv_dtype="int8", kv_kernel: bool = True, parts: int = 2,
                  poison_at: int = 10):
    """Serve ``prompts`` plus one poison record with keyed sampling
    (``SAMPLING``, base key ``prng.key(11)``) over the TCP broker: the
    topic lives in an ``InMemoryBroker`` hosted by a ``BrokerServer`` on
    localhost, and the port's StreamingGenerator consumes it through
    ``MemoryConsumer(BrokerClient(...))``. Prompts go round-robin onto
    ``parts`` partitions (keyed by ``keys`` when given); the poison record
    (``POISON``, which the default ``decode_prompt`` rejects) goes onto
    partition 1 before prompt ``poison_at`` and is dead-lettered to
    "prompts.dlq" by a ``PoisonQuarantine`` (budget 2). The pool: dense or,
    with ``pages``, paged; int8, read by K4 or K5 (``kv_kernel=False``: the
    plain M-major or gathered read), or with ``kv_dtype`` None the compute
    dtype (no decode kernel). Every kernel launch count is zeroed
    just before ``run`` and read just after. Hard checks: every completion
    of ``MAX_NEW`` tokens, committed == end offsets (the poison's
    included), exactly one DLQ record carrying the quarantine's provenance
    headers, the launch counts of the path."""
    from torchkafka_tpu_torch.ops.flash import flash_fwd_bhsd
    from torchkafka_tpu_torch.ops.kvattn import (
        int8_decode_attention_dynlen,
        int8_paged_decode_attention,
    )
    from torchkafka_tpu_torch.resilience import PoisonQuarantine
    from torchkafka_tpu_torch.serve import StreamingGenerator
    from torchkafka_tpu_torch.source import BrokerClient, BrokerServer, MemoryProducer
    from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer
    from torchkafka_tpu_torch.source.records import TopicPartition
    from torchkafka_tpu_torch.utils import prng

    n, plen = prompts.shape
    broker = InMemoryBroker()
    broker.create_topic("prompts", partitions=parts)
    broker.create_topic("prompts.dlq", partitions=1)
    for i in range(n):
        if i == poison_at:
            poison_off = broker.end_offset(TopicPartition("prompts", 1))
            broker.produce("prompts", POISON, key=b"poison", partition=1)
        broker.produce("prompts", prompts[i].tobytes(),
                       key=keys[i] if keys else None, partition=i % parts)
    host = BrokerServer(broker)
    client = BrokerClient(host.host, host.port)
    kernels = (flash_fwd_bhsd, int8_decode_attention_dynlen, int8_paged_decode_attention)
    try:
        consumer = MemoryConsumer(client, "prompts", group_id="sampled")
        server = StreamingGenerator(
            consumer, params, cfg, slots=16, prompt_len=plen, max_new=MAX_NEW,
            commit_every=16, ticks_per_sync=ticks or MAX_NEW - 1, kv_dtype=kv_dtype,
            kv_kernel=kv_kernel if kv_dtype else "auto", kv_pages=pages, rng=prng.key(11),
            quarantine=PoisonQuarantine(MemoryProducer(broker), "prompts.dlq", budget=2),
            device="cuda", **SAMPLING,
        )
        server.warmup()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels:
            fn.launches = 0
        flash_fwd_bhsd.tc_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = {(r.partition, r.offset): out for r, out in server.run(max_records=n)}
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {"flash_fwd": kernels[0].launches, "flash_fwd_tc": kernels[0].tc_launches,
                    "kvattn_dynlen": kernels[1].launches, "kvattn_paged": kernels[2].launches}
        consumer.close()
    finally:
        client.close()
        host.close()
    tps = [TopicPartition("prompts", p) for p in range(parts)]
    committed = [broker.committed("sampled", tp) for tp in tps]
    ends = [broker.end_offset(tp) for tp in tps]
    dlq = broker.fetch(TopicPartition("prompts.dlq", 0), 0, 10)
    m = server.metrics.summary()
    what = "serve_sampled" + (" paged" if pages else "")
    if len(outs) != n or any(len(o) != MAX_NEW for o in outs.values()):
        raise AssertionError(f"{what}: {len(outs)} completions, lengths "
                             f"{sorted({len(o) for o in outs.values()})}")
    if committed != ends:
        raise AssertionError(f"{what}: committed {committed} != end offsets {ends}")
    if any(int(o.min()) < 0 or int(o.max()) >= cfg.vocab_size for o in outs.values()):
        raise AssertionError(f"{what}: token out of the vocabulary")
    headers = dict(dlq[0].headers) if len(dlq) == 1 else {}
    want = {"dlq.topic": b"prompts", "dlq.partition": b"1",
            "dlq.offset": str(poison_off).encode(), "dlq.attempts": b"2"}
    if (len(dlq) != 1 or dlq[0].value != POISON or dlq[0].key != b"poison"
            or any(headers.get(h) != v for h, v in want.items())
            or not headers.get("dlq.error")):
        raise AssertionError(f"{what}: DLQ {[(r.key, r.value, r.headers) for r in dlq]}")
    if (m["quarantined"], m["dropped"], m["dlq_delivery_failures"]) != (1, 1, 0):
        raise AssertionError(f"{what}: quarantine counts {m}")
    nl, kernel = cfg.n_layers, kv_dtype == "int8" and kv_kernel
    if pages is None:
        want_l = {"flash_fwd": nl * m["prefills"],
                  "kvattn_dynlen": nl * m["decode_ticks"] if kernel else 0, "kvattn_paged": 0}
    else:
        want_l = {"flash_fwd": 0, "kvattn_dynlen": 0,
                  "kvattn_paged": nl * (m["decode_ticks"]
                                        - m["chunked_prefill"]["chunk_ticks"]) if kernel else 0}
    if (any(launches[k] != v for k, v in want_l.items())
            or (kernel and not want_l["kvattn_dynlen"] + want_l["kvattn_paged"])):
        raise AssertionError(f"{what}: launches {launches}, want {want_l}")
    if cfg.dtype == torch.bfloat16 and launches["flash_fwd_tc"] != launches["flash_fwd"]:
        raise AssertionError(f"{what}: flash tensor-core launches {launches}")
    tokens = sum(len(o) for o in outs.values())
    row = {"phase": "serve_sampled", "model": f"1b width, {nl} layers",
           "dtype": str(cfg.dtype).replace("torch.", ""), "pool": "paged" if pages else "dense",
           "kv_dtype": kv_dtype or "compute", "kv_kernel": kernel, "transport": "BrokerServer/BrokerClient on localhost",
           "sampling": SAMPLING, "rng": "prng.key(11)", "prompts": n, "prompt_len": plen,
           "max_new": MAX_NEW, "slots": 16, "ticks_per_sync": ticks or MAX_NEW - 1,
           "completions": len(outs), "tokens": tokens, "elapsed_s": elapsed,
           "tokens_per_s": tokens / elapsed, "committed": committed, "end_offsets": ends,
           "dlq": {"records": len(dlq), "key": dlq[0].key.decode(),
                   "headers": {h: v.decode() for h, v in headers.items()}},
           "quarantined": m["quarantined"], "prefills": m["prefills"],
           "decode_ticks": m["decode_ticks"],
           "chunk_ticks": m["chunked_prefill"]["chunk_ticks"], "launches": launches,
           "tick_block_ms_p50": m["step_time"]["p50_ms"],
           "tick_block_ms_p99": m["step_time"]["p99_ms"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "nvidia_smi": smi_line()}
    return outs, row


def check_serve_sampled(torch, cfg, params, prompts, greedy_row) -> list:
    """The 1b sampled serve over the TCP broker, twice: the second run must
    give the same tokens, commits and DLQ record (each draw depends on its
    record's key and token index only)."""
    outs_a, row_a = serve_sampled(torch, cfg, params, prompts)
    outs_b, row_b = serve_sampled(torch, cfg, params, prompts)
    same = outs_a.keys() == outs_b.keys() and all(
        (outs_a[k] == outs_b[k]).all() for k in outs_a)
    if not same or row_a["committed"] != row_b["committed"] or row_a["dlq"] != row_b["dlq"]:
        raise AssertionError("serve_sampled: a second run gave other tokens or commits")
    for row in (row_a, row_b):
        row["greedy_tokens_per_s"] = greedy_row["tokens_per_s"]
        row["greedy_tick_block_ms_p50"] = greedy_row["tick_block_ms_p50"]
    row_b["identical_to_first_run"] = True
    return [row_a, row_b]


def check_serve_sampled_f32(torch, cfg, params) -> list:
    """The tenant stream with keyed sampling at 1b width, 2 layers, f32,
    in six runs. Every token, the commits and the DLQ record must be
    identical between the dense and the paged compute-dtype pools (the
    card's version of the JAX package's seeded dense-vs-paged test),
    between K4 and the plain M-major read of the dense int8 pool, and
    between K5 and the gathered read of the paged int8 pool. The dense and
    paged int8 pools commit the same offsets and DLQ record; their tokens
    are not held equal: the dense prefill attends over the prompt's exact
    k/v, the paged chunk prefill over the quantized pool, in the JAX
    package as here (their agreement is printed)."""
    import numpy as np

    from torchkafka_tpu_torch.kvcache import PagedKVConfig

    prompts, keys = tenant_prompts(np, cfg.vocab_size)
    n, plen = prompts.shape
    nblk = -(-(plen + MAX_NEW) // PAGED_BS)
    pages = PagedKVConfig(block_size=PAGED_BS, num_blocks=16 * nblk + 24 + 1,
                          prefill_chunk=None)
    runs = {}
    for name, kw in (("dense", {"kv_dtype": None}), ("paged", {"kv_dtype": None, "pages": pages}),
                     ("dense_k4", {}), ("dense_plain", {"kv_kernel": False}),
                     ("paged_k5", {"pages": pages}),
                     ("paged_gathered", {"pages": pages, "kv_kernel": False})):
        runs[name] = serve_sampled(torch, cfg, params, prompts, keys, ticks=8, **kw)
        runs[name][1]["phase"] = "serve_sampled_f32"
        runs[name][1]["run"] = name

    def agreement(a, b):
        return float(np.mean([np.mean(runs[a][0][k] == runs[b][0][k]) for k in runs[a][0]]))

    for a, b, exact in (("dense", "paged", True), ("dense_k4", "dense_plain", True),
                        ("paged_k5", "paged_gathered", True), ("dense_k4", "paged_k5", False)):
        ra, rb = runs[a][1], runs[b][1]
        agree = agreement(a, b)
        rb[f"token_agreement_with_{a}"] = agree
        if ra["committed"] != rb["committed"] or ra["dlq"] != rb["dlq"]:
            raise AssertionError(f"serve_sampled_f32: {a} and {b} commit other offsets or DLQ")
        if exact and agree != 1.0:
            raise AssertionError(f"serve_sampled_f32: {a} and {b} tokens differ "
                                 f"(agreement {agree})")
    return [row for _, row in runs.values()]


RESUME_CADENCE = 8  # journal cadence, tokens
RESUME_TICKS = 4  # decode ticks per tick block: the journal lags by up to 4


def _resume_topics(broker, prompts, parts: int = 2, poison_at: int = 10):
    """``prompts`` round-robin on ``parts`` partitions keyed by index, the
    poison record on partition 1 before prompt ``poison_at``, as
    ``serve_sampled`` lays them out; the output and DLQ topics."""
    from torchkafka_tpu_torch.source.records import TopicPartition

    broker.create_topic("prompts", partitions=parts)
    broker.create_topic("completions", partitions=1)
    broker.create_topic("prompts.dlq", partitions=1)
    for i in range(len(prompts)):
        if i == poison_at:
            broker.produce("prompts", POISON, key=b"poison", partition=1)
        broker.produce("prompts", prompts[i].tobytes(), key=str(i).encode(),
                       partition=i % parts)
    return [TopicPartition("prompts", p) for p in range(parts)]


def _prompt_index(broker, tps) -> dict:
    """(partition, offset) → prompt index, from the prompt records' keys."""
    return {(r.partition, r.offset): int(r.key) for tp in tps
            for r in broker.fetch(tp, 0, 1000) if r.key != b"poison"}


def _resume_server(cfg, params, broker, jpath, commit_every, server_cls=None, **kw):
    """The exactly-once journaled server of the resume phases: a
    ``TransactionalProducer`` (transactional id "serve-resume", so a
    successor fences its predecessor), a ``PoisonQuarantine`` over that
    same producer, a ``DecodeJournal`` at ``jpath``; the journal's flushes
    are timed on the host into ``server.flush_s``. ``server_cls``: another
    server class (the speculative one), given ``kw``."""
    from torchkafka_tpu_torch.journal import DecodeJournal
    from torchkafka_tpu_torch.resilience import PoisonQuarantine
    from torchkafka_tpu_torch.serve import StreamingGenerator
    from torchkafka_tpu_torch.source import TransactionalProducer
    from torchkafka_tpu_torch.source.memory import MemoryConsumer

    consumer = MemoryConsumer(broker, "prompts", group_id="resume")
    producer = TransactionalProducer(broker, "serve-resume")
    journal = DecodeJournal(jpath, cadence=RESUME_CADENCE)
    server = (server_cls or StreamingGenerator)(
        consumer, params, cfg, slots=16, prompt_len=128, max_new=MAX_NEW,
        commit_every=commit_every, ticks_per_sync=RESUME_TICKS,
        output_producer=producer, output_topic="completions", exactly_once=True,
        quarantine=PoisonQuarantine(producer, "prompts.dlq", budget=2),
        journal=journal, device="cuda", **kw,
    )
    server.flush_s = []
    flush = journal.flush

    def timed_flush():
        dirty = journal._dirty
        t0 = time.perf_counter()
        flush()
        if dirty:
            server.flush_s.append(time.perf_counter() - t0)

    journal.flush = timed_flush
    return server, consumer, producer


def _drive(server, consumer, kill: bool):
    """Serve every record through the external admission surface, as
    ``run()`` does (poll all, admit into free slots, one tick block a
    step). ``kill``: stop, without a close, commit or flush, at the first
    tick block after the first wave retired where a decoding slot holds
    tokens its journal entry does not have yet (the second wave between
    two cadence writes). Returns the completions by (partition, offset)."""
    import numpy as np

    records = []
    while batch := consumer.poll(max_records=512, timeout_ms=100):
        records.extend(batch)
    server.note_fetched(records)
    pending, outs, first_wave = list(records), {}, None
    while pending or server.has_active():
        free = server.free_slots() - server.pending_admissions
        if free > 0 and pending:
            take, pending = pending[:free], pending[free:]
            filled = server.admit_records(take)
            first_wave = filled if first_wave is None else first_wave
        for rec, out in server.step():
            outs[(rec.partition, rec.offset)] = out
        live = np.nonzero(server._active)[0]
        if kill and len(outs) >= first_wave and any(
                0 < server._slot_journaled[i] < server._slot_emitted[i] for i in live):
            return outs
    if kill:
        raise AssertionError("serve_resume: the run ended before the kill point")
    server.flush_commits()
    return outs


def _committed_once(what, broker, n, tps):
    """The read_committed views: each prompt's completion once (by key),
    the poison's DLQ copy once, committed == end offsets. → {key: tokens}."""
    import numpy as np

    from torchkafka_tpu_torch.source.records import TopicPartition

    recs, _ = broker.fetch_stable(TopicPartition("completions", 0), 0, 100000)
    keys = [r.key for r in recs]
    if sorted(keys) != sorted(str(i).encode() for i in range(n)):
        raise AssertionError(f"{what}: committed outputs {sorted(keys)} are not "
                             f"each of {n} prompts once")
    dlq, _ = broker.fetch_stable(TopicPartition("prompts.dlq", 0), 0, 100)
    if [(r.key, r.value) for r in dlq] != [(b"poison", POISON)]:
        raise AssertionError(f"{what}: committed DLQ {[(r.key, r.value) for r in dlq]}")
    committed = [broker.committed("resume", tp) for tp in tps]
    ends = [broker.end_offset(tp) for tp in tps]
    if committed != ends:
        raise AssertionError(f"{what}: committed {committed} != end offsets {ends}")
    return {int(r.key): np.frombuffer(r.value, np.int32) for r in recs}, committed


def serve_resume(torch, cfg, params, prompts, *, pages=None, sampled=True, server_cls=None,
                 phase=None, **server_kw):
    """A killed-and-resumed exactly-once serve (``_resume_server``) of
    ``prompts`` plus the poison record, over an ``InMemoryBroker``, in
    five runs: the uncut run; A, killed (``_drive``) with nothing
    committed (commit_every effectively infinite); B warm, a new server
    whose producer fences A's, hinted from ``DecodeJournal.load`` of A's
    journal and served to the end by ``run()``; A again on a second
    broker, and B cold on it with no hints. Every kernel launch count is
    zeroed just before each B serves (after its warmup) and read just
    after. Hard checks: A commits nothing; B's producer fences A's; in both
    recoveries each completion and the poison's DLQ copy once in the
    read_committed views and committed == end offsets; every entry A's
    journal holds equals the uncut run's tokens (the same program up to
    the kill); B warm serves A's finished entries from the journal,
    resumes every partial entry, decodes sum(MAX_NEW - g) + MAX_NEW per
    cold admission, fewer than B cold; K1 = (layers + draft layers) x
    (prefills + resumes), all on the tensor cores in bf16 (0 on the paged
    pool, whose prefill is the chunk tick), K4 = K5 = 0; commits > 0; at
    f32 both recoveries equal the uncut run token for token.
    ``server_cls``/``server_kw``: another server (the speculative one)
    and its arguments; ``phase``: the row's phase name. Returns the
    row."""
    import tempfile

    import numpy as np

    from torchkafka_tpu_torch.errors import ProducerFencedError
    from torchkafka_tpu_torch.journal import DecodeJournal
    from torchkafka_tpu_torch.ops.flash import flash_fwd_bhsd
    from torchkafka_tpu_torch.ops.kvattn import (
        int8_decode_attention_dynlen,
        int8_paged_decode_attention,
    )
    from torchkafka_tpu_torch.source.memory import InMemoryBroker
    from torchkafka_tpu_torch.utils import prng

    n, plen = prompts.shape
    nl = cfg.n_layers
    kw = {"kv_pages": pages, "server_cls": server_cls, **server_kw}
    if sampled:
        kw.update(rng=prng.key(11), **SAMPLING)
    what = (f"serve_resume {'paged' if pages else 'dense'} "
            f"{'sampled' if sampled else 'greedy'} {str(cfg.dtype)[6:]}")
    kernels = (flash_fwd_bhsd, int8_decode_attention_dynlen, int8_paged_decode_attention)
    with tempfile.TemporaryDirectory() as tmp:
        broker = InMemoryBroker()
        tps = _resume_topics(broker, prompts)
        server, consumer, _ = _resume_server(cfg, params, broker, f"{tmp}/uncut.json",
                                             16, **kw)
        server.warmup()
        index = _prompt_index(broker, tps)
        uncut = _drive(server, consumer, kill=False)
        uncut_view, _ = _committed_once(what + " uncut", broker, n, tps)
        if any((uncut_view[index[k]] != out).any() for k, out in uncut.items()):
            raise AssertionError(f"{what}: the uncut run's outputs differ from its completions")
        del server

        def killed(path):
            """Run A on a fresh broker: returns the broker, A's producer,
            completions and the journal it left."""
            b = InMemoryBroker()
            _resume_topics(b, prompts)
            srv, cons, prod = _resume_server(cfg, params, b, path, 2**31 - 1, **kw)
            srv.warmup()
            outs = _drive(srv, cons, kill=True)
            flush_s = srv.flush_s
            cons.close()  # the death: no close, no commit, no flush
            recs, _ = b.fetch_stable(type(tps[0])("completions", 0), 0, 100)
            if recs or any(b.committed("resume", tp) is not None for tp in tps):
                raise AssertionError(f"{what}: A committed before its death")
            return b, prod, outs, flush_s

        def recover(b, path, hints):
            """Run B: time to recover runs from its construction (warmup
            included) to its last transaction commit."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv, cons, _ = _resume_server(cfg, params, b, path, 16, **kw)
            commits = []
            commit_txn = srv._commit_txn

            def timed_commit(t):
                ok = commit_txn(t)
                commits.append(time.perf_counter())
                return ok

            srv._commit_txn = timed_commit
            events = []
            resume = srv._resume_into_slot

            def timed_resume(i, rec, toks, hint, key_np):
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s.record()
                resume(i, rec, toks, hint, key_np)
                e.record()
                events.append((plen + len(hint.tokens) - 1, s, e))

            srv._resume_into_slot = timed_resume
            srv.warmup()
            torch.cuda.synchronize()
            for fn in kernels:
                fn.launches = 0
            flash_fwd_bhsd.tc_launches = 0
            if hints:
                srv.add_resume_hints(hints)
            outs = {(r.partition, r.offset): out for r, out in srv.run(max_records=n)}
            torch.cuda.synchronize()
            launches = {"flash_fwd": kernels[0].launches,
                        "flash_fwd_tc": kernels[0].tc_launches,
                        "kvattn_dynlen": kernels[1].launches,
                        "kvattn_paged": kernels[2].launches}
            cons.close()
            by_s: dict = {}
            for s_len, s, e in events:
                by_s.setdefault(s_len, []).append(s.elapsed_time(e))
            return {"server": srv, "outs": outs, "launches": launches,
                    "recover_s": commits[-1] - t0 if commits else None,
                    "resume_event_ms": {str(k): statistics.median(v)
                                        for k, v in sorted(by_s.items())}}

        jpath = f"{tmp}/journal.json"
        broker_w, prod_a, outs_a, flush_a = killed(jpath)
        hints = DecodeJournal.load(jpath)
        warm = recover(broker_w, jpath, hints)
        try:  # the successor's producer fenced A's
            prod_a.begin()
            raise AssertionError(f"{what}: A's producer was not fenced")
        except ProducerFencedError:
            pass
        view_w, committed_w = _committed_once(what + " warm", broker_w, n, tps)
        cpath = f"{tmp}/journal_cold.json"
        broker_c, _, outs_a2, _ = killed(cpath)
        cold = recover(broker_c, cpath, None)
        view_c, committed_c = _committed_once(what + " cold", broker_c, n, tps)

    finished = [e for e in hints.values() if e.finished]
    partial = [e for e in hints.values() if not e.finished and e.tokens]
    by_key = {(e.partition, e.offset): e for e in hints.values()}
    # The journal A left holds the uncut run's tokens: the same program up
    # to the kill.
    for (p, off), e in by_key.items():
        want = uncut[(p, off)][: len(e.tokens)]
        if list(e.tokens) != want.tolist() or (e.finished and len(e.tokens) != MAX_NEW):
            raise AssertionError(f"{what}: journal entry {(p, off)} differs from "
                                 "the uncut run's prefix")
    if len(finished) != len(outs_a):
        raise AssertionError(f"{what}: {len(finished)} finished entries, A "
                             f"finished {len(outs_a)}")
    mw, mc = warm["server"].metrics.summary(), cold["server"].metrics.summary()
    jw, jc = mw["journal"], mc["journal"]
    cold_admissions = n - len(finished) - len(partial)
    want_decoded = sum(MAX_NEW - len(e.tokens) for e in partial) + MAX_NEW * cold_admissions
    if (jw["served_from_journal"], jw["warm_resumes"], jw["decoded_tokens"]) != (
            len(finished), len(partial), want_decoded):
        raise AssertionError(f"{what}: warm journal counters {jw}, want served "
                             f"{len(finished)}, resumes {len(partial)}, decoded "
                             f"{want_decoded}")
    if not 0 < jw["decoded_tokens"] < jc["decoded_tokens"] or jc["warm_resumes"]:
        raise AssertionError(f"{what}: warm decoded {jw}, cold {jc}")
    for run in (warm, cold):
        m = run["server"].metrics.summary()
        draft_cfg = getattr(run["server"], "_draft_cfg", None)
        k1_layers = nl + (draft_cfg.n_layers if draft_cfg is not None else 0)
        want_l = {"flash_fwd": 0 if pages else k1_layers * (
                      m["prefills"] + m["journal"]["warm_resumes"]),
                  "kvattn_dynlen": 0, "kvattn_paged": 0}
        if any(run["launches"][k] != v for k, v in want_l.items()):
            raise AssertionError(f"{what}: launches {run['launches']}, want {want_l}")
        if (cfg.dtype == torch.bfloat16 and not pages
                and run["launches"]["flash_fwd_tc"] != run["launches"]["flash_fwd"]):
            raise AssertionError(f"{what}: flash tensor-core launches {run['launches']}")
        if m["txn"]["commits"] < 1 or m["txn"]["held_outputs"]:
            raise AssertionError(f"{what}: transactions {m['txn']}")
    post, post_same = 0, 0
    for e in partial:
        full = view_w[index[(e.partition, e.offset)]]
        ref = uncut[(e.partition, e.offset)]
        if (full[:len(e.tokens)] != ref[:len(e.tokens)]).any():
            raise AssertionError(f"{what}: a resumed output's restored prefix "
                                 "differs from the uncut run's")
        post += MAX_NEW - len(e.tokens)
        post_same += int((full[len(e.tokens):] == ref[len(e.tokens):]).sum())
    exact = cfg.dtype == torch.float32
    for name, view in (("warm", view_w), ("cold", view_c)):
        same = all((view[k] == uncut_view[k]).all() for k in uncut_view)
        if exact and not same:
            raise AssertionError(f"{what}: {name} recovery's tokens differ from the uncut run")
    flush_w = warm["server"].flush_s
    ms = lambda xs, q: 1e3 * float(np.quantile(xs, q)) if xs else None  # noqa: E731
    return {
        "phase": phase or ("serve_resume" if cfg.dtype == torch.bfloat16
                           else "serve_resume_f32"),
        "model": f"1b width, {nl} layers", "dtype": str(cfg.dtype)[6:],
        "pool": "paged" if pages else "dense", "kv_dtype": "compute",
        "sampling": SAMPLING if sampled else "greedy", "prompts": n, "prompt_len": plen,
        "max_new": MAX_NEW, "slots": 16, "ticks_per_sync": RESUME_TICKS,
        "journal_cadence": RESUME_CADENCE, "output": "TransactionalProducer, exactly_once",
        "a_completions_at_kill": len(outs_a), "a_again_completions_at_kill": len(outs_a2),
        "journal_finished": len(finished), "journal_partial": len(partial),
        "journal_partial_tokens": sorted({len(e.tokens) for e in partial}),
        "warm": {**jw, "txn": mw["txn"], "launches": warm["launches"],
                 "recover_s": warm["recover_s"],
                 "commit_ms_p50": mw["commit"]["p50_ms"], "commit_ms_p99": mw["commit"]["p99_ms"],
                 "resume_prefill_event_ms": warm["resume_event_ms"]},
        "cold": {**jc, "txn": mc["txn"], "launches": cold["launches"],
                 "recover_s": cold["recover_s"],
                 "commit_ms_p50": mc["commit"]["p50_ms"], "commit_ms_p99": mc["commit"]["p99_ms"]},
        "committed": committed_w, "committed_cold": committed_c,
        "post_prefix_tokens": post, "post_prefix_agreement_with_uncut":
            post_same / post if post else None,
        "warm_equals_uncut": all((view_w[k] == uncut_view[k]).all() for k in uncut_view),
        "cold_equals_uncut": all((view_c[k] == uncut_view[k]).all() for k in uncut_view),
        "journal_flush_host_ms_p50": ms(flush_a + flush_w, 0.5),
        "journal_flush_host_ms_p99": ms(flush_a + flush_w, 0.99),
        "journal_flushes": len(flush_a + flush_w),
        "nvidia_smi": smi_line(),
    }


def resume_prefill_times(torch, cfg, params) -> dict:
    """The warm resume's prefill alone (``prefill_capture`` of one
    sequence, all layers) at the ``RESUME_S`` lengths: device ms by CUDA
    events behind a device sleep (the host enqueues ~20 launches a
    layer), L2 flushed first."""
    from torchkafka_tpu_torch.models.generate import prefill_capture, prefill_model

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    model = prefill_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    out = {}
    with torch.inference_mode():
        for s in RESUME_S:
            toks = torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                                 device="cuda", dtype=torch.int32)
            out[str(s)] = cuda_ms(torch, lambda: prefill_capture(params, cfg, toks, model),
                                  flush, n=10, sleep_cycles=80_000_000)
    return out


def check_serve_resume_f32(torch, cfg, params) -> list:
    """``serve_resume`` at 1b width, 2 layers, f32, on the dense and the
    chunked paged compute-dtype pools, greedy and sampled: every warm and
    cold recovery equals the uncut run token for token and in its
    committed watermarks."""
    import numpy as np

    from torchkafka_tpu_torch.kvcache import PagedKVConfig

    prompts = np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, (32, 128), dtype=np.int32)
    nblk = -(-(128 + MAX_NEW) // PAGED_BS)
    pages = PagedKVConfig(block_size=PAGED_BS, num_blocks=16 * nblk + 1,
                          prefill_chunk=None)
    rows = []
    for pool in (None, pages):
        for sampled in (False, True):
            row = serve_resume(torch, cfg, params, prompts, pages=pool, sampled=sampled)
            if not (row["warm_equals_uncut"] and row["cold_equals_uncut"]):
                raise AssertionError(f"serve_resume_f32: {row}")
            rows.append(row)
    return rows


# ------------------------------------------------------ speculative serving

SPEC_K = 4  # draft tokens a verify (harness scenario 7 --spec)
SPEC_ROUNDS = -(-(MAX_NEW - 1) // (SPEC_K + 1))  # 13: a full-accept generation's rounds


def _against_plain(np, name, outs, row, plain_outs, plain_row, exact: bool) -> None:
    """A run against the plain run of the same stream: equal commits and
    token 0 (and, ``exact``, every token); the agreement is recorded."""
    if row["committed"] != plain_row["committed"]:
        raise AssertionError(f"{name}: committed {row['committed']} != plain "
                             f"{plain_row['committed']}")
    row["token0_identical_to_plain"] = all(
        int(outs[key][0]) == int(plain_outs[key][0]) for key in plain_outs)
    row["token_agreement_with_plain"] = float(np.mean(
        [np.mean(outs[key] == plain_outs[key]) for key in plain_outs]))
    if not row["token0_identical_to_plain"]:
        raise AssertionError(f"{name}: token 0 differs from the plain run")
    if exact and row["token_agreement_with_plain"] != 1.0:
        raise AssertionError(f"{name}: tokens differ from the plain run "
                             f"({row['token_agreement_with_plain']})")


def _spec_fields(row, ticks: int) -> None:
    """Rounds, α and tokens a slot-round of a speculative run; host ms a
    tick block and a round (tick) from the block's p50."""
    row["ms_per_round_p50"] = row["tick_block_ms_p50"] / ticks
    st = row.get("spec")
    if st is None:
        return
    if st["proposed"] <= 0:
        raise AssertionError(f"speculative run proposed nothing: {st}")
    slot_rounds = st["proposed"] / st["k"]
    row["tokens_per_slot_round"] = row["decoded_tokens"] / slot_rounds


def check_serve_spec(torch, cfg, params, prompts) -> list:
    """The serve phase's 1b model and 32 prompts, bf16 dense pool, plain
    (``MAX_NEW`` - 1 ticks a block) and speculative (k = ``SPEC_K``,
    ``SPEC_ROUNDS`` rounds a block) with the perfect draft and the
    half-depth self-draft: plain, perfect, self (the in-turn pairs were
    cut for the fleet and harness phases' time); then the self-draft's
    layers served plainly (t_draft).
    Each run: ``serve``'s checks (K1 = (layers + draft layers) x prefills on
    the tensor cores, K4 = K5 = 0), commits and token 0 equal to the
    first plain run's, proposals made. bench_spec's cost terms from the
    host-observed tick-block times: t_target and t_draft (ms a plain
    tick), c = t_draft / t_target, t_round (ms a self-draft round) and
    v = (t_round - (k + 1) t_draft) / t_target."""
    import numpy as np

    from torchkafka_tpu_torch.models.spec_decode import truncated_draft
    from torchkafka_tpu_torch.serve_spec import SpecStreamingGenerator

    t0 = time.perf_counter()
    spec = dict(server_cls=SpecStreamingGenerator, k=SPEC_K, ticks_per_sync=SPEC_ROUNDS)
    runs = {"plain": {}, "perfect": dict(spec, draft_params=params, draft_cfg=cfg),
            "self": spec}
    rows, plain = [], None
    for name in ("plain", "perfect", "self"):
        outs, row = serve(torch, cfg, params, prompts, None, **runs[name])
        row.update(phase="serve_spec", run=name,
                   draft_layers=row.get("spec", {}).get("draft_layers"),
                   ticks_per_sync=SPEC_ROUNDS if name != "plain" else MAX_NEW - 1)
        _spec_fields(row, row["ticks_per_sync"])
        if plain is None:
            plain = (outs, row)
        _against_plain(np, f"serve_spec {name}", outs, row, *plain, exact=False)
        rows.append(row)
    dparams, dcfg = truncated_draft(params, cfg, cfg.n_layers // 2)
    _, row_d = serve(torch, dcfg, dparams, prompts, None)
    row_d.update(phase="serve_spec", run="draft_alone", model=f"1b, first {dcfg.n_layers} layers",
                 ticks_per_sync=MAX_NEW - 1)
    _spec_fields(row_d, MAX_NEW - 1)
    rows.append(row_d)

    def mean(name, key):
        return statistics.mean(r[key] for r in rows if r["run"] == name)

    t_target, t_draft = mean("plain", "ms_per_round_p50"), row_d["ms_per_round_p50"]
    t_round = mean("self", "ms_per_round_p50")
    rows.append({
        "phase": "serve_spec_summary", "k": SPEC_K, "rounds_per_block": SPEC_ROUNDS,
        "draft_layers": cfg.n_layers // 2,
        "tokens_per_s": {n: [r["tokens_per_s"] for r in rows if r["run"] == n]
                         for n in ("plain", "perfect", "self", "draft_alone")},
        "acceptance": {n: [r["spec"]["acceptance"] for r in rows if r["run"] == n]
                       for n in ("perfect", "self")},
        "t_target_ms": t_target, "t_draft_ms": t_draft, "c": t_draft / t_target,
        "t_round_ms": t_round, "v": (t_round - (SPEC_K + 1) * t_draft) / t_target,
        "seconds": time.perf_counter() - t0, "nvidia_smi": smi_line(),
    })
    return rows


def check_serve_spec_paged(torch, cfg, params) -> list:
    """serve_paged's 48-prompt tenant stream through the bf16 compute-dtype
    paged chunked pool (blocks of 16), plain and then speculative
    (self-draft, k = ``SPEC_K``): ``serve_paged``'s checks (prefix hits,
    fewer prefill tokens than 48 x 128, K1 = K4 = K5 = 0), commits and
    token 0 equal, proposals made."""
    import numpy as np

    from torchkafka_tpu_torch.serve_spec import SpecStreamingGenerator

    t0 = time.perf_counter()
    prompts, keys = tenant_prompts(np, cfg.vocab_size)
    outs_p, row_p, _ = serve_paged(torch, cfg, params, prompts, keys, kv_dtype=None)
    outs_s, row_s, _ = serve_paged(torch, cfg, params, prompts, keys, kv_dtype=None,
                                   server_cls=SpecStreamingGenerator, k=SPEC_K)
    for run, row in (("plain", row_p), ("self", row_s)):
        row.update(phase="serve_spec_paged", run=run)
        _spec_fields(row, row["ticks_per_sync"])
    _against_plain(np, "serve_spec_paged", outs_s, row_s, outs_p, row_p, exact=False)
    row_s["seconds"] = time.perf_counter() - t0
    return [row_p, row_s]


def check_serve_spec_f32(torch, cfg, params) -> list:
    """At 1b width, 2 layers, f32: 32 prompts served plainly on the dense
    pool, then speculatively (k = ``SPEC_K``) with the perfect draft and
    the 1-layer self-draft on the dense, the legacy paged
    (``prefill_chunk=0``) and the chunked paged pool: every token and
    watermark equal to the plain run's, the perfect draft's α 1.0. Then
    ``serve_resume`` greedy through the speculative server on the dense
    and the chunked paged pool: both recoveries equal the uncut run."""
    import numpy as np

    from torchkafka_tpu_torch.kvcache import PagedKVConfig
    from torchkafka_tpu_torch.serve_spec import SpecStreamingGenerator

    t0 = time.perf_counter()
    prompts = np.random.default_rng(SEED + 13).integers(
        0, cfg.vocab_size, (32, 128), dtype=np.int32)
    nblk = -(-(128 + MAX_NEW + SPEC_K) // PAGED_BS)

    def pages(chunk):
        return PagedKVConfig(block_size=PAGED_BS, num_blocks=16 * nblk + 25,
                             prefill_chunk=chunk)

    plain_outs, plain_row = serve(torch, cfg, params, prompts, None)
    rows = []
    for pool, kv_pages in (("dense", None), ("paged_legacy", pages(0)),
                           ("paged_chunked", pages(None))):
        for draft, dkw in (("perfect", dict(draft_params=params, draft_cfg=cfg)),
                           ("self", dict(draft_layers=1))):
            outs, row = serve(torch, cfg, params, prompts, None,
                              server_cls=SpecStreamingGenerator, k=SPEC_K,
                              ticks_per_sync=SPEC_ROUNDS, kv_pages=kv_pages, **dkw)
            row.update(phase="serve_spec_f32", model=f"1b width, {cfg.n_layers} layers",
                       dtype="float32", pool=pool, run=draft)
            _spec_fields(row, SPEC_ROUNDS)
            _against_plain(np, f"serve_spec_f32 {pool} {draft}", outs, row, plain_outs,
                           plain_row, exact=True)
            if draft == "perfect" and row["spec"]["acceptance"] != 1.0:
                raise AssertionError(f"serve_spec_f32 {pool}: perfect draft α {row['spec']}")
            rows.append(row)
    for pool in (None, pages(None)):
        row = serve_resume(torch, cfg, params, prompts, pages=pool, sampled=False,
                           server_cls=SpecStreamingGenerator, phase="serve_spec_f32",
                           k=SPEC_K)
        if not (row["warm_equals_uncut"] and row["cold_equals_uncut"]):
            raise AssertionError(f"serve_spec_f32 resume: {row}")
        row["run"] = "resume"
        rows.append(row)
    rows[-1]["seconds"] = time.perf_counter() - t0
    return rows


# ---------------------------------------------------------------- the fleet

FLEET_N = 64  # scenario 10's stream at 1b: 64 prompts of 128 tokens
FLEET_PARTS = 4
FLEET_SLOTS = 8  # each of the two replicas; the single server has 16
FLEET_COMMIT = 4  # completions a replica commits at
FLEET_TICKS = 8  # decode ticks a block, in the fleet and the single server
FLEET_DT = 0.4  # synthetic seconds a scheduling round: ~ two replicas x 8 ticks at 1b
FLEET_QOS = dict(tenant_rates={"throttled": 4.0}, burst=1.0, max_queue_depth=64,
                 resume_queue_depth=16)
FLEET_CHAOS = dict(seed=2, min_completions=40, max_completions=48)
FLEET_CANARY = 8  # canary slice: completions the candidate shadow-decodes


class RoundClock:
    """The fleet's synthetic clock: ``FLEET_DT`` a scheduling round,
    advanced by the serve loop's ``on_round``. The token buckets and lane
    waits read it, so the admission schedule, the completion order and the
    seeded kill's victim and moment are the same in every run, on any
    device (no EOS: a slot's length never depends on its tokens)."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def on_round(self, _fleet, _served) -> None:
        self.t += FLEET_DT


def fleet_stream(np, vocab: int, n: int = FLEET_N, plen: int = 128):
    """Scenario 10's stream: every third prompt keyed ``throttled`` (lane
    batch), the others ``open`` (lane interactive); keyed production puts
    the two tenants on partitions 3 and 0 of 4 (crc32), one per replica."""
    prompts = np.random.default_rng(SEED + 21).integers(0, vocab, (n, plen),
                                                        dtype=np.int32)
    return prompts, [b"throttled" if i % 3 == 0 else b"open" for i in range(n)]


def produce_stream(broker, topic: str, prompts, keys, start: int = 0,
                   stop: int | None = None) -> dict:
    """Produce prompts [start, stop) of the stream keyed (the topic is made
    at ``start`` 0); → {(partition, offset): prompt index}."""
    if start == 0:
        broker.create_topic(topic, partitions=FLEET_PARTS)
    where = {}
    for i in range(start, len(keys) if stop is None else stop):
        key = keys[i]
        lane = b"batch" if key == b"throttled" else b"interactive"
        rec = broker.produce(topic, prompts[i].tobytes(), key=key,
                             headers=(("lane", lane),))
        where[(rec.partition, rec.offset)] = i
    return where


def _zero_launches():
    """Set every serving and training kernel's launch count to 0; → the
    reader of the counts (``fleet.proc.launch_counts``: K1-K3 with their
    tensor-core counts, K4, K5)."""
    from torchkafka_tpu_torch.fleet.proc import launch_counts
    from torchkafka_tpu_torch.ops import flash, kvattn

    for fn in (flash.flash_fwd_bhsd, flash.flash_dq_bhsd, flash.flash_dkv_bhsd):
        fn.launches = fn.tc_launches = 0
    for fn in (kvattn.int8_decode_attention_dynlen, kvattn.int8_paged_decode_attention):
        fn.launches = 0
    return launch_counts


def _check_launches(what, cfg, launches, gens, shadows=(), cuda=True) -> dict:
    """K1 = layers x (prefills + warm resumes) and K4 = layers x decode
    ticks summed over ``gens`` (replicas) and ``shadows`` (canary servers)
    on the dense int8 pool (K4 = 0 on a compute-dtype pool); K5 = 0; bf16
    K1 on the tensor cores. → the expected counts."""
    import torch

    nl = cfg.n_layers
    ms = [g.metrics for g in list(gens) + list(shadows)]
    int8 = [g._kv_int8 for g in list(gens) + list(shadows)]
    want = {
        "flash_fwd": nl * sum(m.prefills.count + m.warm_resumes.count for m in ms),
        "kvattn_dynlen": nl * sum(m.decode_ticks.count for m, q in zip(ms, int8) if q),
        "kvattn_paged": 0,
    }
    if not cuda:
        return want
    got = {k: launches[k] for k in want}
    if got != want or want["flash_fwd"] == 0:
        raise AssertionError(f"{what}: launches {launches}, want {want}")
    if cfg.dtype == torch.bfloat16 and launches["flash_fwd_tc"] != launches["flash_fwd"]:
        raise AssertionError(f"{what}: tensor-core K1 {launches}")
    return want


def fleet_single(torch, cfg, params, prompts, keys, device, kv_dtype, **kw):
    """The 16-slot single server over the fleet's stream → ({(p, o):
    tokens}, row)."""
    from torchkafka_tpu_torch.serve import StreamingGenerator
    from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer
    from torchkafka_tpu_torch.source.records import TopicPartition

    broker = InMemoryBroker()
    produce_stream(broker, "t10", prompts, keys)
    consumer = MemoryConsumer(broker, "t10", group_id="single")
    server = StreamingGenerator(
        consumer, params, cfg, slots=2 * FLEET_SLOTS, prompt_len=prompts.shape[1],
        max_new=MAX_NEW, commit_every=FLEET_COMMIT, ticks_per_sync=FLEET_TICKS,
        kv_dtype=kv_dtype, kv_kernel=True if kv_dtype else "auto", device=device, **kw)
    server.warmup()
    read = _zero_launches()
    t0 = time.perf_counter()
    outs = {(r.partition, r.offset): o for r, o in server.run(max_records=len(keys))}
    _sync(torch, device)
    elapsed = time.perf_counter() - t0
    launches = read()
    consumer.close()
    tps = [TopicPartition("t10", p) for p in range(FLEET_PARTS)]
    committed = [broker.committed("single", tp) or 0 for tp in tps]
    ends = [broker.end_offset(tp) for tp in tps]
    if len(outs) != len(keys) or committed != ends:
        raise AssertionError(f"single server: {len(outs)} completions, committed "
                             f"{committed} != {ends}")
    _check_launches("single server", cfg, launches, [server], cuda=device == "cuda")
    tokens = sum(len(o) for o in outs.values())
    return outs, {"run": "single", "slots": 2 * FLEET_SLOTS, "elapsed_s": elapsed,
                  "tokens_per_s": tokens / elapsed, "committed": committed,
                  "launches": launches}


def _sync(torch, device) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def make_fleet(cfg, params, broker, plen, device, *, kv_dtype, group="fleet",
               journal_dir=None, gen_kwargs=None, generator_cls=None):
    """The 2-replica ``ServingFleet`` over topic "t10" of ``broker`` (8 slots
    each, QoS in front, the synthetic round clock), every commit audited
    (``fleet/drill.py``) and recorded with the version live on its
    replica; commits an earlier fleet left on the group are exempt.
    → (fleet, clock, audit)."""
    from torchkafka_tpu_torch.fleet import QoSConfig, ServingFleet
    from torchkafka_tpu_torch.fleet.drill import audited_consumer
    from torchkafka_tpu_torch.source.memory import MemoryConsumer
    from torchkafka_tpu_torch.source.records import TopicPartition

    audit = {"completed": None, "commits": [], "floor": {
        p: broker.committed(group, TopicPartition("t10", p)) or 0
        for p in range(FLEET_PARTS)}}
    cls = audited_consumer(MemoryConsumer, audit)
    clock = RoundClock()
    kw = {"kv_dtype": kv_dtype, "kv_kernel": True if kv_dtype else "auto",
          "ticks_per_sync": FLEET_TICKS, "device": device, **(gen_kwargs or {})}
    extra = {} if generator_cls is None else {"generator_cls": generator_cls}
    fleet = ServingFleet(
        lambda rid: cls(broker, "t10", group_id=group, member_id=f"{group}-r{rid:03d}"),
        params, cfg, replicas=2, prompt_len=plen, max_new=MAX_NEW, slots=FLEET_SLOTS,
        qos=QoSConfig(**FLEET_QOS), commit_every=FLEET_COMMIT, clock=clock,
        gen_kwargs=kw, journal_dir=journal_dir, **extra)
    audit["completed"] = fleet.completed
    audit["version_of"] = lambda member: next(
        r for r in fleet.replicas if f"{group}-r{r.id:03d}" == member).gen.model_version
    return fleet, clock, audit


def fleet_run(torch, cfg, params, prompts, keys, device, *, kv_dtype, group="fleet",
              chaos=None, journal_dir=None, broker=None, gen_kwargs=None,
              generator_cls=None, on_round=None, on_yield=None, stop_at=None,
              close=True, mem=None):
    """One serve of the stream by ``make_fleet``'s fleet. ``chaos``:
    ``ReplicaChaos`` kwargs; ``stop_at``: drain after that many
    completions; ``mem``: a dict that gets the bytes the fleet's build
    allocated on the card (``fleet_bytes``). → dict(outs [(rid, p, o,
    tokens)], fleet, broker, row, watermarks, audit)."""
    from torchkafka_tpu_torch.fleet import ReplicaChaos
    from torchkafka_tpu_torch.source.memory import InMemoryBroker

    if broker is None:
        broker = InMemoryBroker()
        produce_stream(broker, "t10", prompts, keys)
    if mem is not None:
        gc.collect()  # garbage of earlier phases freed now, not during the build
        _sync(torch, device)
        before = torch.cuda.memory_allocated()
    fleet, clock, audit = make_fleet(cfg, params, broker, prompts.shape[1], device,
                                     kv_dtype=kv_dtype, group=group, journal_dir=journal_dir,
                                     gen_kwargs=gen_kwargs, generator_cls=generator_cls)
    if mem is not None:
        _sync(torch, device)
        mem["fleet_bytes"] = torch.cuda.memory_allocated() - before
    fleet.warmup()
    killer = ReplicaChaos(**chaos) if chaos else None

    def round_hook(f, served):
        clock.on_round(f, served)
        if on_round is not None:
            on_round(f, served)

    read = _zero_launches()
    outs = []
    t0 = time.perf_counter()
    for rid, rec, toks in fleet.serve(idle_timeout_ms=500, chaos=killer,
                                      on_round=round_hook):
        outs.append((rid, rec.partition, rec.offset, toks))
        if on_yield is not None:
            on_yield(rid, rec, toks)
        if stop_at is not None and len(outs) == stop_at:
            fleet.drain()
    _sync(torch, device)
    elapsed = time.perf_counter() - t0
    launches = read()
    s = fleet.metrics.summary(fleet.replicas)
    tokens = sum(len(o[3]) for o in outs)
    row = {"run": "fleet", "replicas": 2, "slots": FLEET_SLOTS, "elapsed_s": elapsed,
           "tokens_per_s": tokens / elapsed, "completions": len(outs),
           "per_replica": {str(r): {"completions": v["completions"]}
                           for r, v in s["replicas"].items()},
           "duplicates": s["duplicates"], "replica_deaths": s["replica_deaths"],
           "journal": s["journal"], "killed": killer.killed if killer else None,
           "lane_wait_p50_synthetic_s": {k: v["p50_ms"] / 1e3 for k, v in s["lanes"].items()},
           "tenants": {t: {k: v[k] for k in ("admitted", "throttled")}
                       for t, v in s["tenants"].items()},
           "backpressure_pauses": s["backpressure_pauses"],
           "commit_ms": {k: s["commit"].get(k) for k in ("p50_ms", "p99_ms")},
           "decode_ticks": sum(r.gen.metrics.decode_ticks.count for r in fleet.replicas),
           "prefills": sum(r.gen.metrics.prefills.count for r in fleet.replicas),
           "launches": launches}
    watermarks = fleet.watermarks()
    if close:
        fleet.close()
    return {"outs": outs, "fleet": fleet, "broker": broker, "row": row,
            "watermarks": watermarks, "audit": audit}


def _fleet_committed(broker, group="fleet"):
    from torchkafka_tpu_torch.source.records import TopicPartition

    tps = [TopicPartition("t10", p) for p in range(FLEET_PARTS)]
    return ([broker.committed(group, tp) or 0 for tp in tps],
            [broker.end_offset(tp) for tp in tps])


def _held_fleet(what, run, where, group="fleet") -> dict:
    """Every prompt completed at least once, committed == end offsets, the
    merged watermarks equal the broker's commits. → {(p, o): [tokens...]}."""
    committed, ends = _fleet_committed(run["broker"], group)
    if committed != ends:
        raise AssertionError(f"{what}: committed {committed} != end offsets {ends}")
    got: dict = {}
    for _rid, p, o, toks in run["outs"]:
        got.setdefault((p, o), []).append(toks)
    if set(got) != set(where):
        raise AssertionError(f"{what}: {len(set(where) - set(got))} prompts never served")
    wm = {tp.partition: off for tp, off in run["watermarks"].items()}
    if any(wm.get(p, 0) != committed[p] for p in range(FLEET_PARTS) if committed[p]):
        raise AssertionError(f"{what}: merged watermarks {wm} != committed {committed}")
    run["row"]["committed"] = committed
    return got


def _equal_to_single(np, what, got, single, exact: bool) -> dict:
    """Each copy's token 0 (every token when ``exact``) equals the single
    server's; → the agreement printed."""
    agree = []
    for key, copies in got.items():
        ref = single[key]
        for toks in copies:
            if int(toks[0]) != int(ref[0]) or (exact and not np_equal(toks, ref)):
                raise AssertionError(f"{what}: prompt {key} differs from the single server")
            agree.append(float(np.mean(toks == ref)))
    return {"token0_identical": True, "token_agreement": float(np.mean(agree))}


def batch_invariance(torch, cfg, params) -> dict:
    """Whether one record's prefill (logits, k, v) is bitwise the same
    alone as in a batch of 8, and one row of the head GEMM at M = 1 as at
    M = 8: what a canary shadow decoding one record at a time can
    reproduce of its replica's batches (why the shadow keeps the
    replica's slot count)."""
    import numpy as np

    from torchkafka_tpu_torch.models.generate import prefill_capture, prefill_model

    model = prefill_model(cfg)
    toks = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (8, 128), dtype=np.int32)).cuda()
    with torch.inference_mode():
        lb, kb, vb = prefill_capture(params, cfg, toks, model)
        l1, k1, v1 = prefill_capture(params, cfg, toks[3:4], model)
        head = params["lm_head"]
        x = torch.randn(8, cfg.d_model, device="cuda", dtype=cfg.dtype)
        h8 = x @ head
        h1 = x[3:4] @ head
    return {"phase": "batch_invariance",
            "prefill_logits_bitwise": bool(torch.equal(lb[3:4], l1)),
            "prefill_kv_bitwise": bool(torch.equal(kb[:, 3:4], k1) and torch.equal(vb[:, 3:4], v1)),
            "prefill_argmax_equal": bool(torch.equal(lb[3:4].argmax(-1), l1.argmax(-1))),
            "head_gemm_m1_vs_m8_bitwise": bool(torch.equal(h8[3:4], h1)),
            "prefill_logits_max_abs_diff": float((lb[3:4] - l1).abs().max())}


def check_serve_fleet(torch, cfg, params, device="cuda") -> list:
    """Scenario 10 at 1b on one card: the single server, then the
    2-replica fleet with a journal and one seeded kill; then a drain and a
    second fleet on the same group. Memory: one 8-slot server against a
    fleet of two."""
    import tempfile

    import numpy as np

    from torchkafka_tpu_torch.serve import StreamingGenerator
    from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer

    t0 = time.perf_counter()
    prompts, keys = fleet_stream(np, cfg.vocab_size)
    where = produce_stream(InMemoryBroker(), "t10", prompts, keys)
    rows = []
    mem = {}
    if device == "cuda":
        # One 8-slot server's bytes; the first fleet run records its own
        # build's, and the difference must be one pool: the params tree is
        # shared by the replicas, never copied.
        gc.collect()
        _sync(torch, device)
        base = torch.cuda.memory_allocated()
        b = InMemoryBroker()
        b.create_topic("m", partitions=1)
        one = StreamingGenerator(MemoryConsumer(b, "m", group_id="m"), params, cfg,
                                 slots=FLEET_SLOTS, prompt_len=128, max_new=MAX_NEW,
                                 kv_dtype="int8", kv_kernel=True, device=device)
        mem["pool_bytes"] = sum(c.numel() * c.element_size() for c in one._caches)
        mem["one_server_bytes"] = torch.cuda.memory_allocated() - base
        del one
        torch.cuda.empty_cache()
    single = {}
    for turn in ("single", "fleet"):
        if turn == "single":
            outs, row = fleet_single(torch, cfg, params, prompts, keys, device, "int8")
            if single and any(not np_equal(outs[k], single[k]) for k in outs):
                raise AssertionError("serve_fleet: the two single runs differ")
            single = single or outs
            rows.append({"phase": "serve_fleet", "model": "1b", **row})
            continue
        first = device == "cuda" and "fleet_bytes" not in mem
        with tempfile.TemporaryDirectory() as jdir:
            run = fleet_run(torch, cfg, params, prompts, keys, device, kv_dtype="int8",
                            chaos=FLEET_CHAOS, journal_dir=jdir,
                            mem=mem if first else None)
        if first:
            extra = mem["fleet_bytes"] - mem["one_server_bytes"]
            mem["second_replica_bytes"] = extra
            if abs(extra - mem["pool_bytes"]) > 64 << 20:  # the weights are ~0.64 GB
                raise AssertionError(f"serve_fleet: the second replica took {extra} "
                                     f"bytes, its pool {mem['pool_bytes']}: {mem}")
        got = _held_fleet("serve_fleet", run, where)
        row = run["row"]
        j = row["journal"]
        if row["duplicates"] < 1 or j["handoffs"] < 1 or row["replica_deaths"] != 1:
            raise AssertionError(f"serve_fleet: the kill served no duplicate: {row}")
        survivor = [r for r in run["fleet"].replicas if r.state != "dead"][0]
        sj = survivor.gen.metrics.journal_summary()
        if sj["warm_resumes"] + sj["served_from_journal"] < 1:
            raise AssertionError(f"serve_fleet: the survivor resumed nothing warm: {sj}")
        row["survivor_journal"] = sj
        row["tokens_restored"] = j["tokens_restored"]
        row["tokens_decoded_again"] = (
            sum(r.gen.metrics.decoded_tokens.count for r in run["fleet"].replicas)
            - len(where) * (MAX_NEW - 1))
        row.update(_equal_to_single(np, "serve_fleet", got, single, exact=False))
        _check_launches("serve_fleet", cfg, row["launches"],
                        [r.gen for r in run["fleet"].replicas], cuda=device == "cuda")
        rows.append({"phase": "serve_fleet", "model": "1b", **row})
    # Drain after half the prompts; a second fleet on the same group.
    b = InMemoryBroker()
    produce_stream(b, "t10", prompts, keys)
    first = fleet_run(torch, cfg, params, prompts, keys, device, kv_dtype="int8",
                      broker=b, group="drain", stop_at=FLEET_N // 2)
    states = [r.state for r in first["fleet"].replicas]
    second = fleet_run(torch, cfg, params, prompts, keys, device, kv_dtype="int8",
                       broker=b, group="drain")
    k1 = {(p, o) for _r, p, o, _t in first["outs"]}
    k2 = {(p, o) for _r, p, o, _t in second["outs"]}
    committed, ends = _fleet_committed(b, "drain")
    if states != ["done", "done"] or k1 | k2 != set(where) or k1 & k2 or committed != ends:
        raise AssertionError(f"serve_fleet drain: states {states}, {len(k1)} + {len(k2)} "
                             f"served, {len(k1 & k2)} by both, committed {committed}")
    rows.append({"phase": "serve_fleet", "model": "1b", "run": "drain_restart",
                 "first": len(k1), "second": len(k2), "served_by_both": 0,
                 "drained_states": states, "committed": committed,
                 "tokens_per_s": [first["row"]["tokens_per_s"], second["row"]["tokens_per_s"]]})
    fleet_tps = [r["tokens_per_s"] for r in rows if r.get("run") == "fleet"]
    single_tps = [r["tokens_per_s"] for r in rows if r.get("run") == "single"]
    rows.append({"phase": "serve_fleet", "summary": True, "memory": mem,
                 "fleet_tokens_per_s": fleet_tps, "single_tokens_per_s": single_tps,
                 "fleet_over_single": statistics.mean(fleet_tps) / statistics.mean(single_tps),
                 "seconds": time.perf_counter() - t0})
    return rows


def _tree_leaves(tree, path=""):
    """(path, tensor) of every leaf, ``QTensor`` pairs included, in the
    checkpoint wire's order, on the tensors' own device."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, tuple):
        for i, x in enumerate(tree):
            yield from _tree_leaves(x, f"{path}/{i}")
    else:
        yield path, tree


def _tagged_output(rec, toks) -> bytes:
    """Output values carry their prompt's (partition, offset) ahead of the
    tokens, so every output record names the record it answers."""
    import numpy as np

    return np.asarray([rec.partition, rec.offset], np.int32).tobytes() + \
        np.asarray(toks, np.int32).tobytes()


def _versions_by_window(what, run, n) -> dict:
    """The output topic of ``run``: every one of the ``n`` prompts
    answered, and each output record's ``mv`` header the version live on
    the replica at the commit that closed its prompt's window
    (``fleet/drill.py``'s ``window_versions`` over the audited commits).
    → {"windows": windows holding outputs, "by_version": {mv: outputs}}."""
    import numpy as np

    from torchkafka_tpu_torch.fleet.drill import window_versions
    from torchkafka_tpu_torch.source.records import TopicPartition

    broker = run["broker"]
    tp = TopicPartition("out", 0)
    outputs = []
    for r in broker.fetch(tp, 0, broker.end_offset(tp)):
        p, o = (int(x) for x in np.frombuffer(r.value[:8], np.int32))
        outputs.append((p, o, int(dict(r.headers)["mv"])))
    if len({(p, o) for p, o, _mv in outputs}) < n:
        raise AssertionError(f"{what}: {len(outputs)} outputs for {n} prompts")
    try:
        return window_versions(run["audit"]["commits"], outputs)
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from None


def _shadow_spy(fleet) -> list:
    """Wrap every replica's ``spawn_shadow`` to keep the canary servers it
    builds (their launches count on the main path too)."""
    shadows = []
    for rep in fleet.replicas:
        orig = rep.gen.spawn_shadow

        def spawn(params, version, orig=orig):
            s = orig(params, version)
            shadows.append(s)
            return s

        rep.gen.spawn_shadow = spawn
    return shadows


def _rollout_run(torch, cfg, params, v1, prompts, keys, device, *, kv_dtype,
                 canary=FLEET_CANARY, max_diffs=0):
    """An in-process rollout to version 1 (``v1``) on the fleet without
    chaos, with an output topic: two thirds of the stream are produced at
    the start, the last third once the rollout is done (promoted or rolled
    back), so traffic after it shows which version serves. → (run, the
    in-process rollout, its canary shadows)."""
    from torchkafka_tpu_torch.source.memory import InMemoryBroker
    from torchkafka_tpu_torch.source.producer import MemoryProducer

    broker = InMemoryBroker()
    early = 2 * len(keys) // 3
    produce_stream(broker, "t10", prompts, keys, stop=early)
    broker.create_topic("out", partitions=1)
    state = {}

    def on_round(f, served):
        if "drv" not in state:
            state["shadows"] = _shadow_spy(f)
            state["drv"] = f.start_rollout(1, {0: params, 1: v1}, canary_slice=canary,
                                           max_canary_diffs=max_diffs)
        state["drv"].on_round(f, served)
        if state["drv"].done and not state.get("late"):
            state["late"] = True
            produce_stream(broker, "t10", prompts, keys, start=early)

    def on_yield(rid, rec, toks):
        state["drv"].observe(rid, rec, toks)

    run = fleet_run(torch, cfg, params, prompts, keys, device, kv_dtype=kv_dtype,
                    broker=broker, on_round=on_round, on_yield=on_yield, close=False,
                    gen_kwargs={"output_producer": MemoryProducer(broker),
                                "output_topic": "out", "encode_output": _tagged_output})
    drv = state["drv"]
    for _ in range(20):  # the tail of a rollout may ride an idle fleet
        if drv.done:
            break
        drv.on_round(run["fleet"], len(run["outs"]))
    run["fleet"].close()
    return run, drv, state["shadows"]


def check_serve_fleet_rollout(torch, cfg, params, device="cuda") -> list:
    """The rolling hot-swap at 1b on the fleet without chaos: (a) a clean
    in-process rollout (version 1 = the same weights) promotes on both
    replicas with no canary diff; (b) a divergent one (weights of another
    seed) rolls back and no output of version 1 reaches the output topic;
    (c) version 1 published on a checkpoint topic, fetched CRC-checked by
    one ``RolloutWorker`` a replica under a ``BrokerRolloutDriver`` and
    rebuilt onto the card bitwise equal to it, then served."""
    import numpy as np

    from torchkafka_tpu_torch.fleet import BrokerRolloutDriver, RolloutController, RolloutWorker
    from torchkafka_tpu_torch.models.zoo import random_serving_params
    from torchkafka_tpu_torch.source import checkpoint_wire as cw
    from torchkafka_tpu_torch.source.memory import InMemoryBroker
    from torchkafka_tpu_torch.source.producer import MemoryProducer

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    v1 = random_serving_params(gen, cfg, device=device)
    rows = [batch_invariance(torch, cfg, params)] if device == "cuda" else []
    # 36 and 24 prompts: the canary replica's first wave (8 of the ``open``
    # tenant's records, two thirds of the stream before the rollout) fills
    # the canary slice.
    # A divergent candidate differs on its first record, so its canary
    # slice is 2.
    for name, cand, n, canary in (("clean", params, 36, FLEET_CANARY),
                                  ("divergent", v1, 24, 2)):
        prompts, keys = fleet_stream(np, cfg.vocab_size, n=n)
        where = produce_stream(InMemoryBroker(), "t10", prompts, keys)
        run, drv, shadows = _rollout_run(torch, cfg, params, cand, prompts, keys, device,
                                         kv_dtype="int8", canary=canary)
        _held_fleet(f"serve_fleet_rollout {name}", run, where)
        ctl, f = drv.controller, run["fleet"]
        versions = [r.gen.model_version for r in f.replicas]
        windows = _versions_by_window(f"serve_fleet_rollout {name}", run, len(where))
        counts = windows["by_version"]
        diffs = f.metrics.canary_token_diffs.count
        if name == "clean" and (ctl.phase != "complete" or versions != [1, 1] or diffs
                                or not counts.get(1)):
            raise AssertionError(f"clean rollout: {ctl.phase}, {versions}, {diffs} diffs, "
                                 f"outputs by version {counts}")
        if name == "divergent" and (ctl.phase != "rolled_back" or versions != [0, 0]
                                    or 1 in counts or diffs < 1):
            raise AssertionError(f"divergent rollout: {ctl.phase}, {versions}, {diffs} "
                                 f"diffs, outputs by version {counts}")
        _check_launches(f"serve_fleet_rollout {name}", cfg, run["row"]["launches"],
                        [r.gen for r in f.replicas], shadows, cuda=device == "cuda")
        rows.append({"phase": "serve_fleet_rollout", "run": name, "rollout": ctl.phase,
                     "versions": versions, "canary_diffs": diffs,
                     "canary_slice": ctl.canary_slice, "outputs_by_version": counts,
                     "commit_windows": windows["windows"],
                     "shadow_prefills": sum(s.metrics.prefills.count for s in shadows),
                     **{k: run["row"][k] for k in ("elapsed_s", "tokens_per_s",
                                                   "launches", "committed")}})
    # (c) the broker path.
    prompts, keys = fleet_stream(np, cfg.vocab_size, n=24)
    where = produce_stream(InMemoryBroker(), "t10", prompts, keys)
    broker = InMemoryBroker()
    early = 2 * len(keys) // 3
    produce_stream(broker, "t10", prompts, keys, stop=early)
    for topic in ("out", "ckpt", "ctl"):
        broker.create_topic(topic, partitions=1)
    _sync(torch, device)
    t_pub = time.perf_counter()
    frames = cw.publish_checkpoint(broker, "ckpt", 1, v1, chunk_bytes=16 << 20)
    publish_s = time.perf_counter() - t_pub
    state = {}
    swap_ms, fetch_s = [], []

    def on_round(f, served):
        if "drv" not in state:
            ctl = RolloutController([f"r{r.id}" for r in f.replicas], 1,
                                    canary_slice=2, max_canary_diffs=2,
                                    metrics=f.metrics)
            state["drv"] = BrokerRolloutDriver(broker, "ctl", ctl)
            state["workers"] = {r.id: RolloutWorker(broker, "ctl", "ckpt", f"r{r.id}", r,
                                                    boot_params=params, metrics=f.metrics)
                                for r in f.replicas}
            for w in state["workers"].values():
                resolve = w._resolve

                def timed_resolve(version, resolve=resolve, w=w):
                    fresh = version not in w._params_by_version
                    ts = time.perf_counter()
                    out = resolve(version)
                    _sync(torch, device)
                    if fresh:  # a fetch over the wire and a rebuild on the card
                        fetch_s.append(time.perf_counter() - ts)
                    return out

                w._resolve = timed_resolve
            state["shadows"] = _shadow_spy(f)
            for rep in f.replicas:
                orig = rep.gen.swap_params

                def timed(p, v, orig=orig):
                    _sync(torch, device)
                    ts = time.perf_counter()
                    orig(p, v)
                    _sync(torch, device)
                    swap_ms.append((time.perf_counter() - ts) * 1e3)

                rep.gen.swap_params = timed
            state["drv"].start()
        state["drv"].pump()
        for w in state["workers"].values():
            w.pump([])
        if state["drv"].done and not state.get("late"):
            state["late"] = True
            produce_stream(broker, "t10", prompts, keys, start=early)

    def on_yield(rid, rec, toks):
        state["workers"][rid].pump([(rec, toks)])

    run = fleet_run(torch, cfg, params, prompts, keys, device, kv_dtype="int8",
                    broker=broker, on_round=on_round, on_yield=on_yield, close=False,
                    gen_kwargs={"output_producer": MemoryProducer(broker),
                                "output_topic": "out", "encode_output": _tagged_output})
    for _ in range(40):
        if state["drv"].done:
            break
        on_round(run["fleet"], len(run["outs"]))
    f = run["fleet"]
    f.close()
    _held_fleet("serve_fleet_rollout broker", run, where)
    ctl = state["drv"].controller
    versions = [r.gen.model_version for r in f.replicas]
    windows = _versions_by_window("serve_fleet_rollout broker", run, len(where))
    counts = windows["by_version"]
    trees = [w._params_by_version.get(1) for w in state["workers"].values()]
    want = list(_tree_leaves(v1))
    bitwise = all(
        t is not None and [n for n, _ in _tree_leaves(t)] == [n for n, _ in want]
        and all(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
                for (_, a), (_, b) in zip(_tree_leaves(t), want))
        for t in trees)
    on_card = all(r.gen._params["embed"].device.type == device for r in f.replicas)
    if ctl.phase != "complete" or versions != [1, 1] or not bitwise or not on_card \
            or not counts.get(1):
        raise AssertionError(f"broker rollout: {ctl.phase}, {versions}, bitwise {bitwise}, "
                             f"on the card {on_card}, outputs by version {counts}")
    _check_launches("serve_fleet_rollout broker", cfg, run["row"]["launches"],
                    [r.gen for r in f.replicas], state["shadows"], cuda=device == "cuda")
    nbytes = sum(a.numel() * a.element_size() for _n, a in want)
    rows.append({"phase": "serve_fleet_rollout", "run": "broker", "rollout": ctl.phase,
                 "versions": versions, "rebuilt_bitwise": bitwise, "frames": frames,
                 "checkpoint_bytes": nbytes, "publish_s": publish_s,
                 "fetch_rebuild_s": fetch_s, "swap_params_ms": swap_ms,
                 "canary_diffs": f.metrics.canary_token_diffs.count,
                 "outputs_by_version": counts, "commit_windows": windows["windows"],
                 "seconds": time.perf_counter() - t0,
                 **{k: run["row"][k] for k in ("elapsed_s", "tokens_per_s", "launches",
                                               "committed")}})
    return rows


def check_serve_fleet_f32(torch, cfg, params, device="cuda") -> list:
    """At 1b width, 2 layers, f32: (1) the single server against the fleet
    with a journal and the seeded kill on the compute-dtype pool (partial
    hints resume warm there): every token of every copy equal; (2) a clean
    rollout's outputs equal the fleet's without one; (3) a speculative
    fleet (k = 4, the perfect draft) publishing to a distill topic, then
    a draft refresh through ``start_distill`` while a replica is killed:
    every completion equal; (4) a ``FleetAutoscaler`` loop driven by the
    workload generator under a manual clock scales up and down and
    replays byte for byte."""
    import tempfile

    import numpy as np

    from torchkafka_tpu_torch.distill import DistillPolicy, decode_completion
    from torchkafka_tpu_torch.fleet.drill import autoscaled_run
    from torchkafka_tpu_torch.models.zoo import random_serving_params
    from torchkafka_tpu_torch.serve_spec import SpecStreamingGenerator
    from torchkafka_tpu_torch.source.memory import InMemoryBroker
    from torchkafka_tpu_torch.source.producer import MemoryProducer
    from torchkafka_tpu_torch.source.records import TopicPartition

    t0 = time.perf_counter()
    prompts, keys = fleet_stream(np, cfg.vocab_size)
    where = produce_stream(InMemoryBroker(), "t10", prompts, keys)
    single, srow = fleet_single(torch, cfg, params, prompts, keys, device, None)
    rows = [{"phase": "serve_fleet_f32", **srow}]
    with tempfile.TemporaryDirectory() as jdir:
        run = fleet_run(torch, cfg, params, prompts, keys, device, kv_dtype=None,
                        chaos=FLEET_CHAOS, journal_dir=jdir)
    got = _held_fleet("serve_fleet_f32", run, where)
    row = run["row"]
    _equal_to_single(np, "serve_fleet_f32", got, single, exact=True)
    if row["duplicates"] < 1 or row["journal"]["warm_resumes"] < 1:
        raise AssertionError(f"serve_fleet_f32: no warm resume after the kill: {row}")
    _check_launches("serve_fleet_f32", cfg, row["launches"],
                    [r.gen for r in run["fleet"].replicas], cuda=device == "cuda")
    rows.append({"phase": "serve_fleet_f32", **row, "every_token_equal": True})
    # (2) a clean rollout against none, both with the tagged output topic.
    plain = fleet_run(torch, cfg, params, prompts, keys, device, kv_dtype=None)
    ro, drv, _shadows = _rollout_run(torch, cfg, params, params, prompts, keys, device,
                                     kv_dtype=None, canary=4)
    pg = _held_fleet("serve_fleet_f32 plain", plain, where)
    rg = _held_fleet("serve_fleet_f32 rollout", ro, where)
    same = all(np_equal(rg[k][0], pg[k][0]) for k in where)
    if drv.controller.phase != "complete" or not same:
        raise AssertionError(f"serve_fleet_f32 rollout: {drv.controller.phase}, equal {same}")
    windows = _versions_by_window("serve_fleet_f32", ro, len(where))
    rows.append({"phase": "serve_fleet_f32", "run": "clean_rollout",
                 "rollout": drv.controller.phase, "equal_to_no_rollout": same,
                 "outputs_by_version": windows["by_version"],
                 "commit_windows": windows["windows"]})
    # (3) the speculative fleet: the distill publisher, then a refresh under a kill.
    spec_kw = {"k": SPEC_K, "draft_params": params, "draft_cfg": cfg}
    b = InMemoryBroker()
    produce_stream(b, "t10", prompts, keys)
    for topic in ("out", "distill"):
        b.create_topic(topic, partitions=1)
    spec = fleet_run(torch, cfg, params, prompts, keys, device, kv_dtype=None, broker=b,
                     generator_cls=SpecStreamingGenerator,
                     gen_kwargs={**spec_kw, "output_producer": MemoryProducer(b),
                                 "output_topic": "out", "distill_topic": "distill"})
    sg = _held_fleet("serve_fleet_f32 spec", spec, where)
    _equal_to_single(np, "serve_fleet_f32 spec", sg, single, exact=True)
    tp = TopicPartition("distill", 0)
    frames = [decode_completion(r.value) for r in b.fetch(tp, 0, b.end_offset(tp))]
    published = sum(r.gen.metrics.distill_published.count for r in spec["fleet"].replicas)
    by_prompt = {bytes(np.asarray(fr["prompt"], np.int32).tobytes()): fr for fr in frames}
    ok = published == len(frames) == len(where) and all(
        np_equal(np.asarray(by_prompt[prompts[i].tobytes()]["tokens"]), sg[k][0])
        for k, i in where.items())
    if not ok:
        raise AssertionError(f"serve_fleet_f32 distill: {published} published, "
                             f"{len(frames)} frames for {len(where)} prompts")
    draft1 = random_serving_params(torch.Generator(device=device).manual_seed(SEED + 2),
                                   cfg, device=device)
    state = {}

    def hook(f, served):
        if "drv" not in state:
            state["drv"] = f.start_distill(
                policy=DistillPolicy(window_rounds=4, min_proposed=8, cooldown_s=0.0,
                                     refresh_on_publish=True),
                versions={1: draft1})
        if served >= 6:
            state["drv"].note_version(1)
        state["drv"].on_round(f, served)

    with tempfile.TemporaryDirectory() as jdir:
        refresh = fleet_run(torch, cfg, params, prompts, keys, device, kv_dtype=None,
                            generator_cls=SpecStreamingGenerator, gen_kwargs=spec_kw,
                            chaos=FLEET_CHAOS, journal_dir=jdir, on_round=hook)
    rg = _held_fleet("serve_fleet_f32 refresh", refresh, where)
    ctl = state["drv"].controller
    same = all(np_equal(t, sg[k][0]) for k, copies in rg.items() for t in copies)
    if ctl.applied_version != 1 or not refresh["row"]["killed"] or not same:
        raise AssertionError(f"serve_fleet_f32 refresh: applied {ctl.applied_version}, "
                             f"killed {refresh['row']['killed']}, equal {same}")
    rows.append({"phase": "serve_fleet_f32", "run": "spec_distill",
                 "distill_frames": len(frames), "distill_published": published,
                 "refresh_applied": ctl.applied_version, "refreshes": ctl.refreshes,
                 "killed": refresh["row"]["killed"], "equal_to_no_refresh": same,
                 "spec": [r.gen.spec_stats() for r in spec["fleet"].replicas],
                 "spec_refresh": [r.gen.spec_stats() for r in refresh["fleet"].replicas]})
    # (4) the autoscaler under the workload generator's manual clock.
    a, b2 = (autoscaled_run(cfg, params, prompt_len=16, max_new=8,
                            gen_kwargs={"device": device}) for _ in range(2))
    br = a["ctrl"]["by_reason"]
    if a != b2 or not br.get("decode/up/queue") or not br.get("decode/down/idle") \
            or a["committed"] != a["ends"]:
        raise AssertionError(f"serve_fleet_f32 autoscaler: replay equal {a == b2}, {br}, "
                             f"committed {a['committed']} != {a['ends']}")
    rows.append({"phase": "serve_fleet_f32", "run": "autoscaler", "decisions": br,
                 "joins": a["joins"], "completions": len(a["order"]),
                 "replays_identical": True, "digest": a["digest"],
                 "seconds": time.perf_counter() - t0})
    return rows


# ------------------------------------------ process fleet and disaggregation

PROC_SLOTS = 8  # each replica process, as serve_fleet's replicas
PROC_SESSION_S = 30.0  # a lease outlives a slow start; the reaper sees a death at once
PROC_WAIT_S = 420.0  # the longest wait of a process phase (startup included)
DISAGG_SLOTS = 8  # each decode replica and the prefill worker of serve_disagg
DISAGG_PATIENCE = 2  # rounds a decode replica holds a record for its handoff
DISAGG_CLOSE_AFTER = 6  # handoffs published before the prefill worker closes
PREFILL_TRACE_TAG = 9  # the prefill worker's replica tag on the shared trace
PROCFLEET_F32_N = 24  # serve_procfleet_f32's stream (scenario 21's oversubscription)


def procfleet_model(cfg) -> dict:
    """``fleet.proc.build_model``'s spec of ``cfg``'s shape (f32, seed
    ``SEED``)."""
    return {"seed": SEED, "vocab_size": cfg.vocab_size, "d_model": cfg.d_model,
            "n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
            "max_seq_len": cfg.max_seq_len}


def procfleet_stream(np, vocab: int, n: int = FLEET_N, plen: int = 128):
    """serve_fleet's prompts and tenants, each record keyed by its tenant
    and index (``throttled-i``, ``open-i``) so that an output names its
    prompt, prompt i on partition i % 4."""
    prompts, keys = fleet_stream(np, vocab, n, plen)
    return prompts, [b"%s-%d" % (k, i) for i, k in enumerate(keys)]


def produce_keyed(broker, topic: str, prompts, keys, parts: int = FLEET_PARTS) -> None:
    for i, key in enumerate(keys):
        broker.produce(topic, prompts[i].tobytes(), partition=i % parts, key=key)


def reference_outputs(cfg, params, prompts, keys, device, *, slots, ticks,
                      **kw) -> dict:
    """The port's in-process server over the keyed stream (one partition
    per prompt index mod 4) → {key: tokens}."""
    from torchkafka_tpu_torch.serve import StreamingGenerator
    from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer

    broker = InMemoryBroker()
    broker.create_topic("ref", partitions=FLEET_PARTS)
    produce_keyed(broker, "ref", prompts, keys)
    consumer = MemoryConsumer(broker, "ref", group_id="ref")
    server = StreamingGenerator(consumer, params, cfg, slots=slots,
                                prompt_len=prompts.shape[1], max_new=MAX_NEW,
                                commit_every=FLEET_COMMIT, ticks_per_sync=ticks,
                                device=device, **kw)
    out = {rec.key: toks for rec, toks in server.run(max_records=len(keys))}
    consumer.close()
    if set(out) != set(keys):
        raise AssertionError(f"reference: {len(out)} of {len(keys)} served")
    return out


def _identical(what, results, ref, np) -> dict:
    """Every copy of every completion on the fleet's output topic equals
    the reference; → duplicates and tokens."""
    if set(results) != set(ref):
        raise AssertionError(f"{what}: {len(set(ref) - set(results))} prompts never "
                             "served")
    for key, copies in results.items():
        for member, toks in copies:
            if not np_equal(np.asarray(toks), np.asarray(ref[key])):
                raise AssertionError(f"{what}: {key!r} via {member} differs from the "
                                     "in-process server")
    return {"duplicates": sum(len(c) - 1 for c in results.values()),
            "tokens": sum(len(t) for c in results.values() for _m, t in c)}


def _child_k1(what, dumps, n_layers, cuda=True) -> list:
    """Each dumping decode child's K1 = layers x (prefills + warm
    resumes), from its own counters (held on the card: a CPU tensor
    launches nothing); → per child (member, K1, prefills, warm resumes)."""
    out = []
    for d in dumps:
        want = n_layers * (d["prefills"] + d["warm_resumes"])
        if cuda and d["launches"]["flash_fwd"] != want:
            raise AssertionError(f"{what}: child {d['member']} launched K1 "
                                 f"{d['launches']}, want {want}")
        out.append({"member": d["member"], "flash_fwd": d["launches"]["flash_fwd"],
                    "prefills": d["prefills"], "warm_resumes": d["warm_resumes"]})
    if cuda and not sum(c["flash_fwd"] for c in out):
        raise AssertionError(f"{what}: no child launched K1: {out}")
    return out


def _wave(fleet, prompts, wave: int, *, keys=None):
    """Produce wave ``wave`` of the keyed stream (keys ``...-w<wave>``) onto
    the fleet's topic; → its keys and the produce time."""
    keys = [b"%s-w%d" % (k, wave) for k in keys]
    produce_keyed(fleet.broker, "pf", prompts, keys)
    return keys, time.perf_counter()


def _served(fleet, keys, what: str, deadline: float) -> float:
    """Wait until every key of a wave is on the output topic; → the time."""
    while not set(keys) <= set(fleet.results()):
        fleet.poll_once()
        if time.monotonic() > deadline:
            raise TimeoutError(f"serve_procfleet {what}: not served\n" + fleet.diagnose())
        time.sleep(0.02)
    return time.perf_counter()


def check_serve_procfleet(torch, cfg, device="cuda") -> list:
    """Item 6's process fleet at ``cfg``'s shape (the 1b), f32 as
    ``fleet.proc.build_model`` gives, over the ``BrokerServer`` TCP
    broker: one ``ProcessFleet`` of 2 replica processes of 8 slots (dense
    f32 pools, a journal, respawn) serves serve_fleet's 64 prompts of 128
    (two tenants, each record keyed by tenant, index and wave, prompt i on
    partition i % 4) three times: wave 1 with one SIGKILL mid-round, once
    outputs exist and the victim's journal on disk holds generations with
    tokens (served-but-uncommitted work; the replacement respawns); wave 2
    on the two warm processes; then ``scale(1)`` drains one and wave 3
    runs on the other. Held: nothing lost (``fully_committed``), every copy
    byte-identical to the port's in-process 8-slot server on the same
    weights, the victim fenced with its journal handed over and resumes
    counted, its generation refused a commit, each dumping child's K1 =
    layers x (prefills + warm resumes) from its own counters. Tok/s count
    from each wave's produce (worker start excluded)."""
    import tempfile

    import numpy as np

    from torchkafka_tpu_torch.errors import CommitFailedError
    from torchkafka_tpu_torch.fleet import ProcessFleet
    from torchkafka_tpu_torch.fleet.proc import build_model
    from torchkafka_tpu_torch.journal import DecodeJournal
    from torchkafka_tpu_torch.source.records import TopicPartition

    t0 = time.perf_counter()
    spec = procfleet_model(cfg)
    prompts, base = procfleet_stream(np, spec["vocab_size"])
    pcfg, params = build_model(spec, device)
    t_ref = time.perf_counter()
    one = reference_outputs(pcfg, params, prompts, base, device, slots=PROC_SLOTS,
                            ticks=FLEET_TICKS)
    ref = {b"%s-w%d" % (k, w): one[k] for k in base for w in (1, 2, 3)}
    ref_s = time.perf_counter() - t_ref
    del params
    if device == "cuda":
        torch.cuda.empty_cache()
    rows = []
    with tempfile.TemporaryDirectory() as wd:
        fleet = ProcessFleet(
            spec, topic="pf", prompt_len=prompts.shape[1], max_new=MAX_NEW, workdir=wd,
            replicas=2, partitions=FLEET_PARTS, slots=PROC_SLOTS,
            commit_every=FLEET_COMMIT, ticks_per_sync=FLEET_TICKS,
            session_timeout_s=PROC_SESSION_S, heartbeat_interval_s=0.2, respawn=True,
            group="pf", device=device)
        try:
            ts = time.perf_counter()
            fleet.start()
            fleet.wait_ready(timeout_s=PROC_WAIT_S)
            ready_s = time.perf_counter() - ts
            deadline = time.monotonic() + PROC_WAIT_S
            gen0 = fleet.broker.membership("pf")["generation"]
            # Wave 1: the kill, mid-round: the victim's journal on disk holds
            # generations with tokens (uncommitted work a survivor resumes).
            keys, t1 = _wave(fleet, prompts, 1, keys=base)

            def in_flight(inc) -> bool:
                return any(not e.finished and len(e.tokens) >= 1
                           for e in DecodeJournal.load(inc.journal_path).values())

            victim = None
            while victim is None:
                fleet.poll_once()
                if set(keys) <= set(fleet.results()):
                    raise AssertionError("serve_procfleet: the storm drained before "
                                         "a kill window")
                for inc in fleet.live():
                    if fleet.results() and in_flight(inc):
                        victim = fleet.kill_replica(inc.idx)
                        t_kill = time.perf_counter()
                        break
                if time.monotonic() > deadline:
                    raise TimeoutError("serve_procfleet: no kill window\n"
                                       + fleet.diagnose())
                time.sleep(0.01)
            t_served = _served(fleet, keys, "wave 1", deadline)
            ready_tp = TopicPartition(fleet.ready_topic, 0)
            while True:  # the replacement's ready marker
                fleet.poll_once()
                ready = {r.value.decode() for r in fleet.broker.fetch(ready_tp, 0, 10**5)}
                fresh = [i for i in fleet.live() if i.idx == victim["idx"]
                         and i.member != victim["member"] and i.member in ready]
                if fresh:
                    respawn_ready_s = time.perf_counter() - t_kill
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError("serve_procfleet: no respawn\n" + fleet.diagnose())
                time.sleep(0.02)
            rows.append({"run": "2_process_kill", "wave": 1, "elapsed_s": t_served - t1,
                         "victim": victim["member"], "kill_at_s": t_kill - t1,
                         "kill_to_respawn_ready_s": respawn_ready_s})
            # Wave 2: two warm processes (the survivor and the replacement).
            keys, t2 = _wave(fleet, prompts, 2, keys=base)
            rows.append({"run": "2_process", "wave": 2,
                         "elapsed_s": _served(fleet, keys, "wave 2", deadline) - t2})
            # Wave 3: one process, the newest drained by scale(1).
            fleet.scale(1)
            fleet.wait(lambda f: sum(i.running for i in f.incarnations) == 1,
                       timeout_s=PROC_WAIT_S)
            keys, t3 = _wave(fleet, prompts, 3, keys=base)
            rows.append({"run": "1_process", "wave": 3,
                         "elapsed_s": _served(fleet, keys, "wave 3", deadline) - t3})
            rebalances = fleet.broker.membership("pf")["generation"] - gen0
            fleet.drain()
            fleet.wait(lambda f: all(not i.running for i in f.incarnations),
                       timeout_s=PROC_WAIT_S)
            fleet.poll_once()
            if not fleet.fully_committed():
                raise AssertionError("serve_procfleet: prompts lost\n" + fleet.diagnose())
            results = fleet.results()
            held = _identical("serve_procfleet", results, ref, np)
            # Every rebalance re-delivers each member's uncommitted work:
            # the JAX package's scenario 17 bound, replicas x (commit_every
            # + slots), a rebalance, summed over the rebalances from wave
            # 1's produce to the drain (the kill's fence, the respawn's
            # join, scale(1)'s leave). Both packages' fleets stay within it
            # on the CPU at these settings (PERF.md, queue C item 15).
            bound = rebalances * 2 * (FLEET_COMMIT + PROC_SLOTS)
            if held["duplicates"] > bound:
                raise AssertionError(
                    f"serve_procfleet: {held['duplicates']} duplicates over "
                    f"{rebalances} rebalances, above the bound {bound}")
            dumps = [d for d in fleet.worker_metrics() if d.get("role") is None]
            vic = next(i for i in fleet.incarnations if i.member == victim["member"])
            warm = sum(d["warm_resumes"] + d["served_from_journal"] for d in dumps)
            if (vic.fence_reason != "process_death" or vic.handoff_entries < 1
                    or warm < 1 or len(fleet.incarnations) != 3):
                raise AssertionError(f"serve_procfleet: failover {vic}, warm {warm}\n"
                                     + fleet.diagnose())
            try:  # the zombie's generation can never commit
                fleet.broker.commit("pf", {TopicPartition("pf", 0): 1},
                                    member_id=victim["member"],
                                    generation=victim["generation"])
                fenced = False
            except CommitFailedError:
                fenced = True
            if not fenced:
                raise AssertionError("serve_procfleet: the killed generation committed")
            summary = {
                "phase": "serve_procfleet", "summary": True, "model": "1b",
                "dtype": "float32", "layers": spec["n_layers"], "slots": PROC_SLOTS,
                "start_to_ready_s": ready_s, "zombie_fenced": True,
                "handoff_entries": vic.handoff_entries, **held,
                "rebalances": rebalances, "duplicate_bound": bound,
                "incarnations": [i.member for i in fleet.incarnations],
                "exit_codes": {i.member: i.exit_code for i in fleet.incarnations},
                "child_launches": _child_k1("serve_procfleet", dumps, spec["n_layers"],
                                            cuda=device == "cuda"),
                "tick_ms": {d["member"]: {"p50": d["step_p50_ms"], "p99": d["step_p99_ms"]}
                            for d in dumps},
                "journal": {d["member"]: {k: d[k] for k in (
                    "warm_resumes", "tokens_restored", "served_from_journal",
                    "resume_rejected")} for d in dumps},
                "fully_committed": True,
            }
        finally:
            fleet.close()
    for row in rows:
        copies = [c for k, cs in results.items() if k.endswith(b"-w%d" % row["wave"])
                  for c in cs]
        row.update({"phase": "serve_procfleet", "model": "1b", "dtype": "float32",
                    "layers": spec["n_layers"], "completions": len(copies),
                    "duplicates": len(copies) - len(base),
                    "tokens_per_s": sum(len(t) for _m, t in copies) / row["elapsed_s"],
                    "unique_tokens_per_s": len(base) * MAX_NEW / row["elapsed_s"]})
    summary.update({"two_over_one_process": rows[1]["unique_tokens_per_s"]
                    / rows[2]["unique_tokens_per_s"],
                    "reference_server_s": ref_s, "seconds": time.perf_counter() - t0})
    return rows + [summary]


def check_serve_disagg(torch, cfg, params, ref, device="cuda") -> list:
    """Disaggregated prefill at serve_paged's model and pool (int8 chunked
    paged, blocks of 16): its 48-prompt tenant stream served by a
    ``ServingFleet`` of two 8-slot decode replicas adopting handoffs
    (``handoff_consumer_factory``) from one ``PrefillPool`` worker in its
    own group, pumped every round; the worker closes once
    ``DISAGG_CLOSE_AFTER`` handoffs are published, and the rest fall back
    to local prefills after ``DISAGG_PATIENCE`` rounds. Held: every prompt
    served once and committed, at least ``DISAGG_CLOSE_AFTER`` slots
    adopted, the prefill group's commits covering only published handoffs,
    no adopted record queued for a local prefill and the replicas'
    prefill tokens those of the fallbacks, K5 = layers x decode-only ticks
    over every server; commits equal to the monolithic paged int8 serve of
    the stream (``ref``: serve_paged's K5 run, (outputs, row)), whose
    tokens the printed agreement compares."""
    import numpy as np

    from torchkafka_tpu_torch.fleet import PrefillPool, ServingFleet
    from torchkafka_tpu_torch.fleet.drill import audited_consumer
    from torchkafka_tpu_torch.fleet.prefill import decode_handoff
    from torchkafka_tpu_torch.obs import ObsConfig
    from torchkafka_tpu_torch.obs.trace import PREFILL_HANDOFF, PREFILL_QUEUED, SLOT_ADOPTED
    from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer
    from torchkafka_tpu_torch.source.records import TopicPartition

    t0 = time.perf_counter()
    prompts, keys = tenant_prompts(np, cfg.vocab_size)
    n, plen = prompts.shape
    outs_m, row_m = ref
    nblk = -(-(plen + MAX_NEW) // PAGED_BS)
    pages = {"block_size": PAGED_BS, "num_blocks": DISAGG_SLOTS * nblk + 24 + 1}
    pool_kw = {"kv_dtype": "int8", "kv_kernel": True}
    broker = InMemoryBroker()
    broker.create_topic("t12", partitions=4)
    for i in range(n):
        broker.produce("t12", prompts[i].tobytes(), key=keys[i])
    broker.create_topic("ho", partitions=1)
    audit = {"completed": None, "commits": [], "floor": {}}
    cls = audited_consumer(MemoryConsumer, audit)
    fleet = ServingFleet(
        lambda rid: cls(broker, "t12", group_id="dg", member_id=f"dg-r{rid:03d}"),
        params, cfg, replicas=2, prompt_len=plen, max_new=MAX_NEW, slots=DISAGG_SLOTS,
        commit_every=FLEET_COMMIT, obs=ObsConfig(token_events=False),
        gen_kwargs={"kv_pages": pages, "ticks_per_sync": 8, "device": device, **pool_kw},
        handoff_consumer_factory=lambda rid: MemoryConsumer(
            broker, "ho", group_id=f"dg-ho-{rid}", member_id=f"dg-ho-{rid}"),
        route_patience=DISAGG_PATIENCE)
    audit["completed"] = fleet.completed
    audit["version_of"] = lambda member: 0
    pool = PrefillPool(broker, "t12", "dg-prefill", "ho", params, cfg, workers=1,
                       slots=DISAGG_SLOTS, prompt_len=plen, max_new=MAX_NEW, kv_pages=pages,
                       commit_every=2, gen_kwargs={
                           **pool_kw, "device": device, "tracer": fleet.tracer,
                           "trace_replica": PREFILL_TRACE_TAG})
    prefill_gen = pool.workers[0].gen
    fleet.warmup()
    pool.warmup()
    state = {"open": True, "rounds": 0}

    def on_round(_f, _served):
        state["rounds"] += 1
        if state["open"]:
            pool.pump_once()
            if prefill_gen.metrics.handoffs_published.count >= DISAGG_CLOSE_AFTER:
                pool.close()  # unpublished prompts stay uncommitted in its group
                state["open"] = False
                state["closed_at_round"] = state["rounds"]

    read = _zero_launches()
    outs = {}
    t1 = time.perf_counter()
    for _rid, rec, toks in fleet.serve(idle_timeout_ms=500, on_round=on_round):
        if (rec.partition, rec.offset) in outs:
            raise AssertionError(f"serve_disagg: {rec.partition}:{rec.offset} served twice")
        outs[(rec.partition, rec.offset)] = toks
    _sync(torch, device)
    elapsed = time.perf_counter() - t1
    launches = read()
    gens = [r.gen for r in fleet.replicas] + [prefill_gen]
    s = fleet.metrics.summary(fleet.replicas)
    tps = [TopicPartition("t12", p) for p in range(4)]
    committed = [broker.committed("dg", tp) or 0 for tp in tps]
    ends = [broker.end_offset(tp) for tp in tps]
    handoffs = broker.fetch(TopicPartition("ho", 0), 0, 10**5)
    published = {decode_handoff(r.value).key for r in handoffs}
    adopted = s["disagg"]["adopted_slots"]
    ev = list(fleet.tracer.events)
    queued = {(e.topic, e.partition, e.offset): dict(e.attrs)["suffix_tokens"]
              for e in ev if e.stage == PREFILL_QUEUED
              and dict(e.attrs)["replica"] != PREFILL_TRACE_TAG}
    adopted_keys = {(e.topic, e.partition, e.offset): e.t for e in ev
                    if e.stage == SLOT_ADOPTED}
    handed_at = {(e.topic, e.partition, e.offset): e.t for e in ev
                 if e.stage == PREFILL_HANDOFF}
    decode_prefill = sum(r.gen.metrics.prefill_tokens.count for r in fleet.replicas)
    fleet.close()
    if len(outs) != n or committed != ends:
        raise AssertionError(f"serve_disagg: {len(outs)} of {n} served, committed "
                             f"{committed} != {ends}")
    if committed != row_m["committed"]:
        raise AssertionError(f"serve_disagg: commits {committed} != monolithic "
                             f"{row_m['committed']}")
    if adopted < DISAGG_CLOSE_AFTER or len(adopted_keys) != adopted:
        raise AssertionError(f"serve_disagg: {adopted} slots adopted")
    for p, tp in enumerate(tps):
        for off in range(broker.committed("dg-prefill", tp) or 0):
            if ("t12", p, off) not in published:
                raise AssertionError(f"serve_disagg: the prefill group committed "
                                     f"{p}:{off} with no handoff published")
    if set(queued) & set(adopted_keys) or sum(queued.values()) != decode_prefill \
            or len(queued) != n - adopted:
        raise AssertionError(f"serve_disagg: {len(queued)} local prefills "
                             f"({sum(queued.values())} tokens, replicas counted "
                             f"{decode_prefill}) beside {adopted} adoptions")
    want_k5 = cfg.n_layers * sum(g.metrics.decode_ticks.count - g.metrics.chunk_ticks.count
                                 for g in gens)
    if device == "cuda" and (launches["kvattn_paged"] != want_k5 or want_k5 == 0
                             or launches["flash_fwd"] != 0 or launches["kvattn_dynlen"] != 0):
        raise AssertionError(f"serve_disagg: launches {launches}, want K5 {want_k5}")
    tok0 = all(int(outs[k][0]) == int(outs_m[k][0]) for k in outs_m)
    agree = float(np.mean([np.mean(outs[k] == outs_m[k]) for k in outs_m]))
    if not tok0:
        raise AssertionError("serve_disagg: token 0 differs from the monolithic serve")
    lag = [1e3 * (adopted_keys[k] - handed_at[k]) for k in adopted_keys if k in handed_at]
    ticks = [r.gen.metrics.tick_time.summary() for r in fleet.replicas]
    tokens = sum(len(t) for t in outs.values())
    return [{"phase": "serve_disagg", "model": "1b", "kv_dtype": "int8", "pool": "paged",
             "slots": DISAGG_SLOTS, "replicas": 2, "prefill_workers": 1,
             "completions": len(outs), "committed": committed,
             "elapsed_s": elapsed, "tokens_per_s": tokens / elapsed,
             "handoffs_published": len(handoffs), "adopted_slots": adopted,
             "prefill_routed": s["disagg"]["prefill_routed"],
             "fallback_prefills": len(queued), "decode_prefill_tokens": decode_prefill,
             "prefill_worker_tokens": prefill_gen.metrics.prefill_tokens.count,
             "closed_at_round": state.get("closed_at_round"),
             "rounds": state["rounds"],
             "handoff_bytes": sum(len(r.value) for r in handoffs),
             "handoff_bytes_each": sorted({len(r.value) for r in handoffs}),
             "publish_to_adopt_ms": {"p50": statistics.median(lag) if lag else None,
                                     "max": max(lag) if lag else None, "n": len(lag)},
             "decode_tick_ms": {"with_prefill_worker": {
                                    f"r{i}": {"p50": t["p50_ms"], "p99": t["p99_ms"]}
                                    for i, t in enumerate(ticks)},
                                "monolithic": {k: row_m.get(k) for k in (
                                    "tick_block_ms_p50", "tick_block_ms_p99")}},
             "token0_identical_to_monolithic": tok0,
             "token_agreement_with_monolithic": agree,
             "launches": launches, "want_kvattn_paged": want_k5,
             "seconds": time.perf_counter() - t0}]


class CheckpointWatch:
    """The checkpoint versions whose manifest and every chunk are on a
    topic, read incrementally (each frame decoded once), so a wait for a
    publish does not re-read the whole topic every poll."""

    def __init__(self, topic: str) -> None:
        self.topic, self.pos = topic, 0
        self.n_chunks: dict = {}
        self.chunks: dict = {}

    def complete(self, broker) -> set:
        from torchkafka_tpu_torch.source.checkpoint_wire import (
            _CHUNK_MAGIC,
            _MANIFEST_MAGIC,
            decode_chunk,
            decode_manifest,
        )
        from torchkafka_tpu_torch.source.records import TopicPartition

        tp = TopicPartition(self.topic, 0)
        end = broker.end_offset(tp)
        for rec in broker.fetch(tp, self.pos, end - self.pos) if end > self.pos else ():
            value = rec.value or b""
            if value[:4] == _MANIFEST_MAGIC:
                m = decode_manifest(value)
                self.n_chunks[m["version"]] = m["n_chunks"]
                self.chunks[m["version"]] = set()
            elif value[:4] == _CHUNK_MAGIC:
                v, idx, _payload = decode_chunk(value)
                self.chunks.setdefault(v, set()).add(idx)
        self.pos = max(self.pos, end)
        return {v for v, n in self.n_chunks.items() if len(self.chunks.get(v, ())) >= n}


def check_serve_procfleet_f32(torch, cfg, device="cuda") -> list:
    """At ``cfg``'s shape (the 1b widths at 2 layers), f32, as real
    processes:
    (a) harness scenario 21's shape — ``ProcessFleet(replicas=2,
    prefill_replicas=1)`` over a paged compute-dtype pool, the prefill
    worker SIGKILLed once handoffs are on the plane, held records falling
    back after the routing patience: every completion byte-identical to an
    in-process monolithic paged server, nothing lost, adoptions before the
    kill, the prefill group's commits covering only published handoffs;
    (b) ``test_distill.py``'s distill role — one replica and one
    ``DistillTrainer`` worker training the 1-layer draft on the card,
    publishing versions 1 and 2 (fetchable), respawned after
    ``kill_distill`` and training again; each dumping child's K1 (decode)
    and K1-K3 (distill: layers x steps) from its own counters."""
    import tempfile

    import numpy as np

    from torchkafka_tpu_torch.fleet import ProcessFleet
    from torchkafka_tpu_torch.fleet.proc import build_model
    from torchkafka_tpu_torch.source.checkpoint_wire import fetch_checkpoint
    from torchkafka_tpu_torch.source.records import TopicPartition

    t0 = time.perf_counter()
    spec = procfleet_model(cfg)
    layers = cfg.n_layers
    n, slots = PROCFLEET_F32_N, 4
    prompts, _tenants = tenant_prompts(np, cfg.vocab_size, n=n)
    keys = [str(i).encode() for i in range(n)]
    nblk = -(-(prompts.shape[1] + MAX_NEW) // PAGED_BS)
    pages = {"block_size": PAGED_BS, "num_blocks": slots * nblk + 24 + 1}
    pcfg, params = build_model(spec, device)
    ref = reference_outputs(pcfg, params, prompts, keys, device, slots=slots, ticks=1,
                            kv_pages=dict(pages))
    del params
    rows = []
    # (a) disaggregated prefill across processes, the prefill worker killed.
    with tempfile.TemporaryDirectory() as wd:
        fleet = ProcessFleet(
            spec, topic="t21", prompt_len=prompts.shape[1], max_new=MAX_NEW, workdir=wd,
            replicas=2, partitions=FLEET_PARTS, slots=slots, commit_every=FLEET_COMMIT,
            session_timeout_s=PROC_SESSION_S, heartbeat_interval_s=0.2,
            journal_cadence=2, respawn=False, group="s21", kv_pages=pages,
            prefill_replicas=1, route_patience=1500, device=device)
        try:
            ta = time.perf_counter()
            fleet.start()
            fleet.wait_ready(timeout_s=PROC_WAIT_S)
            ready_s = time.perf_counter() - ta
            produce_keyed(fleet.broker, "t21", prompts, keys)
            ho = TopicPartition(fleet.handoff_topic, 0)
            deadline = time.monotonic() + PROC_WAIT_S
            while fleet.broker.end_offset(ho) < DISAGG_CLOSE_AFTER:
                if time.monotonic() > deadline:
                    raise TimeoutError("serve_procfleet_f32: no handoffs\n"
                                       + fleet.diagnose())
                time.sleep(0.005)
            victim = fleet.kill_prefill(0)
            at_kill = fleet.broker.end_offset(ho)
            fleet.wait(lambda f: set(f.results()) == set(keys), timeout_s=PROC_WAIT_S)
            fleet.drain()
            fleet.wait(lambda f: all(not i.running for i in f.incarnations),
                       timeout_s=PROC_WAIT_S)
            fleet.poll_once()
            if not fleet.fully_committed():
                raise AssertionError("serve_procfleet_f32: prompts lost\n"
                                     + fleet.diagnose())
            held = _identical("serve_procfleet_f32", fleet.results(), ref, np)
            published = {r.key for r in fleet.broker.fetch(ho, 0, 10**5)}
            for p in range(FLEET_PARTS):
                tp = TopicPartition("t21", p)
                for off in range(fleet.broker.committed("s21-prefill", tp) or 0):
                    if str(off * FLEET_PARTS + p).encode() not in published:
                        raise AssertionError("serve_procfleet_f32: the prefill group "
                                             "committed an unpublished handoff")
            dumps = [d for d in fleet.worker_metrics() if d.get("role") is None]
            adopted = sum(d["adopted_slots"] for d in dumps)
            if adopted < 1 or len(dumps) != 2:
                raise AssertionError(f"serve_procfleet_f32: {adopted} adopted, dumps "
                                     f"{dumps}")
            for d in dumps:  # paged compute-dtype pools: no K1, no K5
                if d["launches"]["flash_fwd"] or d["launches"]["kvattn_paged"]:
                    raise AssertionError(f"serve_procfleet_f32: {d['launches']}")
            rows.append({"phase": "serve_procfleet_f32", "run": "disagg_kill_prefill",
                         "layers": layers, "start_to_ready_s": ready_s,
                         "victim": victim["member"], "handoffs_at_kill": at_kill,
                         "handoffs": len(published), "adopted_slots": adopted,
                         "fallback_prefill_tokens": sum(d["prefill_tokens"] for d in dumps),
                         "prefill_routed": sum(d["prefill_routed"] for d in dumps),
                         "decode_tick_ms_p99": max(d["step_p99_ms"] or 0.0 for d in dumps),
                         "child_launches": {d["member"]: d["launches"] for d in dumps},
                         **held, "fully_committed": True,
                         "seconds": time.perf_counter() - ta})
        finally:
            fleet.close()
    # (b) the distill role on the card, killed and respawned.
    with tempfile.TemporaryDirectory() as wd:
        fleet = ProcessFleet(
            spec, topic="dp", prompt_len=prompts.shape[1], max_new=MAX_NEW, workdir=wd,
            replicas=1, distill_replicas=1, distill_topic="dd", publish_every=2,
            draft_layers=1, distill_batch=2, partitions=2, slots=2, commit_every=2,
            journal_cadence=1, session_timeout_s=PROC_SESSION_S,
            heartbeat_interval_s=0.2, respawn=True, group="dg", device=device)
        try:
            tb = time.perf_counter()
            fleet.start()
            fleet.wait_ready(timeout_s=PROC_WAIT_S)
            for i in range(8):
                fleet.broker.produce("dp", prompts[i].tobytes(), partition=i % 2,
                                     key=str(i).encode())
            fleet.wait(lambda f: f.fully_committed(), timeout_s=PROC_WAIT_S)
            watch = CheckpointWatch("fleet-ckpt")
            fleet.wait(lambda f: {1, 2} <= watch.complete(f.broker), timeout_s=PROC_WAIT_S)
            for version in (1, 2):  # each fetchable, CRCs and all
                if fetch_checkpoint(fleet.broker, "fleet-ckpt", version)[1]["kind"] != "draft":
                    raise AssertionError(f"serve_procfleet_f32: version {version} kind")
            forensics = fleet.kill_distill()
            fleet.wait(lambda f: len(f.live("distill")) == 1
                       and f.live("distill")[0].member != forensics["member"],
                       timeout_s=PROC_WAIT_S)
            fleet.wait_ready(timeout_s=PROC_WAIT_S)
            # One batch for the respawned trainer: it trains on the card
            # (its launches in its dump) without a third publish.
            for i in range(8, 10):
                fleet.broker.produce("dp", prompts[i].tobytes(), partition=i % 2,
                                     key=str(i).encode())
            fleet.wait(lambda f: f.fully_committed(), timeout_s=PROC_WAIT_S)
            dd = TopicPartition("dd", 0)
            fleet.wait(lambda f: f.broker.end_offset(dd) >= 10
                       and (f.broker.committed("dg-distill", dd) or 0) >= 10,
                       timeout_s=PROC_WAIT_S)
            fleet.drain()
            fleet.wait(lambda f: all(not i.running for i in f.incarnations),
                       timeout_s=PROC_WAIT_S)
            fleet.poll_once()
            codes = {i.member: i.exit_code for i in fleet.incarnations}
            if codes.pop(forensics["member"]) != -9 or any(c != 0 for c in codes.values()):
                raise AssertionError(f"serve_procfleet_f32 distill: exits {codes}")
            dumps = fleet.worker_metrics()
            distill = [d for d in dumps if d.get("role") == "distill"]
            decode = [d for d in dumps if d.get("role") is None]
            if not distill or sum(d["steps"] for d in distill) < 1:
                raise AssertionError(f"serve_procfleet_f32 distill: dumps {dumps}")
            for d in distill:  # the 1-layer draft's K1-K3 = steps each
                want = {k: d["draft_layers"] * d["steps"]
                        for k in ("flash_fwd", "flash_dq", "flash_dkv")}
                if device == "cuda" and {k: d["launches"][k] for k in want} != want:
                    raise AssertionError(f"serve_procfleet_f32 distill: launches "
                                         f"{d['launches']}, want {want}")
            rows.append({"phase": "serve_procfleet_f32", "run": "distill_role",
                         "layers": layers, "draft_layers": 1,
                         "versions_fetchable": [1, 2], "victim": forensics["member"],
                         "exit_codes": codes,
                         "distill": [{k: d[k] for k in ("member", "steps", "records",
                                                        "published", "loss", "launches")}
                                     for d in distill],
                         "decode_child_launches": _child_k1("serve_procfleet_f32", decode,
                                                            layers, cuda=device == "cuda"),
                         "seconds": time.perf_counter() - tb})
        finally:
            fleet.close()
    rows.append({"phase": "serve_procfleet_f32", "summary": True,
                 "seconds": time.perf_counter() - t0})
    return rows


def serve_8b(torch, cfg, params, prompts, kv_kernel: bool, prof=None):
    """Scenario 7 at the 8b scale with an output topic (BASELINE config 5):
    ``prompts`` produced round-robin on two partitions, each keyed by its
    index, served by the port's StreamingGenerator over the dense int8
    pool, every completion published to "completions" keyed by its prompt
    and settled before its offset commits. Every kernel launch count is
    zeroed just before ``run`` and read just after. ``prof``: an optional
    profiler context wrapped around ``run``."""
    import numpy as np

    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.models.zoo import params_nbytes
    from torchkafka_tpu_torch.ops import kvattn
    from torchkafka_tpu_torch.ops.flash import flash_fwd_bhsd
    from torchkafka_tpu_torch.ops.qmatmul import quantized_matmul
    from torchkafka_tpu_torch.serve import StreamingGenerator

    n, plen = prompts.shape
    broker = tk.InMemoryBroker()
    broker.create_topic("t7", partitions=2)
    broker.create_topic("completions", partitions=2)
    keys = [f"prompt-{i}".encode() for i in range(n)]
    for i in range(n):
        broker.produce("t7", prompts[i].tobytes(), key=keys[i], partition=i % 2)
    consumer = tk.MemoryConsumer(broker, "t7", group_id="s7")
    server = StreamingGenerator(
        consumer, params, cfg, slots=16, prompt_len=plen, max_new=MAX_NEW,
        commit_every=16, ticks_per_sync=MAX_NEW - 1, kv_dtype="int8",
        kv_kernel=kv_kernel, output_producer=tk.MemoryProducer(broker),
        output_topic="completions", device="cuda",
    )
    server.warmup()
    kernels = {"flash_fwd": flash_fwd_bhsd, "kvattn_dynlen": kvattn.int8_decode_attention_dynlen,
               "qmatmul": quantized_matmul, "kvattn_kmajor": kvattn.int8_decode_attention_kmajor,
               "kvattn_mmajor": kvattn.int8_decode_attention}
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    flash_fwd_bhsd.tc_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        outs = {r.key: out for r, out in server.run(max_records=n)}
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    launches["flash_fwd_tc"] = flash_fwd_bhsd.tc_launches
    consumer.close()
    tps = [tk.TopicPartition("t7", p) for p in (0, 1)]
    committed = [broker.committed("s7", tp) for tp in tps]
    ends = [broker.end_offset(tp) for tp in tps]
    reader = tk.MemoryConsumer(broker, "completions", group_id="check")
    published = []
    while batch := reader.poll(max_records=1000, timeout_ms=0):
        published.extend(batch)
    reader.close()
    m = server.metrics.summary()
    if len(outs) != n or any(len(o) != MAX_NEW for o in outs.values()):
        raise AssertionError(f"serve_8b: {len(outs)} completions, lengths "
                             f"{sorted({len(o) for o in outs.values()})}")
    if committed != ends:
        raise AssertionError(f"serve_8b: committed {committed} != end offsets {ends}")
    if any(int(o.min()) < 0 or int(o.max()) >= cfg.vocab_size for o in outs.values()):
        raise AssertionError("serve_8b: token out of the vocabulary")
    pub = {r.key: np.frombuffer(r.value, np.int32) for r in published}
    if len(published) != n or sorted(pub) != sorted(keys):
        raise AssertionError(f"serve_8b: {len(published)} output records for {n} prompts")
    if any(not np.array_equal(pub[k], outs[k]) for k in keys):
        raise AssertionError("serve_8b: an output record differs from its completion")
    if any(tuple(r.headers) != (("mv", b"0"),) for r in published):
        raise AssertionError("serve_8b: an output record lacks its mv header")
    if m["output_flush_failures"] or m["output_send_failures"]:
        raise AssertionError(f"serve_8b: output failures {m['output_flush_failures']}, "
                             f"{m['output_send_failures']}")
    nl = cfg.n_layers
    tc = cfg.dtype == torch.bfloat16  # D=128: bf16 on the tensor cores, f32 on the CUDA cores
    want = {"flash_fwd": nl * m["prefills"], "flash_fwd_tc": nl * m["prefills"] if tc else 0,
            "kvattn_dynlen": nl * m["decode_ticks"] if kv_kernel else 0,
            "qmatmul": 0, "kvattn_kmajor": 0, "kvattn_mmajor": 0}
    if launches != want or m["prefills"] == 0 or m["decode_ticks"] == 0:
        raise AssertionError(f"serve_8b: launches {launches}, want {want}")
    kb = m["kv_backend"]
    if kb["kernel"] is not kv_kernel or kb["layout"] != "dense" or kb["kv_dtype"] != "int8":
        raise AssertionError(f"serve_8b: backend {kb}")
    tokens = sum(len(o) for o in outs.values())
    row = {"phase": "serve_8b", "model": f"8b width, {nl} layers",
           "dtype": str(cfg.dtype).replace("torch.", ""), "weights": "int8", "kv_dtype": "int8",
           "kv_kernel": kv_kernel, "kv_read": "K4, K-major" if kv_kernel else
           "plain scale-folded read, M-major", "params_nbytes": params_nbytes(params),
           "prompts": n, "prompt_len": plen, "max_new": MAX_NEW, "slots": 16,
           "completions": len(outs), "tokens": tokens, "elapsed_s": elapsed,
           "tokens_per_s": tokens / elapsed, "committed": committed, "end_offsets": ends,
           "output_records": len(published), "output_flush_failures": m["output_flush_failures"],
           "prefills": m["prefills"], "decode_ticks": m["decode_ticks"], "launches": launches,
           "tick_block_ms_p50": m["step_time"]["p50_ms"],
           "tick_block_ms_p99": m["step_time"]["p99_ms"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return outs, row


def check_serve_8b(torch, cfg, name: str, exact: bool):
    """The 8b path twice, K4 then the plain M-major read: both runs must
    commit the same offsets and agree on token 0; ``exact`` (f32) requires
    every token identical. Returns (rows, params, prompts) for the
    optional profile."""
    import numpy as np

    from torchkafka_tpu_torch.models.zoo import random_serving_params

    t0 = time.perf_counter()
    params = random_serving_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, quantized=True, device="cuda"
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (48, 128),
                                                   dtype=np.int32)
    outs_k, row_k = serve_8b(torch, cfg, params, prompts, kv_kernel=True)
    outs_p, row_p = serve_8b(torch, cfg, params, prompts, kv_kernel=False)
    row_k["params_build_s"] = build_s
    for row in (row_k, row_p):
        row["phase"] = name
    if row_p["committed"] != row_k["committed"]:
        raise AssertionError(f"{name}: the plain read committed other offsets")
    tok0_same = all(int(outs_p[k][0]) == int(outs_k[k][0]) for k in outs_k)
    agree = float(np.mean([np.mean(outs_p[k] == outs_k[k]) for k in outs_k]))
    row_p["token0_identical_to_k4_run"] = tok0_same
    row_p["token_agreement_with_k4_run"] = agree
    if not tok0_same:
        raise AssertionError(f"{name}: token 0 differs between the K4 and plain reads")
    if exact and agree != 1.0:
        raise AssertionError(f"{name}: f32 tokens differ (agreement {agree})")
    return (row_k, row_p), params, prompts


def profile_serve_8b(torch, cfg, params, prompts, row_k) -> dict:
    """One wave of the 8b K4 run (16 prompts: one prefill and 63 decode
    ticks) under torch.profiler: device time by kernel against the
    profiled wall time and the unprofiled tick time."""
    prof = _profiler(torch)
    _, row = serve_8b(torch, cfg, params, prompts[:16], kv_kernel=True, prof=prof)
    return profile_summary(prof, "one 8b int8 wave (K4) under torch.profiler", {
        "decode_ticks": row["decode_ticks"], "prefills": row["prefills"],
        "profiled_wall_ms": row["elapsed_s"] * 1e3,
        "unprofiled_tick_wall_ms": row_k["tick_block_ms_p50"] / (MAX_NEW - 1)})


def _profiler(torch):
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


HARNESS_TINY = (1, 2, 6, 9)  # the harness's ingest and training scenarios, tiny


def check_harness(torch) -> list:
    """The port's harness CLI entry point (``harness.run_scenario``) on the
    card: scenario 7 at the 1b (24 layers, full widths, random bf16
    weights from seed 0) on the int8 pool read by K4, with
    ``decode_roofline`` (replays of a CUDA graph of the 63-tick decode
    block, CUDA events, 8 and 24 blocks a window, three of each); scenario
    5 at the 1b (lockstep generate, K1 prefill, the device split by CUDA
    events); scenarios 1, 2, 6 and 9 at tiny size. Every count is zeroed
    just before its scenario and read just after. Held: committed ==
    records, no commit failure, no drop; the roofline's slope held and
    0 < hbm_roofline_pct <= 105, timed from the graph; the captured block
    launches K4 24 x ticks_per_sync times; K4's eager launches (the
    scenario's less the probe's warm block and capture) = 24 x the eager
    decode ticks (serving plus warmup's block); K1 = 24 x (prefills +
    warmup's one) on the tensor cores; scenario 5's K1 = 24 x its
    prefills (warm-up, batches, split) and K4 = 0; scenario 9's K1 = K2 =
    K3 (one of each a layer and step)."""
    from torchkafka_tpu_torch.harness import run_scenario

    rows = []
    smi = smi_line()
    read = _zero_launches()
    t0 = time.perf_counter()
    r7 = run_scenario(7, "full", model_scale="1b", kv_int8=True, kv_kernel=True)
    s7 = time.perf_counter() - t0
    got = read()
    torch.cuda.empty_cache()
    nl, k = 24, r7["ticks_per_sync"]
    if (r7["records"] != 128 or r7["committed"] != r7["records"]
            or r7["commit_failures"] or r7["dropped"] or not r7["kv_kernel"]):
        raise AssertionError(f"harness 7: {r7}")
    if (r7.get("timer") != "cuda_graph" or not r7["slope_ok"]
            or not 0 < r7["hbm_roofline_pct"] <= 105):
        raise AssertionError(f"harness 7 roofline: {r7}")
    probe = r7["probe_launches"]
    eager_k4 = got["kvattn_dynlen"] - probe["kvattn_dynlen"]
    want = {"graph_k4": nl * k, "eager_k4": nl * (r7["decode_ticks"] + k),
            "probe_k4": nl * 2 * k, "k1": nl * (r7["prefills"] + 1)}
    have = {"graph_k4": r7["graph_block_launches"]["kvattn_dynlen"], "eager_k4": eager_k4,
            "probe_k4": probe["kvattn_dynlen"], "k1": got["flash_fwd"]}
    if have != want or got["flash_fwd_tc"] != got["flash_fwd"] or got["kvattn_paged"]:
        raise AssertionError(f"harness 7 launches {got}, {have}, want {want}")
    rows.append({"phase": "harness", "scenario": 7, "args": "--size full --model-scale 1b "
                 "--kv-int8 --kv-kernel on", "seconds": s7, "launches": got,
                 "launch_check": want, "nvidia_smi": smi, **r7})
    read = _zero_launches()
    t0 = time.perf_counter()
    r5 = run_scenario(5, "full", model_scale="1b")
    s5 = time.perf_counter() - t0
    got = read()
    torch.cuda.empty_cache()
    # Prefills: the warm-up generate, one a batch, and the split's warm
    # prefill, three timed ones, warm generate and three timed generates.
    want_k1 = nl * (1 + r5["batches"] + 8)
    if (r5["records"] != 128 or r5["committed"] != r5["records"]
            or r5["commit_failures"] or r5["dropped"]
            or r5["generated_tokens"] != 128 * MAX_NEW):
        raise AssertionError(f"harness 5: {r5}")
    if (got["flash_fwd"] != want_k1 or got["flash_fwd_tc"] != want_k1
            or got["kvattn_dynlen"] or got["kvattn_paged"]):
        raise AssertionError(f"harness 5 launches {got}, want K1 {want_k1}")
    for key in ("device_prefill_ms", "device_generate_ms", "roofline_tok_s"):
        if not r5.get(key, 0) > 0:
            raise AssertionError(f"harness 5: {key} {r5}")
    rows.append({"phase": "harness", "scenario": 5, "args": "--size full --model-scale 1b",
                 "seconds": s5, "launches": got, "nvidia_smi": smi, **r5})
    for num in HARNESS_TINY:
        read = _zero_launches()
        t0 = time.perf_counter()
        r = run_scenario(num, "tiny")
        sec = time.perf_counter() - t0
        got = read()
        if (r["records"] <= 0 or r["records_per_s"] <= 0 or r["commit_failures"]
                or r["dropped"] or r["commit"]["count"] <= 0):
            raise AssertionError(f"harness {num}: {r}")
        if num == 9 and not (got["flash_fwd"] == got["flash_dq"] == got["flash_dkv"] > 0):
            raise AssertionError(f"harness 9 launches {got}")
        if num != 9 and any(got.values()):
            raise AssertionError(f"harness {num} launched kernels: {got}")
        rows.append({"phase": "harness", "scenario": num, "args": "--size tiny",
                     "seconds": sec, "launches": got, **r})
    rows.append(roofline_probe_exact(torch))
    return rows


HARNESS_FLEET = (10, 11, 12, 13, 14, 15, 16, 22, 25)  # the in-process fleet scenarios


@contextlib.contextmanager
def _server_spy():
    """Every server built while the context is open, and how often each
    ran ``warmup`` (a dense server's warm-up is one K1 prefill that no
    metric counts): → (servers, {id(server): warmups})."""
    from torchkafka_tpu_torch.serve import StreamingGenerator

    made, warm = [], {}
    init, warmup = StreamingGenerator.__init__, StreamingGenerator.warmup

    def spy_init(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    def spy_warmup(self):
        warm[id(self)] = warm.get(id(self), 0) + 1
        return warmup(self)

    StreamingGenerator.__init__, StreamingGenerator.warmup = spy_init, spy_warmup
    try:
        yield made, warm
    finally:
        StreamingGenerator.__init__, StreamingGenerator.warmup = init, warmup


def _fleet_passes(servers, warm) -> dict:
    """The K1 launches the servers' own counts imply: on a dense pool,
    layers x (prefills + warm resumes + warm-ups), a speculative server's
    draft layers x (prefills + warm resumes) besides; a paged pool's
    prefills run the plain gathered sweep (0)."""
    k1 = passes = 0
    for g in servers:
        if g._kv_pages is not None:
            continue
        m = g.metrics
        n = m.prefills.count + m.warm_resumes.count
        passes += n
        k1 += g._cfg.n_layers * (n + warm.get(id(g), 0))
        if hasattr(g, "_draft_cfg"):
            k1 += g._draft_cfg.n_layers * n
    return {"servers": len(servers), "dense_prefills": passes,
            "warmups": sum(warm.values()), "k1": k1}


def _fleet_invariants(num: int, r: dict, n: int) -> list:
    """``tests/test_harness.py``'s assertions for scenario ``num`` on a run
    of ``n`` records (the test's literal counts are the tiny size's): →
    the names of those that fail."""
    checks = {
        10: lambda: {
            "scenario": r["scenario"] == "10:serving-fleet", "replicas": r["replicas"] == 2,
            "records": r["records"] == n and r["records_per_s"] > 0,
            "commit": r["commit"]["count"] > 0 and r["commit_failures"] == 0
            and r["dropped"] == 0,
            "drained_states": r["drained_states"] == ["done", "done"],
            "drains": r["drains"] == 2, "coverage": r["coverage_complete"] is True,
            "zero_replayed": r["zero_replayed_after_drain"] is True,
            "throttled": r["tenants"]["throttled"]["throttled"] > 0
            and r["tenants"]["open"]["throttled"] == 0,
            "lanes": set(r["lanes"]) == {"interactive", "batch"}},
        11: lambda: {
            "scenario": r["scenario"] == "11:chaos-soak", "records": r["records"] == n - 1,
            "exactly_once": r["exactly_once"] is True, "duplicates": r["duplicates"] == 0,
            "committed": r["committed_complete"] is True, "dlq": r["dlq_records"] == 1,
            "quarantined": r["quarantined"] == 1, "dropped": r["dropped"] == 1,
            "outage": r["outage_faults"] > 0,
            "circuit": r["circuit_opens"] >= 1 and r["circuit_closes"] >= 1},
        12: lambda: {
            "scenario": r["scenario"] == "12:prefix-cache-fleet", "replicas": r["replicas"] == 2,
            "records": r["records"] == n, "coverage": r["coverage_complete"] is True,
            "committed": r["committed_complete"] is True,
            "clean": r["commit_failures"] == 0 and r["dropped"] == 0,
            "misses": r["cache"]["misses"] <= 3, "hits": r["cache"]["hits"] >= n - 3,
            "hit_rate": r["cache"]["hit_rate"] >= 0.8,
            "saved": r["cache"]["prefix_tokens_saved"] > 0
            and r["prefill_tokens"] < r["prefill_tokens_dense"]
            and r["prefill_savings_pct"] > 0},
        13: lambda: {
            "scenario": r["scenario"] == "13:warm-failover", "replicas": r["replicas"] == 2,
            "killed": len(r["killed"]) == 1 and r["replica_deaths"] == 1,
            "coverage": r["coverage_complete"] is True,
            "committed": r["committed_complete"] is True,
            "identical_to_no_kill": r["identical_to_no_kill"] is True,
            "duplicates_identical": r["duplicates_identical"] is True,
            "journal": r["journal_handoffs"] > 0 and r["warm_resumes"] > 0
            and r["tokens_restored"] > 0 and r["served_from_journal"] > 0
            and r["resume_rejected"] == 0},
        14: lambda: {
            "scenario": r["scenario"] == "14:chunked-prefill-storm",
            "records": r["records"] == n and r["storm_factor"] == 4,
            "coverage": r["coverage_complete"] is True,
            "committed": r["committed_complete"] is True,
            "stall": r["max_decode_stall_ticks"] == 0, "fifo": r["fifo_activation"] is True,
            "queued": r["admission_stall_ticks"] > 0 and r["chunk_ticks"] > 0
            and r["queue_tokens_end"] == 0,
            "hits": r["prefix_hit_rate"] > 0.5
            and r["prefill_tokens"] < r["prefill_tokens_dense"]},
        15: lambda: {
            "scenario": r["scenario"] == "15:slo-observability", "replicas": r["replicas"] == 2,
            "records": r["records"] == n, "coverage": r["coverage_complete"] is True,
            "committed": r["committed_complete"] is True,
            "clean": r["dropped"] == 0 and r["commit_failures"] == 0,
            "tenant_slo": all(
                s["ttft"]["count"] > 0 and s["itl"]["count"] > 0
                and 0 < s["ttft"]["p50_ms"] <= s["ttft"]["p99_ms"] and s["itl"]["p99_ms"] > 0
                for s in r["tenant_slo"].values()),
            "counts": r["ttft"]["count"] == n and r["itl"]["count"] > n
            and r["e2e"]["count"] == n and r["queue_wait"]["count"] == n,
            "labels": set(r["lanes_observed"]) == {"interactive", "batch"}
            and r["replicas_observed"] == ["0", "1"],
            "cache": r["cache_hit_rate"] > 0.5,
            "trace": r["trace_stages"]["polled"] == r["trace_stages"]["slot_active"]
            == r["trace_stages"]["committed"] == n and r["open_records_end"] == 0,
            "endpoint": r["endpoint_status"] == 200 and all(r["endpoint_has"].values())
            and r["endpoint_series"] > 100},
        16: lambda: {
            "scenario": r["scenario"] == "16:traffic-observatory", "replicas": r["replicas"] == 2,
            "arrived": r["all_arrived"] is True, "records": r["records"] == n,
            "coverage": r["coverage_complete"] is True,
            "committed": r["committed_complete"] is True,
            "clean": r["dropped"] == 0 and r["commit_failures"] == 0,
            "zipf": r["tenant_arrivals"]["tenant-00"] > r["tenant_arrivals"]["tenant-02"],
            "tenant_slo": all(
                s["ttft"]["count"] > 0 and s["itl"]["count"] > 0
                and s["ttft"]["p99_ms"] >= s["ttft"]["p50_ms"]
                for s in r["tenant_slo"].values()),
            "counts": r["ttft"]["count"] == n and r["ttft"]["p99_ms"] > 0
            and r["itl"]["count"] > n and r["e2e"]["count"] == n,
            "lanes": set(r["lanes_observed"]) == {"interactive", "batch"},
            "overload": r["burn_transitions"] > 0 and r["overload_deferrals"] > 0,
            "goodput": r["goodput"]["completed"] == n
            and 0 < r["goodput"]["within_slo"] <= r["goodput"]["completed"],
            "budgets": len(r["output_len_spread"]) > 1 and r["output_capped"] > 0,
            "step_time": r["step_time"]["ticks"] > 0
            and r["step_time"]["p99_ms"] >= r["step_time"]["p50_ms"] > 0,
            "cache": r["cache_hit_rate"] > 0.5
            and r["tenant_cache"]["tenant-00"]["hit_rate"] > 0.5,
            "trace": r["trace_stages"]["polled"] == r["trace_stages"]["slot_active"]
            == r["trace_stages"]["committed"] == n
            and r["trace_stages"]["burn_state"] == r["burn_transitions"]
            and r["open_records_end"] == 0},
        22: lambda: {
            "scenario": r["scenario"] == "22:autoscaled-step-storm",
            "replay_identical": r["replay_identical"] is True, "zero_lost": r["zero_lost"] is True,
            "scaled_up": r["scale_ups"] >= 1 and r["peak_live"] >= 2
            and r["first_up_t"] is not None,
            "recovered": r["burn_transitions"] >= 2 and r["burn_recovered_t"] is not None
            and r["burn_recovered_t"] > r["first_up_t"] and r["end_burn_state"] == "ok"
            and r["within_slo"] > 0,
            "scaled_down": r["scale_downs"] >= 1 and r["downs_after_step_end"] is True
            and r["final_target"] == 1 and r["drained_members"] >= r["scale_downs"],
            "hysteresis": r["decisions"] <= 8},
        # The safety half only: the α phases are printed as measured.
        25: lambda: {
            "scenario": r["scenario"] == "25:online-draft-distillation",
            "replicas": r["replicas"] == 2,
            "trainer": r["trainer"]["steps"] >= 1 and r["trainer"]["published"] >= 1,
            "identical_to_no_distill": r["identical_to_no_distill"] is True,
            "committed_duplicates": r["committed_duplicates"] == 0,
            "all_arrived": r["all_arrived"] is True},
    }
    return [name for name, ok in checks[num]().items() if not ok]


# Records each scenario produces, by size (its own stream lengths).
FLEET_RECORDS = {"full": {10: 128, 11: 96, 12: 128, 13: 64, 14: 16, 15: 128, 16: 128,
                          22: 96, 25: 480},
                 "tiny": {10: 24, 11: 16, 12: 24, 13: 16, 14: 16, 15: 24, 16: 24,
                          22: 32, 25: 240}}


@contextlib.contextmanager
def _fleet_token_spy():
    """Every fleet serve's completions by record ({(partition, offset):
    [tokens, ...]}, one dict a serve, in order) and the records a dense
    server warm-resumed, while the context is open."""
    import numpy as np

    from torchkafka_tpu_torch.fleet.fleet import ServingFleet
    from torchkafka_tpu_torch.serve import StreamingGenerator

    serves, resumed = [], set()
    serve, resume = ServingFleet.serve, StreamingGenerator._resume_into_slot

    def spy_serve(self, *a, **k):
        done: dict = {}
        serves.append(done)
        for rid, rec, toks in serve(self, *a, **k):
            done.setdefault((rec.partition, rec.offset), []).append(np.asarray(toks).copy())
            yield rid, rec, toks

    def spy_resume(self, i, rec, *a, **k):
        resumed.add((rec.partition, rec.offset))
        return resume(self, i, rec, *a, **k)

    ServingFleet.serve, StreamingGenerator._resume_into_slot = spy_serve, spy_resume
    try:
        yield serves, resumed
    finally:
        ServingFleet.serve, StreamingGenerator._resume_into_slot = serve, resume


@contextlib.contextmanager
def _f32_scenarios(torch):
    """The harness scenarios' default model at f32 compute (its f32 master
    weights served as they are) while the context is open."""
    from torchkafka_tpu_torch.harness import scenarios

    model = scenarios._serving_model

    def f32_model(*a, **k):
        cfg, params, label = model(*a, **k)
        return dataclasses.replace(cfg, dtype=torch.float32), params, label + "-f32"

    scenarios._serving_model = f32_model
    try:
        yield
    finally:
        scenarios._serving_model = model


def _failover_agreement(serves, resumed) -> dict:
    """Scenario 13's two fleets (the no-kill reference, then the killed
    one): each record's last completion in the killed run against the
    reference's, split by whether a survivor warm-resumed it."""
    import numpy as np

    ref, got = serves
    same = sorted(k for k in ref if k in got
                  and np.array_equal(ref[k][0], got[k][-1]))
    differ = sorted(k for k in ref if k not in same)
    return {
        "same_records": set(ref) == set(got),
        "token0_equal": all(int(ref[k][0][0]) == int(got[k][-1][0]) for k in ref if k in got),
        "cold_identical": all(k in resumed for k in differ),
        "differ": [list(k) for k in differ],
        "differ_resumed": [list(k) for k in differ if k in resumed],
        "resumed": sorted(list(k) for k in resumed),
        "token_agreement": float(np.mean([np.mean(ref[k][0] == got[k][-1]) for k in ref
                                          if k in got])),
    }


def check_harness_fleet(torch, size: str = "full", device=None) -> list:
    """The harness's in-process fleet scenarios (10-16, 22, 25) through
    ``harness.run_scenario`` on the card at full size (``TransformerConfig``'s
    defaults: d_model 512, 4 layers, 8 q / 8 kv heads, head dim 64, bf16;
    weights from seed 0), then scenario 13 again at f32 compute. Every
    count is zeroed just before a scenario and read just after. Held:
    ``tests/test_harness.py``'s assertions for each scenario (25: its
    safety half; its α phases are printed). Scenario 13's
    ``identical_to_no_kill`` compares a warm-resumed generation (one
    prefill of prompt + emitted tokens) with one decoded token by token:
    the repo requires that token-exact at f32 only (ROADMAP queue C item
    4), so the bf16 run holds the record set, every token 0 and every
    record no survivor warm-resumed byte-identical and prints the
    resumed ones' agreement, and the f32 run holds the assertion itself.
    K1 = layers x (dense prefills + warm resumes + dense warm-ups), on a
    speculative server's draft layers too, plus 25's trainer's draft
    layers x steps; K2 = K3 = the trainer's draft layers x steps; bf16
    launches all on the tensor cores, f32 none; K4 = K5 = 0 (the
    scenarios serve compute-dtype pools). ``size``/``device`` exist for a
    CPU rehearsal at tiny size, where no count moves."""
    from torchkafka_tpu_torch.harness import run_scenario

    rows = []
    smi = smi_line() if device is None else "not measured"
    for num, f32 in [(num, False) for num in HARNESS_FLEET] + [(13, True)]:
        with contextlib.ExitStack() as stack:
            servers, warm = stack.enter_context(_server_spy())
            serves, resumed = stack.enter_context(_fleet_token_spy())
            if f32:
                stack.enter_context(_f32_scenarios(torch))
            read = _zero_launches()
            t0 = time.perf_counter()
            r = run_scenario(num, size, device=device)
            sec = time.perf_counter() - t0
            got = read()
            passes = _fleet_passes(servers, warm)
        servers.clear()
        extra = {}
        skip = ()
        if num == 13 and not f32:
            extra["bf16_failover"] = agree = _failover_agreement(serves, resumed)
            skip = ("identical_to_no_kill",)
            if not (agree["same_records"] and agree["token0_equal"]
                    and agree["cold_identical"]):
                raise AssertionError(f"harness 13 bf16: {agree}")
        serves.clear()
        n = FLEET_RECORDS[size][num]
        failed = [f for f in _fleet_invariants(num, r, n) if f not in skip]
        if failed:
            raise AssertionError(f"harness {num}{' f32' if f32 else ''}: {failed} {r}")
        steps = r["trainer"]["steps"] if num == 25 else 0
        want = {"flash_fwd": passes["k1"] + steps, "flash_dq": steps, "flash_dkv": steps,
                "kvattn_dynlen": 0, "kvattn_paged": 0}
        if device is None:
            have = {k: got[k] for k in want}
            tc = {k: got[k + "_tc"] for k in ("flash_fwd", "flash_dq", "flash_dkv")}
            if have != want or any(tc[k] != (0 if f32 else have[k]) for k in tc):
                raise AssertionError(f"harness {num} launches {got}, want {want}")
        row = {"phase": "harness_fleet", "scenario": num, "dtype": "float32" if f32 else "bfloat16",
               "args": f"--size {size}", "seconds": sec, "launches": got,
               "launch_check": want, "passes": passes, "nvidia_smi": smi, **extra, **r}
        if num == 25:
            row["alpha_phases"] = {key: r[key] for key in (
                "alpha_pre", "alpha_drift", "alpha_post", "alpha_windows_proposed",
                "alpha_degraded_at_drift", "refreshes_post_drift", "alpha_recovered")}
        rows.append(row)
        if device is None:
            torch.cuda.empty_cache()
    return rows


HARNESS_PROCFLEET = (17, 18, 19, 21, 23, 24)  # the process-fleet scenarios


@contextlib.contextmanager
def _dump_spy():
    """Every list of worker dumps a ``ProcessFleet`` returned
    (``worker_metrics``) while the context is open, in order."""
    from torchkafka_tpu_torch.fleet.supervisor import ProcessFleet

    seen = []
    read = ProcessFleet.worker_metrics

    def spy(self):
        out = read(self)
        seen.append(out)
        return out

    ProcessFleet.worker_metrics = spy
    try:
        yield seen
    finally:
        ProcessFleet.worker_metrics = read


def _procfleet_invariants(num: int, r: dict) -> list:
    """``tests/test_harness.py``'s assertions for process scenario ``num``:
    → the names of those that fail."""
    codes = sorted(r.get("exit_codes", {}).values())
    checks = {
        17: lambda: {
            "scenario": r["scenario"] == "17:process-fleet-kill-storm",
            "replicas": r["replicas"] == 2, "sigkilled": r["victim_sigkilled"] is True,
            "fence_count": r["fence_count"] == 1, "zero_lost": r["zero_lost"] is True,
            "identical_to_no_kill": r["identical_to_no_kill"] is True,
            "duplicates_within_bound": r["duplicates_within_bound"] is True,
            "journal": r["journal_handoff_entries"] > 0
            and r["warm_resumes_plus_journal_served"] > 0,
            "zombie": r["zombie_commit_rejected"] is True
            and r["watermark_unmoved_by_zombie"] is True,
            "exit_codes": r["exit_codes"][r["victim"]] == -9 and codes == [-9, 0]},
        18: lambda: {
            "scenario": r["scenario"] == "18:exactly-once-kill-storm",
            "replicas": r["replicas"] == 2, "sigkilled": r["victim_sigkilled"] is True,
            "zero_lost": r["zero_lost"] is True,
            "identical_to_no_kill": r["identical_to_no_kill"] is True,
            "committed_duplicates": r["committed_duplicates"] == 0,
            "journal": r["journal_handoff_entries"] > 0
            and r["warm_resumes_plus_journal_served"] > 0,
            "zombie": r["zombie_txn_commit_rejected"] is True
            and r["watermark_unmoved_by_zombie"] is True
            and r["committed_view_unmoved_by_zombie"] is True,
            "exit_codes": r["exit_codes"][r["victim"]] == -9 and codes == [-9, 0]},
        19: lambda: {
            "scenario": r["scenario"] == "19:broker-crash-recovery-storm",
            "replicas": r["replicas"] == 2, "restarts": r["broker_restarts"] == 1,
            "wal": r["recovery"]["replayed_records"] > 0
            and r["recovery"]["replayed_events"] > r["recovery"]["replayed_records"],
            "zero_lost": r["zero_lost"] is True,
            "identical_to_no_restart": r["identical_to_no_restart"] is True,
            "committed_duplicates": r["committed_duplicates"] == 0,
            "unfenced": r["workers_survived_unfenced"] is True,
            "breakers": all(v >= 1 for v in r["breaker_opens"].values())
            and all(v >= 1 for v in r["breaker_closes"].values()),
            "exit_codes": codes == [0, 0]},
        21: lambda: {
            "scenario": r["scenario"] == "21:disaggregated-prefill-kill-storm",
            "workers": r["decode_replicas"] == 2 and r["prefill_workers"] == 1,
            "zero_lost": r["zero_lost"] is True,
            "identical_to_monolithic": r["identical_to_monolithic"] is True,
            "published": r["handoffs_published_at_kill"] >= 1,
            "adopted": r["adopted_slots"] >= 1
            and r["prefill_routed"] >= r["adopted_slots"],
            "fallback": r["decode_fallback_prefill_tokens"] > 0,
            "prefill_watermark": r["prefill_watermark_never_past_published"] is True,
            "step_p99": r["decode_step_p99_ms"] is not None
            and r["decode_step_p99_ms"] < 1000.0},
        23: lambda: {
            "scenario": r["scenario"] == "23:quorum-leader-failover-storm",
            "replicas": r["replicas"] == 2 and r["broker_replicas"] == 3,
            "elections": r["leader_elections"] == 1,
            "failover": r["failover"]["victim_idx"] == 0
            and r["failover"]["winner_idx"] in (1, 2)
            and r["failover"]["epoch"] == r["failover"]["old_epoch"] + 1 == r["cell_epoch"],
            "wal": r["failover"]["recovery"]["replayed_records"] > 0
            and r["failover"]["recovery"]["replayed_events"]
            > r["failover"]["recovery"]["replayed_records"],
            "zero_lost": r["zero_lost"] is True,
            "identical_to_no_kill": r["identical_to_no_kill"] is True,
            "committed_duplicates": r["committed_duplicates"] == 0,
            "deposed": r["deposed_append_rejected"] is True,
            "unfenced": r["workers_survived_unfenced"] is True,
            "exit_codes": codes == [0, 0]},
        24: lambda: {
            "scenario": r["scenario"] == "24:rolling-hot-swap-canary-rollback",
            "replicas": r["replicas"] == 2,
            "rolled_back": r["divergent_rollout"]["phase"] == "rolled_back"
            and r["divergent_rollout"]["rollback_reason"] == "canary_divergence"
            and all(v == 0 for v in r["divergent_rollout"]["member_versions"].values()),
            "complete": r["clean_rollout"]["phase"] == "complete"
            and all(v == 2 for v in r["clean_rollout"]["member_versions"].values())
            and r["fleet_model_version"] == 2,
            "zero_lost": r["zero_lost"] is True,
            "committed_duplicates": r["committed_duplicates"] == 0,
            "identical_to_no_rollout": r["identical_to_no_rollout"] is True,
            "tags": r["divergent_version_leaked"] is False
            and r["version_tags_consistent"] is True
            and "0" in r["version_tags"] and "2" in r["version_tags"],
            "survived": r["workers_survived"] is True},
    }
    return [name for name, ok in checks[num]().items() if not ok]


def _procfleet_children(num: int, dumps, n_layers: int, cuda: bool) -> list:
    """Each dumping worker's launches against its own counts: a dense
    decode replica's K1 = layers x (prefills + warm resumes + canary
    shadow prefills), all on the CUDA cores (f32); scenario 21's paged
    decode replicas 0; K2 = K3 = K4 = K5 = 0 in every worker. On the card
    a mismatch raises, as does a dense scenario whose workers launched no
    K1. → per worker (member, K1 and the counts it follows)."""
    out = []
    for d in dumps:
        passes = d.get("prefills", 0) + d.get("warm_resumes", 0) + d.get("shadow_prefills", 0)
        want = dict.fromkeys(d["launches"], 0)
        want["flash_fwd"] = 0 if num == 21 else n_layers * passes
        if cuda and d["launches"] != want:
            raise AssertionError(f"harness_procfleet {num}: worker {d['member']} launched "
                                 f"{d['launches']}, want {want}")
        out.append({"member": d["member"], "role": d.get("role", "decode"),
                    "flash_fwd": d["launches"]["flash_fwd"], "prefills": d.get("prefills"),
                    "warm_resumes": d.get("warm_resumes"),
                    "shadow_prefills": d.get("shadow_prefills"),
                    "tick_ms": {"p50": d.get("step_p50_ms"), "p99": d.get("step_p99_ms")}})
    if cuda and num != 21 and not sum(c["flash_fwd"] for c in out):
        raise AssertionError(f"harness_procfleet {num}: no worker launched K1: {out}")
    return out


def check_harness_procfleet(torch, size: str = "full", device=None) -> list:
    """The harness's process-fleet scenarios 17, 18, 19, 21, 23 and 24
    through ``harness.run_scenario(n, "full")`` on the card, at
    ``TransformerConfig()``'s widths (d_model 512, 4 layers, 8 q / 8 kv
    heads, head dim 64, d_ff 1,376, vocab 32,000), f32 as
    ``fleet.proc.build_model`` gives the workers and the in-process
    reference (seed 0): the SIGKILL storm, the exactly-once storm, the
    broker crashed and recovered from its WAL on the same port, the
    killed prefill worker under disaggregated prefill, the quorum cell's
    leader killed, and two rollouts over the checkpoint topic (a
    divergent one rolled back, a clean one completed). Every count of
    this process is zeroed just before a scenario and read just after;
    each worker reports its own in its dump. Held: ``tests/test_harness.py``'s
    assertions for each; in this process K1 = layers x (dense prefills +
    warm resumes + warm-ups) of the reference servers (0 for 21's paged
    one); in each worker that dumped (a SIGKILLed one leaves none) K1 =
    layers x (prefills + warm resumes + canary shadow prefills) on a
    dense pool, 0 on 21's paged pools; no tensor-core launch (f32); K2 =
    K3 = K4 = K5 = 0 everywhere. ``size``/``device`` exist for a CPU
    rehearsal at tiny size, where no count moves."""
    from torchkafka_tpu_torch.harness import run_scenario
    from torchkafka_tpu_torch.harness.scenarios import _default_cfg

    cuda = device is None
    n_layers = _default_cfg(size, 64).n_layers
    smi = smi_line() if cuda else "not measured"
    rows = []
    for num in HARNESS_PROCFLEET:
        with contextlib.ExitStack() as stack:
            servers, warm = stack.enter_context(_server_spy())
            dumps = stack.enter_context(_dump_spy())
            read = _zero_launches()
            t0 = time.perf_counter()
            r = run_scenario(num, size, device=device)
            sec = time.perf_counter() - t0
            got = read()
            passes = _fleet_passes(servers, warm)
        failed = _procfleet_invariants(num, r)
        if failed:
            raise AssertionError(f"harness_procfleet {num}: {failed} {r}")
        want = dict.fromkeys(got, 0)
        want["flash_fwd"] = passes["k1"]
        if cuda and got != want:
            raise AssertionError(f"harness_procfleet {num}: launches {got}, want {want}")
        children = _procfleet_children(num, dumps[-1], n_layers, cuda)
        rows.append({"phase": "harness_procfleet", "scenario": num, "dtype": "float32",
                     "args": f"--size {size}", "seconds": sec, "launches": got,
                     "launch_check": want, "passes": passes, "children": children,
                     "nvidia_smi": smi, **r})
        if cuda:
            torch.cuda.empty_cache()
    return rows



# ------------------------------------------------------------- mixture of experts

MOE = dict(n_experts=8, expert_top_k=2)  # Mixtral-8x7B's published routing
MOE_F32_GROUP = 128  # one prompt a group: the f32 pair's drops do not depend on the batch


def moe_serve_config(torch, **overrides):
    """The zoo's 1b widths (d_model 2048, 16/8 heads, vocab 32,000) with 8
    SwiGLU experts of d_ff 5632 each, top-2: about 7.1B parameters."""
    from torchkafka_tpu_torch.models.zoo import zoo_config

    return dataclasses.replace(zoo_config("1b", max_seq_len=128 + MAX_NEW), **MOE,
                               **overrides)


def _moe_lockstep_pair(torch, cfg, params, prompts) -> dict:
    """The 16-slot f32 server (a greedy compute-dtype pool: its tick block
    replayed from a CUDA graph) against the port's lockstep ``generate``
    run on the same waves of 16 prompts (the server admits 16 at a time,
    all finishing on one tick): every token equal. The capacity config
    groups one prompt's 128 tokens, so its prefill drops do not depend on
    which prompts share the batch."""
    import numpy as np

    from torchkafka_tpu_torch.models.generate import generate
    from torchkafka_tpu_torch.serve import StreamingGenerator
    from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer

    n, plen = prompts.shape
    broker = InMemoryBroker()
    broker.create_topic("moe", partitions=2)
    for i in range(n):
        broker.produce("moe", prompts[i].tobytes(), partition=i % 2)
    consumer = MemoryConsumer(broker, "moe", group_id="moe")
    server = StreamingGenerator(consumer, params, cfg, slots=16, prompt_len=plen,
                                max_new=MAX_NEW, commit_every=16,
                                ticks_per_sync=MAX_NEW - 1, device="cuda")
    order = [(2 * r.offset + r.partition, out) for r, out in server.run(max_records=n)]
    consumer.close()
    graphed = server._block_graph is not None
    same = total = 0
    for w in range(0, n, 16):
        wave = [i for i, _ in order[w:w + 16]]
        ref = generate(params, cfg, torch.from_numpy(prompts[wave]).cuda(), MAX_NEW).cpu()
        for row, (_, out) in zip(ref.numpy(), order[w:w + 16]):
            same += int(np.sum(row == out))
            total += len(row)
    return {"dispatch": cfg.moe_dispatch, "graphed": graphed,
            "tokens_equal": same, "tokens": total}


def moe_mlp_times(torch, cfg, params) -> dict:
    """The dense-dispatch MoE MLP (``models.transformer._moe_mlp``) on
    layer 0's bf16 experts at the decode (16 x 1 tokens) and the prefill
    (16 x 128) shapes: its ms beside the same function written as einsums
    (``"bsd,edf->ebsf"``, which copies each expert weight into a [D, E·F]
    layout first) and the bound (every expert weight read once; or its
    products at the bf16 peak)."""
    import torch.nn.functional as F

    from torchkafka_tpu_torch.models.transformer import _moe_mlp, layer_at

    layer = layer_at(params["layers"], 0)
    w = [layer[n] for n in ("w_gate", "w_up", "w_down")]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def einsums(h):
        probs = torch.softmax(torch.einsum("bsd,de->bse", h.float(),
                                           layer["router"].float()), dim=-1)
        vals, idx = torch.topk(probs, cfg.expert_top_k, dim=-1)
        comb = (F.one_hot(idx, cfg.n_experts) * (vals / vals.sum(-1, keepdim=True))[..., None]
                ).sum(2)
        gate = F.silu(torch.einsum("bsd,edf->ebsf", h, w[0]))
        out = torch.einsum("ebsf,efd->ebsd", gate * torch.einsum("bsd,edf->ebsf", h, w[1]), w[2])
        return torch.einsum("ebsd,bse->bsd", out, comb.to(h.dtype))

    out = {}
    for name, s in (("decode", 1), ("prefill", 128)):
        h = torch.randn((16, s, cfg.d_model), generator=gen, device="cuda", dtype=cfg.dtype)
        err = max_err(torch, _moe_mlp(h, layer, cfg)[0], einsums(h))
        n = 16 * s
        flops = 2 * 3 * cfg.n_experts * n * cfg.d_model * cfg.d_ff
        nbytes = sum(t.numel() * t.element_size() for t in w) + 2 * h.numel() * h.element_size()
        b_ms, b_by = bound(flops, nbytes)
        out[name] = {"ms": cuda_ms(torch, lambda: _moe_mlp(h, layer, cfg), flush),
                     "einsum_ms": cuda_ms(torch, lambda: einsums(h), flush),
                     "bound_ms": b_ms, "bound_by": b_by, "max_abs_err_vs_einsum": err}
    return out


def check_serve_moe(torch) -> list:
    """MoE serving at the 1b widths, 8 experts top-2, all 24 layers, random
    bf16 weights from the seed: scenario 7's traffic (32 prompts of 128
    tokens on two partitions, 16 slots, 64 new tokens) through
    ``StreamingGenerator`` three times, each run's counts zeroed just
    before it and read just after: greedy on the bf16 pool (the tick block
    replayed from a CUDA graph: the MoE decode captures), on the int8 pool
    read by K4, and with ``quantize_params`` int8 weights (the router kept
    in bf16) on the int8 pool. Held per run (``serve``): every record once
    with 64 tokens, committed == end offsets, K1 = 24 x prefills on the
    tensor cores, K4 = 24 x decode ticks on the int8 pools (0 on bf16);
    token 0 equal between the two pools. Before them, the MoE MLP of one
    layer at the decode and prefill shapes, timed beside its einsum
    formulation (``moe_mlp_times``). Then an f32 pair at the same
    widths, 2 layers, dense and capacity dispatch (capacity factor 1.0,
    groups of one prompt): the server against the lockstep ``generate``,
    every token equal."""
    import numpy as np

    from torchkafka_tpu_torch.models.quant import quantize_params, quantized_nbytes
    from torchkafka_tpu_torch.models.transformer import count_params
    from torchkafka_tpu_torch.models.zoo import random_serving_params

    smi = smi_line()
    cfg = moe_serve_config(torch)
    params = random_serving_params(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                                   device="cuda")
    n_params = count_params(params)
    mlp = moe_mlp_times(torch, cfg, params)
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (32, 128),
                                                   dtype=np.int32)
    graphs = []
    outs_b, row_b = serve(torch, cfg, params, prompts, None,
                          on_done=lambda s: graphs.append(s._block_graph is not None))
    outs_q, row_q = serve(torch, cfg, params, prompts, "int8")
    qparams = quantize_params(params, cfg)
    q_bytes = quantized_nbytes(qparams)
    del params
    torch.cuda.empty_cache()
    outs_w, row_w = serve(torch, cfg, qparams, prompts, "int8")
    del qparams
    torch.cuda.empty_cache()
    if not graphs[0]:
        raise AssertionError("serve_moe: the bf16 pool's tick block was not graphed")
    for row in (row_q, row_w):
        if row["committed"] != row_b["committed"]:
            raise AssertionError("serve_moe: the runs committed other offsets")
    tok0 = all(int(outs_b[k][0]) == int(outs_q[k][0]) for k in outs_b)
    if not tok0:
        raise AssertionError("serve_moe: token 0 differs between the bf16 and int8 pools")
    rows = []
    for run, row, outs in (("bf16_pool", row_b, outs_b), ("int8_pool", row_q, outs_q),
                           ("int8_weights", row_w, outs_w)):
        agree = float(np.mean([np.mean(outs[k] == outs_b[k]) for k in outs_b]))
        rows.append({**row, "phase": "serve_moe", "run": run, "model": "1b MoE 8x top-2",
                     "layers": cfg.n_layers, "params": n_params,
                     "graphed": graphs[0] if run == "bf16_pool" else False,
                     "token_agreement_with_bf16_pool": agree, "nvidia_smi": smi,
                     **({"int8_param_bytes": q_bytes} if run == "int8_weights" else {})})
    rows[1]["token0_identical_to_bf16_pool"] = tok0
    rows[0]["moe_mlp"] = mlp
    cfg32 = moe_serve_config(torch, n_layers=2, dtype=torch.float32, param_dtype=torch.float32,
                             moe_group_size=MOE_F32_GROUP, capacity_factor=1.0)
    params32 = random_serving_params(torch.Generator(device="cuda").manual_seed(SEED + 2),
                                     cfg32, device="cuda")
    pairs = []
    for dispatch in ("dense", "capacity"):
        pair = _moe_lockstep_pair(torch, dataclasses.replace(cfg32, moe_dispatch=dispatch),
                                  params32, prompts)
        pairs.append(pair)
        if pair["tokens_equal"] != pair["tokens"] or not pair["graphed"]:
            raise AssertionError(f"serve_moe f32: server vs lockstep generate {pair}")
    del params32
    torch.cuda.empty_cache()
    rows.append({"phase": "serve_moe", "run": "f32_lockstep_pair", "layers": 2,
                 "capacity_factor": 1.0, "moe_group_size": MOE_F32_GROUP, "pairs": pairs})
    return rows


def check_train_moe(torch) -> list:
    """MoE training at the 1b widths, 8 experts top-2, ``CUT_LAYERS``
    layers, f32 masters, bf16 compute, ``moe_dispatch="capacity"`` (factor
    1.25, groups of 256): the ``train`` path (48 records of 512 tokens →
    ``KafkaStream`` → ``make_train_step`` → ``token.commit``), 6 steps of
    8. Held there: finite losses, the watermarks, K1 = K2 = K3 = layers x
    steps, all on the tensor cores. Before it, at f32 on 2 layers (B=2,
    S=512): the loss with capacity dispatch at an ample factor (8: no
    drop) equals dense dispatch's within 1e-4."""
    import numpy as np

    from torchkafka_tpu_torch.models.transformer import Transformer, init_params

    smi = smi_line()
    cfg32 = train_config(torch, n_layers=2, dtype=torch.float32, **MOE)
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED + 3), cfg32,
                         device="cuda")
    toks = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, cfg32.vocab_size, (2, 512), dtype=np.int32)).cuda()
    with torch.no_grad():
        dense = Transformer(cfg32).loss(params, toks).item()
        ample = Transformer(dataclasses.replace(
            cfg32, moe_dispatch="capacity", capacity_factor=float(cfg32.n_experts))
        ).loss(params, toks).item()
    del params
    torch.cuda.empty_cache()
    if not abs(ample - dense) <= 1e-4:
        raise AssertionError(f"train_moe f32: capacity {ample} vs dense {dense}")
    cfg = train_config(torch, n_layers=CUT_LAYERS, moe_dispatch="capacity", **MOE)
    row = train(torch, cfg=cfg, phase="train_moe")
    torch.cuda.empty_cache()
    return [{**row, "model": "1b MoE 8x top-2", "capacity_factor": cfg.capacity_factor,
             "moe_group_size": cfg.moe_group_size, "nvidia_smi": smi,
             "f32_2_layers": {"dense_loss": dense, "ample_capacity_loss": ample,
                              "abs_diff": abs(ample - dense), "tolerance": 1e-4}}]


# ------------------------------------------------------------- pod training

POD_RANKS = 2
# (b)'s bound on parameters against the UNSPLIT single-process step. The
# ranks' arithmetic is the split step's (bit for bit on the card, PR 20);
# the unsplit step sums the same gradients in another order, and AdamW's
# normalisation turns that rounding into up to 1.3e-4 relative (the
# embedding's rows, where m/(sqrt(v)+eps) sits near eps) after 3 steps at
# the 1b widths. 1e-3 still catches a gradient off by any factor or a
# dropped shard.
POD_UNSPLIT_PARAM_REL = 1e-3


def _pod_config(torch, device: str, **overrides):
    """The phase's model: the 1b training config on the card; on the CPU
    (a rehearsal of the phase) the same shape of run at tiny widths."""
    if device == "cuda":
        return train_config(torch, **overrides)
    from torchkafka_tpu_torch.models.transformer import TransformerConfig

    small = dict(vocab_size=256, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2,
                 d_ff=128, max_seq_len=512, dtype=torch.float32)
    return TransformerConfig(**{**small, **overrides})


def _param_checksums(torch, params) -> list:
    """Two exact int64 checksums of every parameter's bits (the sum of its
    int32 words and their sum weighted by position mod 2^16), on the card:
    replicas that agree here agree bit for bit but for a vanishing chance."""
    from torchkafka_tpu_torch.parallel.mesh import local_part
    from torchkafka_tpu_torch.utils.tree import tree_leaves

    out = []
    chunk = 1 << 24  # int64 temporaries of 128 MiB at a time
    for leaf in tree_leaves(params):
        words = local_part(leaf).detach().reshape(-1).view(torch.int32)
        plain = weighted = 0
        for lo in range(0, words.numel(), chunk):
            w = words[lo:lo + chunk].to(torch.int64)
            pos = (torch.arange(lo, lo + w.numel(), device=w.device, dtype=torch.int64)
                   % 65521)
            plain += int(w.sum())
            weighted += int((w * pos).sum())
        out += [plain, weighted]
    return out


def _pod_stream_train(torch, tk, cfg, mesh, *, topic, steps, batch, seed, world,
                      flash, device, save=None):
    """One mesh training run through the ingest path: each rank's
    ``pod_consumer`` slice of a topic holding exactly ``steps`` batches a
    rank → ``KafkaStream(mesh=)`` → ``make_train_step(cfg, mesh)`` →
    ``token.commit(wait_for=loss)`` (the default ``BarrierWatchdog``).
    K1-K3 counts zeroed just before, read just after. ``save``: (root,
    step) for a pod checkpoint after that step. → (row, params)."""
    import functools

    import numpy as np

    from torchkafka_tpu_torch.checkpoint import StreamCheckpointer
    from torchkafka_tpu_torch.parallel import collectives
    from torchkafka_tpu_torch.parallel.multihost import pod_consumer

    parts = 2 * world
    broker = tk.InMemoryBroker()
    broker.create_topic(topic, partitions=parts)
    rng = np.random.default_rng(seed)
    for i in range(steps * batch * world):  # every rank's partitions: `steps` batches
        broker.produce(topic, rng.integers(0, cfg.vocab_size, 512, dtype=np.int32).tobytes(),
                       partition=i % parts)
    consumer = pod_consumer(topic, parts, "pod",
                            transport=functools.partial(tk.MemoryConsumer, broker))
    cuda = device == "cuda"
    init_fn, step_fn = tk.make_train_step(cfg, mesh, tk.adamw(1e-3), device=device)
    params, opt = init_fn(torch.Generator(device=device).manual_seed(SEED))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for fn in flash:
        fn.launches = 0
        fn.tc_launches = 0
    losses, step_ms, coll_ms, coll_bytes, calls = [], [], [], [], []
    saved = None
    t0 = time.perf_counter()
    batch_axes = tuple(a for a in ("data", "fsdp") if a in mesh.mesh_dim_names)
    with tk.KafkaStream(consumer, tk.fixed_width(512, np.int32), batch_size=batch,
                        mesh=mesh, data_axis=batch_axes, idle_timeout_ms=2000,
                        device=device) as stream:
        it = iter(stream)
        for i in range(steps):
            b, token = next(it)
            if cuda:
                s_ev = torch.cuda.Event(enable_timing=True)
                e_ev = torch.cuda.Event(enable_timing=True)
                s_ev.record()
            params, opt, loss = step_fn(params, opt, b.data, None)
            if cuda:
                e_ev.record()
            if not token.commit(wait_for=loss):
                raise AssertionError(f"pod {topic}: commit {i} failed")
            step_ms.append(s_ev.elapsed_time(e_ev) if cuda else None)
            coll_ms.append(step_fn.stats["seconds"] * 1e3)
            coll_bytes.append(step_fn.stats["bytes"])
            calls.append(step_fn.stats["calls"])
            losses.append(loss.item())
            if save is not None and i + 1 == save[1]:
                t_s = time.perf_counter()
                saved = StreamCheckpointer(save[0]).save(
                    save[1], {"params": params, "opt": opt.state_tree(params)}, token.offsets)
                saved = {"path": saved, "seconds": time.perf_counter() - t_s,
                         "offsets": {str(tp.partition): o for tp, o in token.offsets.items()}}
        if cuda:
            torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = {fn.__name__.replace("_bhsd", ""): fn.launches for fn in flash}
    tc = {fn.__name__.replace("_bhsd", ""): fn.tc_launches for fn in flash}
    mine = [tp for tp in consumer.assignment()]
    committed = {str(tp.partition): broker.committed("pod", tp) for tp in mine}
    end = {str(tp.partition): broker.end_offset(tp) for tp in mine}
    consumer.close()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"pod {topic}: non-finite losses {losses}")
    row = {"layers": cfg.n_layers, "batch_per_rank": batch, "seq": 512, "steps": steps,
           "losses": losses, "step_ms": step_ms, "collective_ms": coll_ms,
           "collective_bytes": coll_bytes, "collective_calls": calls,
           "loop_s": loop_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
           "launches": launches, "tc_launches": tc, "committed": committed,
           "end_offsets": end, "barrier": type(stream._barrier).__name__,
           "collectives_total": collectives.COUNTS.as_dict()}
    if saved is not None:
        row["checkpoint"] = saved
    return row, params, opt


def pod_rank_main(rank: int, port: int, outdir: str, device: str = "cuda") -> int:
    """One rank of the pod_train phase (``chip_smoke.py --pod-rank``): see
    ``check_pod_train``. Writes ``<outdir>/rank_<rank>.json``."""
    import numpy as np
    import torch

    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.ops import _native
    from torchkafka_tpu_torch.ops.flash import flash_dkv_bhsd, flash_dq_bhsd, flash_fwd_bhsd
    from torchkafka_tpu_torch.parallel import collectives, multihost
    from torchkafka_tpu_torch.parallel.mesh import full_tensor, make_mesh
    from torchkafka_tpu_torch.utils.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = POD_RANKS
    cuda = device == "cuda"
    t_init = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{port}", world, rank, timeout_s=600.0,
                         device=None if cuda else device)
    out = {"rank": rank, "rules": multihost.rules(), "init_s": time.perf_counter() - t_init,
           "libraries_present_at_start": all(_native._target(k).exists()
                                             for k in _native.KERNELS) if cuda else None}
    flash = (flash_fwd_bhsd, flash_dq_bhsd, flash_dkv_bhsd)

    # (a) bf16 compute, f32 masters: {"data": 2}, then {"fsdp": 2}, both
    # at CUT_LAYERS (the data run's 24 layers were cut to keep the script
    # near 700 s once pod_serve joined it). (c) rides on (a1): each rank's
    # commits.
    for name, axes in (("data", {"data": world}), ("fsdp", {"fsdp": world})):
        mesh = make_mesh(axes, device=None if cuda else device)
        cfg = _pod_config(torch, device, n_layers=CUT_LAYERS)
        row, params, opt = _pod_stream_train(
            torch, tk, cfg, mesh, topic=f"pod_{name}", steps=3, batch=8, seed=SEED + 7,
            world=world, flash=flash, device=device)
        if name == "data":
            row["checksums"] = _param_checksums(torch, params)
        del params, opt
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        out[name] = row

    # (b) f32 at the 1b widths, 2 layers: the same 16-row global batch
    # through {"data": 2} and {"fsdp": 2}, 3 steps, against rank 0's
    # single-process make_train_step from the same seed.
    cfg32 = _pod_config(torch, device, n_layers=2, dtype=torch.float32)
    toks = np.random.default_rng(SEED + 8).integers(
        0, cfg32.vocab_size, (3, 8 * world, 512), dtype=np.int32)
    pair = {}
    for name, axes in (("data", {"data": world}), ("fsdp", {"fsdp": world})):
        mesh = make_mesh(axes, device=None if cuda else device)
        init_fn, step_fn = tk.make_train_step(cfg32, mesh, tk.adamw(1e-3), device=device)
        params, opt = init_fn(torch.Generator(device=device).manual_seed(SEED + 9))
        losses = []
        for s in range(3):
            local = torch.from_numpy(toks[s, rank * 8:(rank + 1) * 8]).to(device)
            params, opt, loss = step_fn(params, opt, local, None)
            losses.append(loss.item())
        full = [full_tensor(x).detach() for x in tree_leaves(params)]
        exact = None
        if name == "data":  # the replicas' bits, compared whole
            theirs = [collectives.all_gather(t.reshape(1, -1), 0)[1 - rank] for t in full]
            exact = all(torch.equal(a.reshape(-1), b) for a, b in zip(full, theirs))
        pair[name] = {"losses": losses, "replicas_bit_equal": exact,
                      "full": full if rank == 0 else None}
        del params, opt
    if rank == 0:
        out["f32_pair"] = _pod_f32_references(torch, tk, cfg32, toks, pair, world, device)
    pair.clear()
    if cuda:
        torch.cuda.empty_cache()

    # (d) a pod checkpoint at step 2 of an f32 2-layer {"data": 2} stream
    # run; the parent restores it in one process and carries on.
    mesh = make_mesh({"data": world}, device=None if cuda else device)
    row_d, params, opt = _pod_stream_train(
        torch, tk, cfg32, mesh, topic="pod_ckpt", steps=2, batch=8, seed=SEED + 10,
        world=world, flash=flash, device=device,
        save=(os.path.join(outdir, "ckpt"), 2))
    out["ckpt"] = {k: row_d[k] for k in ("losses", "committed", "end_offsets", "checkpoint")}
    del params, opt
    out["collectives_total"] = collectives.COUNTS.as_dict()
    with open(os.path.join(outdir, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    multihost.shutdown()
    return 0


def _pod_f32_references(torch, tk, cfg32, toks, pair: dict, world: int, device: str) -> dict:
    """(b)'s references, in one process from the same seed, 3 steps each:
    ``single``, the single-process ``make_train_step`` on each 16-row
    global batch; ``split``, the same step with the gradient summed over
    the ranks' 8-row halves (each half's loss over the global count, one
    backward each, then one AdamW step): the data-parallel arithmetic
    without a process group. → each mesh run's losses and per-tensor
    relative L2 parameter differences against both."""
    from torchkafka_tpu_torch.models.transformer import Transformer
    from torchkafka_tpu_torch.utils.tree import tree_leaves

    model = Transformer(cfg32)
    refs = {}
    for how in ("single", "split"):
        init_fn, step_fn = tk.make_train_step(cfg32, None, tk.adamw(1e-3), device=device)
        params, opt = init_fn(torch.Generator(device=device).manual_seed(SEED + 9))
        losses = []
        for s in range(3):
            batch = torch.from_numpy(toks[s]).to(device)
            if how == "single":
                params, opt, loss = step_fn(params, opt, batch, None)
                losses.append(loss.item())
                continue
            count = torch.tensor(float(batch.shape[0] * (batch.shape[1] - 1)), device=device)
            opt.zero_grad()
            total = 0.0
            for r in range(world):
                share = model.loss(params, batch[r * 8:(r + 1) * 8], count=count)
                share.backward()
                total += share.item()
            opt.step()
            losses.append(total)
        refs[how] = (losses, [t.detach().clone() for t in tree_leaves(params)])
        names = _leaf_names(params)
        del params, opt
    out = {"tolerance_rel": 1e-5, "unsplit_param_tolerance_rel": POD_UNSPLIT_PARAM_REL}
    for how, (ref_losses, ref) in refs.items():
        out[f"{how}_losses"] = ref_losses
        for name, got in pair.items():
            rel = {n: float((a - b).norm() / b.norm()) for n, a, b in zip(names, got["full"], ref)}
            worst = max(rel, key=rel.get)
            out.setdefault(name, {"losses": got["losses"],
                                  "replicas_bit_equal": got["replicas_bit_equal"]})
            out[name][f"vs_{how}"] = {
                "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref_losses)),
                "param_rel_l2": rel[worst], "worst": worst, "param_rel_l2_by_tensor": rel}
    return out


def _leaf_names(tree, prefix: str = "") -> list:
    """A parameter tree's leaf names in ``tree_leaves`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def _pod_resume(torch, ckpt_root: str, world: int, device: str) -> dict:
    """(d), one process: restore the pod checkpoint (full arrays, merged
    offsets) into the single-process trainer, seek a consumer of every
    partition to its offsets and train the rest of the topic."""
    import numpy as np

    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.checkpoint import StreamCheckpointer
    from torchkafka_tpu_torch.utils.tree import tree_leaves

    cfg32 = _pod_config(torch, device, n_layers=2, dtype=torch.float32)
    ck = StreamCheckpointer(ckpt_root)
    parts = 2 * world
    broker = tk.InMemoryBroker()  # the same content the ranks built
    broker.create_topic("pod_ckpt", partitions=parts)
    rng = np.random.default_rng(SEED + 10)
    for i in range(2 * 8 * world):
        broker.produce("pod_ckpt", rng.integers(0, cfg32.vocab_size, 512, dtype=np.int32)
                       .tobytes(), partition=i % parts)
    # One more global batch for the resumed process to train on.
    extra = [rng.integers(0, cfg32.vocab_size, 512, dtype=np.int32) for _ in range(8 * world)]
    for i, row in enumerate(extra):
        broker.produce("pod_ckpt", row.tobytes(), partition=i % parts)
    consumer = tk.MemoryConsumer(broker, "pod_ckpt", group_id="pod",
                                 assignment=tk.partitions_for_process("pod_ckpt", parts, 0, 1))
    init_fn, step_fn = tk.make_train_step(cfg32, None, tk.adamw(1e-3), device=device)
    params, opt = init_fn(torch.Generator(device=device).manual_seed(SEED + 10))
    t0 = time.perf_counter()
    state, step = ck.resume(consumer, template={"params": params, "opt": opt.state_tree(params)})
    restore_s = time.perf_counter() - t0
    with torch.no_grad():
        for a, b in zip(tree_leaves(params), tree_leaves(state["params"])):
            a.copy_(b)
    opt.load_state_tree(state["opt"])
    steps = 0
    losses = []
    with tk.KafkaStream(consumer, tk.fixed_width(512, np.int32), batch_size=8 * world,
                        idle_timeout_ms=1000, device=device) as stream:
        for b, token in stream:
            params, opt, loss = step_fn(params, opt, b.data, None)
            if not token.commit(wait_for=loss):
                raise AssertionError("pod resume: commit failed")
            losses.append(loss.item())
            steps += 1
    committed = {str(p): broker.committed("pod", tk.TopicPartition("pod_ckpt", p))
                 for p in range(parts)}
    end = {str(p): broker.end_offset(tk.TopicPartition("pod_ckpt", p)) for p in range(parts)}
    consumer.close()
    return {"restored_step": step, "restore_s": restore_s, "steps_after_restore": steps,
            "losses_after_restore": losses, "committed": committed, "end_offsets": end,
            "complete": step in ck.steps()}


def _scenario3_torchrun(torch, world: int, device: str) -> dict:
    """Harness scenario 3 at full size under ``world`` ranks, started
    through ``torch.distributed.run``; one JSON line a rank."""
    here = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(world),
         "--master-addr", "127.0.0.1", "--master-port", str(port),
         "-m", "torchkafka_tpu_torch.harness", "--scenario", "3",
         *(["--size", "full"] if device == "cuda" else ["--size", "tiny", "--device", device])],
        capture_output=True, text=True, cwd=here, timeout=600,
        env={**os.environ, "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")})
    seconds = time.perf_counter() - t0
    rows = _json_objects(proc.stdout)
    if proc.returncode != 0 or len(rows) != world:
        raise AssertionError(f"pod_train scenario 3: rc {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return {"seconds": seconds, "ranks": rows}


def check_pod_scenario_3(torch, device: str = "cuda") -> list:
    """pod_train's (e): harness scenario 3 at full size under
    ``POD_RANKS`` ranks through ``torch.distributed.run`` (the kernels
    already built): every rank consumes its own partitions, commits each
    of its 50 steps, returns the same global loss and times a slope that
    holds; K1 = K2 = K3 = 4 layers x 50 steps on each rank. One row, run
    ``scenario_3``; ``device="cpu"`` rehearses it at tiny size (no kernel
    counts)."""
    cuda = device == "cuda"
    s3 = _scenario3_torchrun(torch, POD_RANKS, device)
    problems = []
    steps, rows_a_step, layers = (50, 8, 4) if cuda else (8, 2, 2)
    for row in s3["ranks"]:
        if (row["records"] != steps * rows_a_step or row["commit"]["count"] != steps
                or row["commit_failures"] or row["mesh"] != {"data": POD_RANKS}
                or (cuda and not row.get("slope_ok")) or row["rules"]["backend"] != "gloo"
                or any(n != (layers * steps if cuda else 0) for n in row["launches"].values())):
            problems.append(f"rank {row.get('process_index')}: {row}")
    if s3["ranks"][0]["last_loss"] != s3["ranks"][1]["last_loss"]:
        problems.append("the ranks' losses differ")
    if problems:
        raise AssertionError("pod_train scenario 3: " + "; ".join(problems))
    return [{"phase": "pod_train", "run": "scenario_3",
             "nvidia_smi": smi_line() if cuda else None, "seconds": s3["seconds"],
             "ranks": s3["ranks"]}]


def _json_objects(text: str) -> list:
    """Every JSON object in ``text`` that starts a line or follows one:
    ranks writing to one pipe unbuffered may put a line's newline after
    the next rank's object ("{a}{b}\n\n"), but an object shorter than the
    pipe's atomic write is never split."""
    decoder, out = json.JSONDecoder(), []
    for line in text.splitlines():
        i = 0
        while line.startswith("{", i):
            obj, i = decoder.raw_decode(line, i)
            out.append(obj)
    return out


def free_port() -> int:
    """A free localhost port (for a process group's store)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(mode: str, outdir: str, device: str) -> tuple[list, float]:
    """Start ``POD_RANKS`` ranks of ``mode`` (``chip_smoke.py --pod-rank``)
    in one process group, wait for all, raise with their output if one
    failed. → (each rank's ``<outdir>/rank_<r>.json``, seconds)."""
    here = os.path.abspath(__file__)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, here, "--pod-rank", str(r), "--pod-port", str(port),
         "--pod-out", outdir, "--pod-device", device, "--pod-mode", mode],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(POD_RANKS)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    seconds = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        raise AssertionError(f"{mode} ranks: " + " | ".join(
            f"rc {p.returncode}: {log[-3000:]}" for p, log in zip(procs, logs)))
    dumps = []
    for r in range(POD_RANKS):
        with open(os.path.join(outdir, f"rank_{r}.json")) as f:
            dumps.append(json.load(f))
    return dumps, seconds


def check_pod_train(torch, device: str = "cuda") -> list:
    """Data- and fsdp-parallel training across processes: ``POD_RANKS``
    ranks started as children of this process (``chip_smoke.py
    --pod-rank``), one process group (``parallel.multihost.initialize``:
    the device rule puts both on ``cuda:0``, the backend rule picks gloo),
    each dumping its counts to a JSON file:

    (a) the 1b widths, f32 masters, bf16 compute, B=8 rows a rank, S=512,
        AdamW: ``{"data": 2}`` and ``{"fsdp": 2}`` at ``CUT_LAYERS``
        (the data run's 24 layers cut since pod_serve), 3 steps each through ``pod_consumer`` →
        ``KafkaStream(mesh=)`` → ``make_train_step(cfg, mesh)`` →
        ``token.commit``; per rank: step ms (CUDA events), collective ms
        (host clock), bytes a step, peak memory; K1 = K2 = K3 = layers x
        steps on each rank, all on the tensor cores; the data replicas'
        parameter checksums equal;
    (b) f32 at 2 layers: ``{"data": 2}`` and ``{"fsdp": 2}`` on one 16-row
        global batch, 3 steps, against the single-process step: losses
        and parameters within 1e-5 relative; data replicas bit-equal;
    (c) each rank's committed offsets equal its partitions' end offsets;
    (d) a pod checkpoint at step 2 (f32, 2 layers, ``{"data": 2}``) is
        complete, and one process restores it and trains on from its
        offsets to the topic's end;
    (e) harness scenario 3 at full size under 2 ranks through
        ``torch.distributed.run`` (``check_pod_scenario_3``).
    The kernels are built once, by this process, before any rank starts;
    the ranks only load them. ``device="cpu"`` rehearses the phase at
    tiny widths (no kernel counts or device numbers)."""
    import shutil

    from torchkafka_tpu_torch.ops import _native

    cuda = device == "cuda"
    smi = smi_line() if cuda else None
    t0 = time.perf_counter()
    if cuda:
        _native.build_all()
    libs = {k: _native._target(k) for k in _native.KERNELS} if cuda else {}
    mtimes = {k: p.stat().st_mtime_ns for k, p in libs.items()}
    build_s = time.perf_counter() - t0
    outdir = tempfile.mkdtemp(prefix="tk-pod-")
    rows = []
    try:
        dumps, ranks_s = _run_ranks("train", outdir, device)
        rebuilt = [k for k, p in libs.items() if p.stat().st_mtime_ns != mtimes[k]]
        t0 = time.perf_counter()
        resume = _pod_resume(torch, os.path.join(outdir, "ckpt"), POD_RANKS, device)
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(outdir, ignore_errors=True)

    problems = []
    for d in dumps:
        r = d["rank"]
        if d["rules"]["device"] != ("cuda:0" if cuda else "cpu") or d["rules"]["backend"] != "gloo":
            problems.append(f"rank {r} rules {d['rules']}")
        if cuda and not d["libraries_present_at_start"]:
            problems.append(f"rank {r} started before the kernels were built")
        for name in ("data", "fsdp"):
            row = d[name]
            want = row["layers"] * row["steps"] if cuda else 0
            if any(n != want for n in row["launches"].values()) or \
                    any(n != want for n in row["tc_launches"].values()):
                problems.append(f"rank {r} {name}: launches {row['launches']} "
                                f"tc {row['tc_launches']}, want {want}")
            if row["committed"] != row["end_offsets"]:
                problems.append(f"rank {r} {name}: committed {row['committed']} "
                                f"!= end {row['end_offsets']}")
            if row["barrier"] != "BarrierWatchdog":
                problems.append(f"rank {r} {name}: barrier {row['barrier']}")
    if dumps[0]["data"]["checksums"] != dumps[1]["data"]["checksums"]:
        problems.append("data replicas' parameters differ (bf16 compute)")
    for name in ("data", "fsdp"):
        if dumps[0][name]["losses"] != dumps[1][name]["losses"]:
            problems.append(f"{name}: ranks returned different global losses")
    pair = dumps[0]["f32_pair"]
    for name in ("data", "fsdp"):
        got = pair[name]
        if not (got["vs_single"]["loss_rel"] <= 1e-5 and got["vs_split"]["loss_rel"] <= 1e-5
                and got["vs_split"]["param_rel_l2"] <= 1e-5
                and got["vs_single"]["param_rel_l2"] <= POD_UNSPLIT_PARAM_REL):
            problems.append(f"f32 {name} pair: " + json.dumps(
                {h: {k: v for k, v in got[h].items() if k != "param_rel_l2_by_tensor"}
                 for h in ("vs_single", "vs_split")}))
    if pair["data"]["replicas_bit_equal"] is not True:
        problems.append("f32 data replicas not bit-equal")
    ck = [d["ckpt"] for d in dumps]
    if not (resume["complete"] and resume["restored_step"] == 2
            and resume["steps_after_restore"] >= 1
            and resume["committed"] == resume["end_offsets"]):
        problems.append(f"pod checkpoint resume: {resume}")
    if rebuilt:
        problems.append(f"kernels rebuilt during the phase: {rebuilt}")
    if problems:
        raise AssertionError("pod_train: " + "; ".join(problems))

    def per_rank(name, key):
        return [d[name][key] for d in dumps]

    for name in ("data", "fsdp"):
        row = dumps[0][name]
        rows.append({
            "phase": "pod_train", "run": name, "ranks": POD_RANKS, "nvidia_smi": smi,
            "rules": [d["rules"] for d in dumps], "layers": row["layers"],
            "batch_per_rank": row["batch_per_rank"], "seq": row["seq"], "steps": row["steps"],
            "losses": row["losses"], "step_ms": per_rank(name, "step_ms"),
            "collective_ms": per_rank(name, "collective_ms"),
            "collective_bytes_per_step": per_rank(name, "collective_bytes"),
            "collective_calls_per_step": per_rank(name, "collective_calls"),
            "peak_mem_gb": per_rank(name, "peak_mem_gb"), "loop_s": per_rank(name, "loop_s"),
            "launches": per_rank(name, "launches"), "tc_launches": per_rank(name, "tc_launches"),
            "committed": per_rank(name, "committed"), "end_offsets": per_rank(name, "end_offsets"),
            "replica_checksums_equal": name == "data" or None})
    rows.append({"phase": "pod_train", "run": "f32_pair", "layers": 2, **pair})
    rows.append({"phase": "pod_train", "run": "checkpoint",
                 "save": [c["checkpoint"] for c in ck], "losses_before": ck[0]["losses"],
                 "resume": resume, "resume_s": resume_s})
    if cuda:
        torch.cuda.empty_cache()
    rows += check_pod_scenario_3(torch, device)
    rows.append({"phase": "pod_train", "run": "summary", "build_s": build_s,
                 "ranks_s": ranks_s, "kernels_built_once": not rebuilt,
                 "init_s": [d["init_s"] for d in dumps],
                 "collectives_total": [d["collectives_total"] for d in dumps]})
    return rows


# --------------------------------------------- tensor and sequence parallel

# (name, axes, attn_impl) of the pod_tp_sp runs: Megatron tp, ring and
# Ulysses sp, each over the phase's two ranks.
TP_SP_MESHES = (("tp", {"tp": POD_RANKS}, "auto"), ("sp_ring", {"sp": POD_RANKS}, "ring"),
                ("sp_ulysses", {"sp": POD_RANKS}, "ulysses"))
# (b): the first step's loss and every gradient against the single-process
# step, relative (per tensor, L2), before AdamW turns the summation order
# into up to 1e-4 in the parameters (held to POD_UNSPLIT_PARAM_REL).
TP_SP_GRAD_REL = 1e-5
# (c): the flash phases' bounds (check_flash: bf16 o, absolute;
# check_flash_bwd: bf16 gradients, relative to the largest |reference|).
TP_SP_ATTN_TOL = {"out_abs": 4e-2, "grad_rel": 1e-2}


def _mesh_bf16_run(torch, tk, cfg, mesh, toks, flash, device, phase="pod_tp_sp") -> dict:
    """(a): 3 steps of ``make_train_step(cfg, mesh)`` on the global batches
    ``toks`` (the same rows on both ranks, which differ only in tp, sp, pp
    or ep), K1-K3 counts zeroed just before and read just after."""
    import math

    cuda = device == "cuda"
    init_fn, step_fn = tk.make_train_step(cfg, mesh, tk.adamw(1e-3), device=device)
    params, opt = init_fn(torch.Generator(device=device).manual_seed(SEED))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for fn in flash:
        fn.launches = 0
        fn.tc_launches = 0
    losses, step_ms, stats = [], [], []
    t0 = time.perf_counter()
    for s in range(toks.shape[0]):
        batch = torch.from_numpy(toks[s]).to(device)
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        params, opt, loss = step_fn(params, opt, batch, None)
        if cuda:
            ev[1].record()
        losses.append(loss.item())
        step_ms.append(ev[0].elapsed_time(ev[1]) if cuda else None)
        stats.append(dict(step_fn.stats))
    loop_s = time.perf_counter() - t0
    launches = {fn.__name__.replace("_bhsd", ""): fn.launches for fn in flash}
    tc = {fn.__name__.replace("_bhsd", ""): fn.tc_launches for fn in flash}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{phase} {cfg.attn_impl}: non-finite losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    del params, opt
    return {"layers": cfg.n_layers, "attn_impl": cfg.attn_impl, "rows": int(toks.shape[1]),
            "seq": int(toks.shape[2]), "steps": int(toks.shape[0]), "losses": losses,
            "step_ms": step_ms, "collective_ms": [x["seconds"] * 1e3 for x in stats],
            "collective_bytes": [x["bytes"] for x in stats],
            "collective_calls": [x["calls"] for x in stats], "loop_s": loop_s,
            "peak_mem_gb": peak, "launches": launches, "tc_launches": tc}


def _full_grads(torch, params, cfg, mesh) -> list:
    """Every parameter's gradient after a mesh step, put together from the
    ranks' shards (``tree_leaves`` order); a collective of every rank."""
    from torch.distributed.tensor import DTensor

    from torchkafka_tpu_torch.models.transformer import param_specs, shardings_for_mesh
    from torchkafka_tpu_torch.parallel.mesh import full_tensor, local_part
    from torchkafka_tpu_torch.utils.tree import tree_leaves

    placements = shardings_for_mesh(mesh, param_specs(cfg))

    def at(name):
        node = placements
        for part in name.split("/"):
            node = node[part]
        return node

    return [full_tensor(DTensor.from_local(local_part(p).grad, mesh, at(n), run_check=False))
            for p, n in zip(tree_leaves(params), _leaf_names(params))]


def _rel_l2(torch, got: list, ref: list, names: list) -> dict:
    return {n: float((a.float() - b.float()).norm() / b.float().norm())
            for n, a, b in zip(names, got, ref)}


def _single_reference(torch, tk, cfg, toks, rank: int, device: str) -> dict | None:
    """The single-process step from the f32 pairs' seed on the global
    batches ``toks``, 3 steps, computed on rank 0 (None elsewhere): the
    losses, the first step's gradients and the final parameters, on the
    host."""
    from torchkafka_tpu_torch.utils.tree import tree_leaves

    if rank != 0:
        return None
    init_fn, step_fn = tk.make_train_step(cfg, None, tk.adamw(1e-3), device=device)
    params, opt = init_fn(torch.Generator(device=device).manual_seed(SEED + 9))
    names = _leaf_names(params)
    losses = []
    for s in range(toks.shape[0]):
        params, opt, loss = step_fn(params, opt, torch.from_numpy(toks[s]).to(device))
        losses.append(loss.item())
        if s == 0:
            grads = [p.grad.detach().cpu() for p in tree_leaves(params)]
    ref = {"losses": losses, "grads": grads, "names": names,
           "params": [p.detach().cpu() for p in tree_leaves(params)]}
    del params, opt
    if device == "cuda":
        torch.cuda.empty_cache()
    return ref


def _mesh_pair(torch, tk, cfg, axes, toks, ref, rank: int, device: str) -> dict:
    """One f32 pair: ``make_train_step(cfg, mesh)`` from the reference's
    seed on the same batches, 3 steps; on rank 0 the first step's loss and
    every gradient (relative L2 per tensor) and the parameters after 3
    steps against ``ref`` (each tensor compared on the card)."""
    from torchkafka_tpu_torch.parallel.mesh import full_tensor, make_mesh
    from torchkafka_tpu_torch.utils.tree import tree_leaves

    mesh = make_mesh(axes, device=None if device == "cuda" else device)
    init_fn, step_fn = tk.make_train_step(cfg, mesh, tk.adamw(1e-3), device=device)
    params, opt = init_fn(torch.Generator(device=device).manual_seed(SEED + 9))
    losses, grad_rel = [], None
    for s in range(toks.shape[0]):
        params, opt, loss = step_fn(params, opt, torch.from_numpy(toks[s]).to(device))
        losses.append(loss.item())
        if s == 0:
            grads = _full_grads(torch, params, cfg, mesh)
            if rank == 0:
                grad_rel = _rel_l2(torch, grads, [g.to(device) for g in ref["grads"]],
                                   ref["names"])
            del grads
    full = [full_tensor(p).detach() for p in tree_leaves(params)]
    row = {"losses": losses}
    if rank == 0:
        param_rel = _rel_l2(torch, full, [p.to(device) for p in ref["params"]], ref["names"])
        row.update({
            "first_loss_rel": abs(losses[0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
            "grad_rel_l2": grad_rel, "worst_grad": max(grad_rel, key=grad_rel.get),
            "param_rel_l2": param_rel, "worst_param": max(param_rel, key=param_rel.get)})
    del params, opt, full
    if device == "cuda":
        torch.cuda.empty_cache()
    return row


def _tp_sp_f32_pairs(torch, tk, cfg32, toks, rank: int, device: str) -> dict:
    """(b): f32 at 2 layers, each mesh of ``TP_SP_MESHES`` on the global
    batches ``toks``, 3 steps, against the single-process step from the
    same seed (computed first, on rank 0): the first step's loss and every
    gradient (relative L2 per tensor), the parameters after 3 steps. The
    references wait on the host; each tensor is compared on the card."""
    ref = _single_reference(torch, tk, cfg32, toks, rank, device)
    out = {name: _mesh_pair(torch, tk, dataclasses.replace(cfg32, attn_impl=impl), axes, toks,
                            ref, rank, device)
           for name, axes, impl in TP_SP_MESHES}
    if rank == 0:
        out["single_losses"] = ref["losses"]
    return out


def _pair_problems(pairs: dict, other: dict, names, first_step_only=()) -> list:
    """The f32 pairs' bounds: the first loss and every gradient within
    ``TP_SP_GRAD_REL``, the parameters within ``POD_UNSPLIT_PARAM_REL``
    (not for the pairs in ``first_step_only``), the same global losses on
    both ranks."""
    problems = []
    for name in names:
        got = pairs[name]
        params_ok = (name in first_step_only
                     or max(got["param_rel_l2"].values()) <= POD_UNSPLIT_PARAM_REL)
        if not (got["first_loss_rel"] <= TP_SP_GRAD_REL
                and max(got["grad_rel_l2"].values()) <= TP_SP_GRAD_REL and params_ok):
            problems.append(f"f32 {name} pair: " + json.dumps(
                {k: got[k] for k in ("first_loss_rel", "loss_rel", "worst_grad", "worst_param")}
                | {"grad_rel": got["grad_rel_l2"][got["worst_grad"]],
                   "param_rel": got["param_rel_l2"][got["worst_param"]]}))
        if got["losses"] != other[name]["losses"]:
            problems.append(f"f32 {name}: ranks returned different global losses")
    return problems


def _tp_sp_attention(torch, rank: int, device: str) -> dict:
    """(c): ring (K1 per step, K2/K3 per step) and Ulysses (one K1, K2,
    K3 per head shard) at bf16 on this rank's half of the sequence, against
    ``flash_attention`` on the whole sequence: output and q/k/v gradients,
    put together over the sp axis (the 1b heads: 16 q, 8 kv for Ulysses,
    kv repeated to 16 for the ring; Dh 128, B=2, S=512)."""
    from torchkafka_tpu_torch.ops.attention import ring_attention, ulysses_attention
    from torchkafka_tpu_torch.ops.flash import flash_attention
    from torchkafka_tpu_torch.parallel import collectives
    from torchkafka_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"sp": POD_RANKS}, device=None if device == "cuda" else device)
    group = mesh.get_group("sp")
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    b, s, h, d = 2, 512, 16, 128
    sl = s // POD_RANKS
    out = {"shape": [b, s, h, d], "tolerance": TP_SP_ATTN_TOL}
    for name, fn, kv in (("ring", ring_attention, h), ("ulysses", ulysses_attention, h // 2)):
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device=device).to(torch.bfloat16)
                   for n in (h, kv, kv))
        dout = torch.randn((b, s, h, d), generator=gen, device=device).to(torch.bfloat16)
        full = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = flash_attention(*full, True)
        ref.backward(dout)
        mine = [t[:, rank * sl:(rank + 1) * sl].clone().requires_grad_(True)
                for t in (q, k, v)]
        o = fn(*mine, mesh=mesh, causal=True)
        o.backward(dout[:, rank * sl:(rank + 1) * sl])
        got = [collectives.all_gather(t.detach(), 1, group)
               for t in (o, mine[0].grad, mine[1].grad, mine[2].grad)]
        want = [ref.detach(), full[0].grad, full[1].grad, full[2].grad]
        errs = {"out_abs": max_err(torch, got[0], want[0])}
        for g, t, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
            errs[f"{g}_rel"] = max_err(torch, t, w) / float(w.float().abs().max())
        out[name] = errs
    return out


def tp_sp_rank_main(rank: int, port: int, outdir: str, device: str = "cuda") -> int:
    """One rank of the pod_tp_sp phase (``chip_smoke.py --pod-rank N
    --pod-mode tp_sp``): see ``check_pod_tp_sp``. Writes
    ``<outdir>/rank_<rank>.json``."""
    import numpy as np
    import torch

    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.ops import _native
    from torchkafka_tpu_torch.ops.flash import flash_dkv_bhsd, flash_dq_bhsd, flash_fwd_bhsd
    from torchkafka_tpu_torch.parallel import collectives, multihost
    from torchkafka_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device == "cuda"
    t_init = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{port}", POD_RANKS, rank, timeout_s=600.0,
                         device=None if cuda else device)
    out = {"rank": rank, "rules": multihost.rules(), "init_s": time.perf_counter() - t_init,
           "libraries_present_at_start": all(_native._target(k).exists()
                                             for k in _native.KERNELS) if cuda else None}
    flash = (flash_fwd_bhsd, flash_dq_bhsd, flash_dkv_bhsd)
    # (a) bf16 compute, f32 masters, CUT_LAYERS, 8 rows of 512: every rank
    # builds the same global batches from the seed.
    cfg = _pod_config(torch, device, n_layers=CUT_LAYERS)
    toks = np.random.default_rng(SEED + 11).integers(
        0, cfg.vocab_size, (3, 8, 512), dtype=np.int32)
    for name, axes, impl in TP_SP_MESHES:
        mesh = make_mesh(axes, device=None if cuda else device)
        out[name] = _mesh_bf16_run(torch, tk, dataclasses.replace(cfg, attn_impl=impl),
                                    mesh, toks, flash, device)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    # (b) f32 at 2 layers against the single-process step.
    cfg32 = _pod_config(torch, device, n_layers=2, dtype=torch.float32)
    toks32 = np.random.default_rng(SEED + 12).integers(
        0, cfg32.vocab_size, (3, 8, 512), dtype=np.int32)
    t0 = time.perf_counter()
    out["f32_pairs"] = _tp_sp_f32_pairs(torch, tk, cfg32, toks32, rank, device)
    out["f32_pairs_s"] = time.perf_counter() - t0
    # (c) bf16 ring and Ulysses against flash_attention on the whole sequence.
    t0 = time.perf_counter()
    out["attention"] = _tp_sp_attention(torch, rank, device)
    out["attention_s"] = time.perf_counter() - t0
    out["collectives_total"] = collectives.COUNTS.as_dict()
    with open(os.path.join(outdir, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    multihost.shutdown()
    return 0


def check_pod_tp_sp(torch, device: str = "cuda") -> list:
    """Tensor and sequence parallelism across processes: ``POD_RANKS``
    ranks on ``cuda:0`` under gloo (``chip_smoke.py --pod-rank N
    --pod-mode tp_sp``), the 1b widths (16 q heads, 8 kv heads, Dh 128, d
    2,048, vocab 32,000):

    (a) f32 masters, bf16 compute, ``CUT_LAYERS`` layers, 8 rows of 512,
        AdamW, 3 steps each on ``{"tp": 2}`` (Megatron: each rank's heads
        and d_ff columns, K1-K3 through ``flash_attention_sharded``),
        ``{"sp": 2}`` ring (K1 once per ring step with the chunks' offsets,
        K2/K3 likewise) and ``{"sp": 2}`` Ulysses (one K1, K2, K3 per head
        shard after the all-to-all); per rank: step ms (CUDA events),
        collective ms (host clock), bytes and calls a step, peak memory;
        K1 = K2 = K3 = layers x steps on each rank (ring: layers x sp x
        steps, the fully masked steps included, as the JAX package
        launches them), all on the tensor cores; equal losses on both
        ranks;
    (b) f32 at 2 layers, each mesh against the single-process step from
        the same seed on the same batches: the first step's loss and
        every gradient within ``TP_SP_GRAD_REL`` (relative L2 per tensor),
        the parameters after 3 steps within ``POD_UNSPLIT_PARAM_REL``;
    (c) ring and Ulysses at bf16 against ``flash_attention`` on the whole
        sequence: the output and q/k/v gradients within the flash phases'
        bounds (``TP_SP_ATTN_TOL``).
    The kernels are built once, by this process, before the ranks start.
    ``device="cpu"`` rehearses the phase at tiny widths (no kernel counts
    or device numbers)."""
    import shutil

    from torchkafka_tpu_torch.ops import _native

    cuda = device == "cuda"
    smi = smi_line() if cuda else None
    t0 = time.perf_counter()
    if cuda:
        _native.build_all()
    build_s = time.perf_counter() - t0
    outdir = tempfile.mkdtemp(prefix="tk-tpsp-")
    try:
        dumps, ranks_s = _run_ranks("tp_sp", outdir, device)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    problems = []
    for dmp in dumps:
        r = dmp["rank"]
        if dmp["rules"]["device"] != ("cuda:0" if cuda else "cpu") or \
                dmp["rules"]["backend"] != "gloo":
            problems.append(f"rank {r} rules {dmp['rules']}")
        if cuda and not dmp["libraries_present_at_start"]:
            problems.append(f"rank {r} started before the kernels were built")
        for name, axes, impl in TP_SP_MESHES:
            row = dmp[name]
            per_layer = POD_RANKS if impl == "ring" else 1
            want = row["layers"] * per_layer * row["steps"] if cuda else 0
            if any(n != want for n in row["launches"].values()) or \
                    any(n != want for n in row["tc_launches"].values()):
                problems.append(f"rank {r} {name}: launches {row['launches']} "
                                f"tc {row['tc_launches']}, want {want}")
        att = dmp["attention"]
        for name in ("ring", "ulysses"):
            e = att[name]
            if not (e["out_abs"] <= TP_SP_ATTN_TOL["out_abs"] and all(
                    e[f"{g}_rel"] <= TP_SP_ATTN_TOL["grad_rel"] for g in ("dq", "dk", "dv"))):
                problems.append(f"rank {r} bf16 {name} attention: {e}")
    for name, *_ in TP_SP_MESHES:
        if dumps[0][name]["losses"] != dumps[1][name]["losses"]:
            problems.append(f"{name}: ranks returned different global losses")
    pairs = dumps[0]["f32_pairs"]
    problems += _pair_problems(pairs, dumps[1]["f32_pairs"], [m[0] for m in TP_SP_MESHES])
    if problems:
        raise AssertionError("pod_tp_sp: " + "; ".join(problems))

    def per_rank(name, key):
        return [dmp[name][key] for dmp in dumps]

    rows = []
    for name, axes, impl in TP_SP_MESHES:
        row = dumps[0][name]
        rows.append({
            "phase": "pod_tp_sp", "run": name, "mesh": axes, "attn_impl": impl,
            "ranks": POD_RANKS, "nvidia_smi": smi, "layers": row["layers"],
            "rows": row["rows"], "seq": row["seq"], "steps": row["steps"],
            "losses": row["losses"], "step_ms": per_rank(name, "step_ms"),
            "collective_ms": per_rank(name, "collective_ms"),
            "collective_bytes_per_step": per_rank(name, "collective_bytes"),
            "collective_calls_per_step": per_rank(name, "collective_calls"),
            "peak_mem_gb": per_rank(name, "peak_mem_gb"), "loop_s": per_rank(name, "loop_s"),
            "launches": per_rank(name, "launches"), "tc_launches": per_rank(name, "tc_launches")})
    rows.append({"phase": "pod_tp_sp", "run": "f32_pairs", "layers": 2,
                 "tolerance": {"first_loss_and_grad_rel": TP_SP_GRAD_REL,
                               "param_rel_l2": POD_UNSPLIT_PARAM_REL}, **pairs,
                 "seconds": [dmp["f32_pairs_s"] for dmp in dumps]})
    rows.append({"phase": "pod_tp_sp", "run": "attention_bf16",
                 "ranks": [dmp["attention"] for dmp in dumps],
                 "seconds": [dmp["attention_s"] for dmp in dumps]})
    rows.append({"phase": "pod_tp_sp", "run": "summary", "build_s": build_s, "ranks_s": ranks_s,
                 "init_s": [dmp["init_s"] for dmp in dumps],
                 "collectives_total": [dmp["collectives_total"] for dmp in dumps]})
    return rows


# -------------------------------------------- pipeline and expert parallel

PP_MICROBATCHES = 4
DLRM_BATCH = 1024
DLRM_LOSS_ABS = 1e-5


# The f32 pair whose parameters are held on the first step only: capacity
# dispatch at the phase's factor drops (token, choice) pairs, and after one
# AdamW step the unsplit run's parameters differ by ~1e-4 (the summation
# order, amplified near eps: queue C item 26), enough to flip a near-tied
# routing choice and with it the slots of the tokens after it in the group
# (4.7e-3 relative in w_down after 3 steps, PERF.md). Its first step (the
# same drop set on both sides) is held; the capacity path's 3-step bound is
# held at an ample factor, where no pair drops.
PP_EP_FIRST_STEP_ONLY = ("ep_capacity_drops",)


def _pp_ep_runs(torch, device: str, pairs: bool = False, **overrides) -> list:
    """(name, axes, cfg, rows) of pod_pp_ep: ``{"pp": 2}`` at
    ``CUT_LAYERS`` (two layers a stage) with ``PP_MICROBATCHES``
    microbatches of 2 rows, and ``{"ep": 2}`` with ``train_moe``'s 8
    experts (4 a rank) top-2 at 2 layers, dense and capacity dispatch
    (``train_moe``'s factor 1.25), on 4 rows. ``pairs``: the f32 pairs'
    list, whose capacity run takes an ample factor (no drop) and which
    adds ``PP_EP_FIRST_STEP_ONLY``'s run at the phase's factor.
    ``overrides``: e.g. the f32 pairs' depth and dtype."""
    pp = _pod_config(torch, device, n_layers=CUT_LAYERS, pp_microbatches=PP_MICROBATCHES)
    moe = _pod_config(torch, device, n_layers=2, **MOE)
    cap = dataclasses.replace(moe, moe_dispatch="capacity")
    runs = [("pp", {"pp": POD_RANKS}, pp, 8),
            ("ep_dense", {"ep": POD_RANKS}, moe, 4)]
    if pairs:
        runs += [("ep_capacity", {"ep": POD_RANKS},
                  dataclasses.replace(cap, capacity_factor=float(moe.n_experts)), 4),
                 ("ep_capacity_drops", {"ep": POD_RANKS}, cap, 4)]
    else:
        runs.append(("ep_capacity", {"ep": POD_RANKS}, cap, 4))
    return [(n, a, dataclasses.replace(c, **overrides), r) for n, a, c, r in runs]


def _dlrm_pair(torch, tk, rank: int, device: str) -> dict:
    """(d): ``DLRMConfig()`` (8 tables x 100k x 64) on ``{"tp": 2}``, the
    tables row-sharded, 3 steps of ``DLRM_BATCH`` rows (the same on both
    ranks) against the single-process step from the same seed (rank 0):
    the losses, step ms (CUDA events), collective calls and bytes."""
    import numpy as np

    from torchkafka_tpu_torch.models.recsys import DLRMConfig, make_dlrm_train_step
    from torchkafka_tpu_torch.parallel.mesh import make_mesh

    cuda = device == "cuda"
    cfg = DLRMConfig() if cuda else DLRMConfig(vocab_sizes=(1000,) * 8, dtype=torch.float32)
    rng = np.random.default_rng(SEED + 14)
    highs = np.asarray(cfg.vocab_sizes)
    batches = [(torch.from_numpy(rng.normal(size=(DLRM_BATCH, cfg.dense_dim)).astype(np.float32)),
                torch.from_numpy(rng.integers(0, highs, (DLRM_BATCH, cfg.n_tables),
                                              dtype=np.int32)),
                torch.from_numpy(rng.integers(0, 2, DLRM_BATCH).astype(np.float32)),
                torch.ones(DLRM_BATCH)) for _ in range(3)]
    batches = [[t.to(device) for t in b] for b in batches]
    ref = None
    if rank == 0:
        init_fn, step_fn = make_dlrm_train_step(cfg, None, tk.adam(1e-2), device=device)
        params, opt = init_fn(torch.Generator(device=device).manual_seed(SEED + 15))
        ref = [step_fn(params, opt, *b)[2].item() for b in batches]
        del params, opt
    mesh = make_mesh({"tp": POD_RANKS}, device=None if cuda else device)
    init_fn, step_fn = make_dlrm_train_step(cfg, mesh, tk.adam(1e-2), device=device)
    params, opt = init_fn(torch.Generator(device=device).manual_seed(SEED + 15))
    losses, step_ms, stats = [], [], []
    for b in batches:
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        params, opt, loss = step_fn(params, opt, *b)
        if cuda:
            ev[1].record()
        losses.append(loss.item())
        step_ms.append(ev[0].elapsed_time(ev[1]) if cuda else None)
        stats.append(dict(step_fn.stats))
    rows = [int(params["tables"][f"t{i}"].to_local().shape[0]) for i in range(cfg.n_tables)]
    del params, opt
    return {"tables": [list(cfg.vocab_sizes), cfg.embed_dim], "local_table_rows": rows,
            "batch": DLRM_BATCH, "losses": losses, "single_losses": ref, "step_ms": step_ms,
            "collective_calls": [x["calls"] for x in stats],
            "collective_bytes": [x["bytes"] for x in stats],
            "collective_ms": [x["seconds"] * 1e3 for x in stats]}


def pp_ep_rank_main(rank: int, port: int, outdir: str, device: str = "cuda") -> int:
    """One rank of the pod_pp_ep phase (``chip_smoke.py --pod-rank N
    --pod-mode pp_ep``): see ``check_pod_pp_ep``. Writes
    ``<outdir>/rank_<rank>.json``."""
    import numpy as np
    import torch

    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.ops import _native
    from torchkafka_tpu_torch.ops.flash import flash_dkv_bhsd, flash_dq_bhsd, flash_fwd_bhsd
    from torchkafka_tpu_torch.parallel import collectives, multihost
    from torchkafka_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device == "cuda"
    t_init = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{port}", POD_RANKS, rank, timeout_s=600.0,
                         device=None if cuda else device)
    out = {"rank": rank, "rules": multihost.rules(), "init_s": time.perf_counter() - t_init,
           "libraries_present_at_start": all(_native._target(k).exists()
                                             for k in _native.KERNELS) if cuda else None}
    flash = (flash_fwd_bhsd, flash_dq_bhsd, flash_dkv_bhsd)
    # (a), (b): bf16 compute, f32 masters; every rank builds the same
    # global batches from the seed.
    for name, axes, cfg, rows in _pp_ep_runs(torch, device):
        toks = np.random.default_rng(SEED + 16).integers(
            0, cfg.vocab_size, (3, rows, 512), dtype=np.int32)
        mesh = make_mesh(axes, device=None if cuda else device)
        out[name] = _mesh_bf16_run(torch, tk, cfg, mesh, toks, flash, device, "pod_pp_ep")
        out[name]["microbatches"] = cfg.pp_microbatches
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    # (c): f32 at 2 layers against the single-process step.
    t0 = time.perf_counter()
    pairs = {}
    for name, axes, cfg32, rows in _pp_ep_runs(torch, device, pairs=True, n_layers=2,
                                               dtype=torch.float32):
        toks32 = np.random.default_rng(SEED + 17).integers(
            0, cfg32.vocab_size, (3, rows, 512), dtype=np.int32)
        ref = _single_reference(torch, tk, cfg32, toks32, rank, device)
        pairs[name] = _mesh_pair(torch, tk, cfg32, axes, toks32, ref, rank, device)
        gc.collect()
    out["f32_pairs"], out["f32_pairs_s"] = pairs, time.perf_counter() - t0
    # (d): the DLRM's tables row-sharded over tp.
    t0 = time.perf_counter()
    out["dlrm"] = _dlrm_pair(torch, tk, rank, device)
    out["dlrm_s"] = time.perf_counter() - t0
    out["collectives_total"] = collectives.COUNTS.as_dict()
    with open(os.path.join(outdir, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    multihost.shutdown()
    return 0


def check_pod_pp_ep(torch, device: str = "cuda") -> list:
    """Pipeline and expert parallelism across processes: ``POD_RANKS``
    ranks on ``cuda:0`` under gloo (``chip_smoke.py --pod-rank N
    --pod-mode pp_ep``), the 1b widths (d 2,048, 16 q and 8 kv heads, Dh
    128, d_ff 5,632, vocab 32,000), f32 masters, bf16 compute, AdamW, 3
    steps each:

    (a) ``{"pp": 2}``: ``CUT_LAYERS`` layers (2 a stage), 8 rows of 512,
        ``PP_MICROBATCHES`` microbatches (the GPipe schedule; each stage
        runs its layers only on the ticks it holds a microbatch);
    (b) ``{"ep": 2}``: ``train_moe``'s 8 experts (4 a rank) of d_ff 5,632,
        top-2, 2 layers, 4 rows of 512, once with dense and once with
        capacity dispatch;
        per rank: step ms (CUDA events), collective ms (host clock), bytes
        and calls a step, peak memory; K1 = K2 = K3 = (layers / pp) x M x
        steps under pp and layers x steps under ep on each rank, all on the
        tensor cores; equal losses on both ranks;
    (c) f32 at 2 layers, each of the three against the single-process step
        from the same seed on the same batches (capacity at an ample
        factor, and again at 1.25): the first step's loss and every
        gradient within ``TP_SP_GRAD_REL`` (relative L2 per tensor), the
        parameters after 3 steps within ``POD_UNSPLIT_PARAM_REL`` (but
        ``PP_EP_FIRST_STEP_ONLY``'s, reported);
    (d) the DLRM (``DLRMConfig()``: 8 tables x 100k x 64) on ``{"tp": 2}``,
        the tables row-sharded, batch ``DLRM_BATCH``, 3 steps: every loss
        within ``DLRM_LOSS_ABS`` of the single-process step's.
    The kernels are built once, by this process, before the ranks start.
    The ranks start once for all four. ``device="cpu"`` rehearses the
    phase at tiny widths (no kernel counts or device numbers)."""
    import shutil

    from torchkafka_tpu_torch.ops import _native

    cuda = device == "cuda"
    smi = smi_line() if cuda else None
    t0 = time.perf_counter()
    if cuda:
        _native.build_all()
    build_s = time.perf_counter() - t0
    outdir = tempfile.mkdtemp(prefix="tk-ppep-")
    try:
        dumps, ranks_s = _run_ranks("pp_ep", outdir, device)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    runs = _pp_ep_runs(torch, device)
    problems = []
    for dmp in dumps:
        r = dmp["rank"]
        if dmp["rules"]["device"] != ("cuda:0" if cuda else "cpu") or \
                dmp["rules"]["backend"] != "gloo":
            problems.append(f"rank {r} rules {dmp['rules']}")
        if cuda and not dmp["libraries_present_at_start"]:
            problems.append(f"rank {r} started before the kernels were built")
        for name, axes, cfg, _ in runs:
            row = dmp[name]
            per_step = (cfg.n_layers // axes.get("pp", 1)) * (row["microbatches"] or 1) \
                if "pp" in axes else cfg.n_layers
            want = per_step * row["steps"] if cuda else 0
            if any(n != want for n in row["launches"].values()) or \
                    any(n != want for n in row["tc_launches"].values()):
                problems.append(f"rank {r} {name}: launches {row['launches']} "
                                f"tc {row['tc_launches']}, want {want}")
    for name, *_ in runs:
        if dumps[0][name]["losses"] != dumps[1][name]["losses"]:
            problems.append(f"{name}: ranks returned different global losses")
    problems += _pair_problems(dumps[0]["f32_pairs"], dumps[1]["f32_pairs"],
                               [n for n, *_ in _pp_ep_runs(torch, device, pairs=True)],
                               PP_EP_FIRST_STEP_ONLY)
    dlrm = dumps[0]["dlrm"]
    if not all(abs(a - b) <= DLRM_LOSS_ABS for a, b in zip(dlrm["losses"], dlrm["single_losses"])):
        problems.append(f"dlrm: losses {dlrm['losses']} against {dlrm['single_losses']}")
    if dlrm["losses"] != dumps[1]["dlrm"]["losses"]:
        problems.append("dlrm: ranks returned different global losses")
    if problems:
        raise AssertionError("pod_pp_ep: " + "; ".join(problems))

    def per_rank(name, key):
        return [dmp[name][key] for dmp in dumps]

    rows = []
    for name, axes, cfg, _ in runs:
        row = dumps[0][name]
        rows.append({
            "phase": "pod_pp_ep", "run": name, "mesh": axes, "ranks": POD_RANKS,
            "nvidia_smi": smi, "layers": row["layers"], "microbatches": row["microbatches"],
            "experts": cfg.n_experts, "moe_dispatch": cfg.moe_dispatch if cfg.is_moe else None,
            "rows": row["rows"], "seq": row["seq"], "steps": row["steps"],
            "losses": row["losses"], "step_ms": per_rank(name, "step_ms"),
            "collective_ms": per_rank(name, "collective_ms"),
            "collective_bytes_per_step": per_rank(name, "collective_bytes"),
            "collective_calls_per_step": per_rank(name, "collective_calls"),
            "peak_mem_gb": per_rank(name, "peak_mem_gb"), "loop_s": per_rank(name, "loop_s"),
            "launches": per_rank(name, "launches"), "tc_launches": per_rank(name, "tc_launches")})
    rows.append({"phase": "pod_pp_ep", "run": "f32_pairs", "layers": 2,
                 "tolerance": {"first_loss_and_grad_rel": TP_SP_GRAD_REL,
                               "param_rel_l2": POD_UNSPLIT_PARAM_REL,
                               "params_not_held": list(PP_EP_FIRST_STEP_ONLY)},
                 **dumps[0]["f32_pairs"], "seconds": [dmp["f32_pairs_s"] for dmp in dumps]})
    rows.append({"phase": "pod_pp_ep", "run": "dlrm_tp", "mesh": {"tp": POD_RANKS},
                 "nvidia_smi": smi, "tolerance_loss_abs": DLRM_LOSS_ABS,
                 **{k: dlrm[k] for k in ("tables", "local_table_rows", "batch", "losses",
                                         "single_losses")},
                 **{k: per_rank("dlrm", k) for k in ("step_ms", "collective_calls",
                                                     "collective_bytes", "collective_ms")},
                 "seconds": [dmp["dlrm_s"] for dmp in dumps]})
    rows.append({"phase": "pod_pp_ep", "run": "summary", "build_s": build_s, "ranks_s": ranks_s,
                 "init_s": [dmp["init_s"] for dmp in dumps],
                 "collectives_total": [dmp["collectives_total"] for dmp in dumps]})
    return rows


# --------------------------------------------------------- pod serving

# pod_serve's runs: (name, mesh axes, pool). (a) the serve phase's dense
# int8 pool read by K4, (b) serve_paged's paged int8 pool read by K5 with
# the radix cache, both with kv heads, q heads, d_ff and the vocabulary
# over tp; (c) the dense bf16 pool with the slots over data.
POD_SERVE_RUNS = (("tp_int8", "tp", "int8"), ("tp_paged_int8", "tp", "paged_int8"),
                  ("data_bf16", "data", "dense"))
# Layer-sharded serving, ``{"pp": 2}``, each rank holding its stage's layers
# and their pools only: (e) the 8b widths at ``CUT_LAYERS_8B`` (8 a stage)
# with int8 weights on the dense int8 pool read by K4, serve_8b's stream and
# its output topic; (f) the paged int8 pool read by K5 with the radix cache
# and chunked prefill, serve_paged's tenant stream at ``CUT_LAYERS`` (2 a
# stage). Each layer runs whole on one rank, on the single process's shapes
# and kernels, so (f) must equal rank 0's single-process run of the same
# stream bit for bit in bf16/int8.
POD_SERVE_PP_RUNS = (("pp_8b_int8", "pp", "int8_out"), ("pp_paged_int8", "pp", "paged_int8"))
POD_SERVE_PP_EXACT = ("pp_paged_int8",)
# (d)'s f32 pairs at 2 layers: the three runs, and the compute-dtype pools
# on the tp mesh. A compute-dtype pool's tokens must equal one process's
# exactly. An int8 pool's need not under tp: the split sums of wo and
# w_down and the narrower q/k/v products round apart in the last bit, and
# the next layer's int8 quantization can turn such a bit into a whole int8
# step where a value sits at a rounding edge (on the H100 at the 1b
# widths: 3 of 32 records (a) and 5 of 48 (b) differ from output 5 on;
# PERF.md). So those pairs are also run teacher-forced
# (``POD_SERVE_FORCED``): the sharded server is handed the single-process
# run's tokens at every pick, and its logits are held against that run's
# within ``POD_SERVE_FORCED_BOUND``. tp_paged (the compute-dtype pool on
# (b)'s stream; eager, where the dense pool's block is a CUDA graph the
# recording cannot see into) runs forced too, as the witness of the split
# sums' own rounding (no bound but its exact pair).
# A control reruns each int8 pair forced with rank 1 reading its kv heads
# in the wrong order (K4/K5 handed the pool rolled by one head): it must
# fail the bound, or the bound could not tell a wrong read.
POD_SERVE_PAIRS = POD_SERVE_RUNS + (("tp_dense", "tp", "dense"), ("tp_paged", "tp", "paged"),
                                    ("pp_paged_int8", "pp", "paged_int8"),
                                    ("pp_dense", "pp", "dense"))
# (g): the pp pairs at 2 layers (1 a stage), (f)'s pool and the dense
# compute-dtype pool at the 1b widths, and (e) at the 8b widths on its own
# f32 model (``POD_SERVE_8B_PAIR``); every token and commit exact.
POD_SERVE_8B_PAIR = ("pp_8b_int8", "pp", "int8_out")
POD_SERVE_INT8_PAIRS = ("tp_int8", "tp_paged_int8")
POD_SERVE_FORCED = POD_SERVE_INT8_PAIRS + ("tp_paged",)
# The largest |logit difference| of a forced int8 pair (f32 logits of the
# random 1b weights at 2 layers, |logit| up to 5.8). On the H100: 5.3e-3
# (a) and 6.0e-3 (b), the compute-dtype tp_paged 1.4e-5, the wrong-head
# controls 7.4 and 7.6 (PERF.md).
POD_SERVE_FORCED_BOUND = 1e-2


def _pod_serve_model(torch, device: str, f32: bool = False, scale: str = "1b"):
    """(cfg, params) of pod_serve: the 1b widths at ``CUT_LAYERS`` in bf16
    (2 layers in f32 for the pairs), random weights from the seed, the
    same on every rank; ``scale="8b"``: the 8b widths at ``CUT_LAYERS_8B``
    with int8 weights (``random_serving_params(quantized=True)``, as
    serve_8b). On the CPU (a rehearsal) tiny widths, 4 layers for the pp
    runs' bf16 model, int8 weights for the 8b."""
    from torchkafka_tpu_torch.models.zoo import random_serving_params

    if device == "cuda":
        from torchkafka_tpu_torch.models.zoo import zoo_config

        cut = CUT_LAYERS_8B if scale == "8b" else CUT_LAYERS
        cfg = dataclasses.replace(zoo_config(scale, max_seq_len=128 + MAX_NEW),
                                  n_layers=2 if f32 else cut)
        if f32:
            cfg = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)
        return cfg, random_serving_params(
            torch.Generator(device="cuda").manual_seed(SEED), cfg,
            quantized=scale == "8b", device="cuda")
    from torchkafka_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(vocab_size=256, d_model=64, n_layers=2 if f32 else 4, n_heads=8,
                            n_kv_heads=4, d_ff=128, max_seq_len=32, dtype=torch.float32)
    return cfg, random_serving_params(torch.Generator().manual_seed(SEED), cfg,
                                      quantized=scale == "8b", device="cpu")


def _pod_serve_stream(cfg, kind: str, device: str):
    """(prompts, keys, max_new, slots) of a run: the serve phase's 32 prompts
    of 128 (unkeyed, two partitions) on the dense pools, serve_8b's 48
    (keyed by index, two partitions) on ``int8_out``, serve_paged's 48
    tenant prompts (keyed, four partitions) on the paged one; tiny on the
    CPU."""
    import numpy as np

    if device != "cuda":
        rng = np.random.default_rng(SEED)
        prompts = rng.integers(0, cfg.vocab_size, (8, 16), dtype=np.int32)
        keys = None
        if kind.startswith("paged"):
            prompts[:, :8] = prompts[np.arange(8) % 3, :8]
            keys = [TENANTS[i % 3].encode() for i in range(8)]
        elif kind == "int8_out":
            keys = [f"prompt-{i}".encode() for i in range(8)]
        return prompts, keys, 8, 4
    if kind.startswith("paged"):
        prompts, keys = tenant_prompts(np, cfg.vocab_size)
        return prompts, keys, MAX_NEW, 16
    n = 48 if kind == "int8_out" else 32
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (n, 128),
                                                   dtype=np.int32)
    keys = [f"prompt-{i}".encode() for i in range(n)] if kind == "int8_out" else None
    return prompts, keys, MAX_NEW, 16


def _pp_collectives_want(cfg, paged: bool, m: dict, slots: int, plen: int, pp: int,
                         chunk: int, elt: int) -> dict:
    """The collective calls and bytes a ``{"pp": P}`` run makes, worked out
    from its counts: each layer sweep hands the residual on P - 1 times
    (``ppermute`` of [rows, S, D] in the compute dtype, ``elt`` bytes an
    element) and broadcasts the last stage's final-norm rows once ([rows,
    D]). A decode tick sweeps the slots' [B, 1, D]; a chunk tick's first
    sweep also carries the ``chunk`` chunk rows; a dense admission sweeps
    its prompts' [n, P, D] and broadcasts [n, D] (every wave of these
    streams admits all B slots)."""
    row = elt * cfg.d_model
    rows = slots * m["decode_ticks"]
    if paged:
        rows += chunk * m["chunked_prefill"]["chunk_ticks"]
        hop_rows = bcast_rows = rows
    else:
        hop_rows = rows + slots * plen * m["prefills"]
        bcast_rows = rows + slots * m["prefills"]
    return {"calls": pp * (m["decode_ticks"] + m["prefills"]),
            "bytes": row * ((pp - 1) * hop_rows + bcast_rows)}


def _pod_serve_one(torch, cfg, params, mesh, kind: str, device: str, pick=None) -> dict:
    """One serve run of ``kind`` on this rank: on ``mesh`` (every rank of
    it; the root alone owns the broker and the consumer) or, ``mesh`` None,
    the single-process server (the f32 pairs' reference, on rank 0). The
    kernel counts and ``parallel.collectives.COUNTS`` are zeroed just
    before ``run`` and read just after. Hard checks: on the root, every
    record once with ``max_new`` tokens and committed == end offsets (on
    ``int8_out`` one output record a completion, equal to it); on every
    rank K1 = layers x prefills (0 on the paged pool), all on the tensor
    cores in bf16, K4 = layers x decode ticks on the dense int8 pools
    (else 0), K5 = layers x (decode ticks - chunk ticks) on the paged one
    (else 0), layers being this rank's stage's under pp; under pp alone the
    collective calls and bytes ``_pp_collectives_want`` works out.
    ``params``: the tree, or a function that returns it (called once, so
    the caller need not hold the whole tree while the server keeps its
    share: ``resident_gb`` is what stays allocated after warmup, and
    ``build_peak_gb`` the peak since the caller last reset it). ``pick``:
    instruments the server's picks after warmup (``_recording_pick``,
    ``_forcing_pick``)."""
    from torchkafka_tpu_torch.kvcache import PagedKVConfig
    from torchkafka_tpu_torch.ops.flash import flash_fwd_bhsd
    from torchkafka_tpu_torch.ops.kvattn import (
        int8_decode_attention_dynlen,
        int8_paged_decode_attention,
    )
    from torchkafka_tpu_torch.parallel import collectives
    from torchkafka_tpu_torch.parallel.lockstep import is_root
    from torchkafka_tpu_torch.serve import StreamingGenerator
    from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer
    from torchkafka_tpu_torch.source.producer import MemoryProducer
    from torchkafka_tpu_torch.source.records import TopicPartition

    cuda = device == "cuda"
    prompts, keys, max_new, slots = _pod_serve_stream(cfg, kind, device)
    n, plen = prompts.shape
    paged = kind.startswith("paged")
    parts = 4 if paged else 2
    root = mesh is None or is_root(mesh)
    pp = 1 if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)).get("pp", 1)
    broker = consumer = None
    kw = dict(slots=slots, prompt_len=plen, max_new=max_new, commit_every=16,
              ticks_per_sync=max_new - 1, mesh=mesh, device=device)
    if root:
        broker = InMemoryBroker()
        broker.create_topic("ps", partitions=parts)
        for i in range(n):
            if kind == "int8_out":  # serve_8b's layout: keyed, round-robin
                broker.produce("ps", prompts[i].tobytes(), key=keys[i], partition=i % parts)
            elif keys is None:
                broker.produce("ps", prompts[i].tobytes(), partition=i % parts)
            else:
                broker.produce("ps", prompts[i].tobytes(), key=keys[i])
        consumer = MemoryConsumer(broker, "ps", group_id="pod-serve")
        if kind == "int8_out":
            broker.create_topic("completions", partitions=2)
            kw.update(output_producer=MemoryProducer(broker), output_topic="completions")
    if kind in ("int8", "int8_out"):
        kw.update(kv_dtype="int8", kv_kernel=True)
    elif paged:
        bs = PAGED_BS if cuda else 4
        nblk = -(-(plen + max_new) // bs)
        kw.update(ticks_per_sync=8,
                  kv_pages=PagedKVConfig(block_size=bs, num_blocks=slots * nblk + 24 + 1))
        if kind == "paged_int8":
            kw.update(kv_dtype="int8", kv_kernel=True)
    server = StreamingGenerator(consumer, params() if callable(params) else params, cfg,
                                **kw)
    server.warmup()
    w = server._params["layers"]["wq"]
    resident_layers = int(getattr(w, "q", w).shape[0])  # this rank's stage's layers
    build_peak = resident = None
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        build_peak = torch.cuda.max_memory_allocated() / 1e9
        resident = torch.cuda.memory_allocated() / 1e9
    if pick is not None:
        pick(server)
    kernels = (flash_fwd_bhsd, int8_decode_attention_dynlen, int8_paged_decode_attention)
    for fn in kernels:
        fn.launches = 0
    flash_fwd_bhsd.tc_launches = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    collectives.COUNTS.reset()
    t0 = time.perf_counter()
    yields, by_key = [], {}
    for r, out in server.run(max_records=n):
        yields.append([r.partition, r.offset, out.tolist()])
        by_key[r.key] = out
    if cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    coll = collectives.COUNTS.as_dict()
    launches = {"flash_fwd": flash_fwd_bhsd.launches, "flash_fwd_tc": flash_fwd_bhsd.tc_launches,
                "kvattn_dynlen": int8_decode_attention_dynlen.launches,
                "kvattn_paged": int8_paged_decode_attention.launches}
    m = server.metrics.summary()
    what = f"pod_serve {kind} ({'mesh' if mesh is not None else 'single process'})"
    committed = ends = None
    if root:
        consumer.close()
        tps = [TopicPartition("ps", p) for p in range(parts)]
        committed = [broker.committed("pod-serve", tp) or 0 for tp in tps]
        ends = [broker.end_offset(tp) for tp in tps]
        if committed != ends:
            raise AssertionError(f"{what}: committed {committed} != end offsets {ends}")
    if len(yields) != n or len({(p, o) for p, o, _ in yields}) != n or any(
            len(t) != max_new for _, _, t in yields):
        raise AssertionError(f"{what}: {len(yields)} completions")
    if kind == "int8_out" and root:
        reader = MemoryConsumer(broker, "completions", group_id="check")
        published = []
        while batch := reader.poll(max_records=1000, timeout_ms=0):
            published.extend(batch)
        reader.close()
        pub = {r.key: r.value for r in published}
        if (len(published) != n or sorted(pub) != sorted(by_key)
                or any(pub[k] != by_key[k].astype("int32").tobytes() for k in by_key)
                or any(tuple(r.headers) != (("mv", b"0"),) for r in published)):
            raise AssertionError(f"{what}: {len(published)} output records for {n} prompts, "
                                 "or one differs from its completion")
    nl = cfg.n_layers // pp  # this rank's stage's layers
    if resident_layers != nl:
        raise AssertionError(f"{what}: {resident_layers} layers resident, want {nl}")
    want = {"flash_fwd": 0 if paged else nl * m["prefills"],
            "kvattn_dynlen": nl * m["decode_ticks"] if kind in ("int8", "int8_out") else 0,
            "kvattn_paged": nl * (m["decode_ticks"] - m["chunked_prefill"]["chunk_ticks"])
            if kind == "paged_int8" else 0}
    if cuda and (any(launches[k] != v for k, v in want.items())
                 or (not paged and m["prefills"] == 0)
                 or (cfg.dtype == torch.bfloat16
                     and launches["flash_fwd_tc"] != launches["flash_fwd"])):
        raise AssertionError(f"{what}: launches {launches}, want {want}")
    coll_want = None
    if pp > 1:
        elt = torch.empty((), dtype=cfg.dtype).element_size()
        coll_want = _pp_collectives_want(cfg, paged, m, slots, plen, pp,
                                         getattr(server, "_prefill_chunk", 0), elt)
        if {k: coll[k] for k in coll_want} != coll_want:
            raise AssertionError(f"{what}: collectives {coll}, worked out {coll_want}")
    ticks = max(1, m["decode_ticks"])
    return {"yields": yields, "committed": committed, "end_offsets": ends,
            "layers": cfg.n_layers, "stage_layers": nl, "collectives_want": coll_want,
            "build_peak_gb": build_peak, "resident_gb": resident,
            "elapsed_s": elapsed, "prefills": m["prefills"], "decode_ticks": m["decode_ticks"],
            "chunk_ticks": m["chunked_prefill"]["chunk_ticks"], "tick_blocks": m["ticks"],
            "tick_block_ms_p50": m["step_time"]["p50_ms"],
            "tick_block_ms_p99": m["step_time"]["p99_ms"],
            "collectives": coll, "collective_calls_per_tick": coll["calls"] / ticks,
            "collective_bytes_per_tick": coll["bytes"] / ticks,
            "collective_ms_per_tick": coll["seconds"] * 1e3 / ticks,
            "launches": launches, "cache_hits": m["prefix_cache"]["hits"],
            "kv_backend": m["kv_backend"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}


def _pair_agreement(got: list, ref: list) -> dict:
    """A sharded run's completions against the single-process run's: equal
    (same records, order and tokens), the share of equal tokens, the
    records whose token 0 differs and the first differing output index of
    each record that differs."""
    import numpy as np

    ref_of = {(p, o): t for p, o, t in ref}
    first = {}
    same = total = 0
    for p, o, t in got:
        r = ref_of.get((p, o), [])
        a, b = np.asarray(t), np.asarray(r)
        n = min(len(a), len(b))
        eq = a[:n] == b[:n]
        same += int(eq.sum())
        total += max(len(a), len(b))
        if not eq.all() or len(a) != len(b):
            first[f"{p}:{o}"] = int(np.argmin(eq)) if not eq.all() else n
    return {"tokens_equal_single": got == ref,
            "token_agreement": same / max(1, total),
            "records_differing": len(first),
            "token0_differing": sum(1 for i in first.values() if i == 0),
            "first_difference_at": sorted(first.values())}


def _recording_pick(log: list):
    """Instruments a server: every ``_pick`` call's tokens (host) and
    logits (on the device) appended to ``log``, the tokens its own."""
    def instrument(server):
        orig = server._pick

        def pick(logits, keys, idx=None):
            tok = orig(logits, keys, idx)
            log.append((tok.cpu().numpy(), logits.detach().clone()))
            return tok
        server._pick = pick
    return instrument


def _forcing_pick(tokens: list, ref_logits, stats: dict):
    """Instruments a server to pick the reference run's tokens, call for
    call (a call whose rows differ from the reference's raises), and,
    where ``ref_logits`` is given, to fold each call's logits against the
    reference's into ``stats`` over the rows whose token is used (a decode
    tick's active slots, a chunk tick's finished suffixes, every admitted
    row; the others are padding whose pool reads hold no data): the
    largest |difference|, the largest |reference logit|, the rows and the
    rows whose own argmax is not the forced token."""
    import torch

    stats.update(calls=0, rows=0, argmax_differs=0, max_abs_logit_diff=0.0, logit_scale=0.0)
    used = [None]  # the rows of the pick in flight whose token is used

    def scoped(fn):
        def call(logits, mask, *rest):
            used[0] = mask
            try:
                return fn(logits, mask, *rest)
            finally:
                used[0] = None
        return call

    def instrument(server):
        server._bookkeep = scoped(server._bookkeep)
        server._merge_chunk_token0 = scoped(server._merge_chunk_token0)

        def pick(logits, keys, idx=None):
            i = stats["calls"]
            if i >= len(tokens) or len(tokens[i]) != logits.shape[0]:
                raise AssertionError(
                    f"forced run: pick {i} over {logits.shape[0]} rows, the reference's "
                    f"{len(tokens[i]) if i < len(tokens) else 'none'}")
            stats["calls"] += 1
            tok = torch.as_tensor(tokens[i], device=logits.device)
            if ref_logits is not None:
                rows = (used[0] if used[0] is not None
                        else torch.ones_like(tok, dtype=torch.bool))
                ref = ref_logits[i][rows]
                if ref.numel():
                    stats["max_abs_logit_diff"] = max(stats["max_abs_logit_diff"],
                                                      (logits[rows] - ref).abs().max().item())
                    stats["logit_scale"] = max(stats["logit_scale"], ref.abs().max().item())
                stats["rows"] += int(rows.sum())
                stats["argmax_differs"] += int(((logits.argmax(-1) != tok) & rows).sum())
            return tok
        server._pick = pick
    return instrument


def _wrong_head_reads(rank: int):
    """The control's patch: on ``rank``, K4's and K5's sharded wrappers in
    the server module are handed the pool with its kv heads rolled by one
    (so each q head group reads its neighbour's keys and values). →
    a function that undoes it."""
    from torchkafka_tpu_torch import serve

    names = ("int8_decode_attention_dynlen_sharded", "int8_paged_decode_attention_sharded")
    saved = {n: getattr(serve, n) for n in names}
    if rank != 1:
        return lambda: None

    def rolled(fn):
        def read(q, kq, ks, vq, vs, *rest):
            return fn(q, *(t.roll(1, dims=1).contiguous() for t in (kq, ks, vq, vs)), *rest)
        return read

    for n in names:
        setattr(serve, n, rolled(saved[n]))

    def undo():
        for n in names:
            setattr(serve, n, saved[n])
    return undo


def _forced_pair(torch, cfg, params, mesh, kind: str, device: str, rank: int,
                 log: list, committed_single, control: bool) -> dict:
    """(d)'s teacher-forced pair of ``kind`` on the tp ``mesh``: ``log``,
    rank 0's single-process run's picks (``_recording_pick``; empty on
    the other ranks), whose tokens go to every rank (a broadcast over the
    default group); the ranks serve the stream again on the mesh handed
    those tokens, rank 0 holding each pick's logits against the
    single-process run's. ``control``: once more with rank 1's reads on
    the wrong kv heads (``_wrong_head_reads``)."""
    import torch.distributed as dist

    buf = [[t for t, _ in log] if rank == 0 else None]
    dist.broadcast_object_list(buf, src=0)
    tokens = buf[0]
    ref_logits = [lg for _, lg in log] if rank == 0 else None
    out = {}
    for run in ("forced", "control") if control else ("forced",):
        stats: dict = {}
        undo = _wrong_head_reads(rank) if run == "control" else (lambda: None)
        try:
            got = _pod_serve_one(torch, cfg, params, mesh, kind, device,
                                 pick=_forcing_pick(tokens, ref_logits, stats))
        finally:
            undo()
        if stats["calls"] != len(tokens):
            raise AssertionError(f"{kind} {run}: {stats['calls']} picks, the reference "
                                 f"made {len(tokens)}")
        out[run] = {**stats, "committed_equal_single":
                    got["committed"] == committed_single if rank == 0 else None}
    return out


def serve_rank_main(rank: int, port: int, outdir: str, device: str = "cuda") -> int:
    """One rank of the pod_serve phase (``chip_smoke.py --pod-rank N
    --pod-mode serve``): see ``check_pod_serve``. Writes
    ``<outdir>/rank_<rank>.json``."""
    import torch

    from torchkafka_tpu_torch.ops import _native
    from torchkafka_tpu_torch.parallel import multihost
    from torchkafka_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device == "cuda"
    t_init = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{port}", POD_RANKS, rank, timeout_s=600.0,
                         device=None if cuda else device)
    out = {"rank": rank, "rules": multihost.rules(), "init_s": time.perf_counter() - t_init,
           "libraries_present_at_start": all(_native._target(k).exists()
                                             for k in _native.KERNELS) if cuda else None}
    meshes = {axis: make_mesh({axis: POD_RANKS}, device=None if cuda else device)
              for axis in ("tp", "data", "pp")}
    cfg, params = _pod_serve_model(torch, device)
    for name, axis, kind in POD_SERVE_RUNS + POD_SERVE_PP_RUNS[1:]:
        out[name] = _pod_serve_one(torch, cfg, params, meshes[axis], kind, device)
        if name in POD_SERVE_PP_EXACT and rank == 0:  # (f) against one process
            ref = _pod_serve_one(torch, cfg, params, None, kind, device)
            out[name]["single"] = _pair_agreement(out[name]["yields"], ref["yields"])
            out[name]["single"]["committed_equal_single"] = (
                out[name]["committed"] == ref["committed"])
        gc.collect()
    del params
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    # (e): each rank draws the whole 8b tree, keeps its stage's share and
    # lets the whole tree go (the server is handed a function that returns
    # it).
    cfg8, params8 = _pod_serve_model(torch, device, scale="8b")
    box = [params8]
    del params8
    name, axis, kind = POD_SERVE_PP_RUNS[0]
    out[name] = _pod_serve_one(torch, cfg8, box.pop, meshes[axis], kind, device)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # (d) and (g): f32 at 2 layers; rank 0 also serves each stream in one
    # process.
    t0 = time.perf_counter()
    cfg32, params32 = _pod_serve_model(torch, device, f32=True)
    pairs = {}
    for name, axis, kind in POD_SERVE_PAIRS + (POD_SERVE_8B_PAIR,):
        if name == POD_SERVE_8B_PAIR[0]:  # (e) at f32: its own model
            del params32
            gc.collect()
            cfg32, params32 = _pod_serve_model(torch, device, f32=True, scale="8b")
        got = _pod_serve_one(torch, cfg32, params32, meshes[axis], kind, device)
        pair = {"yields": got["yields"], "committed": got["committed"],
                "launches": got["launches"]}
        log: list = []  # the single-process run's picks, for the forced runs
        committed_single = None
        if rank == 0:
            ref = _pod_serve_one(torch, cfg32, params32, None, kind, device,
                                 pick=_recording_pick(log) if name in POD_SERVE_FORCED else None)
            pair.update(_pair_agreement(got["yields"], ref["yields"]))
            committed_single = ref["committed"]
            pair["committed_equal_single"] = got["committed"] == committed_single
        if name in POD_SERVE_FORCED:
            pair["forced"] = _forced_pair(torch, cfg32, params32, meshes[axis], kind, device,
                                          rank, log, committed_single,
                                          control=name in POD_SERVE_INT8_PAIRS)
        pairs[name] = pair
        del log
        gc.collect()
    out["f32_pairs"], out["f32_pairs_s"] = pairs, time.perf_counter() - t0
    with open(os.path.join(outdir, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    multihost.shutdown()
    return 0


def check_pod_serve(torch, device: str = "cuda") -> list:
    """Sharded serving across processes: ``POD_RANKS`` ranks on
    ``cuda:0`` under gloo (``chip_smoke.py --pod-rank N --pod-mode
    serve``), the 1b widths at ``CUT_LAYERS`` in bf16 (random weights from
    the seed, the same on both ranks), each rank's server built with
    ``mesh=`` (the root, rank 0, owns the broker and the consumer; the
    other rank passes ``consumer=None``):

    (a) ``{"tp": 2}``, the dense int8 pool read by K4, the serve phase's
        stream (32 prompts of 128, 16 slots, 64 new);
    (b) ``{"tp": 2}``, the paged int8 pool read by K5, radix cache and
        chunked prefill, serve_paged's tenant stream (48 prompts);
    (c) ``{"data": 2}``, the dense bf16 pool, 8 slots a rank (its tick
        block replayed from a CUDA graph: a data-only tick runs no
        collective);
    per rank: tick-block ms p50/p99, collective calls, bytes and ms a
    decode tick (``parallel.collectives.COUNTS``), peak memory, launches:
    K1 = layers x prefills on the dense pools (the rank's own prefills),
    on the tensor cores; K4 = layers x decode ticks (a); K5 = layers x
    (decode ticks - chunk ticks) (b); both ranks' completions equal, in
    the same order; committed == end offsets on the root;
    (d) f32 at 2 layers, (a)-(c) again and the compute-dtype pools (dense
        and paged) on ``{"tp": 2}``: each run's committed offsets equal the
        single-process f32 server's on the same stream, and its tokens too,
        exactly, but for the int8 pools on tp, which hold token 0, report
        their agreement and are held teacher-forced: handed the single
        process's tokens, every logit within ``POD_SERVE_FORCED_BOUND`` of
        that run's, and a wrong-head control outside it
        (``POD_SERVE_PAIRS``, ``POD_SERVE_FORCED``);
    (e) ``{"pp": 2}``, the 8b widths at ``CUT_LAYERS_8B`` with int8
        weights, the dense int8 pool read by K4, serve_8b's stream (48
        prompts of 128) and its output topic: each rank draws the whole tree
        from the seed and keeps its stage's 8 layers (``resident_gb``,
        ``build_peak_gb``), every completion published once by the root;
    (f) ``{"pp": 2}``, (b)'s paged int8 pool and stream at ``CUT_LAYERS``
        (2 a stage): tokens and commits equal, bit for bit, to rank 0's
        single-process run of the same stream;
    under pp K1/K4/K5 count (L/P) x their events on each rank, and the
    collective calls and bytes are those ``_pp_collectives_want`` works
    out (P - 1 hops and one broadcast a layer sweep);
    (g) f32 at 2 layers (1 a stage) on ``{"pp": 2}``: (f)'s pool, the dense
        compute-dtype pool and (e) at the 8b widths, every token and commit
        equal to one process's.
    The kernels are built once, by this process, before the ranks start.
    ``device="cpu"`` rehearses the phase at tiny widths (no kernel counts
    or device numbers)."""
    import shutil

    from torchkafka_tpu_torch.ops import _native

    cuda = device == "cuda"
    smi = smi_line() if cuda else None
    t0 = time.perf_counter()
    if cuda:
        _native.build_all()
    build_s = time.perf_counter() - t0
    outdir = tempfile.mkdtemp(prefix="tk-podserve-")
    try:
        dumps, ranks_s = _run_ranks("serve", outdir, device)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    problems = []
    for dmp in dumps:
        r = dmp["rank"]
        if dmp["rules"]["device"] != ("cuda:0" if cuda else "cpu") or \
                dmp["rules"]["backend"] != "gloo":
            problems.append(f"rank {r} rules {dmp['rules']}")
        if cuda and not dmp["libraries_present_at_start"]:
            problems.append(f"rank {r} started before the kernels were built")
    for name, _, _ in POD_SERVE_RUNS + POD_SERVE_PP_RUNS:
        if dumps[0][name]["yields"] != dumps[1][name]["yields"]:
            problems.append(f"{name}: the ranks' completions differ")
    for name in POD_SERVE_PP_EXACT:  # (f): bit for bit against one process
        single = dumps[0][name]["single"]
        if not (single["tokens_equal_single"] and single["committed_equal_single"]):
            problems.append(f"{name} against one process: {single}")
    pairs = {}
    for name, _, _ in POD_SERVE_PAIRS + (POD_SERVE_8B_PAIR,):
        pair = dumps[0]["f32_pairs"][name]
        pairs[name] = {k: pair[k] for k in (
            "tokens_equal_single", "token_agreement", "records_differing",
            "token0_differing", "first_difference_at", "committed_equal_single")}
        if name in POD_SERVE_FORCED:
            pairs[name]["forced"] = pair["forced"]
        if name in POD_SERVE_INT8_PAIRS:
            # Free-running, token 0 and the commits; the tokens from there
            # on are held teacher-forced, every logit within the bound,
            # and the wrong-head control must fail that bound.
            forced, control = pair["forced"]["forced"], pair["forced"]["control"]
            exact = (pair["token0_differing"] == 0
                     and forced["max_abs_logit_diff"] <= POD_SERVE_FORCED_BOUND
                     and forced["committed_equal_single"])
            if not control["max_abs_logit_diff"] > POD_SERVE_FORCED_BOUND:
                problems.append(f"{name}: the wrong-head control passed the bound "
                                f"{POD_SERVE_FORCED_BOUND}: {control}")
        else:
            exact = pair["tokens_equal_single"]
        if not (exact and pair["committed_equal_single"]):
            problems.append(f"{name} f32 against one process: {pairs[name]}")
        if pair["yields"] != dumps[1]["f32_pairs"][name]["yields"]:
            problems.append(f"{name} f32: the ranks' completions differ")
    if problems:
        raise AssertionError("pod_serve: " + "; ".join(problems))

    def per_rank(name, key):
        return [dmp[name][key] for dmp in dumps]

    rows = []
    for name, axis, kind in POD_SERVE_RUNS + POD_SERVE_PP_RUNS:
        row = dumps[0][name]
        extra = {}
        if axis == "pp":
            extra = {k: per_rank(name, k) for k in (
                "stage_layers", "collectives_want", "build_peak_gb", "resident_gb")}
            if "single" in row:
                extra["against_single_process"] = row["single"]
        rows.append({
            "phase": "pod_serve", "run": name, "mesh": {axis: POD_RANKS}, "pool": kind,
            "ranks": POD_RANKS, "nvidia_smi": smi, "layers": row["layers"], **extra,
            "completions": len(row["yields"]),
            "tokens": sum(len(t) for _, _, t in row["yields"]),
            "tokens_equal_across_ranks": True, "committed": row["committed"],
            "end_offsets": row["end_offsets"], "elapsed_s": per_rank(name, "elapsed_s"),
            "prefills": per_rank(name, "prefills"),
            "decode_ticks": per_rank(name, "decode_ticks"),
            "chunk_ticks": per_rank(name, "chunk_ticks"),
            "tick_blocks": per_rank(name, "tick_blocks"),
            "tick_block_ms_p50": per_rank(name, "tick_block_ms_p50"),
            "tick_block_ms_p99": per_rank(name, "tick_block_ms_p99"),
            "collective_calls_per_tick": per_rank(name, "collective_calls_per_tick"),
            "collective_bytes_per_tick": per_rank(name, "collective_bytes_per_tick"),
            "collective_ms_per_tick": per_rank(name, "collective_ms_per_tick"),
            "collectives": per_rank(name, "collectives"),
            "cache_hits": per_rank(name, "cache_hits"), "kv_backend": row["kv_backend"],
            "peak_mem_gb": per_rank(name, "peak_mem_gb"), "launches": per_rank(name, "launches")})
    rows.append({"phase": "pod_serve", "run": "f32_pairs", "layers": 2,
                 "nvidia_smi": smi, "against_single_process": pairs,
                 "launches": {n: [d["f32_pairs"][n]["launches"] for d in dumps]
                              for n, _, _ in POD_SERVE_PAIRS + (POD_SERVE_8B_PAIR,)},
                 "seconds": [dmp["f32_pairs_s"] for dmp in dumps]})
    rows.append({"phase": "pod_serve", "run": "summary", "nvidia_smi": smi,
                 "build_s": build_s, "ranks_s": ranks_s,
                 "init_s": [dmp["init_s"] for dmp in dumps]})
    return rows


# ------------------------------------------------- secondary models, examples

def check_harness_models(torch) -> list:
    """Harness scenarios 4 and 8 at ``"full"`` on the card. 4: 8,192 PNGs
    of 64x64 (Paeth-filtered) on four partitions → the native decode →
    resize to 224 → ResNet-50 in bf16 (random weights from seed 0), batch
    64, committed per batch; held: every record, 128 commits, none failed
    or dropped, the chained slope held and its conv MFU (against the H100's
    989 TFLOP/s dense bf16) in (0, 100]. 8: the DLRM (8 tables of 100k x
    64, bf16 compute, f32 masters) trained by ``optim.adam(1e-2)`` on 40
    steps of 4,096 records; held: every record, 40 commits, none failed
    or dropped, one device (``{"data": 1}``), the step slope held, and the
    JAX test's trend (tail-quartile loss below the head's)."""
    from torchkafka_tpu_torch.harness import run_scenario

    smi = smi_line()
    rows = []
    t0 = time.perf_counter()
    r4 = run_scenario(4, "full", device="cuda")
    s4 = time.perf_counter() - t0
    torch.cuda.empty_cache()
    if (r4["records"] != 8192 or r4["commit"]["count"] != 128 or r4["commit_failures"]
            or r4["dropped"] or not r4["native_decode"] or not r4["slope_ok"]
            or not 0 < r4["conv_mfu_pct"] <= 100):
        raise AssertionError(f"harness_models 4: {r4}")
    rows.append({"phase": "harness_models", "scenario": 4, "seconds": s4,
                 "nvidia_smi": smi, **r4})
    t0 = time.perf_counter()
    r8 = run_scenario(8, "full", device="cuda")
    s8 = time.perf_counter() - t0
    torch.cuda.empty_cache()
    if (r8["records"] != 40 * 4096 or r8["commit"]["count"] != 40 or r8["commit_failures"]
            or r8["dropped"] or r8["mesh"] != {"data": 1} or not r8["step_slope_ok"]
            or not r8["tail_loss_mean"] < r8["head_loss_mean"]):
        raise AssertionError(f"harness_models 8: {r8}")
    rows.append({"phase": "harness_models", "scenario": 8, "seconds": s8,
                 "nvidia_smi": smi, **r8})
    return rows


EXAMPLES = ("train_stream_torch.py", "serve_prompts_torch.py", "ctr_train_torch.py")


def check_examples(torch) -> list:
    """``examples/*_torch.py`` as subprocesses on the card at their
    defaults, started together: each exits 0 and prints its offsets;
    the serving and CTR examples commit every record on their topics
    (committed == end offsets), the streaming trainer exactly its 50 steps
    of 32 (its topic holds twice that)."""
    import re
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    ckpt = tempfile.mkdtemp(prefix="tk-example-ckpt-")
    jobs = {}
    t0 = time.perf_counter()
    try:
        for name in EXAMPLES:
            extra = ["--ckpt", ckpt] if name.startswith("train") else []
            jobs[name] = subprocess.Popen(
                [sys.executable, os.path.join(here, "examples", name), *extra],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=here)
        rows = []
        for name, proc in jobs.items():
            out, err = proc.communicate(timeout=600)
            seconds = time.perf_counter() - t0
            m = re.search(r"^offsets: committed=(\d+) end=(\d+)", out, re.M)
            if proc.returncode != 0 or m is None:
                raise AssertionError(f"example {name}: rc {proc.returncode}\n{err[-3000:]}")
            committed, end = int(m.group(1)), int(m.group(2))
            want = 50 * 32 if name.startswith("train") else end
            if committed != want or end == 0:
                raise AssertionError(f"example {name}: committed {committed} of {end}")
            rows.append({"phase": "examples", "example": name, "seconds_since_start": seconds,
                         "committed": committed, "end_offsets": end,
                         "last_lines": out.strip().splitlines()[-2:]})
        return rows
    finally:
        for proc in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(ckpt, ignore_errors=True)


def roofline_probe_exact(torch) -> dict:
    """A server probed by ``decode_roofline`` (the CUDA graph) serves the
    same tokens and commits as one never probed: 1b widths, 2 layers,
    f32, the int8 pool on K4, 16 prompts of 128 on 16 slots."""
    import numpy as np

    from torchkafka_tpu_torch.models.zoo import random_serving_params, zoo_config
    from torchkafka_tpu_torch.serve import StreamingGenerator
    from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer
    from torchkafka_tpu_torch.source.records import TopicPartition

    cfg = dataclasses.replace(zoo_config("1b", max_seq_len=128 + MAX_NEW), n_layers=2,
                              dtype=torch.float32, param_dtype=torch.float32)
    params = random_serving_params(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                                   device="cuda")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (16, 128),
                                                    dtype=np.int32)
    runs = {}
    for probed in (True, False):
        broker = InMemoryBroker()
        broker.create_topic("p", partitions=2)
        for i, row in enumerate(prompts):
            broker.produce("p", row.tobytes(), partition=i % 2)
        consumer = MemoryConsumer(broker, "p", group_id="g")
        server = StreamingGenerator(consumer, params, cfg, slots=16, prompt_len=128,
                                    max_new=MAX_NEW, kv_dtype="int8", kv_kernel=True,
                                    commit_every=16, ticks_per_sync=MAX_NEW - 1,
                                    device="cuda")
        server.warmup()
        pos = server._pos.clone()
        roof = server.decode_roofline(iters=1, windows=1) if probed else None
        if not torch.equal(server._pos, pos):
            raise AssertionError("roofline probe: _pos not restored")
        outs = {(r.partition, r.offset): t for r, t in server.run(max_records=16)}
        consumer.close()
        runs[probed] = (outs, [broker.committed("g", TopicPartition("p", q)) for q in (0, 1)],
                        roof)
    (a, ca, roof), (b, cb, _) = runs[True], runs[False]
    if set(a) != set(b) or any(not np_equal(a[k], b[k]) for k in b) or ca != cb:
        raise AssertionError("roofline probe: the probed server serves other tokens")
    return {"phase": "harness", "check": "roofline_probe_token_exact", "layers": 2,
            "dtype": "float32", "records": len(a), "committed": ca,
            "graph_block_launches": roof["graph_block_launches"],
            "device_tick_ms": roof["device_tick_ms"], "slope_ok": roof["slope_ok"]}


PORT_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
                "flash_fwd_tc_kernel", "flash_dq_tc_kernel", "flash_dkv_tc_kernel",
                "kvattn_split_kernel_dense", "kvattn_split_kernel_paged",
                "kvattn_i8_convert_kernel", "kvattn_split_kernel_full",
                "qmm_decode_kernel", "qmm_tile_kernel", "qmm_tc_kernel",
                "qmm_i8_convert_kernel")


def profile_summary(prof, run: str, extra: dict) -> dict:
    """Device time by kernel name from a finished profiler: the total, the
    twelve busiest and every kernel of ``csrc/`` that ran. Device-side
    events only (kernels, copies, memsets): CPU ops also carry their
    children's device time and would count it twice."""
    from torch.autograd import DeviceType

    def dev_us(e):
        t = getattr(e, "self_device_time_total", None)
        return t if t is not None else getattr(e, "self_cuda_time_total", 0)

    # User annotations (e.g. the optimizer's step range) also appear on the
    # device timeline; they span kernels already counted.
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and dev_us(e) > 0
           and not getattr(e, "is_user_annotation", False)
           and not e.key.startswith("Optimizer.")]
    top = sorted(evs, key=dev_us, reverse=True)[:12]
    ours = [e for e in evs if any(f"::{k}<" in e.key for k in PORT_KERNELS)]

    def row(e):
        return {"name": e.key[:80], "calls": e.count, "device_ms": dev_us(e) / 1e3}

    return {"phase": "profile", "run": run,
            "device_ms_total": sum(dev_us(e) for e in evs) / 1e3, **extra,
            "top": [row(e) for e in top], "port_kernels": [row(e) for e in ours]}


def profile_serve(torch, cfg, params, prompts, row_q) -> dict:
    """The int8 serve run again under torch.profiler: device time per
    decode tick by kernel, against the unprofiled run's tick wall time
    (the profiler slows the host, so only its device times are used)."""
    prof = _profiler(torch)
    _, row = serve(torch, cfg, params, prompts, "int8", prof=prof)
    return profile_summary(prof, "int8 serve under torch.profiler", {
        "decode_ticks": row["decode_ticks"], "prefills": row["prefills"],
        "unprofiled_tick_wall_ms": row_q["tick_block_ms_p50"] / (MAX_NEW - 1)})


def profile_resume(torch, cfg, params, row_r) -> dict:
    """Five warm-resume prefills (``prefill_capture`` of one sequence of
    136 positions, all layers) under torch.profiler: device time by
    kernel, beside the unprofiled device time of one."""
    from torchkafka_tpu_torch.models.generate import prefill_capture, prefill_model

    model = prefill_model(cfg)
    toks = torch.zeros((1, 136), dtype=torch.int32, device="cuda")
    prof = _profiler(torch)
    with torch.inference_mode():
        prefill_capture(params, cfg, toks, model)
        torch.cuda.synchronize()
        with prof:
            for _ in range(5):
                prefill_capture(params, cfg, toks, model)
            torch.cuda.synchronize()
    return profile_summary(prof, "5 resume prefills (B=1, S=136) under torch.profiler", {
        "unprofiled_device_ms_one": row_r["resume_prefill_device_ms"]["136"]})


def profile_paged(torch, cfg, params, row_p) -> dict:
    """The paged int8 serve run (K5 engaged) again under torch.profiler:
    device time by kernel against the profiled run's wall time (the
    profiler slows the host, so the idle share it implies is an upper
    bound) and the unprofiled run's tick-block time."""
    import numpy as np

    prompts, keys = tenant_prompts(np, cfg.vocab_size)
    prof = _profiler(torch)
    _, row, _ = serve_paged(torch, cfg, params, prompts, keys, kv_kernel=True, prof=prof)
    return profile_summary(prof, "paged int8 serve (K5) under torch.profiler", {
        "decode_ticks": row["decode_ticks"], "chunk_ticks": row["chunk_ticks"],
        "profiled_wall_ms": row["elapsed_s"] * 1e3,
        "unprofiled_tick_block_ms_p50": row_p["tick_block_ms_p50"]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phases (a quick build check)")
    ap.add_argument("--profile", nargs="?", const="all",
                    choices=("all", "train", "serve", "paged", "serve8b", "resume"),
                    help="also trace one train step, the dense int8 serve run, "
                         "the paged int8 serve run, one wave of the 8b int8 "
                         "serve run and/or five warm-resume prefills under "
                         "torch.profiler and print where the device time goes "
                         "(a serve trace takes minutes)")
    ap.add_argument("--tier-rounds", type=int, default=1,
                    help="rounds of (HBM only, tier) in the serve_tiered phase "
                         "(more rounds: tok/s compared over more interleaved "
                         "runs)")
    ap.add_argument("--lane", choices=tuple(dict.fromkeys(
                        (*LANES, *sum(LANES.values(), ()), "serve_moe", "pod_tp_sp"))),
                    help="run only this lane's phases, or only this one lane "
                         "phase (the script starts each lane itself, beside "
                         "its main sequence)")
    ap.add_argument("--clock-start", type=float, default=None,
                    help="the starting script's clock, so a lane's at_s is the script's")
    ap.add_argument("--pod-rank", type=int, default=None,
                    help="(internal) run one rank of a pod phase (--pod-mode)")
    ap.add_argument("--pod-port", type=int, default=None, help="(internal) its store's port")
    ap.add_argument("--pod-out", default=None, help="(internal) its dump directory")
    ap.add_argument("--pod-device", default="cuda", help="(internal) its device")
    ap.add_argument("--pod-mode", default="train",
                    choices=("train", "tp_sp", "pp_ep", "serve"),
                    help="(internal) which phase the rank runs: pod_train, pod_tp_sp, "
                         "pod_pp_ep or pod_serve")
    args = ap.parse_args()
    if args.pod_rank is not None:
        rank_main = {"train": pod_rank_main, "tp_sp": tp_sp_rank_main,
                     "pp_ep": pp_ep_rank_main, "serve": serve_rank_main}[args.pod_mode]
        return rank_main(args.pod_rank, args.pod_port, args.pod_out, args.pod_device)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from torchkafka_tpu_torch.models.zoo import random_serving_params, zoo_config
    from torchkafka_tpu_torch.ops import _native, flash, kvattn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # SIGTERM unwinds (finally blocks close fleets, lanes are stopped).
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    if args.lane:
        if args.clock_start is not None:
            _CLOCK["start"] = args.clock_start
        run_lane(torch, args.lane)
        return 0
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": {"matmul": False, "cudnn": False}})

    t0 = time.perf_counter()
    _native.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [f"torchkafka_tpu_torch/csrc/{k}.cu" for k in _native.KERNELS],
          "flags": list(_native.NVCC_FLAGS)})

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    k1 = check_flash(torch, F, flash, flush, gen)
    emit(k1)
    k23 = check_flash_bwd(torch, F, flash, flush, gen)
    emit(k23)
    k4 = check_kvattn(torch, kvattn, flush, gen)
    emit(k4)
    k5 = check_kvattn_paged(torch, kvattn, flush, gen)
    emit(k5)
    k6 = check_qmatmul(torch, kvattn, flush, gen)
    emit(k6)
    k78 = check_kvattn_full(torch, kvattn, flush, gen)
    emit(k78)
    if args.kernels_only:
        return 0
    # The lanes start once the kernels were timed alone on the card; the
    # heaviest phases of all three sequences share CARD_BUDGET_GB.
    os.environ["TK_SMOKE_MEM_DIR"] = tempfile.mkdtemp(prefix="tk-smoke-mem-")
    lanes = [start_lane(lane) for lane in LANES]
    try:
        emit(check_prng(torch, flush))
        del flush

        emit(check_train_grads(torch))
        torch.cuda.empty_cache()
        prof_t = _profiler(torch) if args.profile in ("all", "train") else None
        with card_memory("train"):
            row_t = train(torch, prof=prof_t)
            torch.cuda.empty_cache()
        emit(row_t)
        if prof_t is not None:
            emit(profile_summary(prof_t, "one 1b train step (B=8, S=512) under torch.profiler",
                                 {"unprofiled_step_ms": row_t["step_ms_median_after_first"]}))
        torch.cuda.empty_cache()

        cfg = zoo_config("1b")
        params = random_serving_params(
            torch.Generator(device="cuda").manual_seed(SEED), cfg, device="cuda"
        )
        prompts = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (32, 128), dtype=np.int32
        )
        outs_q, row_q = serve(torch, cfg, params, prompts, "int8")
        emit(row_q)
        outs_b, row_b = serve(torch, cfg, params, prompts, None)
        if row_b["committed"] != row_q["committed"]:
            raise AssertionError("bf16 run committed other offsets")
        tok0_same = all(int(outs_b[key][0]) == int(outs_q[key][0]) for key in outs_q)
        agree = float(np.mean([np.mean(outs_b[key] == outs_q[key]) for key in outs_q]))
        row_b["token0_identical_to_int8_run"] = tok0_same
        row_b["token_agreement_with_int8_run"] = agree
        emit(row_b)
        if not tok0_same:
            raise AssertionError("token 0 differs between the int8 and bf16 runs")

        if args.profile in ("all", "serve"):
            emit(profile_serve(torch, cfg, params, prompts, row_q))
        # Depth cuts: the traced, sampled, resumed, tiered, speculative and
        # fleet paths run the 1b widths at CUT_LAYERS of its 24 layers (views
        # of the first layers' weights), the time the process-fleet phases
        # need.
        cfg_cut, params_cut = cut_depth(cfg, params)
        rows_tr, sum_tr = check_serve_traced(torch, cfg_cut, params_cut, prompts)
        for row in rows_tr + [sum_tr]:
            emit({**row, "layers": CUT_LAYERS})
        for row in check_serve_sampled(torch, cfg_cut, params_cut, prompts, row_q):
            emit({**row, "layers": CUT_LAYERS})
        row_r = serve_resume(torch, cfg_cut, params_cut, prompts)
        row_r["resume_prefill_device_ms"] = resume_prefill_times(torch, cfg, params)
        emit({**row_r, "layers": CUT_LAYERS})
        if args.profile in ("all", "resume"):
            emit(profile_resume(torch, cfg, params, row_r))

        row_p, row_pg, outs_p = check_serve_paged(torch, cfg, params, "serve_paged",
                                                  exact=False)
        emit(row_p)
        emit(row_pg)
        if args.profile in ("all", "paged"):
            emit(profile_paged(torch, cfg, params, row_p))
        rows_ti, sum_ti = check_serve_tiered(torch, cfg_cut, params_cut, args.tier_rounds)
        for row in rows_ti + [sum_ti]:
            emit({**row, "layers": CUT_LAYERS})
        rows_sp = check_serve_spec(torch, cfg_cut, params_cut, prompts)
        for row in rows_sp + check_serve_spec_paged(torch, cfg_cut, params_cut):
            emit({**row, "layers": CUT_LAYERS})
        rows_fl = check_serve_fleet(torch, cfg_cut, params_cut)
        for row in rows_fl:
            emit({**row, "layers": CUT_LAYERS})
        rows_ro = check_serve_fleet_rollout(torch, cfg_cut, params_cut)
        for row in rows_ro:
            emit({**row, "layers": CUT_LAYERS})
        del params_cut
        rows_dg = check_serve_disagg(torch, cfg, params, (outs_p, row_p))
        for row in rows_dg:
            emit(row)
        del params
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32,
                                    param_dtype=torch.float32)
        params32 = random_serving_params(
            torch.Generator(device="cuda").manual_seed(SEED), cfg32, device="cuda"
        )
        row_f, row_fg, _ = check_serve_paged(torch, cfg32, params32, "serve_paged_f32",
                                             exact=True)
        emit(row_f)
        emit(row_fg)
        for row in check_serve_sampled_f32(torch, cfg32, params32):
            emit(row)
        for row in check_serve_resume_f32(torch, cfg32, params32):
            emit(row)
        for row in check_serve_tiered_f32(torch, cfg32, params32):
            emit(row)
        for row in check_serve_spec_f32(torch, cfg32, params32):
            emit(row)
        for row in check_serve_fleet_f32(torch, cfg32, params32):
            emit(row)
        del params32
        torch.cuda.empty_cache()

        cfg8 = dataclasses.replace(zoo_config("8b", max_seq_len=128 + MAX_NEW),
                                   n_layers=CUT_LAYERS_8B)
        with card_memory("serve_8b"):
            rows_8b, params8, prompts8 = check_serve_8b(torch, cfg8, "serve_8b", exact=False)
            for row in rows_8b:
                emit(row)
            if args.profile in ("all", "serve8b"):
                emit(profile_serve_8b(torch, cfg8, params8, prompts8, rows_8b[0]))
            del params8
            torch.cuda.empty_cache()
            cfg8_32 = dataclasses.replace(cfg8, n_layers=2, dtype=torch.float32,
                                          param_dtype=torch.float32)
            rows_8b32, params8_32, _ = check_serve_8b(torch, cfg8_32, "serve_8b_f32",
                                                      exact=True)
            for row in rows_8b32:
                emit(row)
            del params8_32
            torch.cuda.empty_cache()
        # MoE serving and pod_tp_sp end the main sequence (the procfleet
        # lane ends with pod_train and pod_pp_ep, the harness lane with
        # pod_serve, so the three sequences end together).
        with card_memory("serve_moe"):
            rows_sm_all = check_serve_moe(torch)
            for row in rows_sm_all:
                emit(row)
            torch.cuda.empty_cache()
        with card_memory("pod_tp_sp"):
            rows_tpsp = check_pod_tp_sp(torch)
            for row in rows_tpsp:
                emit(row)
        lane_rows = [finish_lane(job) for job in lanes]
    finally:
        stop_lanes(lanes)
        import shutil

        shutil.rmtree(os.environ.pop("TK_SMOKE_MEM_DIR"), ignore_errors=True)
    by_phase = {}
    for row in (r for rows in lane_rows for r in rows):
        by_phase.setdefault(row.get("phase"), []).append(row)
    rows_pf, rows_pf32 = by_phase["serve_procfleet"], by_phase["serve_procfleet_f32"]
    rows_h, rows_hf = by_phase["harness"], by_phase["harness_fleet"]
    rows_hp = by_phase["harness_procfleet"]
    rows_sm = [r for r in rows_sm_all if "launches" in r]
    rows_pod = by_phase["pod_train"]
    rows_ppep = by_phase["pod_pp_ep"]
    rows_ps = by_phase["pod_serve"]
    row_tm = by_phase["train_moe"][0]
    for phase in ("harness_models", "examples"):
        if not by_phase.get(phase):
            raise AssertionError(f"lane phase {phase} printed no row")

    main_pool = k4["pools"]["192"]
    pool_8b = k4["reps"]["4"]
    k6_main = k6["cases"]["w_gate_m16_bfloat16"]
    k78_main = k78["pools"]["192"]
    main_view = k5["views"]["192"]

    def path_8b(kernel):
        return sum(row["launches"][kernel] for row in rows_8b)

    def fleet_launches(kernel):
        """Each 1b fleet run's launches: serve_fleet's two killed runs, then
        the clean, divergent and broker rollouts (canary shadows included)."""
        return [r["launches"][kernel] for r in rows_fl + rows_ro
                if r.get("run") in ("fleet", "clean", "divergent", "broker")]

    distill_rows = [r for r in rows_pf32 if r.get("run") == "distill_role"]

    def harness_launches(kernel):
        """The harness phase's launches by scenario (7 includes the
        roofline probe's warm block and capture)."""
        return {str(r["scenario"]): r["launches"][kernel] for r in rows_h
                if "scenario" in r}

    roof = rows_h[0]

    def harness_fleet_launches(kernel):
        """The fleet scenarios' launches by scenario (25's include its
        trainer's)."""
        return {str(r["scenario"]): r["launches"][kernel] for r in rows_hf}

    def harness_procfleet_launches():
        """The process scenarios' K1 by scenario: this process's (the
        in-process references) and each worker's, from its dump."""
        return {str(r["scenario"]): {"parent": r["launches"]["flash_fwd"],
                                     "children": [c["flash_fwd"] for c in r["children"]]}
                for r in rows_hp}

    def pod_launches(kernel):
        """K1-K3 on each rank of pod_train: the data and fsdp runs (with
        their tensor-core counts) and scenario 3 under torchrun."""
        out = {}
        for r in rows_pod:
            if r.get("run") in ("data", "fsdp"):
                out[r["run"]] = {"layers": r["layers"], "steps": r["steps"],
                                 "launches": [x[kernel] for x in r["launches"]],
                                 "tc_launches": [x[kernel] for x in r["tc_launches"]]}
            elif r.get("run") == "scenario_3":
                out["scenario_3"] = [x["launches"][kernel] for x in r["ranks"]]
        return out

    def tp_sp_launches(kernel):
        """K1-K3 on each rank of pod_tp_sp's bf16 runs, by mesh (with their
        tensor-core counts)."""
        return {r["run"]: {"layers": r["layers"], "steps": r["steps"],
                           "launches": [x[kernel] for x in r["launches"]],
                           "tc_launches": [x[kernel] for x in r["tc_launches"]]}
                for r in rows_tpsp if "launches" in r}

    def pp_ep_launches(kernel):
        """K1-K3 on each rank of pod_pp_ep's bf16 runs, by mesh (with their
        tensor-core counts and the pipeline's microbatches)."""
        return {r["run"]: {"layers": r["layers"], "steps": r["steps"],
                           "microbatches": r["microbatches"],
                           "launches": [x[kernel] for x in r["launches"]],
                           "tc_launches": [x[kernel] for x in r["tc_launches"]]}
                for r in rows_ppep if "launches" in r}

    def pod_serve_launches(kernel):
        """K1, K4 or K5 on each rank of pod_serve's bf16 runs, by run."""
        return {r["run"]: [x[kernel] for x in r["launches"]] for r in rows_ps if "pool" in r}

    def child_launches(kernel):
        """K1-K3 as the worker processes counted them (their metrics
        dumps): serve_procfleet's replica children, then the distill
        child of serve_procfleet_f32."""
        out = {"replica_children": [c["flash_fwd"] for r in rows_pf
                                    for c in r.get("child_launches", ())]}
        if kernel != "flash_fwd":
            out = {}
        out["distill_children"] = [d["launches"][kernel] for r in distill_rows
                                   for d in r["distill"]]
        return out

    def full_split(which):
        """K7's or K8's split and span times at the 192 pool, and at 2048."""
        big = k78["pools"]["2048"]
        return {"n_split": k78_main["n_split"], "span": k78_main["L"],
                "one_span_ms": k78_main[which]["one_span_ms"],
                "span_ms": _spans(k78_main[which]),
                "pool_2048": {"n_split": big["n_split"], "span": big["L"],
                              "kernel_ms": big[which]["kernel_ms"],
                              "one_span_ms": big[which]["one_span_ms"],
                              "span_ms": _spans(big[which]),
                              "plain_ms": big[which]["plain_ms"], "bound_ms": big["bound_ms"]}}

    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "torchkafka_tpu/ops/flash.py:61",
         "launches": row_q["launches"]["flash_fwd"],
         "tc_launches": row_q["launches"]["flash_fwd_tc"],
         "kernel_route": k1["prefill"]["route"],
         "max_abs_err": k1["err_main"], "ms": k1["kernel_ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
         "train_shape": {key: k1["train_shape"][key] for key in (
             "kernel_ms", "simt_bf16_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
         "traced_launches": [r["launches"]["flash_fwd"] for r in rows_tr if r["traced"]],
         "train_launches": row_t["launches"]["flash_fwd"],
         "train_tc_launches": row_t["tc_launches"]["flash_fwd"],
         "resume_launches": row_r["warm"]["launches"]["flash_fwd"],
         "spec_launches": [r["launches"]["flash_fwd"] for r in rows_sp
                           if r.get("spec") is not None],
         "fleet_launches": fleet_launches("flash_fwd"),
         "process_launches": child_launches("flash_fwd"),
         "harness_launches": harness_launches("flash_fwd"),
         "harness_fleet_launches": harness_fleet_launches("flash_fwd"),
         "harness_procfleet_launches": harness_procfleet_launches(),
         "moe_serve_launches": {r["run"]: r["launches"]["flash_fwd"] for r in rows_sm},
         "moe_train_launches": row_tm["launches"]["flash_fwd"],
         "moe_train_tc_launches": row_tm["tc_launches"]["flash_fwd"],
         "pod_launches": pod_launches("flash_fwd"),
         "pod_tp_sp_launches": tp_sp_launches("flash_fwd"),
         "pod_pp_ep_launches": pp_ep_launches("flash_fwd"),
         "pod_serve_launches": pod_serve_launches("flash_fwd"),
         "resume_prefill": {s: {key: k1["resume_prefill"][s][key] for key in (
             "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
                            for s in k1["resume_prefill"]}},
        {"name": "flash_dq", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "torchkafka_tpu/ops/flash.py:201",
         "launches": row_t["launches"]["flash_dq"],
         "tc_launches": row_t["tc_launches"]["flash_dq"],
         "max_abs_err": k23["max_abs_err"]["main_bf16"]["dq"],
         "ms": k23["dq"]["kernel_ms"], "plain_ms": k23["dq"]["plain_ms"],
         "bound_ms": k23["dq"]["bound_ms"], "bound_by": k23["dq"]["bound_by"],
         "library_ms": k23["library_ms_sdpa_bwd"],
         "process_launches": child_launches("flash_dq"),
         "moe_train_launches": row_tm["launches"]["flash_dq"],
         "pod_launches": pod_launches("flash_dq"),
         "pod_tp_sp_launches": tp_sp_launches("flash_dq"),
         "pod_pp_ep_launches": pp_ep_launches("flash_dq"),
         "harness_launches": harness_launches("flash_dq"),
         "harness_fleet_launches": harness_fleet_launches("flash_dq")},
        {"name": "flash_dkv", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "torchkafka_tpu/ops/flash.py:252",
         "launches": row_t["launches"]["flash_dkv"],
         "tc_launches": row_t["tc_launches"]["flash_dkv"],
         "max_abs_err": max(k23["max_abs_err"]["main_bf16"][x] for x in ("dk", "dv")),
         "ms": k23["dkv"]["kernel_ms"], "plain_ms": k23["dkv"]["plain_ms"],
         "bound_ms": k23["dkv"]["bound_ms"], "bound_by": k23["dkv"]["bound_by"],
         "library_ms": k23["library_ms_sdpa_bwd"],
         "process_launches": child_launches("flash_dkv"),
         "moe_train_launches": row_tm["launches"]["flash_dkv"],
         "pod_launches": pod_launches("flash_dkv"),
         "pod_tp_sp_launches": tp_sp_launches("flash_dkv"),
         "pod_pp_ep_launches": pp_ep_launches("flash_dkv"),
         "harness_launches": harness_launches("flash_dkv"),
         "harness_fleet_launches": harness_fleet_launches("flash_dkv")},
        {"name": "kvattn_dynlen", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/kvattn_dynlen.cu",
         "replaces": "torchkafka_tpu/ops/kvattn.py:458",
         "launches": row_q["launches"]["kvattn_dynlen"],
         "traced_launches": [r["launches"]["kvattn_dynlen"] for r in rows_tr if r["traced"]],
         "fleet_launches": fleet_launches("kvattn_dynlen"),
         "harness_launches": harness_launches("kvattn_dynlen"),
         "harness_graph_block_launches": roof["graph_block_launches"]["kvattn_dynlen"],
         "moe_serve_launches": {r["run"]: r["launches"]["kvattn_dynlen"] for r in rows_sm},
         "pod_serve_launches": pod_serve_launches("kvattn_dynlen"),
         "harness_graph_replays": roof["graph_replays"],
         "max_abs_err": main_pool["max_abs_err"]["bf16"], "ms": main_pool["kernel_ms"],
         "plain_ms": main_pool["plain_ms"], "bound_ms": main_pool["bound_ms"],
         "bound_by": main_pool["bound_by"], "library_ms": None,
         "n_split": main_pool["n_split"], "span": main_pool["L"],
         "one_span_ms": main_pool["one_span_ms"], "span_ms": _spans(main_pool),
         "path_8b_launches": path_8b("kvattn_dynlen"),
         "pool_2048": {**{key: k4["pools"]["2048"][key] for key in (
             "n_split", "kernel_ms", "one_span_ms", "plain_ms", "bound_ms")},
                       "span_ms": _spans(k4["pools"]["2048"])},
         "shape_8b": {key: pool_8b[key] for key in (
             "n_split", "kernel_ms", "one_span_ms", "plain_ms", "bound_ms")}},
        {"name": "kvattn_paged", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/kvattn_paged.cu",
         "replaces": "torchkafka_tpu/ops/kvattn.py:755",
         "launches": row_p["launches"]["kvattn_paged"],
         "tier_launches": [r["launches"]["kvattn_paged"] for r in rows_ti
                           if r["kv_tier"] is not None],
         "disagg_launches": rows_dg[0]["launches"]["kvattn_paged"],
         "pod_serve_launches": pod_serve_launches("kvattn_paged"),
         "max_abs_err": main_view["max_abs_err"]["bf16"], "ms": main_view["kernel_ms"],
         "plain_ms": main_view["plain_ms"], "bound_ms": main_view["bound_ms"],
         "bound_by": main_view["bound_by"], "library_ms": None,
         "n_split": main_view["n_split"], "span": main_view["L"],
         "one_span_ms": main_view["one_span_ms"], "span_ms": _spans(main_view),
         "view_2048": {**{key: k5["views"]["2048"][key] for key in (
             "n_split", "kernel_ms", "one_span_ms", "plain_ms", "bound_ms")},
                       "span_ms": _spans(k5["views"]["2048"])}},
        # K6-K8 lie on no serving or training path, as in the JAX package:
        # "launches" counts the calls of their own phase, "path_launches"
        # those of the two full-depth 8b serve runs.
        {"name": "qmatmul", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/qmatmul.cu",
         "replaces": "torchkafka_tpu/ops/qmatmul.py:50",
         "launches": k6["launches"], "path_launches": path_8b("qmatmul"),
         "max_abs_err": k6_main["max_abs_err"], "ms": k6_main["kernel_ms"],
         "plain_ms": k6_main["plain_ms"], "bound_ms": k6_main["bound_ms"],
         "bound_by": k6_main["bound_by"], "library_ms": k6_main["library_ms"],
         "library": k6_main["library"], "tc_launches": k6["tc_launches"],
         "kernel_route": k6_main["route"], "simt_bf16_ms": k6_main["simt_bf16_ms"],
         "prefill_2048": {key: k6["cases"]["w_gate_m2048_bfloat16"][key] for key in (
             "route", "max_abs_err", "kernel_ms", "simt_bf16_ms", "plain_ms", "library_ms",
             "bound_ms", "bound_by", "tflops")}},
        {"name": "kvattn_kmajor", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/kvattn_full.cu",
         "replaces": "torchkafka_tpu/ops/kvattn.py:169",
         "launches": k78["launches"]["kvattn_kmajor"],
         "path_launches": path_8b("kvattn_kmajor"),
         "max_abs_err": k78_main["max_abs_err"]["bf16"]["k7_vs_plain"],
         "ms": k78_main["k7_ms"], "plain_ms": k78_main["plain_kmajor_ms"],
         "bound_ms": k78_main["bound_ms"], "bound_by": k78_main["bound_by"],
         "library_ms": None, **full_split("k7")},
        {"name": "kvattn_mmajor", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/kvattn_full.cu",
         "replaces": "torchkafka_tpu/ops/kvattn.py:98",
         "launches": k78["launches"]["kvattn_mmajor"],
         "path_launches": path_8b("kvattn_mmajor"),
         "max_abs_err": k78_main["max_abs_err"]["bf16"]["k8_vs_plain"],
         "ms": k78_main["k8_ms"], "plain_ms": k78_main["plain_mmajor_ms"],
         "bound_ms": k78_main["bound_ms"], "bound_by": k78_main["bound_by"],
         "library_ms": None, **full_split("k8")},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase catches its own:

 1. device   card name and power limit (nvidia-smi), torch and CUDA
             versions; TF32 off for matmuls and cuDNN.
 2. build    compile the CUDA kernels from src/repro_torch/kernels/csrc;
             print each kernel's registers and spills from build.log.
 3. check    each kernel against its plain PyTorch version.  Flash
             attention and decode at the serving path's shapes, fp32
             (<= 1e-4 abs: summation order) and bf16 (<= 2e-2 abs: one
             bf16 ulp at |out| ~ 2, fp32 accumulation on both sides), and
             at TinyLlama's full context: prefill S=2048 (causal, window
             100, non-causal) and decode L=2048 with positions on both
             sides of every split-K chunk edge and past L, and a ring
             buffer with unwritten chunks (every output finite).
             onebit_encode_ef at the full-width leaf shapes of
             TinyLlama-1.1B, a flat symmetric [R, 256] block and an
             e=None + valid block: signs exactly equal, sp / sn / out /
             new_e within 2e-5 of the row's largest |c_in| (bin sums over
             rows up to 32000 long, taken in another order).
             attention_grad at the training shape: its forward is the
             flash kernel's output and its q/k/v gradients equal
             autograd's through attention_ref within 1e-5 (fp32).  The
             fp32 forward (3xTF32 on the tensor cores) at the training
             shape also with scores ~16x larger (|q.k| / sqrt(hd) ~ 16),
             within 1e-4.
 4. timing   CUDA-event medians (L2 flushed before every launch) of each
             kernel, its plain version and, where one exists, one PyTorch
             library call that computes the same function (a yardstick
             the port never calls), beside the least time the card needs
             for the work.  onebit_encode_ef also summed over one
             full-width step's leaves (one worker); flash_attention also
             in fp32 at the training shape (B=2, S=256); flash_decode also
             at B=8 L=2048.  The rebuilt kernels' lines (flash prefill and
             decode, the fp32 training forward, terngrad_compress) print
             the times of the designs they replaced (PERF.md) beside
             theirs.  The fp32 forward's bound is its route's: 3 TF32
             tensor-core products per fp32 product (3xTF32) at 495
             TFLOP/s, or its bytes.
 5. serve    full-width TinyLlama-1.1B in bf16 with seeded random weights:
             16 requests (prompt 512, 64 new tokens, all at t=0) through
             ServeEngine, continuous batching, paged cache (page 16),
             8 slots, max_len 576.  Launch counts are zeroed just before
             and read just after; every layer's attention must have gone
             through the kernels.
 6. path     the first prefill group and 4 decode steps again through the
             kernel path, the plain path (attn_backend="ref") in bf16, and
             the plain path in fp32.  The served tokens of those 8
             requests must equal this run's greedy tokens (same kernels,
             same shapes: a fault in the paged cache or the per-slot
             positions shows here).  The kernel path's logits must be as
             close to fp32 as the plain bf16 path's are, within a factor
             2: after 22 layers of bf16 activations the plain bf16 path is
             itself ~0.1 from fp32, so phase 3's 2e-2 per-call tolerance
             cannot hold for whole-model logits.
 7. train    full-width TinyLlama-1.1B in fp32, seeded init:
             Strategy.parse("bsp/allreduce/onebit@4", lr=0.01) through
             Trainer.fit, 3 steps of batch 2 x seq 256 per worker
             (make_lm_batches), bucket_mb 4.  Counts are zeroed just
             before and read just after: 22 x 4 flash_attention launches
             and one onebit_encode_ef launch per leaf per worker per step.
             Every loss finite; peak device memory reported.  Then the
             same 3 steps on the plain path (kernel_backend="ref",
             attn_backend="ref"): each step's loss within 1e-3 of the
             kernel path's (the flash forward differs by ~1e-6, which can
             flip signs at |c_in| near 0; error feedback carries the
             difference to the next step instead of losing it).
 8. reduced  the BENCH_pr10.json recipe on the card (reduced TinyLlama,
             seq 16, batch 2, lr 0.01, bucket_mb 0.25, 2 steps) for
             bsp/allreduce/{none,onebit,dgc:0.05}@8: wire bytes per step
             exactly 14700544, 631744 and 2101312, 7 buckets (none depends
             on the init).
 9. measured full-width TinyLlama-1.1B in fp32, as phase 7, with the
             encoded payloads inside the exchange schedule
             (wire="measured"): bsp/ring/onebit@4 for 3 steps (measured
             bytes at most 0.25x the fp32 ring's, the JAX package's
             acceptance bound), bsp/ring/{terngrad,qsgd,dgc}@4 for 2 steps,
             and bsp/allreduce/terngrad@4 with wire="modeled" (the path to
             terngrad_compress) for 2 steps.  Counts are zeroed just before
             and read just after each run; every kernel of the slice must
             have launched.  Each run again on the plain path, same
             generators: each step's loss within 1e-3 of the kernel
             path's, as in phase 7.

 10. matrix   the rest of the survey's strategy matrix at full width, fp32,
             seeded init, 4 workers x batch 2 x seq 256, lr 0.01,
             bucket_mb 4.  First the public entry of onebit_compress,
             onebit.compress, over every leaf of one full-width gradient
             (two error-feedback rounds, as the JAX package's kernel
             benchmark drives it): one launch per leaf per round, signs
             equal to onebit_ref's.  Then Strategy.parse(...) through
             Trainer.fit: ssp:3/ps/onebit@4 (modeled, 2 global steps = 8
             push events, each event's worker and staleness printed; one
             onebit_encode_ef launch per leaf per event) and the same run
             with backend="sim" (the same event sequence, losses within
             1e-3 per event); asp/allreduce/none@4 (2 steps, 8 events);
             sma/allreduce/none@4 (2 steps, 4 fp32 replicas); and
             bsp/ps/onebit@4 with wire="measured" (2 steps: bytes per
             worker per step equal to measured_step_tx_bytes("ps"), about
             0.52x the fp32 ring's: 1-bit pushes, exact fp32 pulls).
             Counts are zeroed just before and read just after each run;
             every loss finite, peak memory reported; each run again on the
             plain path with per-event losses within 1e-3.

 11. launcher the trainer's entry point at full width:
             repro_torch.launch.train.main(["--arch", "tinyllama-1.1b",
             "--steps", "3", "--optimizer", "adam", "--compress", "onebit",
             "--device", "cuda"]) in process (batch 8 x seq 64,
             cosine_warmup), with --compute-dtype float32 and then
             bfloat16 (the bf16 flash forward under autograd).  The fp32
             run again on the plain path (attn_backend="ref", the
             compressor's backend="ref"): each step's loss within 1e-3 of
             the kernel path's, wire_bytes and the lr column equal; every
             bf16 loss finite.  One batch's gradients, per JAX leaf:
             ||g_kernel,bf16 - g_fp32|| <= 1.25 ||g_plain,bf16 - g_fp32||
             (g_fp32 on the plain path): the kernel path as close to fp32
             as the plain bf16 path, phase 6's rule with a tighter factor
             (one step's gradients do not compound over decode steps).
             The warm step's wall, the Adam update's share of it (the
             step's two halves timed apart), peak memory.
 12. trainer  examples/train_100m_e2e.py's full trainer path at full width
             in fp32, phase 7's shapes: Strategy.parse(
             "bsp/allreduce/onebit@4"), make_bucketed_allreduce (bucket_mb
             4, tictac), make_train_step(AdamW(0.01), cosine_warmup(6e-4,
             20, 3), FP32, the onebit compressor, reduce_fn),
             make_sharded_train_step(compressed=True) through train_loop, 3
             steps of batch 2 x seq 256 per worker.  22 x 4 flash_attention
             launches per step and one onebit_encode_ef per leaf per worker
             per step; the bucket count equal to DeviceEngine's for the
             spec; the same steps on the plain path: losses within 1e-3,
             wire_bytes equal.  Step wall and peak memory.

Counts are zeroed just before and read just after phase 11's two
kernel-path main() runs and phase 12's kernel-path run; they make the
kernels' "trainer" launches.

 13. quickstart examples/quickstart.py's save, register, reload and decode
             at full width: phase 11's trained fp32 parameters (the warm
             step's run, 3 launcher steps) saved with save_checkpoint
             (512 MiB shards, per-leaf hashes) into a temporary directory,
             registered with ModelRegistry, restored onto the card with
             load_checkpoint (bitwise equal, leaf by leaf), saved again
             with incremental_from= (every shard linked) and restored
             bitwise; then generate (fp32, the kernels) 16 greedy tokens
             from a seeded 4 x 32 prompt with the restored parameters and
             with the ones in memory: equal.  Save and load seconds are
             host-disk numbers.  The directory is removed.
 14. traced   repro_torch.launch.serve's engine (serve(), as the launcher
      serve   runs it) in bf16 at full width on benchmarks/serve_bench.py's
             traffic (slots 4, max_len 24, prompt 5, Poisson rate 0.6 over
             30 iterations, seed 0, budgets from {3, 6, 10, 14}), both
             policies, contiguous and paged (page 4), each untraced and
             twice with --trace, --slo ttft_p99<8 (the first also
             --report): the virtual-clock columns equal BENCH_pr7.json's,
             the trace is strictly valid and its wall-stripped bytes equal
             between the two traced runs, and the greedy tokens equal the
             untraced run's.  Wall per run and per engine iteration.
 15. traced   the launcher (phase 11's fp32 flags) with --trace and
      train   --report for 3 steps, and phase 7's bsp/allreduce/onebit@4 for
             2 steps under tracing: losses equal the untraced runs' (phases
             11 and 7) bit for bit; the @4 trace holds one exchange span
             per step with the plan's bucket count, and its hop bytes sum
             to measured_step_tx_bytes per step.  Step walls with and
             without tracing.

Counts are zeroed just before and read just after each of phases 13-15's
runs; they make the kernels' "quickstart", "traced_serve" and
"traced_train" launches.

 16. elastic  Trainer.fit(plan=...) at full width, fp32, phase 7's batch
      full    per worker drawn over the reduced config's 512 token ids (a
             chain the model learns within the run), SGD lr 0.1:
             (a) bsp+backup:1/allreduce/onebit@4 under
             slow:w2x4@1,resize:3@3,resize:4@5 for 7 steps, no
             checkpoints: each step's dropped set equals
             elastic.backup.drop_set over the engine's periods and
             slowdowns, dropped_updates 7, a dropped worker's EF tensors
             bitwise unchanged by its step, across each reshard the
             survivors' EF the same tensors bitwise and the grown slot
             zeros, resizes 2, final_workers 4, losses finite and the last
             below the first;
             (b) bsp/allreduce/none@4 under crash:w1@4,resize:4@5 for 6
             steps, checkpoint_every 3, traced, into a temporary directory
             removed at the end: one recovery (restored_step 3,
             lost_steps 1), executed_steps 7, final_workers 4, and the
             parameters restored at step 3 bitwise equal to a host copy
             taken at its commit.  Snapshot spans and the restore in
             seconds (host disk).
 17. elastic  the rest of the plane at 2 layers (TinyLlama's widths, 0.88
      reduced GB of fp32 parameters), lr 0.03: (c) bsp/allreduce/onebit@4
             with restart@3 over 6 steps: losses and parameters bitwise
             equal to an uninterrupted run; (d) ssp:2/ring/onebit@4 under
             crash:w2@5,resize:4@10 for 15 steps, checkpoint_every 3: one
             crash recovery, one resize, final_workers 4, the final loss at
             most 4x the uninterrupted run's and below the first; (e)
             bsp+backup:1+detect/allreduce/onebit@4 for 6 steps with worker
             1's fetch sleeping 50 ms: drops [3], [3] (the scheduled
             ranking while the detector warms up), then the set a
             slow:w1x4 plan schedules, [1]; (f) the sched simulator (12
             jobs, 2 x 4 GPUs, fifo, gandiva, elastic) through
             plan_from_sched_trace (tools/elastic_smoke.py's selection)
             driving ssp:1/allreduce/none@2 on the device backend, and the
             Autoscaler (replica_rate 0.5) over phase 14's arrivals with
             its SLO alert times as burn_times: the decisions and plan.
             Wall and peak memory of every sub-run.

Counts are zeroed just before phase 16 and read just after phase 17; they
make the kernels' "elastic" launches.

 18. hybrid   parallel.HybridEngine through Strategy.parse and Trainer.fit.
             (a) full-width TinyLlama-1.1B, fp32, 4 data slots of batch
             2 x 256, each repeating its batch, AdamW lr 1e-4:
             bsp/ps/none@4:d4.z1.adamw and .z3.adamw for 3 steps each:
             losses, each within 1e-4 of plain AdamW (optim.adam, one
             step over the whole tree on the slots' mean gradient, plain
             attention, no kernel launched), the
             z1-z3 loss gap (bound 1e-4), per_device_state_bytes equal to
             parallel.zero.state_bytes_per_device (opt + the 4 B step
             count), peak memory with the allocator reset between specs;
             (b) bsp/ps/onebit@4:d4.z3.adamw in fp32 and .bf16 (the path
             that launches flash_attention in both dtypes and
             onebit_encode_ef): losses finite and the last below the
             first, the warm step wall, the peak, and the same run on the
             plain path (kernel_backend="ref", attn_backend="ref", no
             kernel launched) within 1e-3 (fp32) and 1e-2 (bf16); the
             compute dtype is the spec's precision; (c) the tensor and stage
             axes: make_tiny_transformer(4, d_model=2048, d_ff=5632),
             bsp/ring/none@8:d2.t2.s2 and ...m8.1f1b on 16 rows per data
             slot for 4 steps, SGD lr 0.05, TF32 off: losses and
             parameters within 1e-4 of the stacked reference on the card
             (both slots' rows through stacked_grad_fn), analytic bubble
             and ticks 0.2 / 5 (GPipe, 4 micro-batches) and 0.0588 / 17
             (1F1B v2, 8 micro-batches).  hybrid_phases(cfg, dev, ...)
             runs on the CPU too (cfg.reduced(), a short seq and a small
             tiny model rehearse it).

Counts are zeroed just before phase 18 and read just after it; they make
the kernels' "hybrid" launches.

 19. tp       tensor-parallel decode (serve/tp.py) of full-width
      decode  TinyLlama-1.1B in bf16 at tp=2, both ranks logical on the one
             card: phase 5's traffic through ServeEngine at tp=1 and at
             tp=2; flash_decode launches twice phase 5's per iteration (each
             rank's launch sees 16 heads on 2 KV heads).  Greedy streams
             compared and reported.  Teacher-forced on the tp=1 run's
             stream (its first prefill group, 16 decode steps): tp=2
             logits within 1e-3 of tp=1's in fp32 with TF32 off (only the
             order of the row-parallel sums differs), and in bf16 within 2x
             the bf16 tp=1 run's own distance from fp32 (the tp=2 run
             rounds each rank's partial product to bf16 before the sum; a
             different rounding order moves the logits no further than
             bf16 rounding does).  Each run's decode iterations are
             timed (synchronized); the tp=2 run's tokens and first decode
             step's logits are what phase 28a holds its ranks to.
 20. MoE +    deepseek-v2-lite-16b at full width: (a) 2 layers (the dense
      MLA     layer 0 and one MoE layer), every published width, fp32,
             capacity_factor = num_experts (no drops in either mode):
             prefill 8 tokens, then 8 decode steps through the latent cache
             against the full forward's logits, within 1e-3 (fp32, other
             summation orders); one value_and_grad of loss_fn: finite
             gradients, nonzero on the router and on every expert that
             received a token, zero on the others.  (b) all 27 layers in
             bf16 at the published capacity 1.0 through ServeEngine on
             phase 5's traffic: tokens/s, peak memory, and the MLA cache's
             (512 + 64) x 2 B x 27 bytes per token.  No flash kernel runs
             on this path: MLA and MoE have no Pallas kernel in the
             reference.
 21. M-RoPE   qwen2-vl-7b at full width in bf16: phase 5's traffic through
             ServeEngine (flash_attention at group 7, head_dim 128), then a
             forward with 64 vision embeddings on an 8 x 8 grid and three
             distinct M-RoPE position rows: the kernel path's logits as
             close to fp32 as the plain bf16 path's, within a factor 2
             (phase 6's bound).

Counts are zeroed just before and read just after phase 19's tp=2 run,
phase 20b's run and phase 21's run with its vision forward; they make the
kernels' "tp_serve", "deepseek" and "qwen2_vl" launches.  Each phase frees
its parameters before the next.  family_phases(dev, smi, ...) runs on the
CPU too, at the configs' .reduced() and a short traffic.

 22. RG-LRU   recurrentgemma-9b at full width (38 layers, 12 groups of
      + local (rglru, rglru, local) and 2 rglru stragglers; MQA at head_dim
             256, window 2048) in bf16 with seeded weights: phase 5's
             traffic plus one request of a 2300-token prompt and 64 new
             tokens through ServeEngine (paged, 8 slots), so the ring
             wraps in cache_from_prefill and again in decode: tokens/s,
             peak, state bytes per slot (the same at any length), and
             flash_attention / flash_decode launched once per local layer
             per prefill group / decode iteration.  At 3 layers (rglru,
             rglru, local), full widths, fp32: prefill 2100 tokens,
             cache_from_prefill, 200 decode steps against the full
             forward's logits within 1e-3, and value_and_grad over 2300
             tokens: every leaf's gradient finite and nonzero.
 23. RWKV-6   rwkv6-7b at full width (32 layers) in bf16: 8 requests of a
             512-token prompt and 32 new tokens through ServeEngine:
             tokens/s, peak, state bytes per slot (fp32 S, 32 x 64 heads x
             64^2 x 4 B, plus the bf16 shifts).  No flash kernel runs on
             this path: RWKV has no Pallas kernel in the reference.  At 2
             layers in fp32: prefill 48, decode to 64 against the forward,
             within 1e-3.
 24. Whisper  whisper-large-v3 (32 + 32 layers) in bf16: 4 utterances of
             seeded frame stubs [4, 1500, 1280]: encode (flash_attention,
             non-causal), build_cross_cache, 64 greedy decode_steps from
             <|startoftranscript|> (flash_decode on the self-attention
             cache, plain cross-attention); the encoder output of the
             kernel path and of the plain bf16 path against fp32 (kernel
             <= 2 x plain, phase 6's bound).  Then one step of
             launch/train.py --arch whisper-large-v3 --layers 2 (full
             width, fp32, batch 2): a finite loss and a nonzero gradient.

Counts are zeroed just before and read just after phase 22's serve, phase
23's serve and phase 24's encode and decode; they make the kernels'
"recurrentgemma", "rwkv6" and "whisper" launches.
recurrent_phases(dev, smi, ...) runs on the CPU too, at the configs'
.reduced() and a short traffic.

Phases 3 and 4 also hold and time the flash kernels at the new shapes of
phases 22 and 24: the bf16 prefill at B 1, S 2560, 16 heads on one KV
head, head_dim 256, window 2048 (and without the window); the fp32
forward at the same heads and S 512 (scores also ~16x larger); the decode
of 8 slots on a 2048-row ring at positions 100-3000 (and a full cache);
Whisper's encoder attention, non-causal at B 4, S 1500, 20 heads, hd 64
(a tail tile).  The library time of a windowed prefill or a decode is
SDPA with a boolean mask.  The kernels line gives these shapes' times
under "at_shapes".

Phase 3 also holds flash_attention and flash_decode at Qwen2-VL-7B's
attention (28 heads on 4 KV heads, head_dim 128) and flash_decode at one
tp=2 rank of TinyLlama's (16 heads on 2 KV heads, a rank's contiguous block
of a rank-major cache), both dtypes, at the serving shapes.  It also holds
topk_compress, terngrad_ternarize, terngrad_compress
and qsgd_compress against their plain versions at full-width shapes (the
compressor's flat layout of the stacked w_down leaf, [991232, 256] as one
segment; a ring chunk of it at @4, 4 segments of [247808, 256]; and a
ragged C = 200): planes and outputs exactly equal, given the same
per-segment scalars and uniform draws; terngrad_compress also on uniform
+-1 g at [991232, 256], where every element lies under 2.5 sigma (the
finishing kernel's second pass against max|g|).  It checks the quantile
threshold on the card against a float64 sort with the float32 position
rule, and
onebit_compress against onebit_ref at the four ONEBIT_SHAPES, the flat
[991232, 256] w_down layout and a ragged [4096, 200], with a block of
exact zeros in c (sign(0) = +1): signs exactly equal, scale and new_e
within 2e-5 of the row's largest |c|.  Phase 4 times the four segment
kernels at [991232, 256] (terngrad_compress also on uniform g) and
onebit_compress at [2048, 32000] and [991232, 256].  The bounds of
terngrad_compress and qsgd_compress count 13 B per element: their
reduction (std, l2 norm) must read g before their output can be
written, and g (1.0 GB) cannot stay in the 50 MB L2 in between.

Phase 25 is the dry-run (repro_torch.launch.dryrun) at production
lengths:
 25a. meta   build_dryrun on the meta device for all 39 (arch x shape)
             pairs on the 16 x 16 and the 2 x 16 x 16 mesh: each pair's
             per-device parameter and cache bytes (run_pair's cache policy,
             attn_hints_seq); the card's allocation is unchanged across it.
 25b. probe  probe_pair on the card at 1 and 2 full-width layer groups:
             TinyLlama-1.1B x all four shapes, Qwen2-VL-7B x prefill_32k,
             DeepSeek-V2-Lite-16B x long_500k (the 524288-row MLA latent
             cache), RecurrentGemma-9B x long_500k, Whisper-large-v3 x
             train_4k, prefill_32k and decode_32k: the meta FLOPs and
             bytes extrapolated to the full depth, the card's median ms at
             each depth at run_pair's batch and their extrapolation, the
             peak GiB at 2 groups beside the meta count it was planned by
             (launch.cost: the card's op transients and BLAS workspaces
             included), each pair's collectives on the 16 x 16 mesh
             (launch.spmd: the step partitioned by DTensor over a fake
             process group of 256 ranks, on the host, on meta shards;
             per-device result bytes by kind and traffic_weighted,
             extrapolated like the cost) and the roofline terms (H100
             constants), the collective term traffic_weighted over NVLink;
             TinyLlama-1.1B's four pairs must have their collectives
             counted (at full width), another pair prints the op DTensor
             cannot partition yet.
 25c. full   run_pair at full depth on the card for TinyLlama-1.1B x all
             four shapes, RecurrentGemma-9B x long_500k and
             DeepSeek-V2-Lite-16B x long_500k: the measured ms beside the
             probe's extrapolation.  The batch is the per-data-shard batch
             (global / 16) unless the meta count of a card run exceeds
             0.8 of the card, then cut (the record's "reduced").
 25d. kernels the flash kernels at the new lengths against their plain
             versions on a slice of the work the plain version can hold:
             the bf16 prefill at B 1, S 32768 (TinyLlama's 32 heads on 4,
             hd 64, causal), its last 256 query rows against plain
             attention of those rows over all keys; flash_decode over 8
             slots at L 32768 (positions at split-K chunk edges); the ring
             decode at positions up to 524287 (window 4096, hd 64; window
             2048, RecurrentGemma's 16 heads on 1, hd 256); each timed
             beside its bound and SDPA (the prefill's plain time is of
             the 256-row slice).  Outputs there are small (std about
             sqrt(e / keys)), so each query row or slot is held relative
             to its own scale: its largest |kernel - plain| within
             REL_TOL of its largest |plain|.  The same plain version with
             DROP_KEYS keys masked out (one K/V tile of the prefill) must
             miss that bound in every row, which shows a grid, offset or
             split-K fault that loses a tile would fail.
A pair that records status "error" fails the phase.  Counts are zeroed
just before 25b and read just after 25c; they make the kernels'
"dryrun" launches.  dryrun_phases(dev, smi, ...) runs 25a-c on the CPU
too, with small configs and shapes given by cfg_for and shape_for.

Phase 26 is the worker axis over torch.distributed, one process per
worker (repro_torch.launch.dist.spawn; core.collectives.DistAxis):
 26a. gloo   bsp/ring/onebit@k (wire="measured") and
             bsp/allreduce/onebit@k (modeled), fp32, TF32 off, 3 steps of
             phase 7's batches, and bsp/ps/onebit@k measured, 2 steps,
             over k Gloo ranks on the one card (each rank's gradient on
             the card with the kernels, the hops staged through pinned
             host memory): k = 2 at 2 layers, full widths, with
             ssp:3/ps/onebit@2 (modeled, 1 step of 3 push events); and
             k = 4 at 2 layers (four full-width ranks do not fit the
             card), the latter also
             bsp/ring/{dgc,terngrad,qsgd}@4 measured (3 steps) and, 2
             steps each, bsp/ps/{dgc,qsgd}@4 measured, bsp/ps/none@4
             modeled, bsp/ps/terngrad@4 in both modes,
             sma/allreduce/none@4 and bsp+backup:1/ring/onebit@4
             measured, and asp/allreduce/none@4 (1 step of 5 events).  Each against the
             logical engine run just before in this process on the same
             draws: losses (one per step, or per push event) within
             DIST_TOL and the terngrad and qsgd cells' bit for bit, wire
             bytes equal.
 26b. nccl   bsp/ring/onebit@1 measured over an NCCL group of
             torch.cuda.device_count() ranks, against the logical axis in
             the same rank process.
26a and 26b run in one spawn of 4 Gloo ranks (one process start), each
run on a group of its first ranks while the others wait.
 26c. torchrun tools/torch_train_100m_e2e.py (AdamW, make_sharded_train_step
             over make_bucketed_allreduce, bsp/allreduce/onebit@2) under
             python -m torch.distributed.run --nproc-per-node 2
             --dist-backend gloo against the same command with logical
             workers: losses within DIST_TOL, wire_bytes equal.
Each rank prints its peak memory, step walls and bytes staged through the
host.  A rank's failure raises here.  Counts are zeroed in each rank
just before each cell and read just after; 26a-b make the kernels'
"dist" launches and 26c's ranks (the trainer's "dist:" line) their
"dist_trainer" launches.  dist_phases(cfg, dev, smi, ...) runs on the
CPU too (Gloo in 26b), with get_config("tinyllama-1.1b").reduced(),
torch.device("cpu"), seq=32 and a short tool_argv.

Phase 27 is the elastic interface and the hybrid engine over Gloo ranks
on the one card (one spawn of 8 ranks, each run on a group of its first
ranks while the others wait), fp32 with TF32 off, each cell held to the
logical engine run just before in this process:
 27a. elastic  Trainer(group=).fit(plan=) over 4 ranks at 2 layers, full
             widths: ELASTIC_CRASH (bsp/allreduce/none@4,
             crash:w1@4,resize:4@5, 6 steps, a snapshot every 3) and
             bsp/allreduce/onebit@4 with restart@3 (6 steps): the same
             recoveries, losses within DIST_TOL, wire bytes equal, the
             final parameters' sha256 equal, and rank 0's snapshot
             manifests (per-leaf content hashes) equal the logical run's.
 27b. restart  bsp/allreduce/onebit@2 with restart@2, 3 steps, full
             depth over 2 ranks: the snapshot's GiB, each save and load's
             seconds (rank 0 writes; every rank loads) and the peak per
             rank; held to the logical engine's run of the spec without
             the restart (it loses no step): losses within DIST_TOL, wire
             bytes equal, the final parameters' sha256 equal (a restore
             of the wrong parameters or EF rows moves them).
 27c. hybrid   HybridEngine(group=): bsp/ps/onebit@2:d2.z3.adamw at full
             width over 2 ranks, 2 steps (step walls, staged GiB and peak
             per rank beside the logical engine's); phase 18's
             HYBRID_MESHES over 8 ranks and bsp/ps/dgc:0.05@4:d2.s2.z2
             measured over 4, on make_tiny_transformer at TinyLlama's FFN
             widths: losses within DIST_TOL, wire bytes equal.
Counts are zeroed in each rank just before each cell and read just
after; 27a-b make the kernels' "dist_elastic" launches and 27c their
"dist_hybrid" launches.

Phase 28 runs in phase 27's spawn, as two more runs on groups of its
first ranks (no process start of its own):
 28a. tp       ServeEngine(group=) at tp=2 over 2 Gloo ranks, one tensor
      serve    rank per process: full-width TinyLlama-1.1B in bf16 from
             seed-0 weights on phase 19's traffic (phase 5's), after its
             warm-up.  Each rank keeps its own shard of the sharded
             weights beside the whole ones (prefill) and its own KV
             heads, runs flash_attention (bf16 prefill) once per layer
             per prefill group and flash_decode (16 heads on 2 KV heads)
             once per layer per decode iteration, and all-gathers the
             row-parallel partials through Gloo.  Held: every rank's
             greedy tokens equal phase 19's logical tp=2 stream bit for
             bit.  Printed: the first decode step's max |rank - logical|
             logits, agreement with the tp=1 stream, each rank's median
             decode-iteration ms and tokens/s beside phase 19's logical
             tp=2 and tp=1 runs, peak, cache and weight GiB and the bytes
             staged through the host per decode iteration.  NCCL refuses
             two ranks on one card (PERF.md, phase 26), so NCCL at tp=2
             waits for a second card.
 28b. hybrid   Trainer(group=).fit(plan=) over 4 Gloo ranks on
      elastic  make_tiny_transformer at TinyLlama's FFN widths, 2 layers
             (HYBRID_ELASTIC_TINY), fp32, TF32 off: bsp/ps/onebit@4:d4.z3
             with restart@2 and bsp/ps/none@4:d2.s2.z2.adamw with
             crash:w1@3,resize:4@4 (the mesh shrinks to one data slot on
             ranks 0-1 while ranks 2-3 wait, then grows back), each
             against the logical engine's run just before: losses within
             DIST_TOL (bit for bit expected), wire bytes, recoveries, the
             final parameters' sha256 and rank 0's snapshot manifests
             equal; the other ranks write nothing.
Counts are zeroed in each rank just before each run and read just after;
28a makes the kernels' "dist_tp" launches and 28b their
"dist_hybrid_elastic" launches.  elastic_hybrid_phases(cfg, dev, smi,
tp_ref, ...) runs on the CPU too, with get_config("tinyllama-1.1b")
.reduced(), torch.device("cpu"), "cpu", the tp_ref of family_phases'
CPU rehearsal, seq=32, a small tiny and tiny_elastic.

The last lines are the script's wall, the kernels JSON, the nvidia-smi
line and the result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
F32_FLOPS = 67e12                  # fp32 outside the tensor cores
TF32_FLOPS = 495e12                # dense TF32 tensor-core peak
F32_TOL, BF16_TOL = 1e-4, 2e-2
ONEBIT_TOL = 2e-5                  # of the row's largest |c_in|
GRAD_TOL = 1e-5
B, H, KV, HD = 8, 32, 4, 64        # TinyLlama-1.1B attention at 8 slots
PROMPT, NEW, MAX_LEN = 512, 64, 576
QWEN_H, QWEN_KV, QWEN_HD = 28, 4, 128  # Qwen2-VL-7B attention
# RecurrentGemma-9B's local attention (MQA, head_dim 256, window 2048): the
# prefill length past the window (bf16; fp32 at the shorter one) and the
# ring decode's positions per slot; Whisper-large-v3's encoder attention
RG_H, RG_HD, RG_WINDOW = 16, 256, 2048
RG_PREFILL, RG_PREFILL_F32 = 2560, 512
RG_RING_POS = [100, 500, 2047, 2048, 2049, 2300, 2900, 3000]
WHISPER_B, WHISPER_F, WHISPER_H = 4, 1500, 20
FULL = 2048                        # TinyLlama-1.1B's context length
# phase 25: the dry-run's probes and full-depth runs on the card, and the
# kernels at its lengths (prefill rows checked; ring positions)
DRY_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DRY_PROBES = ([("tinyllama-1.1b", s) for s in DRY_SHAPES]
              + [("qwen2-vl-7b", "prefill_32k"),
                 ("deepseek-v2-lite-16b", "long_500k"),
                 ("recurrentgemma-9b", "long_500k")]
              + [("whisper-large-v3", s) for s in DRY_SHAPES[:3]])
DRY_RUNS = ([("tinyllama-1.1b", s) for s in DRY_SHAPES]
            + [("recurrentgemma-9b", "long_500k"),
               ("deepseek-v2-lite-16b", "long_500k")])
LONG_S, LONG_ROWS, LONG_L, LONG_POS = 32768, 256, 32768, 524287
SWA_WINDOW = 4096
# 25d: per row, bf16 rounding is <= 2^-8 of the row's largest |value|;
# the phase checks that one dropped 64-key tile moves every row by more
REL_TOL, DROP_KEYS = 1e-2, 64
# the kernels' designs before their rebuild for the H100, at the phase-4
# shapes (PERF.md's kernel table: this script and, at L=2048,
# tools/torch_flash_bench.py on the older tree; H100 80GB HBM3, 700 W)
PREVIOUS_MS = {"flash_attention": 0.8635, "flash_decode": 0.0496,
               "flash_decode_2048": 0.1610, "flash_attention_train": 0.0850,
               "terngrad_compress": 1.5226}
TRAIN_SPEC, TRAIN_STEPS = "bsp/allreduce/onebit@4", 3
# phase 11: the launcher's flags (its defaults: batch 8 x seq 64, lr 3e-3)
LAUNCH_ARGV = ["--arch", "tinyllama-1.1b", "--steps", "3", "--optimizer",
               "adam", "--compress", "onebit", "--device", "cuda"]
BF16_GRAD_FACTOR = 1.25
# phase 12: examples/train_100m_e2e.py's trainer (its --lr default, 20
# warm-up steps)
TRAINER_LR, TRAINER_WARMUP = 6e-4, 20
TRAIN_B, TRAIN_S = 2, 256          # per-worker batch and sequence
# leaves of full-width TinyLlama-1.1B as the compressor encodes them
ONEBIT_SHAPES = ((2048, 32000), (123904, 2048), (45056, 5632), (22, 2048))
ONEBIT_FLOP_PER_ELEM = 5           # c_in (2), c_true, bin sum, new_e
ONEBIT_BYTES_PER_ELEM = 17         # read g, e; write sign, out, new_e
# the stacked w_down leaf (22 x 5632 x 2048) in the compressor's flat
# 256-lane layout, and one ring chunk of it per worker at @4
W_DOWN_ROWS, RING_ROWS = 991232, 247808
# per element: topk reads g, e and writes out, new_e; terngrad and qsgd
# read g, u and write one int8, and terngrad_compress and qsgd_compress
# read g once more for the reduction their output needs first (std, l2
# norm: g cannot stay in L2 between the two).  Operations: topk add, abs,
# compare, select, sub; terngrad clip (2), abs, divide, compare, sign,
# product; qsgd abs, divide, multiply, floor, sub, compare, add, clip (2),
# sign, product
SEGMENT_KERNELS = {"topk_compress": (16, 5), "terngrad_ternarize": (9, 5),
                   "terngrad_compress": (13, 7), "qsgd_compress": (13, 11)}
ONEBIT_COMPRESS_BYTES = 13         # read g, e; write sign, new_e (+4 B/row)
ONEBIT_COMPRESS_FLOP = 4           # c, |c|, row sum, new_e
MATRIX_RUNS = (("ssp:3/ps/onebit@4", {}, 2),
               ("asp/allreduce/none@4", {}, 2),
               ("sma/allreduce/none@4", {}, 2),
               ("bsp/ps/onebit@4", {"wire": "measured"}, 2))
# phase 13: the quickstart's decode (a seeded prompt, greedy tokens)
QUICK_PROMPT, QUICK_NEW = (4, 32), 16
# phase 14: benchmarks/serve_bench.py's traffic and engine knobs, and the
# virtual-clock columns of its tinyllama-1.1b rows in BENCH_pr7.json (the
# same for both cache layouts; they do not depend on the model)
BENCH_SLOTS, BENCH_MAX_LEN, BENCH_PROMPT = 4, 24, 5
BENCH_RATE, BENCH_HORIZON, BENCH_SEED = 0.6, 30.0, 0
BENCH_BUDGETS = (3, 6, 10, 14)
BENCH_PR7 = {"continuous": dict(p99_first_token=16.1775, generated_tokens=161,
                                clock=59.0, decode_iterations=43,
                                prefill_groups=16),
             "oneshot": dict(p99_first_token=37.1775, generated_tokens=161,
                             clock=80.0, decode_iterations=74,
                             prefill_groups=6)}
SERVE_SLO = "ttft_p99<8"
# phases 16-17: elastic plans (spec, plan, steps[, checkpoint_every]) and
# the SGD rates (at 0.1 the 2-layer model's last ssp events jump up and
# down; at 0.03 it descends smoothly, so the 4x bound compares two points
# of one curve)
ELASTIC_LR, REDUCED_LR = 0.1, 0.03
REDUCED_LAYERS = 2
ELASTIC_BACKUP = ("bsp+backup:1/allreduce/onebit@4",
                  "slow:w2x4@1,resize:3@3,resize:4@5", 7)
ELASTIC_CRASH = ("bsp/allreduce/none@4", "crash:w1@4,resize:4@5", 6, 3)
ELASTIC_RESTART = ("bsp/allreduce/onebit@4", "restart@3", 6)
ELASTIC_ACCEPT = ("ssp:2/ring/onebit@4", "crash:w2@5,resize:4@10", 15, 3)
# phase 18: the hybrid engine.  ZeRO AdamW at full width on 4 data slots,
# each repeating its batch (lr small enough for Adam's first, sign-sized
# steps on 1.1 B parameters); then the tiny transformer at TinyLlama's FFN
# widths on d2.t2.s2, each mesh with its analytic bubble and ticks
HYBRID_DATA, HYBRID_STEPS, HYBRID_LR = 4, 3, 1e-4
HYBRID_ZERO = ("bsp/ps/none@4:d4.z1.adamw", "bsp/ps/none@4:d4.z3.adamw")
HYBRID_ONEBIT = "bsp/ps/onebit@4:d4.z3.adamw"
# precision suffix and the kernel-against-plain loss bound: fp32 that of
# phase 7; bf16 ten times it (the kernel and the plain attention round
# their bf16 products in other places)
HYBRID_ONEBIT_TOL = (("", 1e-3), (".bf16", 1e-2))
HYBRID_TINY, HYBRID_ROWS = (4, 2048, 5632), 16
HYBRID_TINY_STEPS, HYBRID_TINY_LR = 4, 0.05
HYBRID_MESHES = (("bsp/ring/none@8:d2.t2.s2", 0.2, 5),
                 ("bsp/ring/none@8:d2.t2.s2.m8.1f1b", 0.0588, 17))
# phases 19-21: teacher-forced decode steps of the tp check and its fp32
# bound (TF32 off: only the order of the row-parallel sums differs); the
# MLA check's (prefill, decode) lengths and its fp32 bound (the full
# forward and the step-by-step decode sum in other orders); the vision
# forward's (batch, sequence, patch-grid side)
FORCED_STEPS, TP_F32_TOL = 16, 1e-3
MLA_SEQ, MLA_F32_TOL = (8, 8), 1e-3
VISION = (2, 256, 8)
# phases 22-24: RecurrentGemma's long prompt (past its 2048-token window)
# and its fp32 decode check (prefill, total length: the ring wraps in
# cache_from_prefill and again in decode); RWKV's traffic (requests,
# prompt, new tokens) and decode check; Whisper's utterances, greedy
# steps and start token (<|startoftranscript|>), the launcher step
RG_LONG, RG_CHECK, RWKV_CHECK = 2300, (2100, 2300), (48, 64)
RWKV_SERVE = (8, 512, 32)
RECURRENT_F32_TOL = 1e-3
WHISPER_UTTERANCES, WHISPER_STEPS, WHISPER_START = 4, 64, 50258
WHISPER_TRAIN_ARGV = ["--arch", "whisper-large-v3", "--layers", "2",
                      "--steps", "1", "--batch-size", "2"]
# spec, steps, the worker whose batch fetch sleeps, the sleep (s)
ELASTIC_DETECT = ("bsp+backup:1+detect/allreduce/onebit@4", 6, 1, 0.05)
SCHED_SPEC, SCHED_STEPS = "ssp:1/allreduce/none@2", 8
MEASURED_RUNS = (("bsp/ring/onebit@4", "measured", 3),
                 ("bsp/ring/terngrad@4", "measured", 2),
                 ("bsp/ring/qsgd@4", "measured", 2),
                 ("bsp/ring/dgc@4", "measured", 2),
                 ("bsp/allreduce/terngrad@4", "modeled", 2))
# phase 26: the worker axis over torch.distributed.  Phase 9's and phase
# 7's cells over Gloo ranks on the one card, as (ranks, layers; None =
# full depth): a full-width rank holds its replica, gradient, EF and the
# exchange's outputs at once, and 4 such ranks ran out of the card's 80 GB
# (PERF.md, phase 26), so 4 ranks at 2 layers, where the other codecs',
# the parameter server's, ASP's, SMA's and the backup workers' cells run
# too; 2 ranks run at 2 layers as well (at full depth their cells took
# ~45 s of the script's time on an H100 80GB HBM3 at 700 W, the SSP
# cell's 3 events 56.5 s before; PERF.md, phases 26 and 28; phases 27c
# and 28a keep 2 full-width ranks).  A cell
# is (spec, wire, global steps; None = TRAIN_STEPS).  The parameter
# server's and SMA's cells over ranks move the whole model through Gloo's
# host staging every step, and an SSP/ASP step is K push events that
# each do, so those cells take fewer steps.  The NCCL cell at world size
# device_count(); the 100M trainer over 2 ranks (its history logs steps
# 0 and 2).  fp32 with TF32 off: the
# ranks launch the logical engine's kernels on their own rows at the
# logical engine's shapes (each stochastic codec's scale from its own
# segment, kernels.segments.per_segment), so the losses agree to DIST_TOL
# and the terngrad and qsgd cells bit for bit
DIST_CELLS = (("bsp/ring/onebit@{k}", "measured", None),
              ("bsp/allreduce/onebit@{k}", "modeled", None),
              ("bsp/ps/onebit@{k}", "measured", 2))
DIST_SSP_CELLS = (("ssp:3/ps/onebit@{k}", "modeled", 1),)
DIST_CODEC_CELLS = (("bsp/ring/dgc@{k}", "measured", None),
                    ("bsp/ring/terngrad@{k}", "measured", None),
                    ("bsp/ring/qsgd@{k}", "measured", None),
                    ("bsp/ps/none@{k}", "modeled", 2),
                    ("bsp/ps/dgc@{k}", "measured", 2),
                    ("bsp/ps/qsgd@{k}", "measured", 2),
                    ("bsp/ps/terngrad@{k}", "modeled", 2),
                    ("bsp/ps/terngrad@{k}", "measured", 2),
                    ("asp/allreduce/none@{k}", "modeled", 1),
                    ("sma/allreduce/none@{k}", "modeled", 2),
                    ("bsp+backup:1/ring/onebit@{k}", "measured", 2))
DIST_RUNS = ((2, REDUCED_LAYERS, DIST_CELLS + DIST_SSP_CELLS),
             (4, REDUCED_LAYERS, DIST_CELLS + DIST_CODEC_CELLS))
# the kernel each (method, wire) cell must launch on every rank that
# computes: the measured codecs' hop kernels, the modeled roundtrip's
DIST_KERNEL = {("onebit", "measured"): "onebit_encode_ef",
               ("onebit", "modeled"): "onebit_encode_ef",
               ("dgc", "measured"): "topk_compress",
               ("terngrad", "measured"): "terngrad_ternarize",
               ("terngrad", "modeled"): "terngrad_compress",
               ("qsgd", "measured"): "qsgd_compress"}
# cells whose losses must equal the logical engine's bit for bit
DIST_BITWISE = ("terngrad", "qsgd")
DIST_NCCL_CELL = ("bsp/ring/onebit@{k}", "measured", None)
DIST_TOL = 1e-5
DIST_TOOL_ARGV = ["--strategy", "bsp/allreduce/onebit@2", "--steps", "3",
                  "--batch-size", "2", "--seq-len", "256"]
# phase 27: the elastic interface and the hybrid engine over ranks.
# Elastic cells (spec, plan, steps, snapshot cadence) at REDUCED_LAYERS
# over 4 ranks, and the full-depth restart over 2; the hybrid cells
# (spec, wire, steps): full width over 2 ranks, then the tiny transformer
# at TinyLlama's FFN widths (HYBRID_TINY) on 8 and 4 ranks
DIST_ELASTIC = (ELASTIC_CRASH, ELASTIC_RESTART + (6,))
DIST_RESTART = ("bsp/allreduce/onebit@2", "restart@2", 3, 3)
DIST_HYBRID_FULL = ("bsp/ps/onebit@2:d2.z3.adamw", "modeled", 2)
DIST_HYBRID_TINY = tuple((spec, "modeled", HYBRID_TINY_STEPS)
                         for spec, _, _ in HYBRID_MESHES) + (
    ("bsp/ps/dgc:0.05@4:d2.s2.z2", "measured", HYBRID_TINY_STEPS),)
# phase 28b: the hybrid engine's elastic interface over 4 ranks on the
# tiny transformer at TinyLlama's FFN widths, 2 layers (one per stage of
# d2.s2; each snapshot is written twice, by the ranks and the logical
# run), as (spec, plan, steps, snapshot cadence, lr)
HYBRID_ELASTIC_TINY = (2, 2048, 5632)
DIST_HYBRID_ELASTIC = (
    ("bsp/ps/onebit@4:d4.z3", "restart@2", 4, 2, HYBRID_TINY_LR),
    ("bsp/ps/none@4:d2.s2.z2.adamw", "crash:w1@3,resize:4@4", 5, 2, 1e-3))


def phase(name):
    print(f"\n== {name}", flush=True)


def timed_ms(fn, reps=20, host_bound=False):
    """Median CUDA-event time of one call, with the L2 flushed before each
    (the serving path reaches a kernel with other layers' data in L2).

    By default the stream first sleeps ~1 ms on the card, so the call is
    queued before its start event runs: the time is the device's alone.
    ``host_bound=True`` leaves the sleep out, so a call whose launch takes
    the host longer than the device's work measures the host."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if not host_bound:
            torch.cuda._sleep(2_000_000)      # clock cycles, ~1 ms
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def row_rel_err(a, b, dim):
    """Per slice of ``dim`` (a query row, a decode slot): the largest
    |a - b| over the slice's largest |b|."""
    a = a.float().movedim(dim, 0).flatten(1)
    b = b.float().movedim(dim, 0).flatten(1)
    return (a - b).abs().amax(1) / b.abs().amax(1)


def kernel_name(mangled):
    """kernel<template args> out of a mangled name (length-prefixed parts;
    a length may follow other digits, so every suffix of a run is tried)."""
    for m in re.finditer(r"\d+(?=[a-z])", mangled):
        for k in range(len(m.group())):
            end = m.end() + int(m.group()[k:])
            name = mangled[m.end():end]
            if name.endswith("_kernel") and mangled[end:end + 1] == "I":
                args = mangled[end + 1:mangled.index("EEv", end)]
                args = re.sub(r"Li(\d+)E", r"\1,",
                              args.replace("13__nv_bfloat16", "bf16,"))
                args = re.sub(r"^f", "float,", args).rstrip(",")
                return f"{name}<{args.replace(',', ', ')}>"
    return mangled


def kernel_resources(log):
    """(kernel<template args>, registers, spill line) for every kernel that
    ``nvcc -Xptxas -v`` reported in ``log``."""
    out, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
            spills = ""
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "registers" in line:
            out.append((name, re.search(r"Used (\d+) registers", line).group(1),
                        spills))
            name = None
    return out


def span_walls(events, names):
    """(name, begin args, wall seconds) of every span called one of
    ``names`` in a recorder's events, nested spans paired by their track's
    begin/end order."""
    stacks, out = {}, []
    for ev in events:
        key = (ev["pid"], ev["tid"])
        if ev["ph"] == "B":
            stacks.setdefault(key, []).append(ev)
        elif ev["ph"] == "E":
            b = stacks[key].pop()
            if b["name"] in names:
                out.append((b["name"], b["args"],
                            ev["args"]["wall_s"] - b["args"]["wall_s"]))
    return out


def elastic_phases(cfg, dev, smi, arrivals, horizon, burn_times,
                   seq=TRAIN_S, batch=TRAIN_B):
    """Phases 16-17 (module docstring): elastic training of ``cfg`` at full
    depth, then the rest of the elastic plane at ``REDUCED_LAYERS``
    layers, through ``Trainer.fit(plan=...)`` on ``dev`` (the CPU
    rehearses them at ``cfg.reduced()`` and a short ``seq``).  Returns the
    sub-runs' walls in seconds."""
    import numpy as np

    from repro_torch.core.sync import default_periods
    from repro_torch.core.tree import get_path, leaf_paths
    from repro_torch.data import LMDataConfig, make_lm_batches
    from repro_torch.elastic import EventPlan, drop_set, plan_from_sched_trace
    from repro_torch.models import build_model
    from repro_torch.obs.trace import tracing
    from repro_torch.sched import Cluster, make_trace, simulate
    from repro_torch.serve.autoscale import AutoscalePolicy, Autoscaler
    from repro_torch.train import Strategy, Trainer, value_and_grad

    cuda = dev.type == "cuda"
    f32 = torch.float32
    engines, watchers = [], []

    class Watched(Strategy):
        """A Strategy whose build hands the engine that fit_elastic drives
        to the ``watchers`` (they wrap its methods with checks)."""

        def build(self, grad_fn, layout=None, device="cuda", group=None):
            eng = Strategy.build(self, grad_fn, layout, device, group)
            for watch in watchers:
                watch(eng)
            engines.append(eng)
            return eng

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def leaves(tree):
        return [get_path(tree, q) for q in leaf_paths(tree)]

    def setup(layers):
        c = dataclasses.replace(cfg, num_layers=layers)
        m = build_model(c)
        params = m.init(seed=0, dtype=f32, device=dev)
        grad_fn = value_and_grad(
            lambda pp, b: m.loss_fn(pp, b, compute_dtype=f32))
        return params, grad_fn, m.leaf_layout(params)

    # the Markov chain over the reduced config's 512 token ids (as phase
    # 14's prompts): the random-init 32000-token model learns it from
    # fresh batches within a few steps, where over all 32000 ids a step
    # moves the loss less than one batch differs from the next
    batches = make_lm_batches(LMDataConfig(
        vocab_size=cfg.reduced().vocab_size, seq_len=seq, batch_size=batch),
        device=dev)
    walls = {}

    lr = ELASTIC_LR

    def fit(label, spec, model, steps, data=batches, **kw):
        """Trainer(Watched.parse(spec)).fit; prints the sub-run's wall and
        peak device memory; returns (params, history, metrics, engine)."""
        params, grad_fn, layout = model
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = Trainer(Watched.parse(spec, lr=lr), device=dev).fit(
            grad_fn, params, data, steps, layout=layout, **kw)
        sync()
        walls[label] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        h = out[1]
        plan = kw.get("plan")
        plan = "" if plan is None else getattr(plan, "spec", lambda: plan)()
        print(f"{label}: {spec} {plan} {steps} steps: wall "
              f"{walls[label]:.2f} s, peak device memory "
              f"{peak / 2**30:.2f} GiB; losses first {h[0]['loss']:.6f} "
              f"last {h[-1]['loss']:.6f} ({len(h)} records)")
        return out + (engines[-1],)

    # --------------------------------------------- 16 elastic, full depth
    phase(f"elastic training, full-width {cfg.name} ({cfg.num_layers} "
          "layers), fp32")
    model = setup(cfg.num_layers)
    spec, plan, steps = ELASTIC_BACKUP
    log = []

    def watch_backup(eng):
        inner, step0, reshard0 = eng.inner, eng.step, eng.reshard

        def step(st, b, t):
            want = sorted(drop_set(inner.periods, inner.cfg.backup,
                                   inner.slowdowns))
            kept = [[x.clone() for x in st["ef"][w]] for w in want]
            st, evs = step0(st, b, t)
            log.append(dict(t=t, want=want, got=evs[0].get("dropped"),
                            kept=all(torch.equal(x, y) for w, rows in
                                     zip(want, kept)
                                     for x, y in zip(st["ef"][w], rows))))
            return st, evs

        def reshard(st, new_workers, step=0, lost=()):
            slots = [w for w in range(inner.cfg.num_workers)
                     if w not in lost][:new_workers]
            rows = [(list(st["ef"][s]), [x.clone() for x in st["ef"][s]])
                    for s in slots]
            st = reshard0(st, new_workers, step=step, lost=lost)
            log.append(dict(
                reshard=new_workers, grown=new_workers - len(slots),
                same=all(a is b and torch.equal(a, c)
                         for i, (r, cl) in enumerate(rows)
                         for a, b, c in zip(st["ef"][i], r, cl)),
                zero=all(not x.any() for row in st["ef"][len(slots):]
                         for x in row)))
            return st

        eng.step, eng.reshard = step, reshard

    watchers[:] = [watch_backup]
    _, hist, mets, eng = fit("16a", spec, model, steps, plan=plan)
    steps_log = [x for x in log if "t" in x]
    reshards = [x for x in log if "reshard" in x]
    losses = [h["loss"] for h in hist]
    print(f"dropped per step {[x['got'] for x in steps_log]} (drop_set over "
          f"the engine's periods and slowdowns "
          f"{[x['want'] for x in steps_log]}); dropped workers' EF bitwise "
          f"unchanged {[x['kept'] for x in steps_log]}; reshards "
          f"{[(x['reshard'], x['same'], x['zero']) for x in reshards]} "
          f"(to, survivors' EF the same tensors bitwise, grown slots "
          f"zero); dropped_updates {mets['dropped_updates']}, resizes "
          f"{mets['resizes']}, final_workers {mets['final_workers']}; "
          f"losses {losses}")
    assert [x["got"] for x in steps_log] == [x["want"] for x in steps_log]
    assert all(x["kept"] for x in steps_log) and len(steps_log) == steps
    assert mets["dropped_updates"] == steps
    assert mets["resizes"] == 2 and mets["final_workers"] == 4
    assert [x["reshard"] for x in reshards] == [3, 4]
    assert all(x["same"] and x["zero"] for x in reshards)
    assert sum(x["grown"] for x in reshards) == 1
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    watchers.clear()
    del eng
    engines.clear()

    spec, plan, steps, every = ELASTIC_CRASH
    rstep = int(plan.split("@")[1].split(",")[0]) - 1
    at_commit, stamps = [], []

    def watch_restore(eng):
        """Host copies of the parameters each time step ``rstep`` starts
        (at its commit, and after the rollback), and the restore's
        wall: the engine's init (the template) to its import_state."""
        step0, init0, import0 = eng.step, eng.init, eng.import_state

        def step(st, b, t):
            if t == rstep:
                at_commit.append([x.detach().to("cpu", copy=True)
                                  for x in leaves(st["params"])])
            return step0(st, b, t)

        def init(params):
            stamps.append(time.perf_counter())
            return init0(params)

        def import_state(arrays, meta):
            st = import0(arrays, meta)
            sync()
            stamps.append(time.perf_counter() - stamps.pop())
            return st

        eng.step, eng.init, eng.import_state = step, init, import_state

    watchers[:] = [watch_restore]
    ckdir = tempfile.mkdtemp(prefix="chip-smoke-elastic-")
    try:
        with tracing() as rec:
            _, hist, mets, eng = fit("16b", spec, model, steps, plan=plan,
                                     checkpoint_dir=ckdir,
                                     checkpoint_every=every)
    finally:
        watchers.clear()
        shutil.rmtree(ckdir, ignore_errors=True)
    (r,) = mets["recoveries"]
    spans = span_walls(rec.events, ("snapshot", "recovery", "resize"))
    saves = [(a["step"], a["mode"], a["dispatch"], w) for n, a, w in spans
             if n == "snapshot"]
    equal = len(at_commit) == 2 and all(
        torch.equal(x, y) for x, y in zip(*at_commit))
    gib = sum(x.numel() * 4 for x in at_commit[0]) / 2**30
    print(f"recovery {r}; executed_steps {mets['executed_steps']}, "
          f"final_workers {mets['final_workers']}; parameters restored at "
          f"step {rstep} bitwise equal to the host copy at its commit: "
          f"{equal}; host disk ({gib:.2f} GiB of fp32 parameters per "
          f"snapshot): snapshot spans (step, mode, dispatch, s; an async "
          f"one times the device-to-host copy and dispatch) "
          f"{[(s, m, d, round(w, 2)) for s, m, d, w in saves]}, the "
          f"rollback's restore {stamps[-1]:.2f} s within a recovery span "
          f"of {sum(w for n, _, w in spans if n == 'recovery'):.2f} s "
          f"(it joins the step-{rstep} write first), resize spans "
          f"{[round(w, 2) for n, _, w in spans if n == 'resize']} s; "
          f"losses {[h['loss'] for h in hist]}; card {smi}")
    assert r["kind"] == "crash" and r["restored_step"] == rstep
    assert r["lost_steps"] == 1 and equal and len(stamps) == 2
    assert mets["executed_steps"] == steps + 1
    assert mets["final_workers"] == 4 and mets["resizes"] == 1
    assert all(math.isfinite(h["loss"]) for h in hist)
    del model, eng, at_commit
    engines.clear()
    if cuda:
        torch.cuda.empty_cache()

    # ------------------------------------------ 17 the rest, reduced depth
    phase(f"elastic plane at {REDUCED_LAYERS} layers, full widths")
    model = setup(REDUCED_LAYERS)
    lr = REDUCED_LR
    spec, plan, steps = ELASTIC_RESTART
    p_u, h_u, _, _ = fit("17c uninterrupted", spec, model, steps)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-elastic-") as d:
        p_r, h_r, m_r, _ = fit("17c", spec, model, steps, plan=plan,
                               checkpoint_dir=d)
    same_params = all(torch.equal(x, y) for x, y in zip(leaves(p_u),
                                                         leaves(p_r)))
    print(f"restart: recoveries {m_r['recoveries']}; losses equal "
          f"{[h['loss'] for h in h_u] == [h['loss'] for h in h_r]}, "
          f"parameters bitwise equal {same_params}")
    assert [h["loss"] for h in h_u] == [h["loss"] for h in h_r]
    assert same_params and len(m_r["recoveries"]) == 1
    assert m_r["recoveries"][0]["lost_steps"] == 0
    del p_u, p_r

    spec, plan, steps, every = ELASTIC_ACCEPT
    _, h_u, _, _ = fit("17d uninterrupted", spec, model, steps)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-elastic-") as d:
        _, h_e, m_e, _ = fit("17d", spec, model, steps, plan=plan,
                             checkpoint_dir=d, checkpoint_every=every)
    (r,) = m_e["recoveries"]
    first, lu, le = h_e[0]["loss"], h_u[-1]["loss"], h_e[-1]["loss"]
    print(f"acceptance: recovery {r}; resizes {m_e['resizes']}, "
          f"final_workers {m_e['final_workers']}; final loss {le:.6f} "
          f"(uninterrupted {lu:.6f}, bound 4x; first {first:.6f})")
    assert r["kind"] == "crash" and m_e["resizes"] == 1
    assert m_e["final_workers"] == 4
    assert le <= 4 * lu and le < first

    spec, steps, slow, delay = ELASTIC_DETECT

    def slow_batches(t, w):
        if w == slow:
            time.sleep(delay)
        return batches(t, w)

    _, h_d, m_d, eng = fit("17e", spec, model, steps, data=slow_batches)
    drops = [h["dropped"] for h in h_d]
    slowdowns = [1.0] * 4
    slowdowns[slow] = 4.0
    sched = sorted(drop_set(default_periods(4), 1, slowdowns))
    factors = [round(f, 2) for f in eng.inner.detector.factors()]
    print(f"detection: dropped per step {drops}; detector ready "
          f"{eng.inner.detector.ready}, measured factors {factors}; the "
          f"drop set slow:w{slow}x4 schedules {sched}")
    assert drops[:2] == [[3], [3]] and all(x == sched for x in drops[2:])
    del eng
    engines.clear()

    jobs = make_trace(12, 8, seed=3, mean_interarrival=20.0)
    res = simulate(jobs, Cluster(n_nodes=2, gpus_per_node=4), "fifo",
                   gandiva=True, elastic=True)
    splan = None
    for j in jobs:
        full = plan_from_sched_trace(res.trace, j.jid, steps_per_sec=0.005)
        due = [e for e in full if e.step < SCHED_STEPS
               and (e.kind != "resize" or e.workers <= 2)]
        if due:
            splan = EventPlan(due[:2])
            break
    assert splan is not None
    with tempfile.TemporaryDirectory(prefix="chip-smoke-elastic-") as d:
        _, h_s, m_s, _ = fit("17f", SCHED_SPEC, model, SCHED_STEPS,
                             plan=splan, checkpoint_dir=d,
                             checkpoint_every=2)
    auto_plan, decisions = Autoscaler(AutoscalePolicy(
        replica_rate=0.5)).plan(arrivals, horizon, burn_times=burn_times)
    print(f"scheduler: {len(res.trace)} allocation events, job {j.jid}'s "
          f"plan {splan.spec()}: recoveries {len(m_s['recoveries'])}, "
          f"resizes {m_s['resizes']}, final_workers "
          f"{m_s['final_workers']}; autoscaler over {len(arrivals)} "
          f"arrivals with burn times {burn_times}: decisions "
          f"{[(d.t, round(d.rate, 3), d.replicas) for d in decisions]}, "
          f"plan {auto_plan.spec()!r}")
    assert all(math.isfinite(h["loss"]) for h in h_s)
    assert len(m_s["recoveries"]) + m_s["resizes"] == len(splan)
    assert decisions[0].replicas == 1
    del model
    if cuda:
        torch.cuda.empty_cache()
    print(f"walls (s) {dict((k, round(v, 2)) for k, v in walls.items())}; "
          f"card {smi}")
    return walls


def hybrid_phases(cfg, dev, smi, seq=TRAIN_S, batch=TRAIN_B,
                  tiny=HYBRID_TINY, rows=HYBRID_ROWS):
    """Phase 18 (module docstring): the hybrid engine through
    ``Strategy.parse`` and ``Trainer.fit`` on ``dev``: ZeRO-1/3 AdamW and
    onebit ZeRO-3 on ``cfg`` at full depth, then the tensor and stage
    axes on the tiny transformer at ``tiny`` = (layers, d_model, d_ff)
    against its stacked reference (the CPU rehearses them at
    ``cfg.reduced()``, a short ``seq`` and a small ``tiny``)."""
    from repro_torch.core import pipeline as PL
    from repro_torch.core.tree import tree_map
    from repro_torch.data import LMDataConfig, make_lm_batches
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import onebit as K1
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.parallel import (make_tiny_transformer,
                                      stacked_grad_fn,
                                      state_bytes_per_device)
    from repro_torch.train import Strategy, Trainer, value_and_grad

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    class Captured(Strategy):
        """A Strategy whose engine reports its state and plan at
        ``finalize`` (Trainer.fit's last call into it)."""

        def build(self, grad_fn, layout=None, device="cuda", group=None):
            eng = Strategy.build(self, grad_fn, layout, device, group)
            fin = eng.finalize

            def finalize(st):
                info.update(state=eng.inner.per_device_state_bytes(st),
                            plan=eng.inner.plan)
                return fin(st)
            eng.finalize = finalize
            return eng

    def fit(label, spec, model, params, data, steps, lr, layout=None,
            **kw):
        """Captured.parse(spec, **kw) through Trainer.fit; step walls are
        read where the engine asks for data slot 0's batch, after a
        synchronize.  Returns (params, losses, info)."""
        info.clear()
        marks = []

        def timed(t, w):
            if w == 0:
                sync()
                marks.append(time.perf_counter())
            return data(t, w)

        sync()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        p, hist, mets = Trainer(Captured.parse(spec, lr=lr, **kw),
                                device=dev).fit(model, params, timed, steps,
                                                layout=layout)
        sync()
        marks.append(time.perf_counter())
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        losses = [h["loss"] for h in hist]
        ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
        info.update(mets=mets, ms=ms, peak=peak)
        print(f"{label} {spec}, {steps} steps: losses "
              f"{[round(x, 6) for x in losses]}; step walls "
              f"{[round(x, 1) for x in ms]} ms; peak device memory "
              f"{peak / 2**30:.2f} GiB")
        return p, losses, dict(info)

    info = {}
    # --------------------------- 18a/b: ZeRO on the full-width model
    phase(f"hybrid: ZeRO-1/3 AdamW, full-width {cfg.name} "
          f"({cfg.num_layers} layers), {HYBRID_DATA} data slots")
    m = build_model(cfg)
    params = m.init(seed=0, dtype=torch.float32, device=dev)
    layout = m.leaf_layout(params)
    lm = make_lm_batches(LMDataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=seq, batch_size=batch),
                         device=dev)
    fixed = [lm(0, w) for w in range(HYBRID_DATA)]

    def same(t, w):
        return fixed[w]

    def grad_fn(model, spec):
        """The model's loss in the compute dtype ``spec``'s precision
        names (bf16 for .bf16 / .bf16r, on the engine's fp32 masters)."""
        dtype = (torch.float32 if Strategy.parse(spec).precision == "fp32"
                 else torch.bfloat16)
        return value_and_grad(lambda pp, b: model.loss_fn(
            pp, b, compute_dtype=dtype))

    def launches():
        return dict(FA.LAUNCHES), dict(K1.LAUNCHES)

    # the plain data-parallel reference: the data slots' mean gradient and
    # one AdamW step (optim.adam) over the whole tree, no mesh and no ZeRO,
    # on the plain attention
    ref_m = build_model(dataclasses.replace(cfg, attn_backend="ref"))
    gf, adam = grad_fn(ref_m, HYBRID_ZERO[0]), AdamW()
    before = launches()
    ref_p = tree_map(torch.clone, params)
    opt, plain = adam.init(ref_p), []
    for _ in range(HYBRID_STEPS):
        acc, ls = None, []
        for w in range(HYBRID_DATA):
            loss, g = gf(ref_p, fixed[w])
            ls.append(float(loss))
            acc = g if acc is None else tree_map(torch.Tensor.add_, acc, g)
            del g
        adam.step(ref_p, tree_map(lambda a: a.div_(HYBRID_DATA), acc), opt,
                  HYBRID_LR)
        plain.append(sum(ls) / HYBRID_DATA)
        del acc
    del ref_p, opt
    assert launches() == before, "plain path ran a kernel"
    print(f"18a plain AdamW over the mean gradient of {HYBRID_DATA} slots "
          f"(plain attention, no kernel launched), {HYBRID_STEPS} steps: "
          f"losses {[round(x, 6) for x in plain]}")

    zero_losses = {}
    for spec in HYBRID_ZERO:
        p, losses, inf = fit("18a", spec, grad_fn(m, spec),
                             params, same, HYBRID_STEPS, HYBRID_LR, layout)
        del p      # the run's parameters leave before the next run's peak
        st = Strategy.parse(spec)
        want = state_bytes_per_device(inf["plan"], st.zero, st.optimizer,
                                      st.moments)
        got = inf["state"]
        print(f"  per_device_state_bytes {got}; state_bytes_per_device "
              f"{want} (opt + the 4 B step count)")
        assert got["params"] == want["params"]
        assert got["opt"] == want["opt"] + 4
        assert all(math.isfinite(x) for x in losses)
        zero_losses[spec] = losses
        gap = max(abs(a - b) for a, b in zip(losses, plain))
        print(f"  against plain AdamW: loss gap {gap:.3e} (bound 1e-4)")
        assert gap <= 1e-4
    gap = max(abs(a - b) for a, b in zip(*zero_losses.values()))
    print(f"  z1-z3 loss gap {gap:.3e} (bound 1e-4)")
    assert gap <= 1e-4

    phase(f"hybrid: {HYBRID_ONEBIT}, fp32 and bf16, full-width {cfg.name}")
    for suffix, tol in HYBRID_ONEBIT_TOL:
        spec = HYBRID_ONEBIT.replace(".adamw", suffix + ".adamw")
        p, losses, inf = fit("18b", spec, grad_fn(m, spec), params,
                             same, HYBRID_STEPS, HYBRID_LR, layout)
        del p
        print(f"  warm step wall {statistics.mean(inf['ms'][1:]):.1f} ms")
        assert all(math.isfinite(x) for x in losses)
        assert losses[-1] < losses[0]
        # the same run on the plain path: no kernel launched
        before = launches()
        p, plain, _ = fit("18b plain path", spec, grad_fn(ref_m, spec),
                          params, same, HYBRID_STEPS, HYBRID_LR, layout,
                          kernel_backend="ref")
        del p
        assert launches() == before, "plain path ran a kernel"
        gap = max(abs(a - b) for a, b in zip(losses, plain))
        print(f"  |kernel - plain| loss gap {gap:.3e} (bound {tol})")
        assert gap <= tol
    del params, fixed, m, ref_m
    # ---------------------- 18c: the tensor and stage axes, tiny model
    layers, d_model, d_ff = tiny
    phase(f"hybrid: d2.t2.s2 GPipe and 1F1B, make_tiny_transformer("
          f"{layers}, d_model={d_model}, d_ff={d_ff}), {rows} rows per slot")
    params, model = make_tiny_transformer(layers, d_model, d_ff, seed=0,
                                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    w_t = torch.randn(d_model, d_model, generator=gen, device=dev) \
        / math.sqrt(d_model)
    xs = [[torch.randn(rows, d_model, generator=gen, device=dev)
           for _ in range(2)] for _ in range(HYBRID_TINY_STEPS)]
    tiny_batches = [[{"x": x, "y": torch.tanh(x @ w_t)} for x in row]
                    for row in xs]

    def tiny_data(t, w):
        return tiny_batches[t][w]

    # the stacked reference: both slots' rows through the unpipelined,
    # unsharded model, SGD on the mean gradient
    ref_p, ref_losses = dict(params), []
    gf = stacked_grad_fn(model)
    for t in range(HYBRID_TINY_STEPS):
        cat = {k: torch.cat([tiny_data(t, w)[k] for w in range(2)])
               for k in ("x", "y")}
        loss, g = gf(ref_p, cat)
        ref_losses.append(float(loss))
        ref_p = {k: ref_p[k] - HYBRID_TINY_LR * g[k] for k in ref_p}
    for spec, bubble, ticks in HYBRID_MESHES:
        p, losses, inf = fit("18c", spec, model, params, tiny_data,
                             HYBRID_TINY_STEPS, HYBRID_TINY_LR)
        plan, v = inf["plan"], inf["mets"].get("interleave", 1)
        if ".1f1b" in spec:
            got_b = PL.onefb_bubble_fraction(2, plan.micro, v)
            got_t = PL.onefb_ticks(2, plan.micro, v)
        else:
            got_b = PL.bubble_fraction(2, plan.micro)
            got_t = PL.gpipe_ticks(2, plan.micro)
        dl = max(abs(a - b) for a, b in zip(losses, ref_losses))
        dp = max(float((p[k] - ref_p[k]).abs().max()) for k in p)
        print(f"  micro {plan.micro}, v {v}: analytic_bubble "
              f"{round(got_b, 4)}, modeled_step_ticks {got_t}; against the "
              f"stacked reference: losses {dl:.3e}, parameters {dp:.3e} "
              f"(bound 1e-4; TF32 off)")
        assert (round(got_b, 4), got_t) == (bubble, ticks)
        assert dl <= 1e-4 and dp <= 1e-4
        del p
    del params, ref_p, tiny_batches
    if cuda:
        torch.cuda.empty_cache()
    print(f"card {smi}")


def _record_decode(eng, dev, vocab):
    """Wrap a ServeEngine's decode iterations and ``transformer.
    decode_step`` (the tensor-parallel path's): returns (each decode
    iteration's ms, synchronized; the first step's logits [B, vocab] on
    the host once they exist; the wrapped ``decode_step``, which the
    caller puts back)."""
    from repro_torch.models import transformer as T
    walls, first = [], []
    step = T.decode_step
    decode = eng._decode_iteration

    def timed():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        decode()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        walls.append(1e3 * (time.perf_counter() - t0))

    def capture(*args, **kw):
        lg, caches = step(*args, **kw)
        if not first:
            first.append(lg[:, 0, :vocab].float().cpu())
        return lg, caches

    eng._decode_iteration = timed
    T.decode_step = capture
    return walls, first, step


def family_phases(dev, smi, tiny, deepseek, qwen, prompt=PROMPT, new=NEW,
                  n_requests=16, slots=8, page=16, forced=FORCED_STEPS,
                  mla_seq=MLA_SEQ, vision=VISION, only_tp=False):
    """Phases 19-21 (module docstring) on ``dev``: tensor-parallel decode
    of ``tiny`` at tp=2, ``deepseek`` (MoE + MLA) and ``qwen`` (M-RoPE,
    biases, the vision stub) through ``ServeEngine`` on phase 5's traffic
    (``n_requests`` prompts of ``prompt`` tokens, ``new`` new tokens,
    ``slots`` slots, pages of ``page``).  The CPU rehearses them at the
    configs' ``.reduced()`` and a short traffic.  Returns each phase's
    launches of the flash kernels, and what phase 28a holds its ranks to
    (phase 19's traffic, its logical tp=2 tokens and first decode step's
    logits, the tp=1 tokens, both runs' decode-iteration ms).
    ``only_tp``: phase 19's serving runs alone (no teacher forcing, no
    20-21)."""
    import numpy as np

    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.serve.cache import cache_bytes as nbytes
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.request import Request
    from repro_torch.serve.tp import TPContext
    from repro_torch.train import value_and_grad

    cuda = dev.type == "cuda"
    bf, f32 = torch.bfloat16, torch.float32
    launches = {}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def free():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0

    def serve(model, params, prompts, tp=1):
        """Phase 5's traffic through ServeEngine (bf16, continuous, paged):
        (metrics with each decode iteration's ms under "iter_ms" and the
        first decode step's logits under "first_logits", requests, flash
        launches of the run, engine)."""
        scfg = ServeConfig(slots=slots, max_len=prompt + new, page_size=page,
                           policy="continuous", cache_dtype=bf,
                           compute_dtype=bf, tp=tp)
        ServeEngine(model, params, scfg, device=dev).run(
            [Request(rid=i, prompt=[int(t) for t in prompts[i, :16]],
                     max_new_tokens=2) for i in range(2)])     # warm-up
        reqs = [Request(rid=i, prompt=[int(t) for t in prompts[i]],
                        max_new_tokens=new) for i in range(n_requests)]
        eng = ServeEngine(model, params, scfg, device=dev)
        walls, first, step = _record_decode(eng, dev, model.cfg.vocab_size)
        sync()
        FA.reset_launches()
        try:
            m = eng.run(reqs)
        finally:
            T.decode_step = step
        m.update(iter_ms=walls, first_logits=first[0] if first else None)
        got = dict(FA.LAUNCHES)
        assert m["completed"] == n_requests
        assert m["generated_tokens"] == n_requests * new
        assert all(0 <= t < model.cfg.vocab_size for r in reqs
                   for t in r.output)
        print(f"  {m['completed']} requests, {m['generated_tokens']} tokens "
              f"in {m['wall_s']:.3f} s wall = "
              f"{m['generated_tokens'] / m['wall_s']:.1f} tokens/s; "
              f"{m['prefill_groups']} prefill groups, "
              f"{m['decode_iterations']} decode iterations; launches {got}")
        return m, reqs, got, eng

    # ------------------------------------------------------- 19 tp decode
    phase(f"19 tensor-parallel decode: {tiny.name}, bf16, tp=2 on one "
          "device (2 logical ranks)")
    model = build_model(tiny)
    params = model.init(seed=0, dtype=bf, device=dev)
    L = tiny.num_layers
    prompts = np.random.RandomState(1).randint(1, tiny.vocab_size,
                                               size=(n_requests, prompt))
    print("  tp=1 (phase 5's run):")
    m1, reqs1, got1, _ = serve(model, params, prompts)
    print("  tp=2:")
    m2, reqs2, got2, _ = serve(model, params, prompts, tp=2)
    launches["tp_serve"] = got2
    equal = sum(a == b for r1, r2 in zip(reqs1, reqs2)
                for a, b in zip(r1.output, r2.output))
    print(f"  greedy streams tp=2 vs tp=1: {equal}/{n_requests * new} tokens "
          f"equal, {sum(r1.output == r2.output for r1, r2 in zip(reqs1, reqs2))}"
          f"/{n_requests} requests equal; flash_decode per decode iteration "
          f"{got2['flash_decode'] / m2['decode_iterations']:.0f} at tp=2, "
          f"{got1['flash_decode'] / m1['decode_iterations']:.0f} at tp=1")
    if cuda:
        assert got2["flash_attention"] == m2["prefill_groups"] * L > 0
        assert got2["flash_decode"] == 2 * m2["decode_iterations"] * L > 0
        assert got1["flash_decode"] == m1["decode_iterations"] * L
    tp_ref = dict(
        traffic=dict(prompt=prompt, new=new, n_requests=n_requests,
                     slots=slots, page=page), prompts=prompts,
        outputs=[r.output for r in reqs2],
        tp1_outputs=[r.output for r in reqs1],
        first_logits=m2["first_logits"],
        iter_ms=statistics.median(m2["iter_ms"]),
        tp1_iter_ms=statistics.median(m1["iter_ms"]),
        tokens_per_s=m2["generated_tokens"] / m2["wall_s"])
    print(f"  decode iteration ms (median, synchronized): tp=1 "
          f"{tp_ref['tp1_iter_ms']:.1f}, tp=2 logical "
          f"{tp_ref['iter_ms']:.1f}")
    if only_tp:
        del model, params
        free()
        return launches, tp_ref

    # teacher forcing on phase 5's stream: the first prefill group, then
    # ``forced`` decode steps fed the tp=1 run's served tokens
    toks = torch.tensor(prompts[:slots], device=dev)
    forced_toks = torch.tensor([r.output[:forced] for r in reqs1[:slots]],
                               device=dev)

    def teacher_forced(p_, dtype, tp):
        _, st = model.prefill(p_, toks, compute_dtype=dtype)
        caches = model.cache_from_prefill(st, prompt + new, dtype=dtype)
        cfg_, kw = tiny, {}
        if tp > 1:
            ctx = TPContext(tiny, tp)
            p_, cfg_ = ctx.shard_params(p_), ctx.cfg_local
            caches, kw = ctx.shard_cache(caches), dict(tp_axis="model")
        out = []
        for s in range(forced):
            pos = torch.full((slots,), prompt + s, device=dev)
            lg, caches = T.decode_step(p_, cfg_, caches,
                                       forced_toks[:, s:s + 1], pos,
                                       compute_dtype=dtype, **kw)
            out.append(lg[:, 0, :tiny.vocab_size].float())
        return torch.stack(out)

    b1, b2 = teacher_forced(params, bf, 1), teacher_forced(params, bf, 2)
    p32 = tree_map(lambda t: t.float(), params)
    del params
    f1, f2 = teacher_forced(p32, f32, 1), teacher_forced(p32, f32, 2)
    del p32
    e32 = float((f2 - f1).abs().max())
    e16, e_ref = float((b2 - b1).abs().max()), float((b1 - f1).abs().max())
    agree = float((b2.argmax(-1) == b1.argmax(-1)).float().mean())
    print(f"  teacher-forced on phase 5's stream, {forced} decode steps x "
          f"{slots} slots: fp32 (TF32 off) max|tp2 - tp1| {e32:.3e} (bound "
          f"{TP_F32_TOL}); bf16 max|tp2 - tp1| {e16:.4f} (bound 2 x bf16's "
          f"own distance from fp32, max|tp1 bf16 - tp1 fp32| = "
          f"{e_ref:.4f}); bf16 argmax agreement tp2/tp1 {agree:.4f}")
    assert torch.isfinite(b2).all() and torch.isfinite(f2).all()
    assert e32 <= TP_F32_TOL, "tp=2 fp32 logits drift from tp=1"
    assert e16 <= 2 * e_ref, "tp=2 bf16 logits drift from tp=1"
    del model, b1, b2, f1, f2
    free()

    # ---------------------------------------------------- 20 MoE + MLA
    phase(f"20a {deepseek.name} at 2 layers (dense layer 0 + one MoE "
          "layer), all widths, fp32, capacity_factor = num_experts")
    E, K = deepseek.num_experts, deepseek.experts_per_token
    cfg2 = dataclasses.replace(deepseek, num_layers=2,
                               capacity_factor=float(E))
    model = build_model(cfg2)
    params = model.init(seed=0, dtype=f32, device=dev)
    B2, S2, S0 = 2, sum(mla_seq), mla_seq[0]
    toks = torch.tensor(np.random.RandomState(2).randint(
        1, cfg2.vocab_size, size=(B2, S2 + 1)), device=dev)
    full, aux, _ = model.forward(params, toks[:, :S2], compute_dtype=f32)
    lg, st = model.prefill(params, toks[:, :S0], compute_dtype=f32)
    caches = model.cache_from_prefill(st, S2, dtype=f32)
    errs = [float((lg[:, 0] - full[:, S0 - 1]).abs().max())]
    for t in range(S0, S2):
        lg, caches = model.decode_step(params, caches, toks[:, t:t + 1],
                                       torch.full((B2,), t, device=dev),
                                       compute_dtype=f32)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    print(f"  prefill {S0} tokens then {S2 - S0} decode steps through the "
          f"latent cache against the full forward's logits (B={B2}): max "
          f"abs err {max(errs):.3e} (bound {MLA_F32_TOL}; |logits| <= "
          f"{float(full.abs().max()):.2f}); aux {float(aux):.5f}")
    assert max(errs) <= MLA_F32_TOL, "decode drifts from the full forward"
    routed = []
    real = T.moe_apply

    def record(p, x, cfg_, per_row=False):
        probs = torch.softmax(x.detach().float().reshape(-1, x.shape[-1])
                              @ p["router"]["w"].detach(), -1)
        routed.append(torch.topk(probs, K, -1).indices.flatten())
        return real(p, x, cfg_, per_row)

    T.moe_apply = record
    try:
        loss, grads = value_and_grad(
            lambda pp, b: model.loss_fn(pp, b, compute_dtype=f32))(
                params, {"tokens": toks[:, :S2], "labels": toks[:, 1:]})
    finally:
        T.moe_apply = real
    used = torch.zeros(E, dtype=torch.bool, device=dev)
    used[torch.cat(routed)] = True
    g = grads["layers"][1]["moe"]
    touched = torch.stack([g[n].flatten(1).abs().sum(1)
                           for n in ("w_gate", "w_up", "w_down")]).amin(0) > 0
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (g["router"]["w"], g["w_gate"], g["w_up"], g["w_down"]))
    print(f"  value_and_grad(loss_fn): loss {float(loss):.5f}; router "
          f"gradient |g| sum {float(g['router']['w'].abs().sum()):.4e}; "
          f"{int(used.sum())} of {E} experts received tokens, every one "
          f"with a nonzero gradient {bool(touched[used].all())}, the "
          f"others zero {not bool(touched[~used].any())}; all finite "
          f"{finite}; peak {peak_gib():.2f} GiB")
    assert finite and float(g["router"]["w"].abs().sum()) > 0
    assert bool(touched[used].all()) and not bool(touched[~used].any())
    del params, grads, g, full, caches, st
    free()

    phase(f"20b {deepseek.name}: all {deepseek.num_layers} layers, bf16, "
          f"capacity_factor {deepseek.capacity_factor}, through ServeEngine")
    model = build_model(deepseek)
    t0 = time.perf_counter()
    params = model.init(seed=0, dtype=bf, device=dev)
    sync()
    print(f"  {deepseek.param_count() / 1e9:.3f} B parameters "
          f"({deepseek.active_param_count() / 1e9:.3f} B active per token), "
          f"seeded init in {time.perf_counter() - t0:.2f} s")
    prompts = np.random.RandomState(1).randint(1, deepseek.vocab_size,
                                               size=(n_requests, prompt))
    m, reqs, got, eng = serve(model, params, prompts)
    launches["deepseek"] = got
    pool_tokens = eng.kv.allocator.num_pages * page
    per_token = nbytes(eng.kv.store) / pool_tokens
    want = (deepseek.kv_lora_rank + deepseek.qk_rope_dim) * 2 * \
        deepseek.num_layers
    print(f"  MLA cache {per_token:.0f} B per token (want ("
          f"{deepseek.kv_lora_rank} + {deepseek.qk_rope_dim}) x 2 B x "
          f"{deepseek.num_layers} = {want}); pool {nbytes(eng.kv.store) / 2**20:.1f} "
          f"MiB; peak {peak_gib():.2f} GiB (params {nbytes(params) / 2**30:.2f}"
          f" GiB); req 0 output[:8] {reqs[0].output[:8]}; card {smi}")
    assert per_token == want
    del params, eng, model
    free()

    # ------------------------------------------------------- 21 Qwen2-VL
    phase(f"21 {qwen.name}: bf16 through ServeEngine, and forward with "
          "vision embeddings and three M-RoPE position rows")
    model = build_model(qwen)
    ref_model = build_model(dataclasses.replace(qwen, attn_backend="ref"))
    params = model.init(seed=0, dtype=bf, device=dev)
    print(f"  {qwen.param_count() / 1e9:.3f} B parameters")
    prompts = np.random.RandomState(1).randint(1, qwen.vocab_size,
                                               size=(n_requests, prompt))
    m, reqs, got, _ = serve(model, params, prompts)
    Lq = qwen.num_layers
    if cuda:
        assert got["flash_attention"] == m["prefill_groups"] * Lq > 0
        assert got["flash_decode"] == m["decode_iterations"] * Lq > 0
    # the vision stub: P patch embeddings on a side x side grid at t=0,
    # then text positions from side on (all three rows equal)
    Bv, Sv, side = vision
    P = side * side
    gen = torch.Generator(device=dev).manual_seed(3)
    v_emb = 0.02 * torch.randn(Bv, P, qwen.d_model, generator=gen, device=dev)
    grid = torch.arange(P, device=dev)
    text = side + torch.arange(Sv - P, device=dev)
    pos3 = torch.stack([torch.cat([torch.zeros_like(grid), text]),
                        torch.cat([grid // side, text]),
                        torch.cat([grid % side, text])])[None].expand(Bv, 3, Sv)
    vtoks = torch.tensor(np.random.RandomState(4).randint(
        1, qwen.vocab_size, size=(Bv, Sv)), device=dev)

    def vforward(m_, p_, dtype):
        lg, _, _ = m_.forward(p_, vtoks, positions=pos3, vision_embeds=v_emb,
                              compute_dtype=dtype)
        return lg[..., :qwen.vocab_size].float()

    FA.reset_launches()
    kern = vforward(model, params, bf)
    got["flash_attention"] += FA.LAUNCHES["flash_attention"]
    assert FA.LAUNCHES["flash_attention"] == (Lq if cuda else 0)
    launches["qwen2_vl"] = got
    ref16 = vforward(ref_model, params, bf)
    p32 = tree_map(lambda t: t.float(), params)
    del params
    ref32 = vforward(ref_model, p32, f32)
    del p32
    e_kern, e_ref = (float((kern - ref32).abs().max()),
                     float((ref16 - ref32).abs().max()))
    agree = float((kern.argmax(-1) == ref16.argmax(-1)).float().mean())
    print(f"  forward B={Bv} S={Sv} with {P} vision embeddings ({side} x "
          f"{side} grid) and position rows t/h/w distinct: logits against "
          f"fp32: kernel {e_kern:.4f}, plain bf16 {e_ref:.4f} (kernel must "
          f"be <= 2 x plain, phase 6's bound); max|kernel - plain bf16| "
          f"{float((kern - ref16).abs().max()):.4f}, argmax agreement "
          f"{agree:.4f}; launches {got}; peak {peak_gib():.2f} GiB; card "
          f"{smi}")
    assert torch.isfinite(kern).all() and kern.shape == (Bv, Sv,
                                                         qwen.vocab_size)
    assert e_kern <= 2 * e_ref, "kernel path drifts from the fp32 model"
    del kern, ref16, ref32, model, ref_model
    free()
    return launches, tp_ref


def dryrun_phases(dev, smi, probes=DRY_PROBES, runs=DRY_RUNS,
                  cfg_for=None, shape_for=None):
    """Phases 25a-c (module docstring) on ``dev``.  ``cfg_for(arch)`` and
    ``shape_for(shape)`` replace the probes' and runs' configs and shapes
    (a small rehearsal on the CPU; 25a always builds the real pairs on
    meta).  Returns the flash kernels' launches of 25b-c."""
    from repro_torch.configs import ARCHS, SKIPS
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.roofline import analyze_record

    cuda = dev.type == "cuda"
    cfg_for = cfg_for or (lambda arch: None)
    shape_for = shape_for or (lambda s: None)
    out_dir = tempfile.mkdtemp(prefix="chip-smoke-dryrun-")
    t_25 = time.perf_counter()
    try:
        # ------------------------------------------------ 25a every pair
        phase("25a dry-run on meta: 39 pairs x 2 meshes, per-device bytes")
        before = torch.cuda.memory_allocated(dev) if cuda else 0
        t0 = time.perf_counter()
        n = 0
        for multi_pod in (False, True):
            for arch in ARCHS:
                for s in D.SHAPES:
                    if (arch, s) in SKIPS:
                        continue
                    _, _, _, info = D.build_dryrun(
                        arch, s, multi_pod, cache_policy="attn_hints_seq",
                        batch=1)
                    cache = info.get("cache_bytes_per_device")
                    print(f"  {arch:22s} {s:12s} {info['mesh']:8s} params "
                          f"{info['param_bytes_per_device'] / 2**20:10.2f} "
                          f"MiB/device"
                          + ("" if cache is None else
                             f", cache {cache / 2**20:10.2f} MiB/device"))
                    n += 1
        after = torch.cuda.memory_allocated(dev) if cuda else 0
        print(f"{n} pair builds in {time.perf_counter() - t0:.1f} s; card "
              f"allocation {before} B before, {after} B after")
        assert n == 78 and after == before

        # ---------------------------------------------------- 25b probes
        phase(f"25b probes at 1 and 2 layer groups on {dev}, full width")
        FA.reset_launches()
        probed = {}
        for arch, s in probes:
            rec = D.probe_pair(arch, s, False, out_dir, force=True,
                               device=dev, cfg=cfg_for(arch),
                               shape=shape_for(s))
            assert rec["status"] == "ok", (arch, s, rec.get("error"),
                                           rec.get("trace"))
            card = rec["card"]
            assert card["status"] == "ok", (arch, s, card)
            probed[(arch, s)] = rec
            row = analyze_record(rec, 256)
            n1, n2 = card["n1"], card["n2"]
            peak = (f"; peak {n2['max_memory_allocated'] / 2**30:.2f} GiB "
                    f"at 2 groups, {card['meta_peak_n2'] / 2**30:.2f} GiB "
                    f"counted on meta (card / count "
                    f"{n2['max_memory_allocated'] / card['meta_peak_n2']:.3f})"
                    if cuda else "")
            coll = rec["collectives"]
            if arch == "tinyllama-1.1b" and cfg_for(arch) is None:
                assert coll is not None and row["collective_s"] is not None, (
                    arch, s, rec.get("collectives_error"))
            counted = (f"collectives null ({rec['collectives_error']})"
                       if coll is None else
                       "collectives MiB/device " + ", ".join(
                           f"{k} {v / 2**20:.2f}" for k, v in coll.items())
                       + f", collective term {row['collective_s']:.6f} s")
            print(f"  {arch} x {s}: meta {rec['cost']['flops']:.4g} FLOP, "
                  f"{rec['cost']['bytes_accessed']:.4g} B (x{rec['extrap_mult']:.4g}"
                  f" groups); card batch {card['batch']} {card['reduced']}: "
                  f"{n1['ms']:.2f} ms (1 group), {n2['ms']:.2f} ms (2), "
                  f"full depth ~{card['ms']:.2f} ms{peak}; {counted}; "
                  f"roofline over 256 devices: compute "
                  f"{row['compute_s']:.6f} s, memory {row['memory_s']:.6f} s, "
                  f"{row['dominant']}, useful {row['useful_ratio']}; {smi}")

        # ------------------------------------------------ 25c full depth
        phase(f"25c full-depth runs on {dev}")
        for arch, s in runs:
            rec = D.run_pair(arch, s, False, out_dir, force=True, device=dev,
                             cfg=cfg_for(arch), shape=shape_for(s))
            assert rec["status"] == "ok", (arch, s, rec.get("error"),
                                           rec.get("trace"),
                                           rec.get("bytes_counted"))
            run = rec["card"]
            probe = probed.get((arch, s), {}).get("card")
            versus = ("" if probe is None else
                      f"; the probe's extrapolation {probe['ms']:.2f} ms at "
                      f"batch {probe['batch']} "
                      f"(measured / extrapolated "
                      f"{run['ms'] / probe['ms']:.3f})")
            peak = (f", peak {run['max_memory_allocated'] / 2**30:.2f} GiB "
                    f"({rec['meta_peak'] / 2**30:.2f} GiB counted on meta; "
                    f"card / count "
                    f"{run['max_memory_allocated'] / rec['meta_peak']:.3f})"
                    if cuda else "")
            print(f"  {arch} x {s}: batch {rec['batch']} {rec['reduced']}, "
                  f"{run['ms']:.2f} ms per step (median of "
                  f"{[round(t, 2) for t in run['ms_all']]}){peak}{versus}; "
                  f"{smi}")
        launches = dict(FA.LAUNCHES)
        print(f"launches of phases 25b-c {launches}; phases 25a-c "
              f"{time.perf_counter() - t_25:.1f} s")
        if cuda:
            assert launches["flash_attention"] > 0
            assert launches["flash_decode"] > 0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return launches


def long_kernel_checks(dev, measure, worst):
    """Phase 25d (module docstring): the flash kernels at the dry-run's
    lengths against their plain versions, and timed."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention.flash_attention import \
        decode_chunk
    from repro_torch.kernels.flash_attention.ref import decode_mask

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(25)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    phase("25d the flash kernels at the dry-run's lengths")
    S, R = LONG_S, LONG_ROWS
    q = randn(1, S, H, HD, dtype=bf)
    k, v = randn(1, S, KV, HD, dtype=bf), randn(1, S, KV, HD, dtype=bf)

    def plain_rows(drop=False):
        """Plain causal attention of the last R query rows over all S
        keys, in fp32; ``drop`` masks out DROP_KEYS keys from S / 2."""
        kr = k.float().repeat_interleave(H // KV, dim=2)
        vr = v.float().repeat_interleave(H // KV, dim=2)
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, S - R:].float(), kr)
        sc = sc / math.sqrt(HD)
        qi = torch.arange(S - R, S, device=dev)[:, None]
        kj = torch.arange(S, device=dev)[None]
        masked = kj > qi
        if drop:
            masked = masked | ((kj >= S // 2) & (kj < S // 2 + DROP_KEYS))
        sc = sc.masked_fill(masked, float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), vr)

    out, ref = FA.attention(q, k, v, causal=True)[:, S - R:], plain_rows()
    e, rel = max_err(out, ref), row_rel_err(out, ref, 1).max().item()
    miss = row_rel_err(plain_rows(drop=True), ref, 1).min().item()
    del out, ref
    print(f"flash_attention bf16 B=1 S={S} H={H} KV={KV} hd={HD} causal, "
          f"last {R} rows: max_abs_err {e:.3e}; per row, max err / max "
          f"|plain| {rel:.3e} (tol {REL_TOL}); {DROP_KEYS} keys dropped "
          f"give >= {miss:.3e}")
    assert miss > REL_TOL, "25d's bound cannot see a dropped tile"
    assert rel <= REL_TOL, "flash_attention disagrees at S=32768"
    worst["flash_attention"] = max(worst["flash_attention"], e)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()

    def library():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    measure("flash_attention_32k",
            f"bf16, causal, B=1 S={S} H={H} KV={KV} hd={HD} (plain: the "
            f"last {R} rows)",
            lambda: FA.attention(q, k, v, causal=True), plain_rows, library,
            2 * (2 * q.numel() + k.numel() + v.numel()),
            4 * H * HD * S * (S + 1) // 2)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    # decode: 8 slots on a 32768-row cache, positions at chunk edges; the
    # rings at positions up to 524287
    L = LONG_L
    c = decode_chunk(B, L, KV)
    cases = [("flash_decode_32k", H, KV, HD, L, 0,
              [L - 1, L - 2, c - 1, c, 2 * c, L - c, L - c - 1, 20000]),
             ("flash_decode_ring_hd64", H, KV, HD, SWA_WINDOW, SWA_WINDOW,
              [LONG_POS - i * 4099 for i in range(8)]),
             ("flash_decode_ring_hd256", RG_H, 1, RG_HD, RG_WINDOW,
              RG_WINDOW, [LONG_POS - i * 2053 for i in range(8)])]
    for name, h, kv, hd, L_, window, positions in cases:
        qd = randn(B, 1, h, hd, dtype=bf)
        ck, cv = (randn(B, L_, kv, hd, dtype=bf) for _ in range(2))
        pos = torch.tensor(positions, device=dev, dtype=torch.int32)
        out = FA.decode(qd, ck, cv, pos, window=window)
        ref = FA.decode_ref(qd, ck, cv, pos, window=window)
        e, rel = max_err(out, ref), row_rel_err(out, ref, 0).max().item()
        # the plain version without cache rows [0, DROP_KEYS): the rest as
        # a plain cache (a ring's slots are all written at these positions)
        dropped = FA.decode_ref(qd, ck[:, DROP_KEYS:], cv[:, DROP_KEYS:],
                                torch.full_like(pos, L_ - DROP_KEYS - 1)
                                if window else pos - DROP_KEYS)
        miss = row_rel_err(dropped, ref, 0).min().item()
        mask = decode_mask(pos, L_, window)
        print(f"flash_decode bf16 B={B} L={L_} H={h} KV={kv} hd={hd} "
              f"window={window} pos={positions}: max_abs_err {e:.3e}; per "
              f"slot, max err / max |plain| {rel:.3e} (tol {REL_TOL}); "
              f"{DROP_KEYS} keys dropped give >= {miss:.3e}")
        assert miss > REL_TOL, "25d's bound cannot see a dropped tile"
        assert rel <= REL_TOL, f"{name} disagrees with its plain version"
        worst["flash_decode"] = max(worst["flash_decode"], e)
        keys = int(mask.sum())
        ckt, cvt, qdt = (t.transpose(1, 2).contiguous()
                         for t in (ck, cv, qd))
        measure(name, f"bf16, B={B} L={L_} H={h} KV={kv} hd={hd} window "
                f"{window}, pos {positions[-1]}-{positions[0]}",
                lambda: FA.decode(qd, ck, cv, pos, window=window),
                lambda: FA.decode_ref(qd, ck, cv, pos, window=window),
                lambda: F.scaled_dot_product_attention(
                    qdt, ckt, cvt, attn_mask=mask[:, None, None, :],
                    enable_gqa=True),
                2 * (2 * qd.numel() + 2 * keys * kv * hd) + 4 * B,
                4 * h * hd * keys)
        del qd, ck, cv, ckt, cvt, qdt, mask, out, ref, dropped
    torch.cuda.empty_cache()


def _launch_modules():
    from repro_torch.kernels import flash_attention, onebit, qsgd, terngrad
    from repro_torch.kernels import topk
    return (flash_attention, onebit, topk, terngrad, qsgd)


def _train_cells(cfg, dev, cells, seq, batch, steps, group=None,
                 logical=False):
    """Each (spec, wire, steps) cell (steps None: ``steps``) from seed-0
    weights through ``Strategy.build`` and the shared fit loop, over
    ``group`` (one worker per rank) or with every worker in this process;
    with ``logical`` also again with every worker in this process.
    Returns per (spec, wire) the losses (one per step, or per push event
    under SSP/ASP), the firing worker of each event, wire bytes, global
    step walls (ms, each ``engine.step`` between two synchronizes), peak
    memory, bytes staged through the host and kernel launches (counts
    zeroed just before the cell)."""
    from repro_torch.data import LMDataConfig, make_lm_batches
    from repro_torch.models import build_model
    from repro_torch.train import Strategy, value_and_grad
    from repro_torch.train.strategy import fit
    on_card = dev.type == "cuda"
    model = build_model(cfg)
    grad_fn = value_and_grad(
        lambda p, b: model.loss_fn(p, b, compute_dtype=torch.float32))
    batches = make_lm_batches(LMDataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=seq, batch_size=batch),
                              device=dev)
    mods = _launch_modules()

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def run(spec, wire, n_steps, group):
        params = model.init(seed=0, dtype=torch.float32, device=dev)
        engine = Strategy.parse(spec, lr=0.01, wire=wire).build(
            grad_fn, model.leaf_layout(params), device=dev, group=group)
        step, walls = engine.step, []

        def timed_step(st, b, t):
            sync()
            t0 = time.perf_counter()
            out = step(st, b, t)
            sync()
            walls.append(1e3 * (time.perf_counter() - t0))
            return out

        engine.step = timed_step
        for mod in mods:
            mod.reset_launches()
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        _, hist, mets = fit(engine, params, batches, n_steps)
        sync()
        del params
        got = dict(losses=[h["loss"] for h in hist],
                   workers=[h.get("worker") for h in hist],
                   wire=mets["wire_bytes"], steps=n_steps, step_ms=walls,
                   peak=torch.cuda.max_memory_allocated(dev) if on_card
                   else 0,
                   staged=getattr(engine.inner.axis, "staged_bytes", 0),
                   launches={k: v for mod in mods
                             for k, v in mod.LAUNCHES.items()})
        del engine
        if on_card:
            torch.cuda.empty_cache()
        return got

    out = {}
    for spec, wire, n_steps in cells:
        out[spec, wire] = run(spec, wire, n_steps or steps, group)
        if logical:
            out[spec, wire]["logical"] = run(spec, wire, n_steps or steps,
                                             None)
    return out


def _dist_rank(rank, world, dev, runs, seq, batch, steps):
    """One rank of phase 26: for each run ``(k, backend, cfg, cells,
    logical)``, ``_train_cells`` over a ``backend`` group of the first k
    ranks (the whole Gloo group when k is the world), while the other
    ranks wait at a barrier.  Returns each run's result (None where this
    rank is outside the run's group)."""
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for k, backend, cfg, cells, logical in runs:
        group = (dist.group.WORLD if (k, backend) == (world, "gloo")
                 else dist.new_group(list(range(k)), backend=backend))
        out.append(_train_cells(cfg, dev, cells, seq, batch, steps, group,
                                logical) if rank < k else None)
        dist.barrier()
    return out


def dist_phases(cfg, dev, smi, seq=TRAIN_S, batch=TRAIN_B,
                steps=TRAIN_STEPS, runs=DIST_RUNS, tool_argv=DIST_TOOL_ARGV):
    """Phase 26: the worker axis over torch.distributed, one process per
    worker (``launch.dist``), at ``cfg``'s widths on ``dev``.  One spawn
    of Gloo ranks runs 26a and 26b, each on a group of its first ranks:

      26a. for each (ranks k, layers, cells) of ``runs``, the cells at @k
           over k Gloo ranks on one card against the logical engine run
           before the spawn in this process on the same draws: losses
           within DIST_TOL (the terngrad and qsgd cells bit for bit),
           wire bytes equal;
      26b. ``DIST_NCCL_CELL`` over an NCCL group of
           ``torch.cuda.device_count()`` ranks against the logical axis
           in the same rank process (the CPU rehearsal takes Gloo here:
           NCCL needs a card);
      26c. ``tools/torch_train_100m_e2e.py``'s AdamW trainer under
           ``torch.distributed.run`` over 2 Gloo ranks against the same
           command on the logical axis.

    Each rank's peak memory, step walls and bytes staged through the host
    are printed.  Returns the launches of the kernels per path ("dist":
    26a and 26b, "dist_trainer": 26c), summed over ranks."""
    import importlib.util
    from repro_torch.launch.dist import spawn
    on_card = dev.type == "cuda"
    where = "cuda" if on_card else "cpu"
    launches = {"dist": {}, "dist_trainer": {}}

    def add(path, counts):
        for name, n in counts.items():
            launches[path][name] = launches[path].get(name, 0) + n

    def report(tag, g, ref, key, rank, cfg_k):
        spec, wire = key
        method = spec.split("/")[2].split("@")[0].split(":")[0]
        events = len(g["losses"])
        diffs = [abs(a - b) for a, b in zip(g["losses"], ref["losses"])]
        per = "event" if events > g["steps"] else "step"
        print(f"  {tag}: losses {g['losses']}, wire {g['wire']} B (logical "
              f"{ref['wire']}); |rank - logical| per {per} "
              f"{[f'{d:.2e}' for d in diffs]} (tol {DIST_TOL}; bitwise "
              f"{g['losses'] == ref['losses']}); step walls "
              f"{[f'{x:.1f}' for x in g['step_ms']]} ms (logical "
              f"{[f'{x:.1f}' for x in ref['step_ms']]} ms), "
              f"{events // g['steps']} event(s) a step; peak "
              f"{g['peak'] / 2**30:.2f} GiB; staged "
              f"{g['staged'] / g['steps'] / 2**30:.3f} GiB/step; launches "
              f"{g['launches']}; card {smi}")
        add("dist", g["launches"])
        assert events == len(ref["losses"]) and \
            g["workers"] == ref["workers"]
        assert max(diffs) <= DIST_TOL
        if method in DIST_BITWISE:
            assert g["losses"] == ref["losses"]
        assert g["wire"] == ref["wire"]
        # a rank computes the gradients of its worker's events (every
        # step but under SSP/ASP)
        grads = (sum(w == rank for w in g["workers"])
                 if per == "event" else g["steps"])
        assert g["launches"]["flash_attention"] == \
            cfg_k.num_layers * grads or not on_card
        kernel = DIST_KERNEL.get((method, wire))
        assert kernel is None or g["launches"][kernel] > 0 or not grads \
            or not on_card, (key, kernel)

    phase("26 the worker axis over torch.distributed: the logical "
          "references, then one spawn of Gloo ranks on " + str(dev))
    nccl = "nccl" if on_card else "gloo"
    n_nccl = torch.cuda.device_count() if on_card else 1
    plan, refs = [], []
    for k, layers, cells in runs:
        cfg_k = cfg if layers is None else dataclasses.replace(
            cfg, num_layers=layers)
        cells = tuple((spec.format(k=k), wire, n) for spec, wire, n in cells)
        refs.append(_train_cells(cfg_k, dev, cells, seq, batch, steps))
        plan.append((k, "gloo", cfg_k, cells, False))
    spec, wire, n = DIST_NCCL_CELL
    plan.append((n_nccl, nccl, cfg, ((spec.format(k=n_nccl), wire, n),),
                 True))
    if on_card:
        torch.cuda.empty_cache()
    world = max(k for k, *_ in plan)
    t0 = time.perf_counter()
    ranks = spawn(_dist_rank, world, "gloo", device=where, timeout_s=900,
                  args=(plan, seq, batch, steps))
    print(f"  {world} ranks in {time.perf_counter() - t0:.1f} s (start and "
          f"every run)")
    for i, (k, backend, cfg_k, cells, logical) in enumerate(plan):
        label = "26b" if logical else "26a"
        phase(f"{label} {k} {backend} rank(s): "
              f"{[f'{c} {w}' for c, w, _ in cells]}, {cfg_k.name} at "
              f"{cfg_k.num_layers} layers, full widths, fp32")
        for spec, wire, _ in cells:
            for r in range(k):
                got = ranks[r][i][spec, wire]
                report(f"{backend} rank {r} {spec} {wire}", got,
                       got["logical"] if logical else refs[i][spec, wire],
                       (spec, wire), r, cfg_k)

    phase("26c tools/torch_train_100m_e2e.py under torch.distributed.run, "
          "2 Gloo ranks, AdamW, against the logical axis")
    tool = os.path.join(ROOT, "tools", "torch_train_100m_e2e.py")
    out_dir = tempfile.mkdtemp(prefix="chip-smoke-dist-")
    argv = list(tool_argv) + ["--device", where]
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", tool, *argv, "--dist-backend", "gloo",
         "--out", os.path.join(out_dir, "dist")],
        capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"torch.distributed.run exited "
                           f"{res.returncode}:\n{res.stdout[-3000:]}\n"
                           f"{res.stderr[-3000:]}")
    wall = time.perf_counter() - t0
    line = [x for x in res.stdout.splitlines() if x.startswith("dist: ")]
    reports = json.loads(line[-1][len("dist: "):])["ranks"]
    spec_ = importlib.util.spec_from_file_location("torch_train_100m_e2e",
                                                   tool)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    mod.main(argv + ["--out", os.path.join(out_dir, "logical")])
    hist = []
    for d in ("dist", "logical"):
        with open(os.path.join(out_dir, d, "history.json")) as f:
            hist.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    diffs = [abs(a["loss"] - b["loss"]) for a, b in zip(*hist)]
    for r, rep in enumerate(reports):
        print(f"  rank {r}: peak {rep['peak_bytes'] / 2**30:.2f} GiB, step "
              f"{1e3 * rep['step_s']:.1f} ms (mean, the first included), "
              f"staged {rep['staged_bytes'] / 2**30:.3f} GiB, launches "
              f"{rep['launches']}; card {smi}")
        add("dist_trainer", rep["launches"])
    print(f"  torchrun wall {wall:.1f} s; losses dist "
          f"{[h['loss'] for h in hist[0]]}, logical "
          f"{[h['loss'] for h in hist[1]]}; |dist - logical| "
          f"{[f'{d:.2e}' for d in diffs]} (tol {DIST_TOL}); wire_bytes "
          f"{[h['wire_bytes'] for h in hist[0]]}")
    assert len(reports) == 2 and len(diffs) == len(hist[1]) >= 2
    assert max(diffs) <= DIST_TOL
    assert [h["wire_bytes"] for h in hist[0]] == \
        [h["wire_bytes"] for h in hist[1]]
    assert all(rep["launches"]["onebit_encode_ef"] > 0 or not on_card
               for rep in reports)
    return launches


def _snapshot_hashes(ckpt_dir):
    """Every committed snapshot in ``ckpt_dir``: its leaves' names, shapes,
    dtypes and content hashes, and its meta, by directory name."""
    out = {}
    for name in sorted(os.listdir(ckpt_dir)):
        path = os.path.join(ckpt_dir, name, "manifest.json")
        if name.startswith("step_") and os.path.isfile(path):
            with open(path) as f:
                m = json.load(f)
            out[name] = ([(r["name"], r["shape"], r["dtype"], r["hash"])
                          for r in m["leaves"]], m["extra"])
    return out


def _tree_sha256(tree):
    """One sha256 over a tree's leaves' bytes in leaf-path order."""
    import hashlib

    from repro_torch.core.tree import get_path, leaf_paths
    h = hashlib.sha256()
    for path in leaf_paths(tree):
        leaf = get_path(tree, path).detach().reshape(-1).cpu()
        h.update(leaf.view(torch.uint8).numpy())
    return h.hexdigest()


def _elastic_cell(cfg, dev, cell, seq, batch, lr, ckpt_dir, group=None,
                  timed=False):
    """One elastic cell ``(spec, plan, steps, snapshot cadence)`` through
    ``Trainer(group=).fit(plan=)`` from seed-0 weights (every worker in
    this process without ``group``).  Returns the losses, recoveries
    (their walls dropped), wire bytes, final workers, the final
    parameters' sha256, the snapshots' hashes (where this process wrote
    them), peak memory, kernel launches and, when ``timed``, each
    snapshot save's and load's seconds and the newest snapshot's
    bytes."""
    from repro_torch.data import LMDataConfig, make_lm_batches
    from repro_torch.elastic import recovery
    from repro_torch.models import build_model
    from repro_torch.train import Strategy, Trainer, value_and_grad
    spec, plan, steps, every = cell
    on_card = dev.type == "cuda"
    model = build_model(cfg)
    grad_fn = value_and_grad(
        lambda p, b: model.loss_fn(p, b, compute_dtype=torch.float32))
    batches = make_lm_batches(LMDataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=seq, batch_size=batch),
                              device=dev)
    params = model.init(seed=0, dtype=torch.float32, device=dev)
    mods = _launch_modules()
    saves, loads = [], []
    originals = recovery.save_engine_state, recovery.restore_engine_state

    def clocked(fn, into):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if on_card:
                torch.cuda.synchronize(dev)
            into.append(time.perf_counter() - t0)
            return out
        return run

    if timed:
        recovery.save_engine_state = clocked(originals[0], saves)
        recovery.restore_engine_state = clocked(originals[1], loads)
    for mod in mods:
        mod.reset_launches()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        final, hist, mets = Trainer(Strategy.parse(spec, lr=lr),
                                    device=dev, group=group).fit(
            grad_fn, params, batches, steps,
            layout=model.leaf_layout(params), plan=plan,
            checkpoint_dir=ckpt_dir, checkpoint_every=every)
    finally:
        recovery.save_engine_state, recovery.restore_engine_state = \
            originals
    writer = group is None or torch.distributed.get_rank(group) == 0
    snaps = _snapshot_hashes(ckpt_dir) if writer and ckpt_dir else None
    newest = max(snaps) if snaps else None
    got = dict(losses=[h["loss"] for h in hist], wire=mets["wire_bytes"],
               recoveries=[{k: v for k, v in r.items() if k != "wall_s"}
                           for r in mets["recoveries"]],
               final=mets["final_workers"], snaps=snaps,
               digest=_tree_sha256(final),
               peak=torch.cuda.max_memory_allocated(dev) if on_card else 0,
               launches={k: v for mod in mods
                         for k, v in mod.LAUNCHES.items()},
               saves=saves, loads=loads,
               snap_bytes=sum(
                   os.path.getsize(os.path.join(ckpt_dir, newest, f))
                   for f in os.listdir(os.path.join(ckpt_dir, newest)))
               if newest else 0)
    del params, final
    if on_card:
        torch.cuda.empty_cache()
    return got


def _tiny_model(dev, tiny, rows):
    """``make_tiny_transformer`` at ``tiny`` = (layers, d_model, d_ff)
    from seed 0, and its batches: ``rows`` seeded rows per (step, data
    slot), y = tanh(x W).  Returns (params, model, batches)."""
    from repro_torch.parallel import make_tiny_transformer
    layers, d_model, d_ff = tiny
    params, model = make_tiny_transformer(layers, d_model, d_ff, seed=0,
                                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    w_t = torch.randn(d_model, d_model, generator=gen, device=dev) \
        / math.sqrt(d_model)
    data = {}

    def batches(t, w):
        if (t, w) not in data:
            g = torch.Generator(device=dev).manual_seed(1000 * t + w)
            x = torch.randn(rows, d_model, generator=g, device=dev)
            data[t, w] = {"x": x, "y": torch.tanh(x @ w_t)}
        return data[t, w]

    return params, model, batches


def _hybrid_cell(cfg, dev, cell, seq, batch, tiny, rows, group=None):
    """One hybrid cell ``(spec, wire, steps)`` through ``Strategy.build``
    and the shared fit loop: full-width ``cfg`` from seed-0 weights when
    the spec has no tensor or stage axis, else ``make_tiny_transformer``
    at ``tiny`` = (layers, d_model, d_ff) on ``rows`` seeded rows per data
    slot.  Over ``group`` (one mesh device per rank) or logical.  Returns
    the losses, wire bytes, step walls (ms), peak memory, bytes staged
    through the host and kernel launches."""
    from repro_torch.data import LMDataConfig, make_lm_batches
    from repro_torch.models import build_model
    from repro_torch.train import Strategy, value_and_grad
    from repro_torch.train.strategy import fit
    spec, wire, steps = cell
    on_card = dev.type == "cuda"
    strat = Strategy.parse(spec, lr=HYBRID_TINY_LR, wire=wire)
    if strat.mesh_spec.is_trivial:
        model = build_model(cfg)
        model_or_fn = value_and_grad(
            lambda p, b: model.loss_fn(p, b, compute_dtype=torch.float32))
        params = model.init(seed=0, dtype=torch.float32, device=dev)
        layout = model.leaf_layout(params)
        batches = make_lm_batches(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch),
            device=dev)
        strat = Strategy.parse(spec, lr=HYBRID_LR, wire=wire)
    else:
        params, model_or_fn, batches = _tiny_model(dev, tiny, rows)
        layout = None
    engine = strat.build(model_or_fn, layout, device=dev, group=group)
    step, walls = engine.step, []

    def timed_step(st, b, t):
        if on_card:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = step(st, b, t)
        if on_card:
            torch.cuda.synchronize(dev)
        walls.append(1e3 * (time.perf_counter() - t0))
        return out

    engine.step = timed_step
    mods = _launch_modules()
    for mod in mods:
        mod.reset_launches()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    _, hist, mets = fit(engine, params, batches, steps)
    ranks = getattr(engine.inner, "ranks", None)
    got = dict(losses=[h["loss"] for h in hist], wire=mets["wire_bytes"],
               step_ms=walls,
               peak=torch.cuda.max_memory_allocated(dev) if on_card else 0,
               staged=ranks.staged_bytes if ranks is not None else 0,
               launches={k: v for mod in mods
                         for k, v in mod.LAUNCHES.items()})
    del params, engine
    if on_card:
        torch.cuda.empty_cache()
    return got


def _hybrid_elastic_cell(dev, cell, tiny, rows, ckpt_dir, group=None):
    """One hybrid elastic cell ``(spec, plan, steps, snapshot cadence,
    lr)`` through ``Trainer(group=).fit(plan=)`` on ``_tiny_model(dev,
    tiny, rows)``, one mesh device per rank of ``group`` or logical.
    Returns the losses, recoveries (their walls dropped), resizes, wire
    bytes, final workers, the final parameters' sha256, the snapshots'
    hashes (where this process wrote them), the run's wall, peak memory
    and kernel launches."""
    from repro_torch.train import Strategy, Trainer
    spec, plan, steps, every, lr = cell
    on_card = dev.type == "cuda"
    params, model, batches = _tiny_model(dev, tiny, rows)
    mods = _launch_modules()
    for mod in mods:
        mod.reset_launches()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    final, hist, mets = Trainer(Strategy.parse(spec, lr=lr), device=dev,
                                group=group).fit(
        model, params, batches, steps, plan=plan, checkpoint_dir=ckpt_dir,
        checkpoint_every=every)
    if on_card:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    writer = group is None or torch.distributed.get_rank(group) == 0
    got = dict(losses=[h["loss"] for h in hist], wire=mets["wire_bytes"],
               recoveries=[{k: v for k, v in r.items() if k != "wall_s"}
                           for r in mets["recoveries"]],
               resizes=mets["resizes"], final=mets["final_workers"],
               snaps=_snapshot_hashes(ckpt_dir) if writer else None,
               digest=_tree_sha256(final), wall=wall,
               peak=torch.cuda.max_memory_allocated(dev) if on_card else 0,
               launches={k: v for mod in mods
                         for k, v in mod.LAUNCHES.items()})
    del params, final
    if on_card:
        torch.cuda.empty_cache()
    return got


def _tp_serve_rank(cfg, dev, ref, group):
    """Phase 28a on one rank of ``group``: ``ServeEngine(group=)`` at
    tp=2 on phase 19's traffic (``ref``, its warm-up first) from seed-0
    bf16 weights.  Returns the tokens, the first decode step's logits,
    each decode iteration's ms, the metrics, this rank's peak and the
    flash kernels' launches."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.request import Request
    on_card = dev.type == "cuda"
    tr, prompts, bf = ref["traffic"], ref["prompts"], torch.bfloat16
    model = build_model(cfg)
    params = model.init(seed=0, dtype=bf, device=dev)
    scfg = ServeConfig(slots=tr["slots"], max_len=tr["prompt"] + tr["new"],
                       page_size=tr["page"], policy="continuous",
                       cache_dtype=bf, compute_dtype=bf, tp=2)
    ServeEngine(model, params, scfg, device=dev, group=group).run(
        [Request(rid=i, prompt=[int(t) for t in prompts[i, :16]],
                 max_new_tokens=2) for i in range(2)])         # warm-up
    reqs = [Request(rid=i, prompt=[int(t) for t in prompts[i]],
                    max_new_tokens=tr["new"])
            for i in range(tr["n_requests"])]
    eng = ServeEngine(model, params, scfg, device=dev, group=group)
    walls, first, step = _record_decode(eng, dev, cfg.vocab_size)
    # the host wall of the tensor line's all-gathers (staging included)
    axis, gathers = eng._tp.axis, []
    gather = axis.all_gather

    def timed_gather(x):
        t0 = time.perf_counter()
        out = gather(x)
        gathers.append(time.perf_counter() - t0)
        return out

    axis.all_gather = timed_gather
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    FA.reset_launches()
    try:
        m = eng.run(reqs)
    finally:
        T.decode_step = step
    got = dict(outputs=[r.output for r in reqs], first=first[0],
               iter_ms=walls, metrics=m, gather_s=sum(gathers),
               gathers=len(gathers),
               peak=torch.cuda.max_memory_allocated(dev) if on_card else 0,
               launches=dict(FA.LAUNCHES))
    del params, eng
    if on_card:
        torch.cuda.empty_cache()
    return got


def _elastic_hybrid_rank(rank, world, dev, runs, seq, batch, tiny, rows):
    """One rank of phases 27-28: for each run ``(kind, k, cfg, cells,
    dir)`` the cells over the group of the first k ranks (kind
    "elastic": each cell's snapshots under its own directory in ``dir``,
    "restart" the same, timed; "hybrid"; "tp": phase 28a, its one cell
    phase 19's reference; "hybrid_elastic": phase 28b's cells on the tiny
    model ``tiny[1]``, snapshots as "elastic"), while the other ranks
    wait at a barrier.  Returns each run's results (None outside its
    group) and its wall on this rank."""
    import torch.distributed as dist
    from repro_torch.launch.dist import (mesh_ladder, prefix_group,
                                         prefix_groups)
    from repro_torch.train import Strategy
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every rank builds every run's groups in one order (a group is
    # collective over the world; the runs' engines then find them built,
    # a hybrid mesh's with those of every mesh it can resize into)
    for kind, k, _, cells, _ in runs:
        prefix_groups(range(k))
        for cell in cells:
            if kind not in ("hybrid", "hybrid_elastic"):
                continue
            strat = Strategy.parse(cell[0])
            m = strat.mesh_spec
            if strat.is_hybrid:
                mesh_ladder(m.data, m.tensor, m.stage, ranks=range(k))
    out, walls = [], []
    for kind, k, cfg, cells, root in runs:
        group = prefix_group(k)
        got = None
        t0 = time.perf_counter()
        if group is not None:
            got = {}
            for i, cell in enumerate(cells):
                if kind == "hybrid":
                    got[cell[0]] = _hybrid_cell(cfg, dev, cell, seq, batch,
                                                tiny[0], rows, group)
                elif kind == "tp":
                    got["tp"] = _tp_serve_rank(cfg, dev, cell, group)
                elif kind == "hybrid_elastic":
                    got[cell[0]] = _hybrid_elastic_cell(
                        dev, cell, tiny[1], rows,
                        os.path.join(root, f"cell{i}"), group)
                else:
                    got[cell[0]] = _elastic_cell(
                        cfg, dev, cell, seq, batch, REDUCED_LR,
                        os.path.join(root, f"cell{i}"), group,
                        timed=kind == "restart")
        walls.append(time.perf_counter() - t0)
        out.append(got)
        dist.barrier()
        if rank == 0 and root:
            shutil.rmtree(root, ignore_errors=True)
    return out, walls


def elastic_hybrid_phases(cfg, dev, smi, tp_ref, seq=TRAIN_S,
                          batch=TRAIN_B, tiny=HYBRID_TINY,
                          tiny_elastic=HYBRID_ELASTIC_TINY,
                          rows=HYBRID_ROWS, phases=("27", "28")):
    """Phases 27-28 (module docstring): the elastic interface, the hybrid
    engine and tensor-parallel serving over Gloo ranks on ``dev`` in one
    spawn, each cell against the logical engine run just before in this
    process, and 28a against phase 19's logical tp=2 run (``tp_ref``,
    from ``family_phases``).  ``phases`` picks 27, 28 or both.  Returns
    the kernels' launches per path ("dist_elastic": 27a-b,
    "dist_hybrid": 27c, "dist_tp": 28a, "dist_hybrid_elastic": 28b),
    summed over ranks."""
    from repro_torch.launch.dist import spawn
    on_card = dev.type == "cuda"
    where = "cuda" if on_card else "cpu"
    paths = ("dist_elastic", "dist_hybrid", "dist_tp", "dist_hybrid_elastic")
    launches = {path: {} for path in paths}
    cfg2 = dataclasses.replace(cfg, num_layers=REDUCED_LAYERS)
    scratch = tempfile.mkdtemp(prefix="chip-smoke-p27-")
    runs = [("elastic", 4, cfg2, DIST_ELASTIC,
             os.path.join(scratch, "elastic")),
            ("restart", 2, cfg, (DIST_RESTART,),
             os.path.join(scratch, "restart")),
            ("hybrid", 2, cfg, (DIST_HYBRID_FULL,), None),
            ("hybrid", 8, cfg, DIST_HYBRID_TINY[:-1], None),
            ("hybrid", 4, cfg, DIST_HYBRID_TINY[-1:], None),
            ("tp", 2, cfg, (tp_ref,), None),
            ("hybrid_elastic", 4, cfg, DIST_HYBRID_ELASTIC,
             os.path.join(scratch, "hybrid_elastic"))]
    runs = [run for run in runs if
            ("28" if run[0] in ("tp", "hybrid_elastic") else "27") in phases]
    p28 = [i for i, run in enumerate(runs) if run[0] in ("tp",
                                                           "hybrid_elastic")]

    def add(path, counts):
        for name, n in counts.items():
            launches[path][name] = launches[path].get(name, 0) + n

    t_phase = time.perf_counter()
    phase("27 the elastic interface and the hybrid engine over ranks (and "
          "28, tensor-parallel serving and the hybrid engine's elastic "
          "interface over ranks): the logical references on " + str(dev)
          + "; snapshots in " + scratch)
    t_refs28 = 0.0
    try:
        refs = []
        for kind, k, cfg_k, cells, root in runs:
            got = {}
            t0 = time.perf_counter()
            for i, cell in enumerate(cells):
                if kind == "hybrid":
                    got[cell[0]] = _hybrid_cell(cfg_k, dev, cell, seq, batch,
                                                tiny, rows)
                    continue
                if kind == "tp":
                    continue              # phase 19 ran the logical tp=2
                d = os.path.join(scratch, f"logical{i}")
                if kind == "hybrid_elastic":
                    got[cell[0]] = _hybrid_elastic_cell(dev, cell,
                                                        tiny_elastic, rows, d)
                    shutil.rmtree(d, ignore_errors=True)
                    continue
                if kind == "restart":
                    # the same run without its restart, which loses no
                    # step, and without snapshots: no I/O on this side
                    cell, d = (cell[0], "") + cell[2:], None
                got[cell[0]] = _elastic_cell(cfg_k, dev, cell, seq, batch,
                                             REDUCED_LR, d)
                if d is not None:
                    shutil.rmtree(d, ignore_errors=True)
            if kind == "hybrid_elastic":
                t_refs28 += time.perf_counter() - t0
            refs.append(got)
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        world = max(k for _, k, *_ in runs)
        got_ranks = spawn(_elastic_hybrid_rank, world, "gloo", device=where,
                          timeout_s=900,
                          args=(runs, seq, batch, (tiny, tiny_elastic),
                                rows))
        ranks = [r for r, _ in got_ranks]
        print(f"  logical references {t0 - t_phase:.1f} s; {world} ranks "
              f"in {time.perf_counter() - t0:.1f} s (start and every run)")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for i, (kind, k, cfg_k, cells, _) in enumerate(runs):
        if i in p28:
            continue
        label = {"elastic": "27a", "restart": "27b", "hybrid": "27c"}[kind]
        phase(f"{label} {kind} over {k} Gloo rank(s): "
              f"{[c[0] for c in cells]}, fp32")
        for cell in cells:
            spec = cell[0]
            ref = refs[i][spec]
            for r in range(k):
                g = ranks[r][i][spec]
                path = "dist_hybrid" if kind == "hybrid" else "dist_elastic"
                add(path, g["launches"])
                diffs = [abs(a - b) for a, b in zip(g["losses"],
                                                    ref["losses"])]
                line = (f"  rank {r} {spec}: losses {g['losses']}, wire "
                        f"{g['wire']} B (logical {ref['wire']}); |rank - "
                        f"logical| {[f'{d:.2e}' for d in diffs]} (tol "
                        f"{DIST_TOL}; bitwise "
                        f"{g['losses'] == ref['losses']}); peak "
                        f"{g['peak'] / 2**30:.2f} GiB (logical "
                        f"{ref['peak'] / 2**30:.2f})")
                if kind == "restart":
                    line += (f"; recoveries {g['recoveries']}; saves "
                             f"{[f'{x:.2f}' for x in g['saves']]} s, loads "
                             f"{[f'{x:.2f}' for x in g['loads']]} s"
                             + (f"; snapshot {g['snap_bytes'] / 2**30:.3f} "
                                "GiB" if r == 0 else "")
                             + f"; final parameters' sha256 equal "
                             f"{g['digest'] == ref['digest']}")
                    assert [x["kind"] for x in g["recoveries"]] == \
                        ["restart"] and g["recoveries"][0]["lost_steps"] == 0
                    assert len(g["loads"]) == 1 and \
                        (g["snap_bytes"] > 0 or r > 0)
                elif kind == "hybrid":
                    line += (f"; step walls "
                             f"{[f'{x:.1f}' for x in g['step_ms']]} ms "
                             f"(logical "
                             f"{[f'{x:.1f}' for x in ref['step_ms']]}); "
                             f"staged {g['staged'] / 2**30:.3f} GiB")
                else:
                    line += (f"; recoveries {g['recoveries']}; final "
                             f"parameters' sha256 equal "
                             f"{g['digest'] == ref['digest']}")
                print(line + f"; launches {g['launches']}; card {smi}")
                assert len(diffs) == len(ref["losses"]) > 0
                assert max(diffs) <= DIST_TOL
                assert g["wire"] == ref["wire"]
                if kind != "hybrid":
                    assert g["digest"] == ref["digest"]
                if kind == "elastic":
                    assert g["recoveries"] == ref["recoveries"]
                    assert g["final"] == ref["final"] == 4
                    # rank 0 writes the snapshots: file for file the
                    # logical run's (per-leaf content hashes)
                    assert g["snaps"] == (ref["snaps"] if r == 0 else None)
    t_ranks28 = max(sum(w[i] for i in p28) for _, w in got_ranks)
    if "27" in phases:
        print(f"  phase 27 wall "
              f"{time.perf_counter() - t_phase - t_refs28 - t_ranks28:.1f} s")
    if "28" not in phases:
        return launches
    i_tp, i = p28
    _tp_ranks_report(cfg, smi, tp_ref, [r[i_tp]["tp"] for r in ranks[:2]],
                     add, on_card)
    phase(f"28b the hybrid engine's elastic interface over "
          f"{runs[i][1]} Gloo ranks: make_tiny_transformer{tiny_elastic}, "
          "fp32")
    for cell in DIST_HYBRID_ELASTIC:
        spec, ref = cell[0], refs[i][cell[0]]
        for r in range(runs[i][1]):
            g = ranks[r][i][spec]
            add("dist_hybrid_elastic", g["launches"])
            diffs = [abs(a - b) for a, b in zip(g["losses"], ref["losses"])]
            print(f"  rank {r} {spec} {cell[1]}: losses {g['losses']}; "
                  f"|rank - logical| {[f'{d:.2e}' for d in diffs]} (tol "
                  f"{DIST_TOL}; bitwise {g['losses'] == ref['losses']}); "
                  f"wire {g['wire']} B (logical {ref['wire']}); recoveries "
                  f"{g['recoveries']}, resizes {g['resizes']}; final "
                  f"parameters' sha256 equal {g['digest'] == ref['digest']}"
                  + (f"; rank 0's manifests equal the logical run's "
                     f"{g['snaps'] == ref['snaps']} ({len(g['snaps'])} "
                     "snapshots)" if r == 0 else "")
                  + f"; run {g['wall']:.1f} s (logical {ref['wall']:.1f}); "
                  f"peak {g['peak'] / 2**30:.2f} GiB (logical "
                  f"{ref['peak'] / 2**30:.2f}); launches {g['launches']}; "
                  f"card {smi}")
            assert len(diffs) == len(ref["losses"]) > 0
            assert max(diffs) <= DIST_TOL
            assert g["wire"] == ref["wire"]
            assert g["recoveries"] == ref["recoveries"]
            assert g["final"] == ref["final"] == runs[i][1]
            assert g["digest"] == ref["digest"]
            # rank 0 writes the snapshots, in the logical layout
            assert g["snaps"] == (ref["snaps"] if r == 0 else None)
    print(f"  phase 28 wall {t_refs28 + t_ranks28:.1f} s (28b's logical "
          f"references {t_refs28:.1f} s; the ranks' runs "
          f"{t_ranks28:.1f} s)")
    return launches


def _tp_ranks_report(cfg, smi, ref, got, add, cuda):
    """Phase 28a's report and holds: each rank's tokens bitwise phase
    19's logical tp=2 tokens, its first decode step against the logical
    one's, its decode iterations beside the logical tp=2 and tp=1 runs'
    (and PERF.md section 5's earlier figures), peak, cache and staged
    bytes, and the flash kernels launched on every rank."""
    tr = ref["traffic"]
    phase(f"28a tensor-parallel serving over 2 Gloo ranks: {cfg.name}, "
          f"bf16, tp=2, one rank per process; phase 19's traffic "
          f"({tr['n_requests']} requests, prompt {tr['prompt']}, "
          f"{tr['new']} tokens, {tr['slots']} slots, page {tr['page']})")
    L = cfg.num_layers
    for r, g in enumerate(got):
        m = g["metrics"]
        add("dist_tp", g["launches"])
        tp1 = sum(a == b for o1, o2 in zip(ref["tp1_outputs"], g["outputs"])
                  for a, b in zip(o1, o2))
        first = float((g["first"] - ref["first_logits"]).abs().max())
        med = statistics.median(g["iter_ms"])
        staged = m["rank_staged_bytes"][r] / m["decode_iterations"]
        print(f"  rank {r}: tokens equal the logical tp=2 stream "
              f"{g['outputs'] == ref['outputs']}; equal to tp=1's "
              f"{tp1}/{tr['n_requests'] * tr['new']}; first decode step "
              f"max|rank - logical| logits {first:.3e}; decode iteration "
              f"{med:.1f} ms median over {len(g['iter_ms'])} (logical tp=2 "
              f"{ref['iter_ms']:.1f}, tp=1 {ref['tp1_iter_ms']:.1f} in "
              f"phase 19; PERF.md section 5: 127.4 and 40.8); "
              f"{m['generated_tokens'] / m['wall_s']:.1f} tokens/s (logical "
              f"tp=2 {ref['tokens_per_s']:.1f}); peak "
              f"{g['peak'] / 2**30:.2f} GiB; cache "
              f"{m['rank_cache_bytes'][r] / 2**30:.4f} GiB, weights "
              f"{m['rank_param_bytes'][r] / 2**30:.3f} GiB; staged "
              f"{staged / 2**20:.3f} MiB per decode iteration; "
              f"{g['gathers']} all-gathers over the tensor line took "
              f"{1e3 * g['gather_s'] / m['decode_iterations']:.1f} ms per "
              f"decode iteration (host wall: the device to host copy waits "
              f"for the partial, then Gloo, then the copy back); launches "
              f"{g['launches']}; card {smi}")
        assert g["outputs"] == ref["outputs"], "rank tokens != logical tp=2"
        assert m["generated_tokens"] == tr["n_requests"] * tr["new"]
        assert len(set(m["rank_cache_bytes"])) == 1
        if cuda:
            assert g["launches"]["flash_decode"] == \
                m["decode_iterations"] * L > 0
            assert g["launches"]["flash_attention"] == \
                m["prefill_groups"] * L > 0


def recurrent_phases(dev, smi, rg, rwkv, whisper, prompt=PROMPT, new=NEW,
                     n_requests=16, slots=8, page=16, long_prompt=RG_LONG,
                     rg_check=RG_CHECK, rwkv_serve=RWKV_SERVE,
                     rwkv_check=RWKV_CHECK, utterances=WHISPER_UTTERANCES,
                     whisper_steps=WHISPER_STEPS, start=WHISPER_START,
                     train_argv=WHISPER_TRAIN_ARGV):
    """Phases 22-24 (module docstring) on ``dev``: ``rg`` (RG-LRU +
    local attention) through ``ServeEngine`` on phase 5's traffic and one
    request of ``long_prompt`` tokens, then its (prefill, total) decode
    check at 3 layers in fp32 and the gradients; ``rwkv`` through the
    engine (``rwkv_serve`` = requests, prompt, new tokens) and its decode
    check at 2 layers; ``whisper``'s encoder, cross cache and greedy
    ``decode_step`` over ``utterances`` seeded frame stubs from token
    ``start``, the encoder's
    kernel path against the plain one, and one launcher step
    (``train_argv``).  The CPU rehearses them at the configs'
    ``.reduced()`` and short traffic.  Returns each phase's launches of
    the flash kernels."""
    import numpy as np

    from repro_torch.core.tree import get_path, leaf_paths, tree_map
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as launcher
    from repro_torch.models import build_model
    from repro_torch.models import whisper as W
    from repro_torch.serve.cache import cache_bytes as nbytes
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.request import Request
    from repro_torch.train import value_and_grad

    cuda = dev.type == "cuda"
    bf, f32 = torch.bfloat16, torch.float32
    launches = {}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def free():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0

    def serve(model, params, reqs, max_len, page_size):
        """The requests through ServeEngine (bf16, continuous): (metrics,
        engine, flash launches of the run), after a 2-request warm-up."""
        scfg = ServeConfig(slots=slots, max_len=max_len, page_size=page_size,
                           policy="continuous", cache_dtype=bf,
                           compute_dtype=bf)
        ServeEngine(model, params, scfg, device=dev).run(
            [Request(rid=i, prompt=r.prompt[:16], max_new_tokens=2)
             for i, r in enumerate(reqs[:2])])
        eng = ServeEngine(model, params, scfg, device=dev)
        sync()
        FA.reset_launches()
        m = eng.run(reqs)
        got = dict(FA.LAUNCHES)
        assert m["completed"] == len(reqs)
        assert m["generated_tokens"] == sum(r.max_new_tokens for r in reqs)
        assert all(0 <= t < model.cfg.vocab_size for r in reqs
                   for t in r.output)
        per_slot = nbytes(eng.kv.store) / slots
        print(f"  {m['completed']} requests, {m['generated_tokens']} tokens "
              f"in {m['wall_s']:.3f} s wall = "
              f"{m['generated_tokens'] / m['wall_s']:.1f} tokens/s; "
              f"{m['prefill_groups']} prefill groups, "
              f"{m['decode_iterations']} decode iterations; state "
              f"{per_slot / 1e6:.3f} MB per slot ({per_slot:.0f} B, the "
              f"same at any length); peak {peak_gib():.2f} GiB; launches "
              f"{got}; card {smi}")
        return m, eng, got

    def decode_check(cfg, seq, name):
        """``cfg`` in fp32: prefill seq[0] tokens, cache_from_prefill,
        then decode to seq[1] against the full forward's logits."""
        model = build_model(cfg)
        params = model.init(seed=0, dtype=f32, device=dev)
        P, Sq = seq
        toks = torch.tensor(np.random.RandomState(5).randint(
            1, cfg.vocab_size, size=(1, Sq + 1)), device=dev)
        FA.reset_launches()
        full, _, _ = model.forward(params, toks[:, :Sq], compute_dtype=f32)
        lg, st = model.prefill(params, toks[:, :P], compute_dtype=f32)
        caches = model.cache_from_prefill(st, Sq, dtype=f32)
        errs = [float((lg[:, 0] - full[:, P - 1]).abs().max())]
        for t in range(P, Sq):
            lg, caches = model.decode_step(params, caches, toks[:, t:t + 1],
                                           torch.full((1,), t, device=dev),
                                           compute_dtype=f32)
            errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
        print(f"  {name}: {cfg.num_layers} layers {cfg.layer_kinds}, fp32: "
              f"prefill {P} tokens, cache_from_prefill, {Sq - P} decode "
              f"steps against the full forward of {Sq}: max abs err "
              f"{max(errs):.3e} (bound {RECURRENT_F32_TOL}; |logits| <= "
              f"{float(full.abs().max()):.2f}); launches {dict(FA.LAUNCHES)}")
        assert all(math.isfinite(e) for e in errs)
        assert max(errs) <= RECURRENT_F32_TOL, \
            "decode drifts from the full forward"
        del full, caches, st
        return model, params, toks

    # ------------------------------------------------- 22 RecurrentGemma
    phase(f"22 {rg.name}: {rg.num_layers} layers {rg.block_pattern}, "
          f"bf16, through ServeEngine, with a {long_prompt}-token prompt "
          f"past the {rg.window}-token window")
    model = build_model(rg)
    t0 = time.perf_counter()
    params = model.init(seed=0, dtype=bf, device=dev)
    sync()
    print(f"  {rg.param_count() / 1e9:.3f} B parameters "
          f"({nbytes(params) / 1e9:.2f} GB bf16), seeded init in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(1)
    prompts = rng.randint(1, rg.vocab_size, size=(n_requests, prompt))
    reqs = [Request(rid=i, prompt=[int(t) for t in prompts[i]],
                    max_new_tokens=new) for i in range(n_requests)]
    reqs.append(Request(rid=n_requests, prompt=[int(t) for t in rng.randint(
        1, rg.vocab_size, size=long_prompt)], max_new_tokens=new))
    m, eng, got = serve(model, params, reqs, long_prompt + new, page)
    launches["recurrentgemma"] = got
    local = rg.layer_kinds.count("local")
    long_out = reqs[-1].output
    print(f"  the {long_prompt}-token request: {len(long_out)} tokens "
          f"(positions {long_prompt}-{long_prompt + new - 1} on a "
          f"{rg.window}-row ring), output[:8] {long_out[:8]}; "
          f"{local} local layers; flash_decode per decode iteration "
          f"{got['flash_decode'] / m['decode_iterations']:.0f}")
    assert len(long_out) == new and long_prompt > rg.window
    if cuda:
        assert got["flash_attention"] == m["prefill_groups"] * local > 0
        assert got["flash_decode"] == m["decode_iterations"] * local > 0
    del params, eng, model
    free()
    model, params, toks = decode_check(
        dataclasses.replace(rg, num_layers=3), rg_check, rg.name)
    loss, grads = value_and_grad(
        lambda pp, b: model.loss_fn(pp, b, compute_dtype=f32))(
            params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    paths = leaf_paths(grads)
    zero = [p for p in paths if not bool(get_path(grads, p).abs().sum() > 0)]
    finite = all(bool(torch.isfinite(get_path(grads, p)).all())
                 for p in paths)
    print(f"  value_and_grad(loss_fn) over {toks.shape[1] - 1} tokens: loss "
          f"{float(loss):.5f}; {len(paths)} leaves, all finite {finite}, "
          f"zero {zero}; peak {peak_gib():.2f} GiB")
    assert finite and not zero and math.isfinite(float(loss))
    del model, params, grads
    free()

    # --------------------------------------------------------- 23 RWKV-6
    n_rwkv, rwkv_prompt, rwkv_new = rwkv_serve
    phase(f"23 {rwkv.name}: {rwkv.num_layers} layers, bf16, through "
          "ServeEngine (attention-free: no flash kernel on this path)")
    model = build_model(rwkv)
    params = model.init(seed=0, dtype=bf, device=dev)
    print(f"  {rwkv.param_count() / 1e9:.3f} B parameters "
          f"({nbytes(params) / 1e9:.2f} GB bf16)")
    prompts = np.random.RandomState(1).randint(1, rwkv.vocab_size,
                                               size=(n_rwkv, rwkv_prompt))
    reqs = [Request(rid=i, prompt=[int(t) for t in prompts[i]],
                    max_new_tokens=rwkv_new) for i in range(n_rwkv)]
    m, eng, got = serve(model, params, reqs, rwkv_prompt + rwkv_new, page)
    launches["rwkv6"] = got
    H = rwkv.d_model // rwkv.rwkv_head_size
    s_bytes = rwkv.num_layers * H * rwkv.rwkv_head_size ** 2 * 4
    per_slot = nbytes(eng.kv.store) / slots
    print(f"  state per slot: S {s_bytes} B fp32 ({rwkv.num_layers} x {H} "
          f"heads x {rwkv.rwkv_head_size}^2 x 4 B) + shifts "
          f"{per_slot - s_bytes:.0f} B = {per_slot:.0f} B")
    assert per_slot == s_bytes + rwkv.num_layers * 2 * rwkv.d_model * 2
    assert got["flash_attention"] == got["flash_decode"] == 0
    del params, eng, model
    free()
    decode_check(dataclasses.replace(rwkv, num_layers=2), rwkv_check,
                 rwkv.name)
    free()

    # ------------------------------------------------------- 24 Whisper
    phase(f"24 {whisper.name}: {whisper.encoder_layers} + "
          f"{whisper.num_layers} layers, bf16: encode, build_cross_cache, "
          f"{whisper_steps} greedy decode_steps")
    model = build_model(whisper)
    ref_model = build_model(dataclasses.replace(whisper, attn_backend="ref"))
    params = model.init(seed=0, dtype=bf, device=dev)
    print(f"  {whisper.param_count() / 1e9:.3f} B parameters "
          f"({nbytes(params) / 1e9:.2f} GB bf16)")
    Fr = whisper.max_source_positions
    gen = torch.Generator(device=dev).manual_seed(11)
    frames = torch.randn(utterances, Fr, whisper.d_model, generator=gen,
                         device=dev)
    FA.reset_launches()
    sync()
    t0 = time.perf_counter()
    enc = W.encode(params, whisper, frames, compute_dtype=bf)
    cache = model.init_cache(utterances, whisper_steps, dtype=bf,
                             enc_frames=Fr, device=dev)
    cache["cross"] = W.build_cross_cache(params, whisper, enc, dtype=bf)
    sync()
    t_enc = time.perf_counter() - t0
    tok = torch.full((utterances, 1), start, device=dev)
    out = []
    t0 = time.perf_counter()
    for t in range(whisper_steps):
        lg, cache = model.decode_step(
            params, cache, tok, torch.full((utterances,), t, device=dev),
            compute_dtype=bf)
        tok = lg[..., :whisper.vocab_size].argmax(-1)
        out.append(tok)
    sync()
    t_dec = time.perf_counter() - t0
    out = torch.cat(out, 1)
    got = launches["whisper"] = dict(FA.LAUNCHES)
    print(f"  encode + cross cache {t_enc:.3f} s; {whisper_steps} decode "
          f"steps x {utterances} utterances in {t_dec:.3f} s = "
          f"{utterances * whisper_steps / t_dec:.1f} tokens/s; utterance 0 "
          f"tokens[:8] {out[0, :8].tolist()}; cache "
          f"{nbytes(cache) / 1e6:.1f} MB; peak {peak_gib():.2f} GiB; "
          f"launches {got}")
    assert out.shape == (utterances, whisper_steps)
    assert bool(((out >= 0) & (out < whisper.vocab_size)).all())
    if cuda:
        assert got["flash_attention"] == whisper.encoder_layers > 0
        assert got["flash_decode"] == whisper_steps * whisper.num_layers > 0
    ref16 = W.encode(params, ref_model.cfg, frames, compute_dtype=bf)
    p32 = tree_map(lambda t: t.float(), params)
    del params, cache
    ref32 = W.encode(p32, ref_model.cfg, frames, compute_dtype=f32)
    del p32
    e_kern = float((enc.float() - ref32).abs().max())
    e_ref = float((ref16.float() - ref32).abs().max())
    print(f"  encoder output [{utterances}, {Fr}, {whisper.d_model}] "
          f"against fp32: kernel {e_kern:.4f}, plain bf16 {e_ref:.4f} "
          f"(kernel must be <= 2 x plain); max|kernel - plain bf16| "
          f"{float((enc.float() - ref16.float()).abs().max()):.4f}; card "
          f"{smi}")
    assert torch.isfinite(enc).all()
    assert e_kern <= 2 * e_ref, "the encoder's kernel path drifts from fp32"
    del enc, ref16, ref32, model, ref_model
    free()
    args = launcher.parse_args(train_argv + ["--device", dev.type])
    run = launcher.build(args)
    FA.reset_launches()
    _, hist = launcher.train(run)
    wmodel = build_model(launcher.config(args))
    wparams = run.state["params"]
    loss, grads = value_and_grad(
        lambda pp, b: wmodel.loss_fn(pp, b, compute_dtype=f32))(
            wparams, run.batch_fn(0))
    paths = leaf_paths(grads)
    norms = [float(get_path(grads, p).norm()) for p in paths]
    zero = ["/".join(map(str, p)) for p, n in zip(paths, norms) if n == 0]
    print(f"  launch/train.py {' '.join(train_argv)}: losses "
          f"{[h['loss'] for h in hist]}; value_and_grad at step 0: loss "
          f"{float(loss):.5f}, {len(paths)} leaves, gradient norm "
          f"{math.sqrt(sum(n * n for n in norms)):.4e}, zero leaves {zero}; "
          f"launches {dict(FA.LAUNCHES)}; peak {peak_gib():.2f} GiB")
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert all(math.isfinite(n) for n in norms) and sum(norms) > 0
    del run, wparams, grads
    free()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device on this host", file=sys.stderr)
        return 1
    t_script = time.perf_counter()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.compression import Compressor
    from repro_torch.data import LMDataConfig, make_lm_batches
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import onebit as K1
    from repro_torch.kernels import qsgd as KQ
    from repro_torch.kernels import terngrad as KT
    from repro_torch.kernels import topk as KK
    from repro_torch.kernels.terngrad.ref import std0
    from repro_torch.kernels.flash_attention.flash_attention import \
        decode_chunk
    from repro_torch.kernels.flash_attention.ref import decode_mask
    from repro_torch.models import build_model
    from repro_torch.models.transformer import tree_map
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.request import Request
    from repro_torch.core.precision import FP32
    from repro_torch.core.tree import get_path, leaf_paths
    from repro_torch.checkpoint import (ModelRegistry, load_checkpoint,
                                        save_checkpoint)
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as launcher
    from repro_torch.obs.trace import (canonical_bytes, find_spans,
                                       load_trace, strip_wall, tracing,
                                       validate_trace)
    from repro_torch.serve import generate
    from repro_torch.serve.autoscale import poisson_trace
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import cosine_warmup
    from repro_torch.train import (Strategy, Trainer, TrainState,
                                   make_bucketed_allreduce,
                                   make_sharded_train_step, make_train_step,
                                   train_loop, value_and_grad)
    from repro_torch.train.train_loop import step_generator

    # ------------------------------------------------------------ 1 device
    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ------------------------------------------------------------- 2 build
    phase("build")
    t0 = time.perf_counter()
    lib = kbuild.build()
    kbuild.library()
    print(f"built {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, regs, spills in kernel_resources(
            (kbuild.build_dir() / "build.log").read_text()):
        print(f"  {name}: {regs} registers, {spills}")

    # ------------------------------------------------------------- 3 check
    phase("kernels against plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    worst = {"flash_attention": 0.0, "flash_decode": 0.0}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for S, causal, window in ((PROMPT, True, 0), (PROMPT, True, 128),
                                  (PROMPT, False, 0), (300, True, 0)):
            q = randn(B, S, H, HD, dtype=dtype)
            k, v = randn(B, S, KV, HD, dtype=dtype), randn(B, S, KV, HD,
                                                            dtype=dtype)
            e = max_err(FA.attention(q, k, v, causal=causal, window=window),
                        FA.attention_ref(q, k, v, causal=causal,
                                         window=window))
            print(f"flash_attention {str(dtype)[6:]:8s} S={S} causal={causal}"
                  f" window={window}: max_abs_err {e:.3e} (tol {tol})")
            assert e <= tol, "flash_attention disagrees with its plain version"
            worst["flash_attention"] = max(worst["flash_attention"], e)
        for L, window, pos in ((MAX_LEN, 0, [0, 17, 63, 64, 200, 300, 511, 575]),
                               (128, 128, [5, 60, 127, 128, 129, 300, 575, 1000])):
            q = randn(B, 1, H, HD, dtype=dtype)
            ck, cv = randn(B, L, KV, HD, dtype=dtype), randn(B, L, KV, HD,
                                                              dtype=dtype)
            pos = torch.tensor(pos, device=dev)
            e = max_err(FA.decode(q, ck, cv, pos, window=window),
                        FA.decode_ref(q, ck, cv, pos, window=window))
            print(f"flash_decode    {str(dtype)[6:]:8s} L={L} window={window}"
                  f" pos={pos.tolist()}: max_abs_err {e:.3e} (tol {tol})")
            assert e <= tol, "flash_decode disagrees with its plain version"
            worst["flash_decode"] = max(worst["flash_decode"], e)
        # TinyLlama's full context: prefill S=2048 (B=2); decode L=2048 with
        # positions on both sides of every split-K chunk edge and past L,
        # and a ring buffer written only up to pos < W (unwritten chunks)
        q = randn(2, FULL, H, HD, dtype=dtype)
        k, v = (randn(2, FULL, KV, HD, dtype=dtype) for _ in range(2))
        for causal, window in ((True, 0), (True, 100), (False, 0)):
            e = max_err(FA.attention(q, k, v, causal=causal, window=window),
                        FA.attention_ref(q, k, v, causal=causal,
                                         window=window))
            print(f"flash_attention {str(dtype)[6:]:8s} B=2 S={FULL} causal="
                  f"{causal} window={window}: max_abs_err {e:.3e} (tol {tol})")
            assert e <= tol, "flash_attention disagrees with its plain version"
            worst["flash_attention"] = max(worst["flash_attention"], e)
        chunk = decode_chunk(B, FULL, KV)
        edges = sorted({p for c in range(chunk, FULL, chunk) for p in (c - 1, c)}
                       | {0, FULL - 1, FULL, FULL + 37})
        edges += [0] * (-len(edges) % B)
        cases = [(0, edges[i:i + B]) for i in range(0, len(edges), B)]
        cases.append((FULL, [0, 5, chunk - 1, chunk, 3 * chunk + 1, 700,
                             FULL - 1, FULL + 100]))
        q = randn(B, 1, H, HD, dtype=dtype)
        ck, cv = (randn(B, FULL, KV, HD, dtype=dtype) for _ in range(2))
        for window, pos in cases:
            pos = torch.tensor(pos, device=dev)
            out = FA.decode(q, ck, cv, pos, window=window)
            e = max_err(out, FA.decode_ref(q, ck, cv, pos, window=window))
            print(f"flash_decode    {str(dtype)[6:]:8s} L={FULL} chunk {chunk}"
                  f" window={window} pos={pos.tolist()}: max_abs_err {e:.3e} "
                  f"(tol {tol})")
            assert torch.isfinite(out).all() and e <= tol, \
                "flash_decode disagrees with its plain version"
            worst["flash_decode"] = max(worst["flash_decode"], e)
        # phases 19 and 21: Qwen2-VL-7B's attention (28 query heads on 4
        # KV heads, group 7, head_dim 128) at the serving shapes, and one
        # tp=2 rank of TinyLlama's decode (16 on 2 KV heads), its cache a
        # rank's contiguous block of a rank-major [2, B, L, 2, 64] cache
        q = randn(B, PROMPT, QWEN_H, QWEN_HD, dtype=dtype)
        k, v = (randn(B, PROMPT, QWEN_KV, QWEN_HD, dtype=dtype)
                for _ in range(2))
        e = max_err(FA.attention(q, k, v), FA.attention_ref(q, k, v))
        print(f"flash_attention {str(dtype)[6:]:8s} B={B} S={PROMPT} H="
              f"{QWEN_H} KV={QWEN_KV} hd={QWEN_HD} causal: max_abs_err "
              f"{e:.3e} (tol {tol})")
        assert e <= tol, "flash_attention disagrees with its plain version"
        worst["flash_attention"] = max(worst["flash_attention"], e)
        pos = torch.tensor([0, 63, 64, 127, 300, 511, 512, 575], device=dev)
        for h, kv_, hd, ranks in ((QWEN_H, QWEN_KV, QWEN_HD, 1),
                                  (H // 2, KV // 2, HD, 2)):
            q = randn(B, 1, h, hd, dtype=dtype)
            ck, cv = (randn(ranks, B, MAX_LEN, kv_, hd, dtype=dtype)[-1]
                      for _ in range(2))
            e = max_err(FA.decode(q, ck, cv, pos),
                        FA.decode_ref(q, ck, cv, pos))
            print(f"flash_decode    {str(dtype)[6:]:8s} L={MAX_LEN} H={h} "
                  f"KV={kv_} hd={hd}{' (rank 1 of 2)' if ranks > 1 else ''}"
                  f" pos={pos.tolist()}: max_abs_err {e:.3e} (tol {tol})")
            assert e <= tol, "flash_decode disagrees with its plain version"
            worst["flash_decode"] = max(worst["flash_decode"], e)
        # phases 22 and 24: RecurrentGemma-9B's local attention (16 query
        # heads on one KV head, head_dim 256, window 2048) in prefill past
        # the window (bf16; fp32 at S 512, scores also ~16x larger) and
        # the ring decode with slots at positions 100-3000; Whisper's
        # encoder (20 heads, hd 64, non-causal at S 1500, a tail tile)
        S_ = RG_PREFILL if dtype == torch.bfloat16 else RG_PREFILL_F32
        q = randn(1, S_, RG_H, RG_HD, dtype=dtype)
        k, v = (randn(1, S_, 1, RG_HD, dtype=dtype) for _ in range(2))
        for scale in ((1.0,) if dtype == torch.bfloat16 else (1.0, 4.0)):
            qs, ks = q * scale, k * scale
            for window in (RG_WINDOW, 0):
                e = max_err(FA.attention(qs, ks, v, window=window),
                            FA.attention_ref(qs, ks, v, window=window))
                print(f"flash_attention {str(dtype)[6:]:8s} B=1 S={S_} H="
                      f"{RG_H} KV=1 hd={RG_HD} window={window} q, k x"
                      f"{scale}: max_abs_err {e:.3e} (tol {tol})")
                assert e <= tol, \
                    "flash_attention disagrees with its plain version"
                worst["flash_attention"] = max(worst["flash_attention"], e)
        q = randn(B, 1, RG_H, RG_HD, dtype=dtype)
        ck, cv = (randn(B, RG_WINDOW, 1, RG_HD, dtype=dtype) for _ in range(2))
        for window, pos in ((RG_WINDOW, RG_RING_POS),
                            (0, [0, 63, 64, 700, 1023, 1500, 2047, 2100])):
            pos = torch.tensor(pos, device=dev)
            out = FA.decode(q, ck, cv, pos, window=window)
            e = max_err(out, FA.decode_ref(q, ck, cv, pos, window=window))
            print(f"flash_decode    {str(dtype)[6:]:8s} L={RG_WINDOW} H={RG_H}"
                  f" KV=1 hd={RG_HD} window={window} pos={pos.tolist()}: "
                  f"max_abs_err {e:.3e} (tol {tol})")
            assert torch.isfinite(out).all() and e <= tol, \
                "flash_decode disagrees with its plain version"
            worst["flash_decode"] = max(worst["flash_decode"], e)
        q, k, v = (randn(WHISPER_B, WHISPER_F, WHISPER_H, HD, dtype=dtype)
                   for _ in range(3))
        e = max_err(FA.attention(q, k, v, causal=False),
                    FA.attention_ref(q, k, v, causal=False))
        print(f"flash_attention {str(dtype)[6:]:8s} B={WHISPER_B} S="
              f"{WHISPER_F} H={WHISPER_H} hd={HD} non-causal: max_abs_err "
              f"{e:.3e} (tol {tol})")
        assert e <= tol, "flash_attention disagrees with its plain version"
        worst["flash_attention"] = max(worst["flash_attention"], e)
        del q, k, v, ck, cv
    torch.cuda.synchronize()

    worst["onebit_encode_ef"] = 0.0
    onebit_cases = ([(shape, True, False, False) for shape in ONEBIT_SHAPES]
                    + [((8192, 256), True, False, True),      # flat symmetric
                       ((8192, 256), False, True, False)])    # e=None + valid
    for (R, C), has_e, has_valid, symmetric in onebit_cases:
        g = randn(R, C, dtype=torch.float32)
        e = randn(R, C, dtype=torch.float32) if has_e else None
        valid = randn(R, C, dtype=torch.float32) > -0.5 if has_valid else None
        kern = K1.encode_ef(g, e, valid, gain=2.0, symmetric=symmetric)
        plain = K1.onebit_encode_ef_ref(g, e, valid, gain=2.0,
                                        symmetric=symmetric)
        cin = g if e is None else g + 2.0 * e
        scale = cin.abs().amax(-1, keepdim=True)
        signs_equal = torch.equal(kern[0], plain[0])
        err = max(((a - b).abs() / scale).max().item()
                  for a, b in zip(kern[1:], plain[1:]))
        abs_err = max(max_err(a, b) for a, b in zip(kern[1:], plain[1:]))
        print(f"onebit_encode_ef [{R}, {C}] e={has_e} valid={has_valid} "
              f"symmetric={symmetric}: signs equal {signs_equal}, max_abs_err"
              f" {abs_err:.3e}, relative to the row's max|c_in| {err:.3e} "
              f"(tol {ONEBIT_TOL})")
        assert signs_equal, "onebit_encode_ef signs differ from the plain ones"
        assert err <= ONEBIT_TOL, "onebit_encode_ef disagrees with plain"
        worst["onebit_encode_ef"] = max(worst["onebit_encode_ef"], abs_err)
        del g, e, valid, kern, plain, cin
    torch.cuda.empty_cache()

    worst["onebit_compress"] = 0.0
    for R, C in ONEBIT_SHAPES + ((W_DOWN_ROWS, 256), (4096, 200)):
        g = randn(R, C, dtype=torch.float32)
        e = 0.3 * randn(R, C, dtype=torch.float32)
        z = max(1, R // 16)
        e[:z, : C // 2] = -g[:z, : C // 2]          # c exactly 0: sign +1
        kern = K1.compress(g, e)
        plain = K1.onebit_ref(g, e)
        scale = (g + e).abs().amax(-1, keepdim=True)
        signs_equal = torch.equal(kern[0], plain[0])
        zeros_positive = bool((kern[0][:z, : C // 2] == 1).all())
        err = max(((a - b).abs() / scale).max().item()
                  for a, b in zip(kern[1:], plain[1:]))
        abs_err = max(max_err(a, b) for a, b in zip(kern[1:], plain[1:]))
        print(f"onebit_compress [{R}, {C}]: signs equal {signs_equal}, "
              f"sign(0) = +1 {zeros_positive}, max_abs_err {abs_err:.3e}, "
              f"relative to the row's max|c| {err:.3e} (tol {ONEBIT_TOL})")
        assert signs_equal and zeros_positive, \
            "onebit_compress signs differ from the plain ones"
        assert err <= ONEBIT_TOL, "onebit_compress disagrees with plain"
        worst["onebit_compress"] = max(worst["onebit_compress"], abs_err)
        del g, e, kern, plain, scale
    torch.cuda.empty_cache()

    for name in SEGMENT_KERNELS:
        worst[name] = 0.0
    for R, C, S in ((W_DOWN_ROWS, 256, 1), (4 * RING_ROWS, 256, 4),
                    (4096, 200, 4)):
        g = randn(R, C, dtype=torch.float32)
        e = 0.3 * randn(R, C, dtype=torch.float32)
        u = torch.rand(R, C, generator=gen, device=dev)
        th = KK.threshold_for_density(g, e, 0.01, segments=S)
        # the codec's terngrad scale: max|clip(g)| per segment
        s_seg = torch.minimum(g.reshape(S, -1).abs().amax(1),
                              2.5 * std0(g.reshape(S, -1), dim=1))
        pairs = {
            "topk_compress": (KK.sparsify(g, e, th), KK.topk_ref(g, e, th)),
            "terngrad_ternarize": ((KT.ternarize(g, u, s_seg),),
                                   (KT.ternarize_ref(g, u, s_seg),)),
            "terngrad_compress": (KT.compress(g, u, clip_sigma=2.5),
                                  KT.terngrad_ref(g, u, 2.5)),
            "qsgd_compress": (KQ.quantize(g, u, segments=S),
                              KQ.qsgd_ref(g, u, 127, S))}
        for name, (kern, plain) in pairs.items():
            equal = all(torch.equal(a, b) for a, b in zip(kern, plain))
            err = max(max_err(a, b) for a, b in zip(kern, plain))
            kept = (kern[0] != 0).float().mean().item()
            print(f"{name} [{R}, {C}] segments={S}: outputs equal to the "
                  f"plain version's {equal}, max_abs_err {err:.3e}, nonzero "
                  f"share {kept:.4f}")
            assert equal, f"{name} differs from its plain version"
            worst[name] = max(worst[name], err)
        del g, e, u, pairs
    # uniform +-1: 2.5 sigma ~ 1.44 lies above max|g| = 1, so no element
    # reaches the clip and the finishing kernel ternarizes again
    g = 2 * torch.rand(W_DOWN_ROWS, 256, generator=gen, device=dev) - 1
    u = torch.rand(W_DOWN_ROWS, 256, generator=gen, device=dev)
    kern, plain = KT.compress(g, u, clip_sigma=2.5), KT.terngrad_ref(g, u, 2.5)
    equal = all(torch.equal(a, b) for a, b in zip(kern, plain))
    print(f"terngrad_compress [{W_DOWN_ROWS}, 256] uniform +-1 (max|g| "
          f"{g.abs().max().item():.6f} < 2.5 sigma "
          f"{2.5 * std0(g).item():.6f}): outputs equal to the plain "
          f"version's {equal}, scale {kern[1].item():.6f}")
    assert equal, "terngrad_compress differs from its plain version"
    del g, u, kern, plain
    torch.cuda.empty_cache()

    # the quantile threshold against a float64 sort of the same data with
    # the float32 position rule: they differ only in the last rounding
    x = randn(4, RING_ROWS * 256, dtype=torch.float32)
    for density in (0.01, 0.05):
        card = KK.threshold_for_density(x, None, density, segments=4)
        n = x.shape[1]
        pos = np.float32(1.0 - density) * (np.float32(n) - np.float32(1))
        lo, hi = int(np.floor(pos)), int(np.ceil(pos))
        hw = float(pos - np.float32(lo))
        srt = torch.sort(x.abs().double(), dim=1).values
        ref = srt[:, lo] * (1 - hw) + srt[:, hi] * hw
        del srt
        rel = ((card.double() - ref).abs() / ref).max().item()
        print(f"threshold_for_density [4, {n}] density {density}: card "
              f"{card.tolist()}, float64 sort {ref.tolist()}, max relative "
              f"difference {rel:.3e} (tol 1.2e-7: one fp32 rounding)")
        assert rel <= 1.2e-7
    del x
    torch.cuda.empty_cache()

    q = randn(TRAIN_B, TRAIN_S, H, HD, dtype=torch.float32)
    k, v = (randn(TRAIN_B, TRAIN_S, KV, HD, dtype=torch.float32)
            for _ in range(2))
    dout = randn(TRAIN_B, TRAIN_S, H, HD, dtype=torch.float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FA.attention_grad(*leaves)
    out.backward(dout)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.attention_ref(*ref_leaves).backward(dout)
    fwd_equal = torch.equal(out, FA.attention(q, k, v))
    grad_err = max(max_err(a.grad, b.grad) for a, b in zip(leaves, ref_leaves))
    print(f"attention_grad fp32 [{TRAIN_B}, {TRAIN_S}, {H}, {HD}]: forward "
          f"equals flash_attention {fwd_equal}; q/k/v gradients against "
          f"autograd through attention_ref: max_abs_err {grad_err:.3e} "
          f"(tol {GRAD_TOL})")
    assert fwd_equal and grad_err <= GRAD_TOL
    for scale in (1.0, 4.0):
        qs, ks = q * scale, k * scale
        e = max_err(FA.attention(qs, ks, v), FA.attention_ref(qs, ks, v))
        print(f"flash_attention float32  training shape [{TRAIN_B}, {TRAIN_S},"
              f" {H}, {HD}] q, k x{scale}: max_abs_err {e:.3e} (tol "
              f"{F32_TOL})")
        assert e <= F32_TOL, "flash_attention disagrees with its plain version"
        worst["flash_attention"] = max(worst["flash_attention"], e)
    torch.cuda.synchronize()

    # ------------------------------------------------------------ 4 timing
    phase("timing")
    bf = torch.bfloat16
    q, k, v = (randn(B, PROMPT, H, HD, dtype=bf),
               randn(B, PROMPT, KV, HD, dtype=bf),
               randn(B, PROMPT, KV, HD, dtype=bf))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    timing = {}

    def bound(nbytes, flops, peak):
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = flops / peak * 1e3
        return (max(by_bytes, by_ops),
                "bytes" if by_bytes >= by_ops else "operations")

    def measure(name, what, kernel, plain, library, nbytes, flops,
                peak=BF16_FLOPS):
        """Times under ``timing[name]``; ``library`` None: no single
        PyTorch call computes the function."""
        bound_ms, bound_by = bound(nbytes, flops, peak)
        t = timing[name] = dict(
            ms=timed_ms(kernel), plain_ms=timed_ms(plain),
            library_ms=None if library is None else timed_ms(library),
            bound_ms=bound_ms, bound_by=bound_by)
        call_ms = timed_ms(kernel, host_bound=True)
        lib = ("-" if library is None else f"{t['library_ms']:.4f} ms")
        old = (f" [previous design: {PREVIOUS_MS[name]} ms, PERF.md]"
               if name in PREVIOUS_MS else "")
        print(f"{name} ({what}): kernel {t['ms']:.4f} ms on the device{old} "
              f"({call_ms:.4f} ms per call when the host issues it alone), "
              f"plain {t['plain_ms']:.4f} ms, library {lib}, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {nbytes} B, "
              f"{flops} FLOP)")

    measure("flash_attention", f"bf16, causal, B={B} S={PROMPT}",
            lambda: FA.attention(q, k, v, causal=True),
            lambda: FA.attention_ref(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            2 * (q.numel() + k.numel() + v.numel() + q.numel()),
            4 * B * H * HD * PROMPT * (PROMPT + 1) // 2)   # causal pairs

    for key, L, first in (("flash_decode", MAX_LEN, PROMPT),
                          ("flash_decode_2048", FULL, FULL - 64)):
        qd = randn(B, 1, H, HD, dtype=bf)
        ck, cv = randn(B, L, KV, HD, dtype=bf), randn(B, L, KV, HD, dtype=bf)
        pos = torch.tensor([first + 9 * b for b in range(B)], device=dev,
                           dtype=torch.int32)            # mid-serve positions
        mask = decode_mask(pos, L)
        keys = int(mask.sum())                           # valid cache rows
        ckt, cvt, qdt = (t.transpose(1, 2).contiguous() for t in (ck, cv, qd))
        measure(key, f"bf16, B={B} L={L}, pos {first}-{first + 63}, "
                f"{-(-L // decode_chunk(B, L, KV))} x {KV} x {B} blocks",
                lambda: FA.decode(qd, ck, cv, pos),
                lambda: FA.decode_ref(qd, ck, cv, pos),
                lambda: F.scaled_dot_product_attention(
                    qdt, ckt, cvt, attn_mask=mask[:, None, None, :],
                    enable_gqa=True),
                2 * (2 * qd.numel() + 2 * keys * KV * HD) + 4 * B,
                4 * H * HD * keys)

    f32 = torch.float32
    q, k, v = (randn(TRAIN_B, TRAIN_S, H, HD, dtype=f32),
               randn(TRAIN_B, TRAIN_S, KV, HD, dtype=f32),
               randn(TRAIN_B, TRAIN_S, KV, HD, dtype=f32))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    measure("flash_attention_train",
            f"fp32, causal, training shape B={TRAIN_B} S={TRAIN_S}",
            lambda: FA.attention(q, k, v, causal=True),
            lambda: FA.attention_ref(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            4 * (q.numel() + k.numel() + v.numel() + q.numel()),
            3 * 4 * TRAIN_B * H * HD * TRAIN_S * (TRAIN_S + 1) // 2,
            TF32_FLOPS)                                     # 3xTF32

    # the slice's new shapes: RecurrentGemma-9B's local attention at head
    # dim 256 (bf16 prefill past the 2048 window, the fp32 forward, the
    # ring decode) and Whisper's non-causal encoder attention
    S_ = RG_PREFILL
    q, k, v = (randn(1, S_, RG_H, RG_HD, dtype=bf),
               randn(1, S_, 1, RG_HD, dtype=bf), randn(1, S_, 1, RG_HD,
                                                       dtype=bf))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    i = torch.arange(S_, device=dev)
    wmask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - RG_WINDOW)
    measure("flash_attention_hd256",
            f"bf16, causal, window {RG_WINDOW}, B=1 S={S_} H={RG_H} KV=1 "
            f"hd={RG_HD}",
            lambda: FA.attention(q, k, v, window=RG_WINDOW),
            lambda: FA.attention_ref(q, k, v, window=RG_WINDOW),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=wmask, enable_gqa=True),
            2 * (2 * q.numel() + k.numel() + v.numel()),
            4 * RG_H * RG_HD * int(wmask.sum()))           # visible pairs
    S_ = RG_PREFILL_F32
    q, k, v = (randn(1, S_, RG_H, RG_HD, dtype=f32),
               randn(1, S_, 1, RG_HD, dtype=f32), randn(1, S_, 1, RG_HD,
                                                        dtype=f32))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    measure("flash_attention_train_hd256",
            f"fp32, causal, B=1 S={S_} H={RG_H} KV=1 hd={RG_HD}",
            lambda: FA.attention(q, k, v, window=RG_WINDOW),
            lambda: FA.attention_ref(q, k, v, window=RG_WINDOW),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            4 * (2 * q.numel() + k.numel() + v.numel()),
            3 * 4 * RG_H * RG_HD * S_ * (S_ + 1) // 2, TF32_FLOPS)
    qd = randn(B, 1, RG_H, RG_HD, dtype=bf)
    ck, cv = (randn(B, RG_WINDOW, 1, RG_HD, dtype=bf) for _ in range(2))
    pos = torch.tensor(RG_RING_POS, device=dev, dtype=torch.int32)
    mask = decode_mask(pos, RG_WINDOW, RG_WINDOW)
    keys = int(mask.sum())                               # written ring rows
    ckt, cvt, qdt = (t.transpose(1, 2).contiguous() for t in (ck, cv, qd))
    measure("flash_decode_hd256",
            f"bf16, B={B} ring L={RG_WINDOW} H={RG_H} KV=1 hd={RG_HD}, pos "
            f"{RG_RING_POS[0]}-{RG_RING_POS[-1]}",
            lambda: FA.decode(qd, ck, cv, pos, window=RG_WINDOW),
            lambda: FA.decode_ref(qd, ck, cv, pos, window=RG_WINDOW),
            lambda: F.scaled_dot_product_attention(
                qdt, ckt, cvt, attn_mask=mask[:, None, None, :],
                enable_gqa=True),
            2 * (2 * qd.numel() + 2 * keys * RG_HD) + 4 * B,
            4 * RG_H * RG_HD * keys)
    q, k, v = (randn(WHISPER_B, WHISPER_F, WHISPER_H, HD, dtype=bf)
               for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    measure("flash_attention_whisper",
            f"bf16, non-causal, B={WHISPER_B} S={WHISPER_F} H={WHISPER_H} "
            f"hd={HD}",
            lambda: FA.attention(q, k, v, causal=False),
            lambda: FA.attention_ref(q, k, v, causal=False),
            lambda: F.scaled_dot_product_attention(qt, kt, vt),
            2 * 4 * q.numel(),
            4 * WHISPER_B * WHISPER_H * HD * WHISPER_F * WHISPER_F)
    del q, k, v, qt, kt, vt, qd, ck, cv, ckt, cvt, qdt, wmask, mask
    torch.cuda.empty_cache()

    def onebit_bytes(R, C):
        return ONEBIT_BYTES_PER_ELEM * R * C + 8 * R

    R, C = ONEBIT_SHAPES[0]
    g, e = randn(R, C, dtype=f32), randn(R, C, dtype=f32)
    measure("onebit_encode_ef", f"fp32 [{R}, {C}], the lm_head leaf",
            lambda: K1.encode_ef(g, e, gain=2.0),
            lambda: K1.onebit_encode_ef_ref(g, e, gain=2.0), None,
            onebit_bytes(R, C), ONEBIT_FLOP_PER_ELEM * R * C, F32_FLOPS)
    del g, e

    # one worker's encode of a whole full-width step: every leaf of the
    # reference's layout through the compressor, as the engine calls it
    cfg = get_config("tinyllama-1.1b")
    model = build_model(cfg)
    tparams = model.init(seed=0, device=dev)
    leaf_shapes = model.leaf_layout(tparams).shapes(tparams)
    del tparams
    kern_comp, plain_comp = Compressor("onebit"), Compressor("onebit",
                                                             backend="ref")
    step = dict(ms=0.0, plain_ms=0.0, nbytes=0, flops=0)
    for shape in leaf_shapes:
        g, e = randn(*shape, dtype=f32), randn(*shape, dtype=f32)
        n = g.numel()
        chan = shape[-1] if shape[-1] >= kern_comp.min_channel else 256
        step["ms"] += timed_ms(lambda: kern_comp._leaf_onebit(g, e), reps=5)
        step["plain_ms"] += timed_ms(lambda: plain_comp._leaf_onebit(g, e),
                                     reps=5)
        step["nbytes"] += onebit_bytes(-(-n // chan), chan)
        step["flops"] += ONEBIT_FLOP_PER_ELEM * n
        del g, e
    step_bound, step_by = bound(step["nbytes"], step["flops"], F32_FLOPS)
    timing["onebit_encode_ef_step"] = dict(step, bound_ms=step_bound)
    print(f"onebit_encode_ef over one full-width step's {len(leaf_shapes)} "
          f"leaves (one worker): kernel {step['ms']:.4f} ms, plain "
          f"{step['plain_ms']:.4f} ms, bound {step_bound:.4f} ms ({step_by}:"
          f" {step['nbytes']} B)")
    torch.cuda.empty_cache()

    # the slice's four elementwise kernels at the compressor's flat layout
    # of the stacked w_down leaf; the wrappers' reductions (std, max|g|,
    # the l2 norm) are part of the function and of the time
    R = W_DOWN_ROWS
    g, e = randn(R, 256, dtype=f32), 0.3 * randn(R, 256, dtype=f32)
    u = torch.rand(R, 256, generator=gen, device=dev)
    th = KK.threshold_for_density(g, e, 0.01)
    s_one = g.abs().amax()
    calls = {
        "topk_compress": (lambda: KK.sparsify(g, e, th),
                          lambda: KK.topk_ref(g, e, th)),
        "terngrad_ternarize": (lambda: KT.ternarize(g, u, s_one),
                               lambda: KT.ternarize_ref(g, u, s_one)),
        "terngrad_compress": (lambda: KT.compress(g, u, clip_sigma=2.5),
                              lambda: KT.terngrad_ref(g, u, 2.5)),
        "qsgd_compress": (lambda: KQ.quantize(g, u),
                          lambda: KQ.qsgd_ref(g, u))}
    for name, (kern_fn, plain_fn) in calls.items():
        per_byte, per_op = SEGMENT_KERNELS[name]
        measure(name, f"fp32 [{R}, 256], the stacked w_down leaf",
                kern_fn, plain_fn, None, per_byte * R * 256,
                per_op * R * 256, F32_FLOPS)
    # uniform g: the finishing kernel's second pass (9 B more per element)
    g = 2 * torch.rand(R, 256, generator=gen, device=dev) - 1
    per_byte, per_op = SEGMENT_KERNELS["terngrad_compress"]
    measure("terngrad_compress_uniform", f"fp32 [{R}, 256], uniform +-1",
            lambda: KT.compress(g, u, clip_sigma=2.5),
            lambda: KT.terngrad_ref(g, u, 2.5), None, per_byte * R * 256,
            per_op * R * 256, F32_FLOPS)
    del g, e, u, calls
    torch.cuda.empty_cache()

    # onebit_compress (row 4) at the lm_head leaf and the flat w_down layout
    for key, (R, C), what in (
            ("onebit_compress", ONEBIT_SHAPES[0], "the lm_head leaf"),
            ("onebit_compress_flat", (W_DOWN_ROWS, 256),
             "the stacked w_down leaf, flat")):
        g, e = randn(R, C, dtype=f32), 0.3 * randn(R, C, dtype=f32)
        measure(key, f"fp32 [{R}, {C}], {what}",
                lambda: K1.compress(g, e), lambda: K1.onebit_ref(g, e), None,
                ONEBIT_COMPRESS_BYTES * R * C + 4 * R,
                ONEBIT_COMPRESS_FLOP * R * C, F32_FLOPS)
        del g, e
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- 5 serve
    phase("serve full-width TinyLlama-1.1B")
    t0 = time.perf_counter()
    params = model.init(seed=0, dtype=bf, device=dev)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.param_count() / 1e9:.3f} B params, bf16, "
          f"init {time.perf_counter() - t0:.2f} s")
    scfg = ServeConfig(slots=8, max_len=MAX_LEN, page_size=16,
                       policy="continuous", cache_dtype=bf, compute_dtype=bf)
    prompts = np.random.RandomState(1).randint(1, cfg.vocab_size,
                                               size=(16, PROMPT))

    def requests(n, plen, new):
        return [Request(rid=i, prompt=[int(t) for t in prompts[i, :plen]],
                        max_new_tokens=new) for i in range(n)]

    ServeEngine(model, params, scfg, device=dev).run(requests(2, 16, 4))
    reqs = requests(16, PROMPT, NEW)
    eng = ServeEngine(model, params, scfg, device=dev)
    FA.reset_launches()
    m = eng.run(reqs)
    launches = dict(FA.LAUNCHES)
    print(f"{m['completed']} requests, {m['generated_tokens']} tokens in "
          f"{m['wall_s']:.3f} s wall = "
          f"{m['generated_tokens'] / m['wall_s']:.1f} tokens/s; "
          f"{m['prefill_groups']} prefill groups, {m['decode_iterations']} "
          f"decode iterations; launches {launches}")
    print(f"req 0 output[:8] = {reqs[0].output[:8]}")
    assert m["completed"] == 16 and m["generated_tokens"] == 16 * NEW
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.output)
    assert launches["flash_attention"] == m["prefill_groups"] * cfg.num_layers > 0
    assert launches["flash_decode"] == m["decode_iterations"] * cfg.num_layers > 0

    # -------------------------------------------------------------- 6 path
    phase("whole path: kernel vs plain (attn_backend='ref')")
    ref_model = build_model(dataclasses.replace(cfg, attn_backend="ref"))
    toks = torch.tensor(prompts[:8], device=dev)        # first prefill group

    def run_path(m_, p_, dtype, forced=None):
        logits, st = m_.prefill(p_, toks, compute_dtype=dtype)
        caches = m_.cache_from_prefill(st, MAX_LEN, dtype=dtype)
        out = [logits.float()]
        for step in range(4):
            tok = (forced[:, step:step + 1] if forced is not None
                   else out[-1][..., :cfg.vocab_size].argmax(-1))
            pos = torch.full((8,), PROMPT + step, device=dev)
            logits, caches = m_.decode_step(p_, caches, tok, pos,
                                            compute_dtype=dtype)
            out.append(logits.float())
        return torch.cat(out, 1)[..., :cfg.vocab_size]  # [8, 5, V]

    kern = run_path(model, params, bf)
    greedy = kern.argmax(-1)                             # [8, 5]
    ref16 = run_path(ref_model, params, bf, forced=greedy)
    p32 = tree_map(lambda t: t.float(), params)
    ref32 = run_path(ref_model, p32, torch.float32, forced=greedy)
    e_kern, e_ref16 = max_err(kern, ref32), max_err(ref16, ref32)
    agree = int((greedy == ref16.argmax(-1)).sum())
    served = int(sum(reqs[i].output[s] == int(greedy[i, s])
                     for i in range(8) for s in range(5)))
    print(f"logits max|kernel-ref bf16| {max_err(kern, ref16):.4f}; against "
          f"fp32: kernel {e_kern:.4f}, plain bf16 {e_ref16:.4f} (kernel must be"
          f" <= 2 x plain); greedy agreement kernel/plain {agree}/40; "
          f"served tokens equal to this run's greedy tokens {served}/40")
    assert torch.isfinite(kern).all()
    assert served == 40, "served tokens differ from the kernel path's greedy"
    assert e_kern <= 2 * e_ref16, "kernel path drifts from the fp32 model"

    del params, p32, eng, kern, ref16, ref32
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- 7 train
    phase(f"train full-width TinyLlama-1.1B: {TRAIN_SPEC}, fp32")
    f32 = torch.float32
    strat = Strategy.parse(TRAIN_SPEC, lr=0.01)
    K = strat.workers
    batches = make_lm_batches(LMDataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=TRAIN_S,
                                           batch_size=TRAIN_B), device=dev)

    def train(kernels: bool, strat=strat, steps=TRAIN_STEPS):
        """``steps`` steps through Trainer.fit; returns (losses, step ms,
        peak bytes, wire bytes, layout, metrics).  Step boundaries are read
        where the engine asks for worker 0's batch, after a synchronize."""
        m_ = model if kernels else build_model(
            dataclasses.replace(cfg, attn_backend="ref"))
        st_ = strat if kernels else dataclasses.replace(strat,
                                                        kernel_backend="ref")
        p_ = m_.init(seed=0, dtype=f32, device=dev)
        layout = m_.leaf_layout(p_)
        marks = []

        def timed_batches(t, w):
            if w == 0:
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            return batches(t, w)

        grad_fn = value_and_grad(
            lambda pp, b: m_.loss_fn(pp, b, compute_dtype=f32))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, hist, mets = Trainer(st_, device=dev).fit(
            grad_fn, p_, timed_batches, steps, layout=layout)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        del p_
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        return ([h["loss"] for h in hist],
                [1e3 * (b - a) for a, b in zip(marks, marks[1:])], peak,
                mets["wire_bytes"], layout, mets)

    FA.reset_launches()
    K1.reset_launches()
    losses, step_ms, peak, wire, layout, _ = train(kernels=True)
    phase7_losses, phase7_ms = list(losses), list(step_ms)
    train_launches = {"flash_attention": FA.LAUNCHES["flash_attention"],
                      "onebit_encode_ef": K1.LAUNCHES["onebit_encode_ef"]}
    tokens = K * TRAIN_B * TRAIN_S
    for t, (loss, ms) in enumerate(zip(losses, step_ms)):
        print(f"step {t}: loss {loss:.6f}, wall {ms:.1f} ms = "
              f"{tokens / ms * 1e3:.1f} tokens/s")
    print(f"{K} workers x batch {TRAIN_B} x seq {TRAIN_S}; "
          f"{len(layout.names)} leaves; wire {wire // TRAIN_STEPS} B/step; "
          f"peak device memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated); launches {train_launches}")
    assert all(math.isfinite(x) for x in losses) and len(losses) == TRAIN_STEPS
    assert train_launches["flash_attention"] == \
        cfg.num_layers * K * TRAIN_STEPS
    assert train_launches["onebit_encode_ef"] == \
        len(layout.names) * K * TRAIN_STEPS

    FA.reset_launches()
    K1.reset_launches()
    plain_losses, plain_ms, plain_peak, _, _, _ = train(kernels=False)
    assert FA.LAUNCHES["flash_attention"] == 0, "plain path ran a kernel"
    assert K1.LAUNCHES["onebit_encode_ef"] == 0, "plain path ran a kernel"
    diffs = [abs(a - b) for a, b in zip(losses, plain_losses)]
    print(f"kernel path losses {losses}")
    print(f"plain path (kernel_backend='ref', attn_backend='ref', no kernel "
          f"launched): losses {plain_losses}, wall "
          f"{[round(x, 1) for x in plain_ms]} ms, peak "
          f"{plain_peak / 2**30:.2f} GiB; |kernel - plain| per step "
          f"{[f'{d:.2e}' for d in diffs]} (tol 1e-3)")
    assert max(diffs) <= 1e-3, "kernel path's losses drift from the plain path"

    # ----------------------------------------------------------- 8 reduced
    phase("reduced TinyLlama, the BENCH_pr10.json recipe")
    rcfg = cfg.reduced()
    rmodel = build_model(rcfg)
    rparams = rmodel.init(seed=0, device=dev)
    rbatches = make_lm_batches(LMDataConfig(vocab_size=rcfg.vocab_size,
                                            seq_len=16, batch_size=2),
                               device=dev)
    rgrad = value_and_grad(
        lambda pp, b: rmodel.loss_fn(pp, b, compute_dtype=f32))
    for spec, want in (("bsp/allreduce/none@8", 14700544),
                       ("bsp/allreduce/onebit@8", 631744),
                       ("bsp/allreduce/dgc:0.05@8", 2101312)):
        engine = Strategy.parse(spec, lr=0.01, bucket_mb=0.25).build(
            rgrad, layout=rmodel.leaf_layout(rparams), device=dev)
        _, hist, wire = engine.run(rparams, rbatches, 2)
        n_buckets = engine.inner.modeled_timeline(rparams)["n_buckets"]
        print(f"{spec}: wire {wire // 2} B/step (want {want}), {n_buckets} "
              f"buckets (want 7), losses {[h['loss'] for h in hist]}")
        assert wire // 2 == want and n_buckets == 7
        assert all(math.isfinite(h["loss"]) for h in hist)

    # ---------------------------------------------------------- 9 measured
    slice_mods = (FA, K1, KK, KT, KQ)

    def reset_all():
        for mod in slice_mods:
            mod.reset_launches()

    def read_all():
        return {k: v for mod in slice_mods for k, v in mod.LAUNCHES.items()}

    measured_launches = dict.fromkeys(read_all(), 0)
    for spec, wire_mode, steps in MEASURED_RUNS:
        phase(f"train full-width TinyLlama-1.1B: {spec}, wire={wire_mode}, "
              "fp32")
        mstrat = Strategy.parse(spec, lr=0.01, wire=wire_mode)
        reset_all()
        losses, step_ms, peak, wire, _, mets = train(True, mstrat, steps)
        run_launches = read_all()
        for name, count in run_launches.items():
            measured_launches[name] += count
        for t, (loss, ms) in enumerate(zip(losses, step_ms)):
            print(f"step {t}: loss {loss:.6f}, wall {ms:.1f} ms = "
                  f"{tokens / ms * 1e3:.1f} tokens/s")
        ratio = mets["measured_step_tx_bytes"] / mets["fp32_step_tx_bytes"]
        print(f"wire {wire // steps} B/step over {K} workers; per worker "
              f"measured_step_tx_bytes {mets['measured_step_tx_bytes']} "
              f"against fp32_step_tx_bytes {mets['fp32_step_tx_bytes']} = "
              f"{ratio:.4f} (shape-static part); peak device memory "
              f"{peak / 2**30:.2f} GiB; launches {run_launches}")
        assert all(math.isfinite(x) for x in losses) and len(losses) == steps
        assert wire > 0
        assert run_launches["flash_attention"] == cfg.num_layers * K * steps
        method = mstrat.compressor.method
        want = {"onebit": ("onebit_encode_ef",),
                "terngrad": ("terngrad_ternarize",) if wire_mode == "measured"
                else ("terngrad_compress",),
                "qsgd": ("qsgd_compress",),
                "dgc": ("topk_compress", "onebit_encode_ef")}[method]
        assert all(run_launches[name] > 0 for name in want), want
        if wire_mode == "modeled":
            assert run_launches["terngrad_compress"] == \
                len(layout.names) * K * steps
        if method == "onebit":
            assert ratio <= 0.25, "measured bytes above the JAX bound"
        reset_all()
        plain, plain_ms, plain_peak, plain_wire, _, _ = train(False, mstrat,
                                                              steps)
        assert not any(read_all().values()), "plain path ran a kernel"
        diffs = [abs(a - b) for a, b in zip(losses, plain)]
        print(f"kernel path losses {losses}; plain path losses {plain}, "
              f"wall {[round(x, 1) for x in plain_ms]} ms, peak "
              f"{plain_peak / 2**30:.2f} GiB, wire {plain_wire // steps} "
              f"B/step; |kernel - plain| per step "
              f"{[f'{d:.2e}' for d in diffs]} (tol 1e-3)")
        assert max(diffs) <= 1e-3, "kernel path drifts from the plain path"

    # ------------------------------------------------------------ 10 matrix
    phase("onebit.compress over one full-width gradient (two EF rounds)")
    p_ = model.init(seed=0, dtype=f32, device=dev)
    layout = model.leaf_layout(p_)
    grad_fn = value_and_grad(
        lambda pp, b: model.loss_fn(pp, b, compute_dtype=f32))
    _, grads = grad_fn(p_, batches(0, 0))
    del p_
    leaves = list(layout.leaves(grads, consume=True))
    del grads
    # rows along the trailing channel axis, as the compressor lays out a
    # leaf (every leaf of this model has at least 2048 channels)
    rows = [g.reshape(-1, g.shape[-1]) for g in leaves]
    efs = [torch.zeros_like(g) for g in rows]
    reset_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for _ in range(2):
        outs = [K1.compress(g, e) for g, e in zip(rows, efs)]
        inputs = efs
        efs = [o[2] for o in outs]
    torch.cuda.synchronize()
    compress_ms = 1e3 * (time.perf_counter() - t0)
    compress_launches = read_all()
    signs_equal = all(torch.equal(o[0], K1.onebit_ref(g, e)[0])
                      for o, g, e in zip(outs, rows, inputs))
    print(f"{len(rows)} leaves ({sum(g.numel() for g in rows)} elements), "
          f"2 rounds in {compress_ms:.1f} ms wall; launches "
          f"{compress_launches}; last round's signs equal to onebit_ref's "
          f"{signs_equal}")
    assert compress_launches["onebit_compress"] == 2 * len(rows)
    assert signs_equal
    del leaves, rows, efs, outs, inputs
    torch.cuda.empty_cache()

    def matrix_run(spec, kernels: bool, steps, backend="auto", **kw):
        """``steps`` global steps through Trainer.fit; returns (history,
        wall ms, peak bytes, metrics)."""
        m_ = model if kernels else build_model(
            dataclasses.replace(cfg, attn_backend="ref"))
        st_ = Strategy.parse(spec, lr=0.01, backend=backend,
                             kernel_backend="auto" if kernels else "ref",
                             **kw)
        p_ = m_.init(seed=0, dtype=f32, device=dev)
        layout = m_.leaf_layout(p_)
        grad_fn = value_and_grad(
            lambda pp, b: m_.loss_fn(pp, b, compute_dtype=f32))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, hist, mets = Trainer(st_, device=dev).fit(
            grad_fn, p_, batches, steps, layout=layout)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        del p_
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        return hist, wall, peak, mets

    matrix_launches = dict.fromkeys(read_all(), 0)
    for spec, kw, steps in MATRIX_RUNS:
        backends = ("auto", "sim") if spec.startswith("ssp") else ("auto",)
        device_hist = None
        for backend in backends:
            phase(f"train full-width TinyLlama-1.1B: {spec}, backend="
                  f"{backend}, {kw or 'wire=modeled'}, fp32")
            reset_all()
            hist, wall, peak, mets = matrix_run(spec, True, steps, backend,
                                                **kw)
            run_launches = read_all()
            for name, count in run_launches.items():
                matrix_launches[name] += count
            events = len(hist)
            losses = [h["loss"] for h in hist]
            for h in hist:
                print(f"event {h['step']}: worker {h.get('worker', '-')}, "
                      f"max_staleness {h['max_staleness']}, loss "
                      f"{h['loss']:.6f}")
            print(f"{events} events in {wall:.1f} ms = {wall / events:.1f} ms"
                  f" per event; wire {mets['wire_bytes'] // steps} B/step; "
                  f"peak device memory {peak / 2**30:.2f} GiB; launches "
                  f"{run_launches}")
            assert all(math.isfinite(x) for x in losses)
            sync = spec.split("/")[0].split(":")[0]
            per_step = 1 if sync in ("bsp", "sma") else 0
            assert events == (steps if per_step else steps * K)
            assert run_launches["flash_attention"] == cfg.num_layers * (
                K * steps if per_step else events)
            if "onebit" in spec:
                assert run_launches["onebit_encode_ef"] > 0
                if sync == "ssp":
                    assert run_launches["onebit_encode_ef"] == \
                        len(layout.names) * events
            if kw.get("wire") == "measured":
                ratio = (mets["measured_step_tx_bytes"]
                         / mets["fp32_step_tx_bytes"])
                print(f"per worker measured_step_tx_bytes('ps') "
                      f"{mets['measured_step_tx_bytes']} against the fp32 "
                      f"ring's {mets['fp32_step_tx_bytes']} = {ratio:.4f}")
                assert mets["wire_bytes"] == \
                    mets["measured_step_tx_bytes"] * K * steps
                assert 0.5 < ratio < 0.55
            if backend == "sim":
                seq = [(h["worker"], h["max_staleness"]) for h in hist]
                dseq = [(h["worker"], h["max_staleness"])
                        for h in device_hist]
                diffs = [abs(a["loss"] - b["loss"])
                         for a, b in zip(hist, device_hist)]
                print(f"sim against device: same event sequence "
                      f"{seq == dseq}; |sim - device| per event "
                      f"{[f'{d:.2e}' for d in diffs]} (tol 1e-3)")
                assert seq == dseq and max(diffs) <= 1e-3
            device_hist = device_hist or hist
            reset_all()
            plain, plain_wall, plain_peak, _ = matrix_run(spec, False, steps,
                                                          backend, **kw)
            assert not any(read_all().values()), "plain path ran a kernel"
            diffs = [abs(a["loss"] - b["loss"]) for a, b in zip(hist, plain)]
            print(f"plain path: {plain_wall:.1f} ms, peak "
                  f"{plain_peak / 2**30:.2f} GiB, losses "
                  f"{[h['loss'] for h in plain]}; |kernel - plain| per event "
                  f"{[f'{d:.2e}' for d in diffs]} (tol 1e-3)")
            assert len(plain) == events and max(diffs) <= 1e-3
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 11 launcher
    phase("launcher: repro_torch.launch.train.main, full width, "
          "Adam + onebit")
    fp32_argv = LAUNCH_ARGV + ["--compute-dtype", "float32"]
    bf16_argv = LAUNCH_ARGV + ["--compute-dtype", "bfloat16"]
    reset_all()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist32 = launcher.main(fp32_argv)
    torch.cuda.synchronize()
    peak32 = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    print(f"main({fp32_argv}) above; peak device memory "
          f"{peak32 / 2**30:.2f} GiB")
    hist16 = launcher.main(bf16_argv)
    torch.cuda.synchronize()
    trainer_launches = read_all()
    torch.cuda.empty_cache()
    print(f"main({bf16_argv}) above; launches of both runs "
          f"{trainer_launches}")
    args32 = launcher.parse_args(fp32_argv)
    n_leaves = len(layout.names)
    assert trainer_launches["flash_attention"] == 2 * 3 * cfg.num_layers
    assert trainer_launches["onebit_encode_ef"] == 2 * 3 * n_leaves
    assert all(math.isfinite(h["loss"]) for h in hist32 + hist16)
    reset_all()
    _, plain32 = launcher.train(launcher.build(args32, attn_backend="ref",
                                               kernel_backend="ref"))
    assert not any(read_all().values()), "plain path ran a kernel"
    torch.cuda.empty_cache()
    diffs = [abs(a["loss"] - b["loss"]) for a, b in zip(hist32, plain32)]
    print(f"fp32 kernel path losses {[h['loss'] for h in hist32]}; plain "
          f"path {[h['loss'] for h in plain32]}; |kernel - plain| per step "
          f"{[f'{d:.2e}' for d in diffs]} (tol 1e-3); wire_bytes "
          f"{[h['wire_bytes'] for h in hist32]} and "
          f"{[h['wire_bytes'] for h in plain32]}; lr "
          f"{[h['lr'] for h in hist32]} and {[h['lr'] for h in plain32]}")
    print(f"bf16 kernel path losses {[h['loss'] for h in hist16]}")
    assert len(plain32) == len(hist32) == 3 and max(diffs) <= 1e-3
    assert [h["wire_bytes"] for h in hist32] == \
        [h["wire_bytes"] for h in plain32]
    assert [h["lr"] for h in hist32] == [h["lr"] for h in plain32]

    # one batch's gradients per JAX leaf: bf16 kernel and plain paths
    # against the plain fp32 path
    ref_model = build_model(dataclasses.replace(cfg, attn_backend="ref"))
    p_ = model.init(seed=0, device=dev)
    batch = make_lm_batches(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=args32.seq_len,
        batch_size=args32.batch_size), device=dev)(0, 0)

    def grad_leaves(m_, dtype):
        _, g = value_and_grad(
            lambda pp, b: m_.loss_fn(pp, b, compute_dtype=dtype))(p_, batch)
        return list(layout.leaves(g, consume=True))

    g32 = grad_leaves(ref_model, torch.float32)
    dists = {}
    for name, m_ in (("kernel", model), ("plain", ref_model)):
        dists[name] = [torch.linalg.vector_norm(a - b).item() for a, b in
                       zip(grad_leaves(m_, bf), g32)]
    del p_, g32
    torch.cuda.empty_cache()
    ratios = [k / p for k, p in zip(dists["kernel"], dists["plain"])]
    kern_d, plain_d = ([f"{x:.3e}" for x in dists[k]]
                       for k in ("kernel", "plain"))
    print(f"bf16-compute gradients of one batch, ||g_bf16 - g_fp32|| per "
          f"JAX leaf ({n_leaves}): kernel {kern_d}; plain {plain_d}; "
          f"kernel/plain median {statistics.median(ratios):.4f}, worst "
          f"{max(ratios):.4f} "
          f"({layout.names[ratios.index(max(ratios))]}; tol "
          f"{BF16_GRAD_FACTOR})")
    assert max(ratios) <= BF16_GRAD_FACTOR, \
        "bf16 kernel-path gradients drift from fp32"

    # the warm step's two halves timed apart (the kernel path, fp32)
    run = launcher.build(args32)
    state, step = run.state, run.step
    gen = torch.Generator().manual_seed(0)
    for t in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, mets, leaves, wire = step._worker(
            state["params"], run.batch_fn(t), state["ef"],
            step_generator(gen))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, _ = step._update(state, leaves, mets, loss, wire)
        del leaves
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    trained = state.pop("params")      # phase 13's checkpoint, fp32
    del run, state
    torch.cuda.empty_cache()
    warm_ms, update_ms = 1e3 * (t2 - t0), 1e3 * (t2 - t1)
    tokens = args32.batch_size * args32.seq_len
    print(f"warm (third) step {warm_ms:.1f} ms = {tokens / warm_ms * 1e3:.1f}"
          f" tokens/s: gradient and compression {1e3 * (t1 - t0):.1f} ms, "
          f"Adam update {update_ms:.1f} ms = {update_ms / warm_ms:.1%} of "
          f"the step; peak device memory of the fp32 run "
          f"{peak32 / 2**30:.2f} GiB; card {smi}")

    # ----------------------------------------------------------- 12 trainer
    phase(f"trainer: make_sharded_train_step, full width, {TRAIN_SPEC}, "
          "AdamW, fp32")
    strat = Strategy.parse(TRAIN_SPEC, lr=0.01)
    assert (strat.bucket_mb, strat.order) == (4.0, "tictac")

    def stacked(t):
        per = [batches(t, w) for w in range(K)]
        return tree_map(lambda *xs: torch.stack(xs), *per)

    def trainer_run(kernels: bool):
        """3 steps of the K-worker trainer; returns (history, peak bytes,
        bucket count)."""
        m_ = model if kernels else ref_model
        comp = (strat.compressor if kernels else
                dataclasses.replace(strat.compressor, backend="ref"))
        p_ = m_.init(seed=0, device=dev)
        lay = m_.leaf_layout(p_)
        reduce_fn = make_bucketed_allreduce(
            p_, topology=strat.topology, bucket_mb=strat.bucket_mb,
            order=strat.order, layout=lay)
        opt = AdamW(0.01)
        step = make_train_step(
            m_.loss_fn, opt,
            cosine_warmup(TRAINER_LR, TRAINER_WARMUP, TRAIN_STEPS),
            precision=FP32, compressor=comp, reduce_fn=reduce_fn,
            layout=lay)
        state = TrainState.create(p_, opt, comp, lay)
        del p_
        state["ef"] = [torch.zeros((K,) + e.shape, device=dev)
                       for e in state["ef"]]
        sharded = make_sharded_train_step(step, K, compressed=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, hist = train_loop(sharded, state, stacked, TRAIN_STEPS,
                             log_every=1)
        del state
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        return hist, peak, len(reduce_fn.fused_layers)

    reset_all()
    hist, peak, n_buckets = trainer_run(kernels=True)
    run_launches = read_all()
    for name, count in run_launches.items():
        trainer_launches[name] += count
    p_ = model.init(seed=0, device=dev)
    engine_buckets = strat.build(
        value_and_grad(lambda pp, b: model.loss_fn(pp, b)),
        layout=layout, device=dev).inner.modeled_timeline(p_)["n_buckets"]
    del p_
    walls = [b["wall_s"] - a["wall_s"] for a, b in zip(hist, hist[1:])]
    print(f"losses {[h['loss'] for h in hist]}; lr {[h['lr'] for h in hist]};"
          f" wire_bytes {[h['wire_bytes'] for h in hist]}; step walls after "
          f"the first {[f'{1e3 * w:.1f}' for w in walls]} ms "
          f"({K} x {TRAIN_B} x {TRAIN_S} tokens per step); peak device "
          f"memory {peak / 2**30:.2f} GiB; {n_buckets} buckets "
          f"(DeviceEngine {engine_buckets}); launches {run_launches}")
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert n_buckets == engine_buckets
    assert run_launches["flash_attention"] == \
        cfg.num_layers * K * TRAIN_STEPS
    assert run_launches["onebit_encode_ef"] == n_leaves * K * TRAIN_STEPS
    reset_all()
    plain, plain_peak, _ = trainer_run(kernels=False)
    assert not any(read_all().values()), "plain path ran a kernel"
    diffs = [abs(a["loss"] - b["loss"]) for a, b in zip(hist, plain)]
    print(f"plain path losses {[h['loss'] for h in plain]}, peak "
          f"{plain_peak / 2**30:.2f} GiB; |kernel - plain| per step "
          f"{[f'{d:.2e}' for d in diffs]} (tol 1e-3)")
    assert len(plain) == TRAIN_STEPS and max(diffs) <= 1e-3
    assert [h["wire_bytes"] for h in hist] == \
        [h["wire_bytes"] for h in plain]
    del ref_model
    torch.cuda.empty_cache()

    # -------------------------------------------------------- 13 quickstart
    phase("quickstart at full width: save, register, load, generate")

    def leaf_list(tree):
        return [get_path(tree, p) for p in leaf_paths(tree)]

    def leaves_equal(a, b):
        return leaf_paths(a) == leaf_paths(b) and all(
            x.device.type == "cuda" and x.dtype == y.dtype
            and torch.equal(x, y) for x, y in zip(leaf_list(a),
                                                   leaf_list(b)))

    n_bytes = sum(t.numel() * t.element_size() for t in leaf_list(trained))
    root = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        ck, ck_incr = os.path.join(root, "ckpt"), os.path.join(root, "incr")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        man = save_checkpoint(ck, trained, step=3, hash_leaves=True)
        save_s = time.perf_counter() - t0
        reg = ModelRegistry(os.path.join(root, "registry"))
        mid = reg.register("chip_smoke", ck, arch=cfg.name,
                           metrics={"loss": hist32[-1]["loss"]})
        t0 = time.perf_counter()
        restored, step_no = load_checkpoint(reg.get(mid)["checkpoint"],
                                            trained)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        direct_equal = leaves_equal(restored, trained)
        del restored
        t0 = time.perf_counter()
        man2 = save_checkpoint(ck_incr, trained, step=3, incremental_from=ck)
        incr_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, _ = load_checkpoint(ck_incr, trained)
        torch.cuda.synchronize()
        incr_load_s = time.perf_counter() - t0
        incr_equal = leaves_equal(restored, trained)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gib = n_bytes / 2**30
    print(f"{len(man['leaves'])} leaves, {gib:.2f} GiB fp32 in "
          f"{man['shards']} shards; registered {mid}; host disk: save (with "
          f"sha256 per leaf) {save_s:.2f} s = {gib / save_s:.2f} GiB/s, "
          f"load onto the card {load_s:.2f} s = {gib / load_s:.2f} GiB/s, "
          f"incremental save {incr_s:.2f} s ({man2['linked_shards']} of "
          f"{man2['shards']} shards linked), its load {incr_load_s:.2f} s; "
          f"bitwise equal: direct {direct_equal}, incremental {incr_equal}; "
          f"card {smi}")
    assert step_no == 3 and direct_equal and incr_equal
    assert man2["linked_shards"] == man2["shards"] == man["shards"] > 1
    prompt = np.random.RandomState(13).randint(1, cfg.vocab_size,
                                               size=QUICK_PROMPT)
    reset_all()
    t0 = time.perf_counter()
    out_restored = generate(model, restored, prompt, QUICK_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    del restored
    out_memory = generate(model, trained, prompt, QUICK_NEW)
    quick_launches = read_all()
    del trained
    torch.cuda.empty_cache()
    print(f"generate {QUICK_NEW} tokens from a {QUICK_PROMPT[0]} x "
          f"{QUICK_PROMPT[1]} prompt in {gen_s:.2f} s: restored "
          f"{out_restored[:, QUICK_PROMPT[1]:].tolist()}; equal to the "
          f"in-memory parameters' {torch.equal(out_restored, out_memory)}; "
          f"launches {quick_launches}")
    assert out_restored.shape == (QUICK_PROMPT[0],
                                  QUICK_PROMPT[1] + QUICK_NEW)
    assert torch.equal(out_restored, out_memory)
    assert quick_launches["flash_attention"] == 2 * cfg.num_layers
    assert quick_launches["flash_decode"] == \
        2 * (QUICK_NEW - 1) * cfg.num_layers

    # ------------------------------------------------------ 14 traced serve
    phase(f"traced serve: repro_torch.launch.serve, bf16, full width, "
          f"serve_bench traffic, --slo {SERVE_SLO}")
    params16 = model.init(seed=0, dtype=bf, device=dev)
    arrivals = [0.0] + poisson_trace(BENCH_RATE, BENCH_HORIZON,
                                     seed=BENCH_SEED)
    # serve_bench.py draws its prompts over the reduced config's vocab, and
    # the budgets drawn after them depend on that draw
    rng = np.random.RandomState(BENCH_SEED)
    bench_prompts = rng.randint(1, cfg.reduced().vocab_size,
                                size=(len(arrivals), BENCH_PROMPT))
    budgets = rng.choice(BENCH_BUDGETS, size=len(arrivals))

    def bench_requests():
        return [Request(rid=i, prompt=[int(t) for t in bench_prompts[i]],
                        max_new_tokens=int(budgets[i]), arrival=arrivals[i])
                for i in range(len(arrivals))]

    trace_path = os.path.join(tempfile.mkdtemp(prefix="chip-smoke-trace-"),
                              "serve.json")

    alert_times = {}

    def serve_run(argv):
        """(metrics, token outputs, wall-stripped trace or None); the
        engine's SLO alert times go to ``alert_times`` under the argv."""
        reqs = bench_requests()
        m_, eng_, rec = serve_launcher.serve(serve_launcher.parse_args(argv),
                                             model, params16, reqs, dev)
        alert_times[tuple(argv)] = [a["t"] for a in eng_.slo_alerts]
        tr = None if rec is None else load_trace(trace_path)
        return m_, [r.output for r in reqs], tr

    base_argv = ["--slots", str(BENCH_SLOTS), "--max-len",
                 str(BENCH_MAX_LEN), "--dtype", "bf16", "--device", "cuda",
                 "--slo", SERVE_SLO]
    serve_run(base_argv + ["--pages", "0"])              # warm-up
    serve_launches = dict.fromkeys(read_all(), 0)
    serve_walls = []
    for policy in ("continuous", "oneshot"):
        for pages in (0, 4):
            argv = base_argv + ["--policy", policy, "--pages", str(pages)]
            traced_argv = argv + ["--trace", trace_path]
            reset_all()
            m0, outs0, _ = serve_run(argv)
            m1, outs1, tr1 = serve_run(traced_argv + ["--report"])
            m2, outs2, tr2 = serve_run(traced_argv)
            for name, count in read_all().items():
                serve_launches[name] += count
            stats = validate_trace(tr1, strict=True)
            identical = (canonical_bytes(strip_wall(tr1))
                         == canonical_bytes(strip_wall(tr2)))
            iters = m0["decode_iterations"] + m0["prefill_groups"]
            walls = [m_["wall_s"] for m_ in (m0, m1, m2)]
            serve_walls.append((walls, iters))
            cols = {k: (round(m1[k], 4) if isinstance(m1[k], float)
                        else m1[k]) for k in BENCH_PR7[policy]}
            print(f"{policy}, pages {pages}: {cols} (BENCH_pr7.json "
                  f"{BENCH_PR7[policy]}); slo_alerts {m1['slo_alerts']}; "
                  f"trace {stats['events']} events, {stats['spans']} spans,"
                  f" strictly valid, identical across two traced runs "
                  f"{identical}; tokens equal untraced "
                  f"{outs1 == outs0 and outs2 == outs0}; wall untraced "
                  f"{walls[0]:.3f} s, traced {walls[1]:.3f} and "
                  f"{walls[2]:.3f} s = {1e3 * walls[0] / iters:.2f}, "
                  f"{1e3 * walls[1] / iters:.2f} and "
                  f"{1e3 * walls[2] / iters:.2f} ms per engine iteration "
                  f"({iters})")
            assert cols == BENCH_PR7[policy], (policy, pages)
            assert identical and outs1 == outs0 and outs2 == outs0
            assert m1["slo_alerts"] == m2["slo_alerts"] == m0["slo_alerts"]
            assert len(find_spans(tr1, "queued")) == m1["completed"]
    shutil.rmtree(os.path.dirname(trace_path), ignore_errors=True)
    del params16
    torch.cuda.empty_cache()
    untraced_ms = sum(w[0] for w, _ in serve_walls) / sum(
        n for _, n in serve_walls)
    traced_ms = sum(w[1] + w[2] for w, _ in serve_walls) / (2 * sum(
        n for _, n in serve_walls))
    print(f"per engine iteration over the 4 cells: untraced "
          f"{1e3 * untraced_ms:.3f} ms, traced {1e3 * traced_ms:.3f} ms "
          f"({100 * (traced_ms / untraced_ms - 1):+.1f}%); launches "
          f"{serve_launches}; card {smi}")
    assert serve_launches["flash_attention"] > 0
    assert serve_launches["flash_decode"] > 0

    # ------------------------------------------------------ 15 traced train
    phase("traced training: the launcher with --trace --report, and "
          f"{TRAIN_SPEC} under tracing")
    trace_dir = tempfile.mkdtemp(prefix="chip-smoke-trace-")
    train_trace = os.path.join(trace_dir, "train.json")
    reset_all()
    hist_t = launcher.main(fp32_argv + ["--trace", train_trace, "--report"])
    traced_launches = read_all()
    tr = load_trace(train_trace)
    validate_trace(tr, strict=True)
    walls_u = [b["wall_s"] - a["wall_s"] for a, b in zip(hist32, hist32[1:])]
    walls_t = [b["wall_s"] - a["wall_s"] for a, b in zip(hist_t, hist_t[1:])]
    print(f"launcher traced losses {[h['loss'] for h in hist_t]}, untraced "
          f"(phase 11) {[h['loss'] for h in hist32]}; step walls after the "
          f"first: untraced {[f'{1e3 * w:.1f}' for w in walls_u]} ms, "
          f"traced {[f'{1e3 * w:.1f}' for w in walls_t]} ms; "
          f"{len(find_spans(tr, 'step'))} step spans")
    assert [h["loss"] for h in hist_t] == [h["loss"] for h in hist32]
    assert len(find_spans(tr, "step")) == 3
    reset_all()
    with tracing(train_trace):
        losses_t, ms_t, _, _, _, mets_t = train(True, strat, 2)
    for name, count in read_all().items():
        traced_launches[name] += count
    tr = load_trace(train_trace)
    shutil.rmtree(trace_dir, ignore_errors=True)
    validate_trace(tr, strict=True)
    ex = find_spans(tr, "exchange")
    hop_bytes = sum(ev["args"]["tx_bytes"] for ev in tr["traceEvents"]
                    if ev.get("name") == "hop")
    print(f"{TRAIN_SPEC} traced losses {losses_t}, untraced (phase 7) "
          f"{phase7_losses[:2]}; step walls traced "
          f"{[f'{x:.1f}' for x in ms_t]} ms, untraced "
          f"{[f'{x:.1f}' for x in phase7_ms[:2]]} ms; {len(ex)} exchange "
          f"spans of {[e['args']['n_buckets'] for e in ex]} buckets "
          f"(DeviceEngine {engine_buckets}); hop bytes {hop_bytes} = 2 x "
          f"measured_step_tx_bytes {mets_t['measured_step_tx_bytes']}; "
          f"launches {traced_launches}; card {smi}")
    assert losses_t == phase7_losses[:2]
    assert len(ex) == 2 and all(e["args"]["n_buckets"] == engine_buckets
                                for e in ex)
    assert len(find_spans(tr, "compute")) == 2
    assert hop_bytes == 2 * mets_t["measured_step_tx_bytes"]
    del model
    torch.cuda.empty_cache()

    # --------------------------------------------- 16-17 elastic training
    burn_times = alert_times[tuple(base_argv + ["--policy", "continuous",
                                                "--pages", "0"])]
    reset_all()
    elastic_phases(cfg, dev, smi, arrivals, BENCH_HORIZON, burn_times)
    elastic_launches = read_all()
    print(f"launches of phases 16-17 {elastic_launches}")

    # ------------------------------------------------------------ 18 hybrid
    reset_all()
    hybrid_phases(cfg, dev, smi)
    hybrid_launches = read_all()
    print(f"launches of phase 18 {hybrid_launches}")

    # ------------------------------------------ 19-21 tp decode, families
    family_launches, tp_ref = family_phases(
        dev, smi, cfg, get_config("deepseek-v2-lite-16b"),
        get_config("qwen2-vl-7b"))
    print(f"launches of phases 19-21 {family_launches}")

    # ------------------------- 22-24 the recurrent and encoder-decoder families
    recurrent_launches = recurrent_phases(dev, smi,
                                          get_config("recurrentgemma-9b"),
                                          get_config("rwkv6-7b"),
                                          get_config("whisper-large-v3"))
    print(f"launches of phases 22-24 {recurrent_launches}")

    # ------------------------------------------------------- 25 the dry-run
    dryrun_launches = dryrun_phases(dev, smi)
    long_kernel_checks(dev, measure, worst)

    # ----------------------------------------- 26 the torch.distributed axis
    torch.cuda.empty_cache()
    dist_launches = dist_phases(cfg, dev, smi)
    print(f"launches of phase 26 {dist_launches}")

    # --------------------------- 27 the elastic interface and hybrid ranks
    torch.cuda.empty_cache()
    p27_launches = elastic_hybrid_phases(cfg, dev, smi, tp_ref)
    print(f"launches of phases 27-28 {p27_launches}")

    # ------------------------------------------------------------- results
    src = "src/repro_torch/kernels/csrc/"
    sources = {"flash_attention": (src + "flash_attention.cu",
                                   "src/repro/kernels/flash_attention/flash_attention.py:69"),
               "flash_decode": (src + "flash_decode.cu",
                                "src/repro/kernels/flash_attention/flash_attention.py:160"),
               "onebit_encode_ef": (src + "onebit_encode_ef.cu",
                                    "src/repro/kernels/onebit/fused.py:75"),
               "onebit_compress": (src + "onebit_compress.cu",
                                   "src/repro/kernels/onebit/onebit.py:32"),
               "topk_compress": (src + "topk_compress.cu",
                                 "src/repro/kernels/topk/topk.py:24"),
               "terngrad_ternarize": (src + "terngrad.cu",
                                      "src/repro/kernels/terngrad/terngrad.py:27"),
               "terngrad_compress": (src + "terngrad.cu",
                                     "src/repro/kernels/terngrad/terngrad.py:55"),
               "qsgd_compress": (src + "qsgd_compress.cu",
                                 "src/repro/kernels/qsgd/qsgd.py:21")}
    by_path = {name: {"serve": launches.get(name, 0),
                      "train": train_launches.get(name, 0),
                      "measured": measured_launches[name],
                      "compress": compress_launches.get(name, 0),
                      "matrix": matrix_launches[name],
                      "trainer": trainer_launches[name],
                      "quickstart": quick_launches[name],
                      "traced_serve": serve_launches[name],
                      "traced_train": traced_launches[name],
                      "elastic": elastic_launches[name],
                      "hybrid": hybrid_launches[name],
                      "tp_serve": family_launches["tp_serve"].get(name, 0),
                      "deepseek": family_launches["deepseek"].get(name, 0),
                      "qwen2_vl": family_launches["qwen2_vl"].get(name, 0),
                      **{path: got.get(name, 0)
                         for path, got in recurrent_launches.items()},
                      "dryrun": dryrun_launches.get(name, 0),
                      **{path: got.get(name, 0)
                         for path, got in dist_launches.items()},
                      **{path: got.get(name, 0)
                         for path, got in p27_launches.items()}}
               for name in sources}
    # the flash kernels at the slice's new shapes (phase 4's lines)
    shapes = {"flash_attention": ("flash_attention_hd256",
                                  "flash_attention_train_hd256",
                                  "flash_attention_whisper",
                                  "flash_attention_32k"),
              "flash_decode": ("flash_decode_hd256", "flash_decode_32k",
                               "flash_decode_ring_hd64",
                               "flash_decode_ring_hd256")}
    kernels = [dict(name=n, route="cuda", source=sources[n][0],
                    replaces=sources[n][1],
                    launches=sum(by_path[n].values()),
                    launches_by_path=by_path[n],
                    max_abs_err=worst[n], ms=timing[n]["ms"],
                    plain_ms=timing[n]["plain_ms"],
                    bound_ms=timing[n]["bound_ms"],
                    bound_by=timing[n]["bound_by"],
                    library_ms=timing[n]["library_ms"],
                    **({"at_shapes": {key: timing[key]
                                      for key in shapes[n]}}
                       if n in shapes else {}))
               for n in sources]
    assert all(math.isfinite(x["ms"]) for x in kernels)
    assert by_path["flash_attention"]["trainer"] > 0
    assert by_path["onebit_encode_ef"]["trainer"] > 0
    assert by_path["onebit_encode_ef"]["traced_train"] > 0
    assert by_path["flash_attention"]["elastic"] > 0
    assert by_path["onebit_encode_ef"]["elastic"] > 0
    assert by_path["flash_attention"]["hybrid"] > 0
    assert by_path["onebit_encode_ef"]["hybrid"] > 0
    for path in ("tp_serve", "qwen2_vl", "recurrentgemma", "whisper",
                 "dryrun"):
        assert by_path["flash_attention"][path] > 0
        assert by_path["flash_decode"][path] > 0
    for path in ("dist", "dist_trainer"):
        assert by_path["flash_attention"][path] > 0
        assert by_path["onebit_encode_ef"][path] > 0
    assert all(by_path[name]["dist"] > 0 for name in DIST_KERNEL.values())
    for path in ("dist_elastic", "dist_hybrid"):
        assert by_path["flash_attention"][path] > 0
        assert by_path["onebit_encode_ef"][path] > 0
    assert by_path["topk_compress"]["dist_hybrid"] > 0
    assert by_path["flash_attention"]["dist_tp"] > 0
    assert by_path["flash_decode"]["dist_tp"] > 0
    assert by_path["onebit_encode_ef"]["dist_hybrid_elastic"] > 0
    print(f"chip_smoke.py wall {time.perf_counter() - t_script:.1f} s "
          f"(kernel build included)")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

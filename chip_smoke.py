#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device and build: CUDA and sm_90 present; the card's name and power
     limit; every hand-written kernel built from ``param_tpu_torch/kernels/
     csrc`` (one nvcc per source, in parallel); ptxas's registers and
     spills per library, and per K6 / K7 kernel.
  2. K1 (embedding bag) against its plain PyTorch version on the card: the
     1M x 128 f32 headline shape (B 8192, nnz 30, indices shifted per
     iteration), the DLRM trainer's shape (flat 8 x 100k x 64 table, 2048 x 8
     bags of 10) in f32 and bf16.  Every K1 shape (here and in phases 22
     and 25) records the launch shape ``emb_gather_schedule`` gave it and
     must give the same bits on two launches.
  3. The dedup (``kernels/dedup.py``, ``csrc/dedup.cu``) against its plain
     version (one gradient row a lookup, then ``dedup_row_updates``) on the
     same ids and pooled gradient: one batch of the trainer's (2048 x 8
     bags of 10 over the flat 800k x 64 table), and the benchmark cells'
     shapes (8 x 1M rows of 64, batch 16384, 100 uniform ids a bag; 26 x
     4M rows of 128, batch 32768, one zipf(1.15) id a feature, scale
     -0.01) and the first with zipf(1.15) ids, whose hot rows run over
     thousands of chunks.  Rows exactly, sums within rtol 1e-4 plus 1e-6
     of their terms' summed magnitudes, a zero tail, the same bits on two
     calls; each shape's device time by kernel (``torch.profiler`` in a
     fresh process).  Then K2 (sparse row update) against its plain
     version, SGD and Adagrad, on the trainer's table with the first
     shape's dedup output (163840 slots, the unused tail dropped as ids >=
     R).
  4. Timings: kernel, plain version, one library call computing the same
     function (none for the dedup), and the least time the card could
     take (the dedup's: the ids and the pooled gradient read once, its
     rows and sums written once).
  5. Model parity: a small DLRM's logits and one step of each sparse
     optimizer on the card (kernels) against the same on the CPU (plain
     versions).
  6. The DLRM trainer at the CLI's full default width through
     ``param_tpu_torch.cli.dlrm.main`` for 5 batches each of sparse_adagrad,
     sparse_sgd and dense adagrad, with the launch counts reset just before
     and read just after: K1 must have launched, K2 and the dedup in the
     sparse steps.
  7. K3 (tiled GEMM) against its plain version (f32 torch.matmul of the
     same inputs, TF32 off) in bf16, f16 and f32 at GEMM_A / GEMM_C shapes
     (with the split-K shapes (128, 1024, 1024) and (1024, 1024, 128)) and
     a ragged (100, 100, 100); library call torch.matmul in the same dtype.
     Each row names the path taken (wgmma, mma_sync or simt, from the
     launch counters) and its K splits; an aligned 16-bit shape must take
     wgmma.  A planted fault (one element of B negated between the plain
     call and the kernel's) must break the tolerance.
  8. K4 (weight-resident GEMMs): S = 8 x (128, 4096, 4096) bf16, on the
     wgmma path; library call torch.matmul on the stacked A.
  9. K5 (int4 GEMM): llama2-7B MLP projections (M, 4096) @ (4096, 11008)
     and (M, 11008) @ (11008, 4096), g = 128, at M = 1, 8, 32, and MLP_A's
     (512, 4096) @ (4096, 4096), with bf16-exact scales.  Each row names
     its path (stream up to M = 32, wgmma at 512, from the launch
     counters) and K splits; its f32-output kernel is held to 1e-5 x
     max |want| and its bf16-output kernel (the main path's) to one bf16
     ulp of max |want| against the plain version rounded to bf16, and so
     is the parent's design (mma_sync and its reduce kernel, the path of
     unaligned products); each must give the same bits twice.  It prints the
     ptxas registers and spills of its path's kernels and the profiler's
     kernel split (one kernel; the parent design's main kernel and its
     reduce), and times the parent's design (the mma_sync kernel and its
     reduce kernel, still in the source) beside it.  A planted fault (one
     packed byte changed between the plain call and the kernel's, at M = 1
     and 512) must break the tolerance.  Library call:
     torch._weight_int4pack_mm on the same nibbles (q + 8 unsigned, zero
     point 0, bf16 scales; the one-off _convert_weight_to_int4pack is not
     timed); torch.matmul on the dequantized bf16 weight is timed beside it
     as a different function.
 10. The compute-tier CLIs in-process at full width, the launch counts
     reset before each command and read after it: ``cli.compute gemm``
     (GEMM_A bf16 through K3's wgmma path; GEMM_C --compare; --weight-
     resident 8 through K4), ``emb --dataset baseline`` (K1), ``emb`` at the
     trainer's width in bf16 (K1; the bf16 entry's launches), ``linear``, and
     ``cli.inference --dtype int4`` (K5, 18 layers, all on the wgmma path;
     beside it the int8 and bf16 rungs, and int4 / int8 at batch 1); one
     int4 forward launches K5 exactly 18 times, all on wgmma, and a small
     int4 MLP on the card agrees with the CPU plain path.
 11. K6 (flash-attention forward) against its plain version (f32
     attention on upcast inputs) with the logsumexp: llama2 (1, 32, 2048,
     128) causal, gpt2 (8, 12, 1024, 64), GQA 32 / 8 heads, a window of
     512, S_q 128 < S_k 2048 causal, f32 (the tf32x3 path) at llama2 (1,
     32, 2048, 128) causal, gpt2 (8, 12, 1024, 64) and (1, 4, 512, 64)
     causal, and a ragged length 1000; library call
     F.scaled_dot_product_attention (enable_gqa for GQA, the boolean mask
     for the window and the rectangular case).  Each row names the path it
     took (from the launch counters), which must be the one
     ``flash_schedule`` gives and, for 16-bit inputs at D 64 / 128, wgmma.
     Every element is held to its own bound (``flash_fwd_tolerance``), and
     that bound must flag a planted fault (a dropped diagonal kv entry) on
     the bf16 and the f32 llama2 rows.  f32 rows are bounded at the
     split-TF32 rate (TF32 / 3, 165 TF/s).
 12. Transformer parity: a small block (emb 512, 8 heads; f32, f32 GQA and
     bf16) through block_apply (flash), prefill, four windowed decode_steps
     and an int4 decode_step on the card against the same on the CPU.
 13. The serving CLIs in-process at llama2 width with launch counts:
     ``attention --dataset llama2 --paths xla,flash,dpa`` and
     ``transformer --dataset llama2 --fwd-only`` (K6), ``attention
     --dtype float32 --paths flash,dpa`` at llama2 and gpt2 (K6 on the
     tf32x3 path), ``decode --dataset
     llama3-gqa``, ``serve --dataset llama2`` in bf16 and int4 (K5, exactly
     4 launches per decode step, all on the stream path); K5 alone (as in
     phase 9) at the serve path's QKV (M, 4096) @ (4096, 12288) and output
     (M, 4096) @ (4096, 4096) projections at M = 1, 8, 32; host-clock time
     against the card's kernel time (torch.profiler) for the llama2 block
     forward and the bf16 / int4 decode step at batch 1 and 32, the int4
     step also with K5 on the parent's design.
 14. K7 (flash-attention backward) against its plain version (f32 on
     upcast inputs) from K6's output and lse and a random dO: llama2 (1,
     32, 2048, 128) causal, contiguous and in the train step's layout
     (q / k / v strided head views of one fused projection, dO a
     transposed-head view), the other ATTN_LLAMA2 shapes (1, 32, 4096,
     128) and (4, 32, 2048, 128) causal, gpt2 (8, 12, 1024, 64), GQA 32 /
     8 heads, S_q 128 < S_k 2048 causal, f32 at llama2 (1, 32, 2048, 128)
     causal, gpt2 (8, 12, 1024, 64) and (1, 4, 512, 64) causal, a ragged
     length 1000 and head dim 32; each row's path as in phase 11; every
     element of dq, dk and dv within its own bound
     (``flash_bwd_tolerance``), which must flag a planted fault (a dropped
     diagonal kv entry) in each on the bf16 and f32 llama2 rows; those two
     rows run twice must give bitwise-equal gradients; library call
     aten._scaled_dot_product_flash_attention_backward on SDPA's own
     forward residuals where it computes the same function, and for GQA
     and f32 SDPA's backward through autograd (enable_gqa for GQA), timed
     by its kernel time in torch.profiler, with the kernels that name the
     backend PyTorch picked (K7 is timed that way too on those rows).
 15. Train-step parity: a small block (emb 512, 8 heads; f32, f32 GQA and
     bf16) trained two steps by make_train_step on the card against the
     same on the CPU, losses and every parameter; K6 and K7 launch once
     per step.
 16. The training CLIs in-process at llama2 width with launch counts:
     ``attention --dataset llama2 --grad --paths xla,flash,dpa`` (one K7
     per K6), ``transformer --dataset llama2 --paths flash,xla`` (K6 and
     K7 exactly once per flash train step) and ``attention --dataset llama2
     --dtype float32 --grad --paths flash,dpa`` (K6 and K7 on the tf32x3
     path); host-clock time against the
     card's kernel time for the llama2 train step on flash and xla, with
     the shares of K6, K7 and the cuBLAS GEMMs.
 17. K8a-d (ring all-gather, ring reduce-scatter, both-direction ring
     all-gather, loopback) on one card: first the op API of
     ``param_tpu_torch.ops.ring_collectives`` (ring_all_gather,
     ring_all_reduce, ring_all_gather_bidir, loopback_remote_copy) at n 1,
     2, 4, 8 ranks, 1 MiB a rank, and at n 8, 8 MiB, with the launch counts
     reset before and read after: every kernel, and K8a / K8b on each of
     their routes (copy, memory, K8b's cluster), must have launched;
     then each kernel against its plain version at n 1, 2, 4, 8 with
     per-rank payloads of 4 KiB, 1 MiB and 64 MiB in f32 and 1 MiB in
     bf16, every byte equal; a planted fault (rank 0 sends its first hop
     to right + 1) must raise from the bounded wait, and the next call
     must be right again (K8b on both its routes).  Each K8a-d row
     prints its plan (blocks a rank, slice bytes, lag, slots and where
     they are, scope); each K8b row over 2 to 8 ranks is also held and
     timed on its other route (cluster or memory, through
     ``ring.forced_route``), and K8b also runs at 2, 4 and 16 MiB a rank
     on both routes, about where ``ring_plan`` switches between them.
     Library yardsticks, on a
     stack X of the shards made before the timed window: K8a and K8c
     ``X.expand(n, n, L).contiguous()`` (``X.clone()`` over one rank,
     where that is a view), K8b ``X.view(n, n, c).sum(0)``, K8d
     ``X.clone()``.  K8d's n = 1, 64 MiB row also times, in the same
     call, the kernel K8a-c take over one rank (the same copy without
     the handshake).
     With two or more cards the rings also run with one rank per card,
     timed beside NCCL's all-gather and reduce-scatter at the same per-rank
     shape (``torch.cuda.nccl``), and once behind a peer card still busy
     with earlier work; with one card the wire between cards is unchecked.
 18. ``cli.comms`` on the card: a world of one on NCCL in-process,
     all_reduce, all_gather, reduce_scatter, all_to_all, broadcast and
     pt2pt from 8 B to 64 MiB with dcheck, and all_reduce / all_gather
     replayed from CUDA graphs (``--mode graph``); with two or more cards
     also ``torchrun`` worlds of all of them (pairwise pt2pt eagerly and
     from CUDA graphs among them); every row's dcheck OK.
 19. The coalesced-fetch kernels and the headline bench, at the
     experiment's full sizes (table 1,048,576 x 128 f32): K9 (k-row bulk
     fetch, tile sums) at k 1, 2, 4, 8, 16, 32 (262,144 rows, 4096 a tile)
     against its plain version within rtol 1e-4, timed beside
     ``F.embedding_bag`` over each tile's row ids (its library call), and a
     planted fault (one start shifted by one row) must break that
     comparison; K10 (block-
     coalesced bag, r_blk 8, 16 bags a tile, one launch planning its own
     tiles) at B 8192 x nnz 32 uniform and zipf ids against the plain bag
     (K1's) within rtol 1e-5, NaN bags included, and K1 at the same ids
     (stage B's shape) against it too; K10's per-tile block copies
     equal to the plain planning stage's (``coalesce_plan``) counts; two
     calls bitwise equal; an id moved by one row must break the
     comparison; one profiled ``coalesced_bag`` call must run K10 and no
     other kernel; timed beside K1 and F.embedding_bag (its library call),
     with the parent design's pre-pass + K10 and K10-alone times quoted
     beside (recorded in PERF.md, not measured by this run).  Then
     ``param_tpu_torch.bench.main()`` (the 1M x 128 headline through K1)
     and ``experiments.coalesce.main()`` (--verify, then stages A and B)
     in-process, the launch counts reset before and read after: K1, K9 and
     K10 must each have launched, and the bench's JSON line must hold a
     finite GB/s.
 20. The sharded DLRM (``DlrmModel`` over a ``torch.distributed`` group):
     in a world of one on NCCL at the CLI's full default width, two steps
     each of dense adagrad, sparse_sgd and sparse_adagrad against the
     single-device model on the card (rtol 1e-5, atol 1e-6 on losses,
     parameters and accumulators); ``cli.dlrm.main`` with no flags (the
     per-region bench) and with ``--optimizer sparse_adagrad``, all 21
     reference rows finite and positive and a ``QPS:`` line; its
     ``--print-comms`` pattern.  The launch counts are reset before each
     sharded run and read after: K1 and K2 must have launched, and the dot
     interaction's kernels once each way a step.  With two or
     more cards, ``cli.dlrm`` under torchrun over all of them:
     ``--train-batches 5`` for each optimizer (rank 0's first loss equal to
     phase 6's within rtol 1e-5) and the default bench.
 21. The multi-device transformer tier in a world of one on NCCL at
     llama2-7B width (``param_tpu_torch.experiments.parallel_tier``'s
     checks, the launch counts reset before each parallel run and read
     after): ring attention (1, 32, 2048, 128) bf16 causal against K6
     within flash_fwd_tolerance; ring attention over 4 sequence shards in
     one process ((1, 32, 4096, 128) bf16 and (1, 4, 2048, 64) f32,
     causal), each rank's steps fed the shards in ring order, held to the
     plain version and to K6 over the whole sequence, with its K6 launches
     and times; the dp x tp step (1, 1), two bf16 steps equal to
     ``make_train_step``'s (rtol 1e-5), K6 and K7 once each a step, its
     host and kernel ms beside the single-device step's; the pipeline step
     with one stage and 4 microbatches, its loss the single-device step's
     on batch 4 within rtol 1e-3, K6 and K7 4 times each; the MoE layer
     with one expert (emb 4096, ffn 11008, 8192 tokens, bf16) against
     ``moe_apply_reference``, and one train step; the dp x tp MLP step
     (512-512-256-1, batch 2048, f32) equal to the plain step (rtol 1e-5).
     With two or more cards, ``experiments.parallel_tier`` under torchrun
     over all of them in f32, each path against the single-card result.
 22. The comms remainder and the comm-trace replay in a world of one on
     NCCL, in-process, at the CLIs' default widths: K1 at the
     comms-compute bench's lookup shape (100000 x 128 f32, 2048 bags x 30)
     against its plain version and timed (phase 4's way); the quantized
     all_reduce and reduce at 16 and 8 bits from 8 B to 64 MiB, every
     element within one quantization step of the quantize -> dequantize
     round trips of its input (the bf16 cast; two int8 round trips), and a
     planted fault (phase 2 dequantized with scale 1) must break that;
     ``cli.comms --bitwidth 16`` and ``8`` (all_reduce, reduce, 8 B to 64
     MiB, dcheck OK, ``quant_us`` finite); ``cli.comms --backend
     torchcomms`` (all_reduce, all_gather, reduce_scatter, all_to_all,
     broadcast, pt2pt, dcheck OK) and ``--backend mock``; ``cli.overlap``
     (same group, all_reduce + all_gather, 64K to 4M; every time finite,
     efficiency in [0, 1]); ``cli.comms_compute`` with gemm, emb_lookup,
     d2h and h2d at the defaults (K1 must launch in emb_lookup's run); an
     all_reduce, all_to_all sweep recorded with ``--trace-dump`` and
     ``--trace-dump-et`` and replayed blocking by ``cli.replay`` from each
     file (the replayed ops, their count and their sizes equal the
     recorded ones) and by a ``--dry-run``; the replay of a trace with an
     emb_lookup op at the comms-compute shape (K1 must launch); and
     ``cli.comms --bitwidth 8 --profile``, whose device-time split must
     show non-zero comm and quant time.  The launch counts are reset
     before each of those runs and read after.  With two or more cards,
     ``experiments.comms_remainder`` under torchrun over all of them: the
     quantized all_reduce / reduce at 8 and 16 bits against f32 (rtol 0.02
     / 1e-2 of the largest sum), the overlap bench (same group; split-pgs
     at an even count of 4+), comms-compute gemm, and a sweep recorded and
     replayed by that world.
 23. The execution-trace tier at the trainer's full default width (8 x
     100,000 x 64 f32, nnz 10, MLPs 512-256-64 / 512-256-1, batch 2048): the
     forward, ``make_train_step(Sgd)``, ``make_sparse_sgd_step`` and
     ``make_sparse_adagrad_step`` captured on the card (``trace.capture``);
     each graph holds as many ``param_tpu_torch::emb_gather`` /
     ``::sparse_update`` nodes as the direct call launches K1 / K2.  Each
     is replayed with the real inputs (3 iterations after 1 warm-up): no
     error, no skipped node, every output equal to the direct call's
     within rtol 1e-5, atol 1e-6 (the dense step's ``index_add_`` adds in
     atomic order, so not bitwise), K1 / K2 launched 4 x the direct
     count, the launch counts reset before each replay and read after.
     A planted fault (one table row of the replay's inputs + 1) must break
     the forward's comparison.  Each replay's iter_s, qps and top five
     per-op times (a replay of one iteration after one warm-up, each op
     synchronised) beside the direct call's host ms.  ``cli.et`` capture /
     validate / replay / codegen for dlrm, mlp and dlrm_train in-process
     (K1 launched in the dlrm replay), and the generated dlrm script in a
     subprocess (``replayed N ops OK``, K1 launched).  Dry-run path 4: the
     table-wise sharded dense step in a world of one on NCCL
     (``experiments.et_sharded``) captured and replayed equal to the
     direct step, its saved trace replayed by ``cli.replay --trace-type
     et --blocking``: exactly ``comms_from_et``'s 6 comm ops.  With two or
     more cards, ``experiments.et_sharded`` under torchrun over all of
     them, each rank's replay equal to its own direct step.  Phases 2 and 3
     also time K1 and K2 issued eagerly through their registered ops
     beside the wrappers' own eager time.
 24. The op-level PyTorch-ET replay at the fixtures' llama2-7B attention
     width (d 4096, 32 x 128 heads, S 2048, FFN 16384, 4 layers; f32 and
     ``--cast bf16``), after an unrecorded warm-up replay:
     ``cli.pt_et`` on ``transformer_long_et`` unfused and with ``--fuse
     attention``, and on ``transformer_train_long_et`` unfused and with
     ``--fuse attention-train``, the launch counts reset before each run
     and read after: no op skipped, 4 forward (and 4 backward) windows,
     as many ``fused::flash_attention`` (``_bwd``) calls, and K6 (K7)
     launched twice a call (untimed, timed), all on tf32x3 in f32 and on
     wgmma in bf16, none unfused.  Each run's ms in its timed calls, wall
     s, top five ops and peak device memory.  Window 0's K6 output in the
     replay, f32 and bf16: bitwise a direct K6 call on the same q / k / v
     views, and within ``flash_fwd_tolerance`` of the plain version (in
     f32 scaled by max |v|: phase 13's bound is for unit-scale inputs) on
     every row whose softmax cannot turn over under the products' rounding
     (at least 90% of them).  ``--chain`` on the bf16 train fixture: the
     CUDA graph captured, its two replays running 8 each of
     ``flash_fwd_wgmma``, ``flash_bwd_dq_wgmma`` and ``flash_bwd_dkv_wgmma``
     by ``torch.profiler`` kernel names (the wrappers' counters do not see
     a graph replay), and its ms an iteration beside discrete mode's.  The
     generated script of ``transformer_train_et`` in a subprocess on the
     card (``replayed 226 ops OK``), ``cli.analyze`` of phase 22's replay
     details, and ``cli.scaling --collective all_reduce --size 64M
     --worlds 2 4 8 16 64`` (the model's rows, not a measurement).
 25. The operator microbench tier, the launch counts reset before each of
     its main-path runs and read after: ``cli.run_benchmark`` on
     ``configs/basic_ops.json`` and ``transformer_ops.json`` (``-b``) and
     ``llama2.json`` (the llama2-7B projection GEMMs at full width, bf16,
     forward) in chain mode, and ``basic_ops`` in discrete mode: every
     record free of errors (BatchedEmbedding's backward is "no
     differentiable tensor args", as in the JAX package), every latency
     finite and positive, the run ids those of the config's iterators and
     of a CPU run, and the config's ``BatchedEmbedding`` (4 x 1,000 x 16
     f32, 32 bags x 8) rebuilt on the card: 4 K1 launches a forward, its
     output within phase 2's rtol 1e-5 of the plain bag; ``BatchedEmbedding``
     at the DLRM trainer's width (8 x 100,000 x 64 f32, batch 2048, nnz 10,
     an inline config): exactly 8 K1 launches a forward, its output within
     rtol 1e-5 of the plain bag, and a ``--profile-dir`` run whose device
     ops name K1's kernel; every registered op but Dropout (the registry's
     names checked against the phase's specs; the f32-output bf16 matmuls'
     gradients too), AlexNet and ResNetSmall (32 x 224 x 224 x 3, the CPU
     model's weights carried to the card) on the card against the CPU on
     the same inputs (elementwise f32 1e-6, sums 1e-4 of max |out|, 16-bit
     outputs two bf16 ulps of it); ``cli.cvt`` over all 11 layers at batch
     32, forward and forward + backward, f32 and bf16, and a conv_proj and
     a patch_embed layer on the card against the CPU (1e-4 of max |out|);
     ``tune_matmul`` at (2048, 4096) @ (4096, 4096) bf16, GEMM_C (1024,
     4096) @ (4096, 1024) f32 and (128, 1024) @ (1024, 1024) bf16: five
     rounds of graph replays of each candidate in turns (median and
     spread, the model's estimate, the default schedule's, torch.matmul's),
     every candidate within phase 7's tolerance of K3's plain version, and
     a planted fault (B's largest element negated under the best schedule)
     flagged; the device's busy share (``torch.profiler`` device time over
     the eager call's time, in a fresh process) of a trainer-width
     ``BatchedEmbedding`` forward, two ops' backward passes and CvT layers
     forward and forward + backward.  K1 is timed at both of its
     ``BatchedEmbedding`` shapes (phase 4's way), and each tuned shape's
     default schedule (``gemm_schedule``'s pick) as phase 7 times K3.
 26. The MLP steps (``ops.mlp.make_train_step`` / ``infer_step``): three
     steps at MLP_A's width (18 layers of 4096, batch 1024) in f32 and
     bf16 with sgd and adagrad, finite losses and every parameter and loss
     bitwise equal to the same steps written out by hand (autograd and the
     optimizer, as ``bench_mlp`` had them inline), no kernel of the port
     launched (the products are ``torch.matmul``, as in the reference), and
     the step's ms; ``infer_step`` there bitwise ``mlp_forward`` under
     ``no_grad``, and its ms; at (3, 256, 512, 64, 128) both optimizers,
     both losses (MSE, cross-entropy on integer labels) and both dtypes for
     three steps on the card against the CPU (f32 at the tests' tolerance,
     1e-5 x max |leaf| beside rtol 1e-5; bf16 two ulps of the layer's max
     |param|: the tests hold each leaf to its own max, but a bias starts at
     zero and is three updates made from cancelling bf16 gradient sums,
     which reached 5 ulps of its own max on the card; the per-leaf ulps are
     printed), and ``infer_step`` the same way; ``cast_int4_mlp`` then
     ``mlp_forward_int4`` at the inference bench's (18, 4096, 4096, 4096,
     512): exactly one K5 launch a layer, all wgmma (the counts reset just
     before the forward and read just after), the output bitwise the raw
     carriers' call, and both calls' ms; a ``param_profile`` region around
     a train step inside a CUDA ``torch.profiler`` session, named in its
     events, with its host time and the session's device time.
 27. Per-feature bags (DLRM-DCNv2's multi-hot features, port_bench's
     ``dcnv2.adagrad.multihot``: 26 features of the published sizes, 214
     ids a sample, batch 8192, over its flat 54,184,588 x 128 f32 tables,
     each feature's ids uniform over its table): K1 in one launch over the
     B x 214 real ids against its plain version (rtol 1e-5 of max |want|,
     the same bits on two launches, one launch a call), and the dedup on
     those ids and a pooled gradient against its plain version (phase 3's
     checks); each timed as phase 4 times them, with the launch shape K1
     took, and bounded by bytes (K1: unique rows, ids and pooled rows; the
     dedup: ids, the pooled gradient, rows and sums written once); K1
     beside ``F.embedding_bag`` over the same layout (the flattened ids, a
     bag starting at each feature's offset of each sample), which it must
     match; then ``DlrmModel``'s DCN sparse Adagrad step at the cell's
     widths, bag sizes and batch (tables capped at 1M rows), the launch
     counts reset just before four steps: one K1, one dedup and one K2
     Adagrad launch a step and no other kernel of the port, or it fails.
 28. The dot interaction (``kernels/interaction.py``, one kernel each way)
     at the shapes of the cells that run it (``tb26.sgd.zipf``: batch
     32768, 27 rows of 128; ``rm8x1m.adagrad.uniform``: 16384, 9 of 64)
     and of wider models (32768, 41 of 256; 32768, 33 of 128: the tiled
     backward),
     f32: both kernels against their plain versions in f64 (within 1e-5,
     or n 2^-24 for a sum of n > 167 terms, of the terms' summed
     magnitudes; the bottom output copied bitwise), the
     same bits on two calls; each way timed beside its plain version and
     today's torch composition (concatenation, ``bmm``, the triangle's
     gather, and its autograd backward, issued eagerly; its device time by
     kernel) and the byte bound (z and the output read or written once).
Timings (phases 2-4, 7-9, 11, 13, 14, 17, 19, 22, 25, 27, 28) use CUDA events after a
warm-up and report the median of several windows with the spread (min-max): the
kernel and the library call replayed from a CUDA graph (the card's time,
without the host's cost of issuing the calls; the kernel is also timed
issued eagerly from Python), the plain version issued eagerly.  Bounds: bytes over
3.35 TB/s, or operations over the H100's peak for the type (989 TF/s bf16,
67 TF/s f32, 165 TF/s for f32-accurate attention on the tensor cores).
Then a ``{"kernels": [...]}`` line (K6 and K7 by the path the main path
took; every launch of theirs in the 16-bit runs of phases 13, 16 and 24
must have been on wgmma, and in the f32 runs on tf32x3; K8a, K8b
and their one-rank copy by route, each with its own launches), and last
the ``{"ok": true, ...}`` line.
``--out PATH`` also writes the full results as JSON to PATH.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi exited {r.returncode}: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def ring_across_cards(n: int, smi: str) -> dict:
    """K8a-d with one rank per card (shard r on cuda:r, peers reached by
    peer writes over NVLink) against their plain versions, every byte
    equal, at 1 MiB and 64 MiB f32 per rank; a planted fault must raise,
    and a ring whose peer card is still busy with earlier work must wait
    for it rather than run out of its bounded wait.  Timed eagerly on card
    0's stream (a CUDA graph captures one card's stream), median of 5
    windows; beside each, NCCL's call for the same function at the same
    per-rank shape in this process (``torch.cuda.nccl``, one communicator
    per card), timed the same way."""
    import torch
    import torch.cuda.nccl as nccl

    from param_tpu_torch.kernels import ring as k8
    from param_tpu_torch.utils.timer import time_samples

    devices = [torch.device("cuda", r) for r in range(n)]
    gen = torch.Generator().manual_seed(17)
    fns = {"all_gather": (k8.ring_all_gather_cuda, k8.ring_all_gather_plain),
           "reduce_scatter": (k8.ring_reduce_scatter_cuda,
                              k8.ring_reduce_scatter_plain),
           "bidir": (k8.ring_all_gather_bidir_cuda,
                     k8.ring_all_gather_bidir_plain),
           "loopback": (k8.ring_loopback_cuda, k8.ring_loopback_plain)}

    def library(coll, xs):
        """NCCL's collective computing the same function (the reduce-scatter
        leaves rank r chunk r, the ring chunk r + 1); None for the
        loopback, which no library call computes."""
        if coll == "loopback":
            return None
        if not nccl.is_available(xs):
            fail(f"torch.cuda.nccl cannot take the {n} shards")
        if coll == "reduce_scatter":
            outs = [torch.empty(x.numel() // n, device=x.device) for x in xs]
            call = lambda: nccl.reduce_scatter(xs, outs)  # noqa: E731
            want = torch.stack([x.cpu() for x in xs]).sum(0).chunk(n)
        else:
            outs = [torch.empty(n * x.numel(), device=x.device) for x in xs]
            call = lambda: nccl.all_gather(xs, outs)  # noqa: E731
            want = [torch.cat([x.cpu() for x in xs])] * n
        call()
        for r, (o, w) in enumerate(zip(outs, want)):
            if not torch.allclose(o.cpu(), w, rtol=1e-5, atol=1e-5):
                fail(f"NCCL {coll} across {n} cards: rank {r} is not the "
                     f"function the ring computes")
        return call

    rows = {}
    for coll, (cuda_fn, plain_fn) in fns.items():
        for mib in (1, 64):
            xs = [torch.randn((mib << 18,), generator=gen).to(d)
                  for d in devices]
            got, want = cuda_fn(xs), plain_fn(xs)
            for d in devices:
                torch.cuda.synchronize(d)
            for r, (g, w) in enumerate(zip(got, want)):
                if not torch.equal(g.view(torch.uint8), w.view(torch.uint8)):
                    fail(f"K8 {coll} across {n} cards, {mib} MiB: rank {r} "
                         f"differs from the plain version")
            iters = 5 if mib > 1 else 50
            t = time_samples(lambda: cuda_fn(xs, check=False), iters,
                             devices[0], reps=5)
            tp = time_samples(lambda: plain_fn(xs), 3, devices[0], reps=5)
            k8.check_errors(xs)
            lib = library(coll, xs)
            tl = time_samples(lib, iters, devices[0], reps=5) if lib else None
            for d in devices:
                torch.cuda.synchronize(d)
            # per card: its input read and output written over its HBM,
            # and what it sends one way over NVLink (450 GB/s each way)
            nb = mib << 20
            hbm, link = {"all_gather": (nb + n * nb, (n - 1) * nb),
                         "bidir": (nb + n * nb, (n // 2) * nb),
                         "reduce_scatter": (nb + nb // n,
                                            (n - 1) * nb // n),
                         "loopback": (2 * nb, 0)}[coll]
            b_ms, b_by = max((hbm / 3.35e9, "bytes"),
                             (link / 450e6, "NVLink bytes"))
            rec = dict(ms=statistics.median(t), min=min(t), max=max(t),
                       plain_ms=statistics.median(tp), bound_ms=b_ms,
                       bound_by=b_by, max_abs_err=0.0,
                       library_ms=statistics.median(tl) if tl else None,
                       library_min=min(tl) if tl else None,
                       library_max=max(tl) if tl else None)
            rows[f"{coll} n={n} {mib} MiB float32 cards"] = rec
            lib_text = "none" if tl is None else (
                f"{rec['library_ms']:.4f} ms ({rec['library_min']:.4f}-"
                f"{rec['library_max']:.4f})")
            say(f"phase 17 K8 {coll} across {n} cards (one rank per card), "
                f"{mib} MiB f32 per rank: every byte equal | kernel "
                f"{rec['ms']:.4f} ms ({rec['min']:.4f}-{rec['max']:.4f}, "
                f"issued eagerly) plain {rec['plain_ms']:.4f} ms NCCL "
                f"{lib_text} | bound {b_ms:.4f} ms ({b_by}, per card) | {smi}")
            del xs, got, want
    xs = [torch.randn((1 << 18,), generator=gen).to(d) for d in devices]
    try:
        k8.ring_all_gather_cuda(xs, fault=1, timeout_s=0.05)
    except RuntimeError as e:
        say(f"phase 17 K8 all_gather across {n} cards, planted fault: {e}")
    else:
        fail(f"K8 across {n} cards: the planted fault was not flagged")
    if not all(torch.equal(g, w) for g, w in zip(
            k8.ring_all_gather_cuda(xs), k8.ring_all_gather_plain(xs))):
        fail(f"K8 across {n} cards: wrong after the planted fault")
    # a peer card still busy: about 0.5 s of sleep queued on the last card
    # must hold every rank back, not run out a 0.2 s bounded wait
    for d in devices:
        torch.cuda.synchronize(d)
    with torch.cuda.device(devices[-1]):
        torch.cuda._sleep(10 ** 9)  # cycles: 0.5 s at 2 GHz or longer
    t0 = time.perf_counter()
    got = k8.ring_all_gather_cuda(xs, timeout_s=0.2)
    busy_s = time.perf_counter() - t0
    if busy_s < 0.3 or not all(torch.equal(g, w) for g, w in zip(
            got, k8.ring_all_gather_plain(xs))):
        fail(f"K8 across {n} cards behind a busy peer: {busy_s:.3f} s (the "
             f"queued work must outlast the 0.2 s wait), or a wrong result")
    say(f"phase 17 K8 all_gather across {n} cards behind about 0.5 s of "
        f"work queued on cuda:{n - 1}: the call took {busy_s:.3f} s, no "
        f"bounded wait (0.2 s) ran out, every byte equal")
    rows["busy peer"] = dict(seconds=busy_s)
    return rows


def comms_world(cards: int, smi: str) -> dict:
    """``cli.comms`` under torchrun, one rank per card on NCCL, every
    collective from 8 B to 64 MiB with dcheck, then all_reduce and
    all_gather from CUDA graphs, and pairwise pt2pt eagerly and from CUDA
    graphs; every row's dcheck must be OK."""
    from param_tpu_torch.backend import SUPPORTED_COLLECTIVES

    runs = {}
    for label, extra in (
            ("dispatch", ["--collective", ",".join(
                c for c in SUPPORTED_COLLECTIVES if c != "barrier"),
                "--b", "8", "--e", "64M", "--f", "8"]),
            ("graph", ["--collective", "all_reduce,all_gather,reduce_scatter",
                       "--b", "1K", "--e", "64M", "--f", "8", "--mode",
                       "graph"]),
            ("pairwise", ["--collective", "pt2pt", "--pt2pt", "pairwise",
                          "--b", "1K", "--e", "64M", "--f", "64"]),
            # each window one replayed CUDA graph, as the reference runs it
            # as one lax.scan program
            ("pairwise graph", ["--collective", "pt2pt", "--pt2pt",
                                "pairwise", "--b", "1K", "--e", "64M",
                                "--f", "64", "--mode", "graph"])):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(cards), "-m",
               "param_tpu_torch.cli.comms", "--", "--c", "1", *extra]
        t0 = time.perf_counter()
        p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             start_new_session=True,
                             env=dict(os.environ, PYTHONPATH=ROOT))
        try:
            out = p.communicate(timeout=300)[0]
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            p.communicate()
            fail(f"phase 18 torchrun world of {cards} ({label}) timed out")
        rows = [ln for ln in out.splitlines()
                if re.match(r"\s+\d+[KMG]?\s+\d+\s", ln)]
        if p.returncode != 0 or not rows or any(
                not ln.endswith("  OK") for ln in rows):
            fail(f"phase 18 torchrun world of {cards} ({label}): rc "
                 f"{p.returncode}, dcheck not OK everywhere:\n{out[-6000:]}")
        wall = time.perf_counter() - t0
        say(f"phase 18 torchrun --nproc-per-node {cards} cli.comms "
            f"({label}) | {wall:.1f} s | {smi}\n{out.rstrip()}")
        runs[label] = dict(wall_s=wall, rows=len(rows), output=out)
    return runs


DLRM_OPTS = ("adagrad", "sparse_sgd", "sparse_adagrad")

# Phase 3: the dedup's shapes, (name, tables, rows a table, batch, nnz,
# dim, ids, scale): the benchmark cells' (port_bench's configurations and
# traffic) and the first with zipf ids
DEDUP_CASES = [
    ("rm8x1m.adagrad.uniform", 8, 1_000_000, 16384, 100, 64, "uniform", None),
    ("tb26.sgd.zipf", 26, 4_000_000, 32768, 1, 128, "zipf", -0.01),
    ("rm8x1m.zipf", 8, 1_000_000, 16384, 100, 64, "zipf", None),
]


def dedup_case_ids(tables, rows, batch, nnz, ids, seed=0):
    """(batch * tables, nnz) int32 ids in the flat view of the tables, in
    the step's (b, t, k) order: uniform, or zipf(1.15) wrapped into each
    table."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    shape = (batch, tables, nnz)
    local = (rng.integers(0, rows, shape) if ids == "uniform"
             else (rng.zipf(1.15, shape) - 1) % rows)
    flat = local + (np.arange(tables) * rows)[None, :, None]
    return torch.from_numpy(flat.astype(np.int32).reshape(-1, nnz))


# Phase 3: the kernels one dedup call runs at each of DEDUP_CASES, from
# torch.profiler over 5 calls in a fresh process (see phase 19's)
DEDUP_PROFILE = """
import json
import torch
import chip_smoke as c
from param_tpu_torch.kernels.dedup import dedup_sum_cuda
from param_tpu_torch.utils.profiler import kernel_times
out = {}
for name, T, E, B, nnz, D, kind, scale in c.DEDUP_CASES:
    ids = c.dedup_case_ids(T, E, B, nnz, kind).cuda()
    g = torch.randn((B * T, D), device="cuda")
    out[name] = kernel_times(lambda: dedup_sum_cuda(ids, g, scale, T * E),
                             calls=5)[1]
    del ids, g
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def dedup_profile() -> dict:
    """{case: {kernel name: {launches, ms} a call}} of ``DEDUP_PROFILE``."""
    r = subprocess.run([sys.executable, "-c", DEDUP_PROFILE], cwd=ROOT,
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    if r.returncode != 0:
        fail(f"phase 3 dedup profile: rc {r.returncode}:\n{r.stdout}\n"
             f"{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


# Phase 19: the kernels one coalesced_bag call runs on stage B's uniform
# and zipf ids, from torch.profiler over 5 calls in a fresh process (in
# this process, after the earlier phases, such a profile recorded no
# device events at all)
K10_PROFILE = """
import json
import numpy as np
import torch
from param_tpu_torch.experiments import coalesce as coal
from param_tpu_torch.kernels import coalesce as kc
from param_tpu_torch.utils.profiler import kernel_times
dev = torch.device("cuda")
table = torch.rand((coal.E, coal.D), device=dev)
rng = np.random.default_rng(0)
out = {}
for dist in ("uniform", "zipf"):
    ids = torch.from_numpy(coal.stage_b_ids(rng, dist)).to(dev)
    out[dist] = kernel_times(lambda: kc.coalesced_bag(
        table, ids, coal.R_BLK, coal.TILE_BAGS), calls=5)[1]
print(json.dumps(out))
"""


def k10_profile() -> dict:
    """{dist: {kernel name: {launches, ms} a call}} of ``K10_PROFILE``."""
    r = subprocess.run([sys.executable, "-c", K10_PROFILE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    if r.returncode != 0:
        fail(f"phase 19 K10 profile: rc {r.returncode}:\n{r.stdout}\n"
             f"{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


# Phase 19: the design before the one-launch K10 (b6e95b8: a PyTorch
# pre-pass, then the kernel on its plan) at phase 19's shape, graph-replay
# medians in ms of its two runs in one chip call, where b6e95b8's own
# experiments/coalesce.py stage B ran in turns with this tree's (parent,
# new, new, parent); quoted from PERF.md section 6, not measured here
K10_PARENT_ORIGIN = ("b6e95b8's experiments/coalesce.py in turns with this "
                     "K10, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md "
                     "section 6, not measured in this run")
K10_PARENT = {"uniform": dict(call="0.4174 / 0.4169", alone="0.2760 / 0.2764",
                              origin=K10_PARENT_ORIGIN),
              "zipf": dict(call="0.3303 / 0.3298", alone="0.1888 / 0.1893",
                           origin=K10_PARENT_ORIGIN)}

_DLRM_ROW = re.compile(r"^\s*(\S+)\s+(\d+)\s+([\d.]+)\s+([\d.]+)\s+([\d.]+)"
                       r"\s+([\d.]+)\s+([\d.]+)$", re.M)


def dlrm_bench_rows(out: str, what: str) -> dict:
    """The 21 reference rows of a DLRM-RES table and its QPS; fails unless
    every row is there, finite and positive."""
    from param_tpu_torch.models.dlrm_bench import REF_ROWS

    rows = {m.group(1): [float(v) for v in m.groups()[1:6]]
            for m in _DLRM_ROW.finditer(out)}
    names = [name for name, _, _ in REF_ROWS]
    qps = re.findall(r"^QPS: (\S+)$", out, re.M)
    bad = [k for k in names if k not in rows or not all(
        math.isfinite(v) and v > 0 for v in rows[k][1:])]
    if "DLRM-RES" not in out or bad or len(qps) != 1 or \
            not float(qps[0]) > 0:
        fail(f"phase 20 {what}: rows missing or not finite and positive "
             f"{bad}, QPS {qps}:\n{out}")
    return dict(rows={k: rows[k] for k in names}, qps=float(qps[0]))


def sharded_dlrm(smi: str, breakdown) -> dict:
    """Phase 20: the sharded DLRM in a world of one on NCCL, in-process,
    at the CLI's full default width (8 x 100,000 x 64 f32, batch 2048, nnz
    10, MLPs 512-256-64 / 512-256-1): two steps each of dense adagrad,
    sparse_sgd and sparse_adagrad against the single-device model on the
    card from the same parameters and batches (losses, every parameter and
    accumulator within rtol 1e-5, atol 1e-6); then ``cli.dlrm.main`` with
    no flags (the per-region bench, dense adagrad) and with ``--optimizer
    sparse_adagrad``, every one of the 21 reference rows finite and
    positive; then ``--print-comms``, the five entries of the step's
    pattern with the bench's payload bytes.  The launch counts are reset
    just before each sharded run and read just after: K1 must have
    launched on the sharded path, K2 in its sparse steps.  ``breakdown``
    (phase 13's) gives each step's host ms, kernel ms and busy share, the
    single-device model's beside the sharded one's."""
    import tempfile

    import torch

    from param_tpu_torch import kernels
    from param_tpu_torch.backend import DistBackend
    from param_tpu_torch.cli import dlrm as cli
    from param_tpu_torch.models.dlrm import DlrmConfig, DlrmModel
    from param_tpu_torch.models.dlrm_bench import DlrmCommBench
    from param_tpu_torch.models.dlrm_data import RandomDataset
    from param_tpu_torch.ops.mlp import make_optimizer, tree_leaves

    backend = DistBackend("cuda")
    backend.initialize()  # phase 18's world was shut down: a new one
    dev = backend.device
    cfg = DlrmConfig()
    single = DlrmModel(cfg, device=dev)
    sharded = DlrmModel(cfg, group=backend.get_default_group(), device=dev)
    batches = list(RandomDataset(batch=cfg.batch, dense_dim=cfg.dense_dim,
                                 num_tables=cfg.num_tables, nnz=cfg.nnz,
                                 num_rows=cfg.rows_per_table, num_batches=2,
                                 seed=11))
    launches = {k: 0 for k in kernels.launch_counts}

    def train(model, opt):
        params = model.init_params(0)
        acc, losses = None, []
        if opt == "sparse_sgd":
            step = model.make_sparse_sgd_step(0.01)
        elif opt == "sparse_adagrad":
            step = model.make_sparse_adagrad_step(0.01)
            acc = model.init_adagrad_state(params)
        else:
            optimizer = make_optimizer(opt, 0.01)
            step = model.make_train_step(optimizer)
            acc = optimizer.init(params)
        def again(b):
            return (step(params, *b) if opt == "sparse_sgd"
                    else step(params, acc, *b))[-1]

        for b in batches:
            losses.append(float(again(model.place_batch(b))))
        leaves = tree_leaves(params) + ([] if acc is None
                                        else tree_leaves(acc))
        return losses, [t.detach().clone() for t in leaves], again

    parity = {}
    for opt in DLRM_OPTS:
        want_losses, want, single_step = train(single, opt)
        kernels.reset_launch_counts()
        got_losses, got, sharded_step = train(sharded, opt)
        delta = dict(kernels.launch_counts)
        for k, v in delta.items():
            launches[k] += v
        if delta["emb_gather"] <= 0 or (opt.startswith("sparse") and (
                delta[f"sparse_update_{opt[len('sparse_'):]}"] <= 0
                or delta["dedup_sum"] <= 0)):
            fail(f"phase 20 sharded {opt}: K1 / K2 / the dedup not launched "
                 f"({delta})")
        if (delta["dot_interaction"], delta["dot_interaction_bwd"]) != (
                len(batches), len(batches)):
            fail(f"phase 20 sharded {opt}: the dot interaction's kernels "
                 f"launched {delta['dot_interaction']} / "
                 f"{delta['dot_interaction_bwd']} times in {len(batches)} "
                 f"steps, not once each way a step")
        err = max(abs(a - b) for a, b in zip(got_losses, want_losses))
        if not all(math.isclose(a, b, rel_tol=1e-5, abs_tol=1e-6)
                   for a, b in zip(got_losses, want_losses)):
            fail(f"phase 20 sharded {opt}: losses {got_losses} against the "
                 f"single-device model's {want_losses}")
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            err = max(err, (g - w).abs().max().item())
            if not torch.allclose(g, w, rtol=1e-5, atol=1e-6):
                fail(f"phase 20 sharded {opt}: leaf {i} of the parameters "
                     f"and accumulators differs from the single-device "
                     f"model's by {(g - w).abs().max().item():.3e}")
        b1, bn = single.place_batch(batches[0]), sharded.place_batch(
            batches[0])
        parity[opt] = dict(
            losses=got_losses, max_abs_err=err,
            launches={k: v for k, v in delta.items() if v},
            single=breakdown(f"single-device step {opt}",
                             lambda: single_step(b1), grad=True, phase=20),
            sharded=breakdown(f"sharded step {opt} (world 1)",
                              lambda: sharded_step(bn), grad=True, phase=20))
        say(f"phase 20 sharded DLRM (world 1, NCCL) {opt}: 2 steps at full "
            f"width, losses {got_losses} equal the single-device model's "
            f"within rtol 1e-5, atol 1e-6; every parameter and accumulator "
            f"too, max abs err {err:.3e} | launches {parity[opt]['launches']}")
        del want, got, single_step, sharded_step
        torch.cuda.empty_cache()

    runs = {}
    for label, argv, k2 in (("default", [], None),
                            ("sparse_adagrad",
                             ["--optimizer", "sparse_adagrad"],
                             "sparse_update_adagrad")):
        buf = io.StringIO()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv + ["--log", "WARNING"])
        wall = time.perf_counter() - t0
        delta = dict(kernels.launch_counts)
        for k, v in delta.items():
            launches[k] += v
        out = buf.getvalue()
        if rc != 0 or delta["emb_gather"] <= 0 or (k2 and delta[k2] <= 0):
            fail(f"phase 20 cli.dlrm {' '.join(argv)}: rc {rc}, K1 / K2 not "
                 f"launched ({delta}):\n{out}")
        runs[label] = dict(dlrm_bench_rows(out, f"cli.dlrm {label}"),
                           argv=argv, wall_s=wall, output=out,
                           launches={k: v for k, v in delta.items() if v})
        say(f"phase 20 cli.dlrm {' '.join(argv) or '(no flags)'}: per-region "
            f"bench, world 1 on NCCL, full width | {wall:.1f} s | launches "
            f"{runs[label]['launches']} | {smi}\n{out.strip()}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "comms.json")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["--print-comms", path, "--log", "WARNING"])
        with open(path) as f:
            pattern = json.load(f)
    mem = DlrmCommBench(sharded, "sparse_sgd").region_memory_bytes()
    want = [("all_to_all", "idx_xchg"), ("all_to_all", "fwd_a2a"),
            ("all_reduce", "bwd_top_ar(iso)"), ("all_to_all", "bwd_a2a(iso)"),
            ("all_reduce", "bwd_bot_ar(iso)")]
    if rc != 0 or len(pattern) != 5 or any(
            e["comms"] != c or e["in_msg_size"] * 4 != mem[k]
            or e["world_size"] != 1 for e, (c, k) in zip(pattern, want)):
        fail(f"phase 20 --print-comms: rc {rc}, pattern {pattern} against "
             f"the payload bytes {mem}")
    say(f"phase 20 cli.dlrm --print-comms: {len(pattern)} entries "
        f"({', '.join(e['markers'][0] for e in pattern)}) with the bench's "
        f"payload bytes")
    backend.shutdown()
    del single, sharded
    torch.cuda.empty_cache()
    return dict(parity=parity, bench=runs, pattern=pattern,
                launches={k: v for k, v in launches.items() if v})


def dlrm_world(cards: int, smi: str, first_losses=None) -> dict:
    """``cli.dlrm`` under torchrun, one rank per card on NCCL:
    ``--train-batches 5`` for each optimizer, whose first loss (rank 0's,
    the global batch's) must equal ``first_losses[opt]`` of a world of one
    within rtol 1e-5 (and 1e-5, the printed loss's resolution), then the
    default per-region bench.  Without ``first_losses`` the world of one
    (the single-device trainer) runs here first."""
    if first_losses is None:
        from param_tpu_torch.cli import dlrm as cli

        first_losses = {}
        for opt in DLRM_OPTS:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["--train-batches", "5", "--optimizer", opt,
                               "--log", "WARNING"])
            losses = re.findall(r"loss (\S+)", buf.getvalue())
            if rc != 0 or not losses:
                fail(f"phase 20 world of one {opt}:\n{buf.getvalue()}")
            first_losses[opt] = float(losses[0])
            say(f"phase 20 world of one {opt}:\n{buf.getvalue().strip()}")
    runs = {}
    for label, argv in [(opt, ["--train-batches", "5", "--optimizer", opt])
                        for opt in DLRM_OPTS] + [("bench", [])]:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(cards), "-m",
               "param_tpu_torch.cli.dlrm", "--", *argv, "--log", "WARNING"]
        t0 = time.perf_counter()
        p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             start_new_session=True,
                             env=dict(os.environ, PYTHONPATH=ROOT))
        try:
            out = p.communicate(timeout=300)[0]
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            p.communicate()
            fail(f"phase 20 torchrun world of {cards} ({label}) timed out")
        wall = time.perf_counter() - t0
        if p.returncode != 0:
            fail(f"phase 20 torchrun world of {cards} ({label}): rc "
                 f"{p.returncode}:\n{out[-6000:]}")
        if label == "bench":
            rec = dlrm_bench_rows(out, f"torchrun world of {cards} bench")
            if f"DLRM-RES world={cards} " not in out:
                fail(f"phase 20 torchrun bench: not a world of {cards}")
        else:
            losses = [float(x) for x in re.findall(r"loss (\S+)", out)]
            e2e = [ln for ln in out.splitlines() if ln.startswith("DLRM-E2E")]
            if len(losses) != 5 or len(e2e) != 1 or \
                    f"world={cards}" not in e2e[0]:
                fail(f"phase 20 torchrun {label}: output:\n{out[-6000:]}")
            if not math.isclose(losses[0], first_losses[label],
                                rel_tol=1e-5, abs_tol=1e-5):
                fail(f"phase 20 torchrun world of {cards} {label}: first "
                     f"loss {losses[0]} against a world of one's "
                     f"{first_losses[label]}")
            fields = dict(re.findall(r"(\w[\w-]*)=(\S+)", e2e[0]))
            rec = dict(losses=losses, step_ms=float(fields["step_ms"]),
                       qps=float(fields["QPS"]))
        rec.update(wall_s=wall, output=out)
        runs[label] = rec
        say(f"phase 20 torchrun --nproc-per-node {cards} cli.dlrm "
            f"{' '.join(argv) or '(no flags)'} | {wall:.1f} s | {smi}\n"
            f"{out.strip()}")
    return runs


LLAMA2 = dict(seq=2048, emb=4096, heads=32, ffn=11008)


def ring_shards(shape, dtype, causal, smi, dev, breakdown) -> dict:
    """Ring attention over 4 sequence shards on one card, in one process:
    for each rank r in turn, ``ring_attention_steps`` fed the shards in
    ring order (what r would hold at each step), the 4 outputs
    concatenated and held to the plain version and to K6 over the whole
    sequence.  f32: within atol = rtol = 3e-5 of the plain version (the
    reference's ring tolerance).  16-bit, with u the unit roundoff: each
    partial output is rounded once by K6 within its own flash bound,
    u (2 |O_t| + |P_t| @ |V|); the merge weights sum these to at most
    3 u |P| @ |V|, and the final cast adds u |O|; with flash_fwd_tolerance's
    2^-6 margin and 2^-16 for the f32 sums.  Against K6 the bound is that
    one plus K6's own.  Also times the 4 ranks' steps one after another
    beside one K6 call over the whole sequence (eager, CUDA events), and
    ``breakdown`` (phase 13's) splits the 4 ranks' steps by kernel."""
    import torch

    from param_tpu_torch import kernels
    from param_tpu_torch.kernels.flash_fwd import (
        flash_fwd_plain, flash_fwd_tolerance,
    )
    from param_tpu_torch.ops.attention import flash_attention
    from param_tpu_torch.ops.ring_attention import ring_attention_steps
    from param_tpu_torch.utils.timer import time_samples

    n = 4
    b, h, s, d = shape
    sl = s // n
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v = ((torch.randn(shape, generator=gen, device=dev) * 0.3)
               .to(dtype) for _ in range(3))
    ks = [k[:, :, i * sl:(i + 1) * sl] for i in range(n)]
    vs = [v[:, :, i * sl:(i + 1) * sl] for i in range(n)]

    def ring():
        return torch.cat([ring_attention_steps(
            q[:, :, r * sl:(r + 1) * sl],
            ((ks[(r - t) % n], vs[(r - t) % n]) for t in range(n)), r, n,
            causal=causal) for r in range(n)], dim=2)

    kernels.reset_launch_counts()
    got = ring()
    torch.cuda.synchronize()
    launches = kernels.launch_counts["flash_fwd"]
    whole = flash_attention(q, k, v, causal=causal)
    want = flash_fwd_plain(q, k, v, causal)
    if dtype == torch.float32:
        bound = 3e-5 + 3e-5 * want.abs()
        k6_bound = 2e-5
    else:
        u = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -11
        pv = flash_fwd_plain(q, k, v.abs(), causal).float()
        bound = (1 + 2.0 ** -6) * u * (want.float().abs() + 3 * pv) + 2.0 ** -16
        k6_bound = flash_fwd_tolerance(q, k, v, want, causal)
    err = (got.float() - want.float()).abs()
    err_k6 = (got.float() - whole.float()).abs()
    if not (err <= bound).all() or not (err_k6 <= bound + k6_bound).all():
        fail(f"phase 21 ring attention {shape} {dtype} over {n} in-process "
             f"shards: max error {err.max().item():.3e} against the plain "
             f"version, {err_k6.max().item():.3e} against K6 over the whole "
             f"sequence, over their bounds")
    ring_ms = statistics.median(time_samples(ring, 5, dev, reps=5))
    k6_ms = statistics.median(time_samples(
        lambda: flash_attention(q, k, v, causal=causal), 5, dev, reps=5))
    rec = dict(shape=list(shape), dtype=str(dtype), k6_launches=launches,
               max_abs_err=err.max().item(),
               max_abs_err_k6=err_k6.max().item(), ring_ms=ring_ms,
               k6_whole_ms=k6_ms, breakdown=breakdown(
                   f"ring attention {shape} {dtype} over {n} in-process "
                   f"shards", ring, 10, phase=21))
    say(f"phase 21 ring attention {shape} {dtype} causal over {n} "
        f"in-process shards: K6 launches {launches}, max abs err "
        f"{rec['max_abs_err']:.3e} (plain) / {rec['max_abs_err_k6']:.3e} "
        f"(K6 whole) | the 4 ranks' steps {ring_ms:.4f} ms against K6 over "
        f"the whole sequence {k6_ms:.4f} ms (eager, CUDA events) | {smi}")
    return rec


def parallel_tier(smi: str, breakdown) -> dict:
    """Phase 21: the multi-device transformer tier in a world of one on
    NCCL at llama2-7B width (``experiments.parallel_tier``'s checks; the
    launch counts reset just before each parallel run and read just
    after): ring attention (1, 32, 2048, 128) bf16 causal against K6's
    ``flash_attention`` within flash_fwd_tolerance, then over 4 in-process
    shards (:func:`ring_shards`); the dp x tp step at (1, 1), two steps
    equal to ``make_train_step``'s (losses and every parameter within rtol
    1e-5), K6 and K7 once each a step; the pipeline step with one stage
    and 4 microbatches of 1, its loss the single-device step's on batch 4
    within rtol 1e-3, K6 and K7 4 times each; ``moe_apply_ep`` (emb 4096,
    ffn 11008, 8192 tokens, bf16, one expert) against
    ``moe_apply_reference`` within 4 bf16 ulps of the largest output, then
    one train step, its loss finite and within rtol 1e-3 of the oracle's;
    the dp x tp MLP step (512-512-256-1, batch 2048, f32) equal to the
    plain step within rtol 1e-5.  ``breakdown`` (phase 13's) gives the tp
    step's host and kernel ms beside the single-device step's."""
    import torch

    from param_tpu_torch.backend import DistBackend
    from param_tpu_torch.experiments import parallel_tier as par
    from param_tpu_torch.kernels.flash_fwd import flash_fwd_tolerance
    from param_tpu_torch.models import moe
    from param_tpu_torch.models import transformer as tfm
    from param_tpu_torch.models.parallel import mesh_groups

    backend = DistBackend("cuda")
    backend.initialize()  # phase 20's world was shut down: a new one
    dev = backend.device
    group = backend.get_default_group()
    bf16 = torch.bfloat16
    res = {}

    def show(label, rec, extra=""):
        errs = ", ".join(f"{k} {v:.3e}" for k, v in rec.items()
                         if k.startswith("max_"))
        say(f"phase 21 {label}: {rec['wall_s']:.3f} s | launches "
            f"{rec['launches']} | {errs}{extra} | steady {rec['ms']:.4f} ms "
            f"a call (single-device oracle {rec['oracle_ms']:.4f}) | {smi}")

    def launched(label, rec, fwd, bwd):
        got = (rec["launches"].get("flash_fwd", 0),
               rec["launches"].get("flash_bwd", 0))
        if got != (fwd, bwd):
            fail(f"phase 21 {label}: K6 / K7 launched {got} times, not "
                 f"({fwd}, {bwd}): {rec['launches']}")

    res["ring_world1"] = par.check_ring(
        group, (1, 32, 2048, 128), bf16, dev,
        tol=lambda q, k, v, want, causal: flash_fwd_tolerance(
            q, k, v, want, causal))
    launched("ring attention, world 1", res["ring_world1"], 1, 0)
    show("ring attention (1, 32, 2048, 128) bf16 causal, world 1, against "
         "K6's flash_attention", res["ring_world1"])
    res["ring_shards"] = [ring_shards((1, 32, 4096, 128), bf16, True, smi,
                                      dev, breakdown),
                          ring_shards((1, 4, 2048, 64), torch.float32, True,
                                      smi, dev, breakdown)]
    torch.cuda.empty_cache()

    cfg = tfm.TransformerConfig(batch=1, **LLAMA2)
    rec = par.check_tp(backend, 1, 1, cfg, dev, steps=2, loss_rtol=1e-5,
                       param_rtol=1e-5)
    launched("tp step (1, 1)", rec, 2, 2)
    show("dp x tp step (1, 1) at llama2 width bf16, 2 steps against "
         "make_train_step", rec, f" | losses {rec['losses']}")
    groups = mesh_groups(backend, 1, 1)
    x = (torch.randn((1, cfg.seq, cfg.emb), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev) * 0.1).bfloat16()
    full = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           dev)
    for label, step, p in (
            ("single-device step", tfm.make_train_step(cfg), full),
            ("tp step (1, 1)", tfm.make_sharded_train_step(groups, cfg),
             tfm.tp_shard(full, cfg, 0, 1))):
        state = {"p": p}

        def train(state=state, step=step):
            state["p"], loss = step(state["p"], x)
            return loss

        rec[f"breakdown {label}"] = breakdown(
            f"{label} (1, 2048, 4096, 32, 11008) bf16", train, 10, grad=True,
            phase=21)
        del state
    res["tp_world1"] = rec
    del full, x
    torch.cuda.empty_cache()

    rec = par.check_pp(group, tfm.TransformerConfig(batch=4, **LLAMA2), 4,
                       dev, loss_rtol=1e-3)
    launched("pp step, one stage", rec, 4, 4)
    show("pp step, one stage, 4 microbatches of 1 at llama2 width bf16, "
         "against the single-device step on batch 4", rec,
         f" | loss {rec['loss']} (oracle {rec['oracle_loss']})")
    res["pp_world1"] = rec
    torch.cuda.empty_cache()

    rec = par.check_moe(
        group, moe.MoeConfig(4096, 11008, 1, dtype="bfloat16"), 8192, dev,
        out_tol=lambda want: 4 * 2.0 ** -8 * want.float().abs().max(),
        loss_rtol=1e-3)
    show("MoE, one expert (emb 4096, ffn 11008, 8192 tokens, bf16), "
         "moe_apply_ep against moe_apply_reference, then one train step",
         rec, f" | step loss {rec['loss']} (oracle {rec['oracle_loss']})")
    res["moe_world1"] = rec
    torch.cuda.empty_cache()

    rec = par.check_mlp(backend, 1, 1, [512, 512, 256, 1], 2048, dev,
                        rtol=1e-5, param_rtol=1e-5)
    show("dp x tp MLP step (1, 1), 512-512-256-1, batch 2048, f32, against "
         "the plain step", rec, f" | loss {rec['loss']}")
    res["mlp_world1"] = rec
    backend.shutdown()
    torch.cuda.empty_cache()
    return res


def parallel_world(cards: int, smi: str) -> dict:
    """``experiments.parallel_tier`` under torchrun, one rank per card on
    NCCL, in f32: ring attention over the cards, tp at (cards / 2, 2) and
    (1, cards), pp over the cards, MoE with one expert a card, the MLP at
    (cards / 2, 2), each held to the single-card result on the same inputs
    (loss rtol 1e-4; the largest parameter error printed)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(cards), "-m",
           "param_tpu_torch.experiments.parallel_tier"]
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        out = p.communicate(timeout=600)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, 9)
        p.communicate()
        fail(f"phase 21 torchrun world of {cards} timed out")
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if p.returncode != 0 or not lines:
        fail(f"phase 21 torchrun world of {cards}: rc {p.returncode}:\n"
             f"{out[-6000:]}")
    res = json.loads(lines[-1])
    for key, rec in res.items():
        if not isinstance(rec, dict):
            continue
        want = ({"flash_fwd"} if key == "ring" else
                {"flash_fwd", "flash_bwd"} if key.startswith(("tp", "pp"))
                else set())
        if not want <= set(rec["launches"]):
            fail(f"phase 21 torchrun {key}: {want} not launched "
                 f"({rec['launches']})")
        errs = ", ".join(f"{k} {v:.3e}" for k, v in rec.items()
                         if k.startswith("max_"))
        say(f"phase 21 torchrun world of {cards} {key}: {rec['wall_s']:.3f} s "
            f"(rank 0) | launches (rank 0) {rec['launches']} | {errs} | "
            f"steady {rec['ms']:.4f} ms a call on {cards} cards, the "
            f"single-card oracle {rec['oracle_ms']:.4f} (rank 0) | {smi}")
    res["wall_s"] = wall
    return res


def run_cli(mod, argv, log=True):
    """A CLI's ``main(argv)`` in this process -> (rc, stdout, wall s);
    ``log``: the CLI takes ``--log`` (WARNING is passed)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv + (["--log", "WARNING"] if log else []))
    return rc, buf.getvalue(), time.perf_counter() - t0


_COMMS_ROW = re.compile(r"^\s+\d+[KMG]?\s+\d+\s")


def comms_rows_ok(out: str, tables: int) -> list:
    """The COMMS-RES rows of ``out``, or [] unless there are ``tables``
    tables and every row's numbers are finite and its dcheck OK."""
    rows = [ln for ln in out.splitlines() if _COMMS_ROW.match(ln)]
    nums = [float(v) for ln in rows for v in ln.split()[1:]
            if re.fullmatch(r"-?[\d.]+", v)]
    if out.count("COMMS-RES:") != tables or not rows or any(
            not ln.endswith("  OK") for ln in rows) or not all(
            math.isfinite(v) for v in nums):
        return []
    return rows


def comms_remainder(smi: str) -> dict:
    """Phase 22: the comms remainder and the comm-trace replay in a world
    of one on NCCL, in-process, at the CLIs' own default widths (see the
    module docstring).  Returns the records, with K1's launches in
    ``launches``."""
    import tempfile

    import torch

    from param_tpu_torch import kernels
    from param_tpu_torch.backend import CollectiveArgs, DistBackend
    from param_tpu_torch.cli import comms, comms_compute, overlap, replay
    from param_tpu_torch.comms import quantization

    backend = DistBackend("cuda")
    backend.initialize()  # phase 21's world was shut down: a new one
    dev = backend.device
    tmp = tempfile.mkdtemp(prefix="chip_smoke_22_")
    rec = {"launches": {k: 0 for k in kernels.launch_counts}}

    def count(fn):
        kernels.reset_launch_counts()
        got = fn()
        for k, v in kernels.launch_counts.items():
            rec["launches"][k] += v
        return got, {k: v for k, v in kernels.launch_counts.items() if v}

    # -- quantized collectives against the round trips of their input
    def rt8(v):
        a = v.abs().max()
        s = torch.where(a > 0, a / 127.0, torch.ones_like(a))
        return torch.clamp(torch.round(v / s), -127, 127) * s

    def tolerance(want, bw):
        """One quantization step: a bf16 step of each element, or the
        int8 scale of the whole result."""
        return (want.abs() * 2.0 ** -7 if bw == 16
                else want.abs().max() / 127.0)

    gen = torch.Generator(device=dev).manual_seed(22)
    quant = {}
    for elems in (2, 1025, 1 << 18, 16 << 20):  # 8 B to 64 MiB of f32
        x = torch.randn(elems, generator=gen, device=dev) * 3
        for bw in (16, 8):
            want = x.to(torch.bfloat16).float() if bw == 16 else rt8(rt8(x))
            tol = tolerance(want, bw)
            for coll in ("all_reduce", "reduce"):
                got = backend.collective_fn[coll](CollectiveArgs(
                    in_tensor=x, bitwidth=bw))
                err = (got - want).abs()
                if got.shape != x.shape or not torch.isfinite(got).all() or \
                        not bool((err <= tol).all()):
                    fail(f"phase 22 {coll} bitwidth {bw} at {elems * 4} B: "
                         f"max abs err {err.max().item():.3e} beyond one "
                         f"quantization step")
                quant[f"{coll} bitwidth {bw} {elems * 4} B"] = dict(
                    max_abs_err=err.max().item(),
                    tol=tol.max().item())
    real = quantization.dequantize
    quantization.dequantize = lambda q, s, dtype=torch.float32: real(
        q, torch.ones_like(s), dtype)
    try:
        bad = backend.all_reduce(CollectiveArgs(in_tensor=x, bitwidth=8))
    finally:
        quantization.dequantize = real
    fault_err = (bad - want).abs().max().item()
    if bool(((bad - want).abs() <= tol).all()):
        fail("phase 22: a planted fault (phase 2 dequantized with scale 1) "
             "passed the comparison")
    say(f"phase 22 quantized all_reduce / reduce (world 1, NCCL) against "
        f"the quantize -> dequantize round trips of their input, 8 B to 64 "
        f"MiB: every element within one step (largest errors "
        f"{max(v['max_abs_err'] for v in quant.values()):.3e}); planted "
        f"fault (phase 2 dequantized with scale 1) caught, max abs err "
        f"{fault_err:.3e} | {smi}")
    rec["quantized"] = dict(rows=quant, fault_max_abs_err=fault_err)

    # -- cli.comms --bitwidth 16 / 8: rows, dcheck, quant_us
    for bw in (16, 8):
        js = os.path.join(tmp, f"bitwidth{bw}.jsonl")
        rc, out, wall = run_cli(comms, [
            "--collective", "all_reduce,reduce", "--b", "8", "--e", "64M",
            "--c", "1", "--bitwidth", str(bw), "--output-json", js])
        metrics = [json.loads(ln) for ln in open(js)] if rc == 0 else []
        quant_us = [m["quant"]["quant_us"] for m in metrics]
        if rc != 0 or not comms_rows_ok(out, 2) or not quant_us or not all(
                math.isfinite(q) and q > 0 for q in quant_us):
            fail(f"phase 22 cli.comms --bitwidth {bw}: rc {rc}, rows not OK "
                 f"or quant_us not finite ({quant_us}):\n{out}")
        at64 = {m["commsOp"]: (m["p50_us"], m["quant"]["quant_us"],
                               m["bus_bw_gbs"])
                for m in metrics if m["input_size_bytes"] == 64 << 20}
        say(f"phase 22 cli.comms --bitwidth {bw} | {wall:.1f} s | at 64 MiB "
            f"(p50 us, quant_us, busBW): {at64} | {smi}\n{out.rstrip()}")
        rec[f"cli_bitwidth{bw}"] = dict(wall_s=wall, at_64MiB=at64,
                                        output=out)

    # -- --backend torchcomms and mock
    rc, out, wall = run_cli(comms, [
        "--backend", "torchcomms", "--collective",
        "all_reduce,all_gather,reduce_scatter,all_to_all,broadcast,pt2pt",
        "--c", "1"])
    if rc != 0 or not comms_rows_ok(out, 6) or "(torchcomms, nccl)" not in out:
        fail(f"phase 22 cli.comms --backend torchcomms: rc {rc}:\n{out}")
    say(f"phase 22 cli.comms --backend torchcomms | {wall:.1f} s | {smi}\n"
        f"{out.rstrip()}")
    rec["torchcomms"] = dict(wall_s=wall, output=out)
    rc, out, wall = run_cli(comms, ["--backend", "mock", "--collective",
                                    "all_reduce,all_gather", "--e", "1M",
                                    "--c", "1"])
    if rc != 0 or not comms_rows_ok(out, 2) or "(mock, none)" not in out:
        fail(f"phase 22 cli.comms --backend mock: rc {rc}:\n{out}")
    say(f"phase 22 cli.comms --backend mock: ran ({wall:.1f} s)")

    # -- cli.overlap, same group
    rc, out, wall = run_cli(overlap, ["--collective", "all_reduce",
                                      "--collective-pair", "all_gather"])
    lines = [ln for ln in out.splitlines() if ln.startswith("OVERLAP-RES")]
    parsed = []
    for ln in lines:
        times = [float(v) for v in re.findall(r"=([\d.]+)us", ln)]
        eff = float(re.search(r"eff=([\d.]+)%", ln).group(1)) / 100
        parsed.append(dict(size=int(re.search(r"size=(\d+)B", ln).group(1)),
                           times_us=times, eff=eff))
    if rc != 0 or len(lines) != 4 or not all(
            len(p["times_us"]) == 3 and all(math.isfinite(t) and t > 0
                                            for t in p["times_us"])
            and 0.0 <= p["eff"] <= 1.0 for p in parsed):
        fail(f"phase 22 cli.overlap: rc {rc}, rows missing or out of range:"
             f"\n{out}")
    say(f"phase 22 cli.overlap (same group, all_reduce + all_gather, 64K to "
        f"4M) | {wall:.1f} s | {smi}\n{out.rstrip()}")
    rec["overlap"] = dict(wall_s=wall, rows=parsed)

    # -- cli.comms_compute, each kernel at the defaults
    rec["comms_compute"] = {}
    for kernel in ("gemm", "emb_lookup", "d2h", "h2d"):
        (rc, out, wall), launched = count(lambda: run_cli(
            comms_compute, ["--kernel", kernel]))
        m = re.search(r"comm=([\d.]+)us compute=([\d.]+)us both=([\d.]+)us "
                      r"eff=([\d.]+)%", out)
        vals = [float(v) for v in m.groups()] if m else []
        if rc != 0 or not vals or not all(math.isfinite(v) for v in vals) \
                or (kernel == "emb_lookup"
                    and launched.get("emb_gather", 0) <= 0):
            fail(f"phase 22 cli.comms_compute --kernel {kernel}: rc {rc}, "
                 f"launches {launched}:\n{out}")
        say(f"phase 22 cli.comms_compute --kernel {kernel} | {wall:.1f} s | "
            f"launches {launched} | {smi}\n{out.rstrip()}")
        rec["comms_compute"][kernel] = dict(
            t_comm_us=vals[0], t_compute_us=vals[1], t_both_us=vals[2],
            eff=vals[3] / 100, launches=launched, output=out)

    # -- record a sweep, replay it from both files
    basic, et = os.path.join(tmp, "comms.json"), os.path.join(tmp, "et.json")
    rc, out, _ = run_cli(comms, ["--collective", "all_reduce,all_to_all",
                                 "--b", "8", "--e", "64M", "--f", "8",
                                 "--c", "1", "--trace-dump", basic,
                                 "--trace-dump-et", et])
    if rc != 0 or not comms_rows_ok(out, 2):
        fail(f"phase 22 cli.comms --trace-dump: rc {rc}:\n{out}")
    with open(basic) as f:
        recorded = [(e["comms"], e["in_msg_size"] * 4) for e in json.load(f)]
    rec["replay"] = {}
    for path, ttype in ((basic, "basic"), (et, "pytorch_et")):
        details = os.path.join(tmp, f"details_{ttype}.json")
        rc, out, wall = run_cli(replay, ["--trace-path", path,
                                         "--trace-type", ttype, "--blocking",
                                         "--output-path", details])
        with open(details) as f:
            replayed = [(d["comms"], d["size_bytes"]) for d in json.load(f)]
        rc2, dry, _ = run_cli(replay, ["--trace-path", path, "--trace-type",
                                       ttype, "--dry-run"])
        counts = {k: v["count"] for k, v in json.loads(dry)["dry_run"]
                  .items() if k != "init"}
        want_counts = {c: sum(1 for r in recorded if r[0] == c)
                       for c in {r[0] for r in recorded}}
        if rc != 0 or rc2 != 0 or replayed != recorded or \
                counts != want_counts:
            fail(f"phase 22 cli.replay {ttype}: rc {rc} / {rc2}, "
                 f"{len(replayed)} ops replayed against {len(recorded)} "
                 f"recorded, dry-run counts {counts} against {want_counts}")
        say(f"phase 22 cli.comms --trace-dump{'-et' if ttype != 'basic' else ''}"
            f" -> cli.replay --trace-type {ttype} --blocking: {len(replayed)} "
            f"ops, each the recorded collective and size; --dry-run counts "
            f"{counts} | {wall:.1f} s | {smi}")
        rec["replay"][ttype] = dict(ops=len(replayed), wall_s=wall,
                                    counts=counts, details=details)

    # -- a trace with an emb_lookup compute op at the comms-compute shape
    trace = [{"compute": "emb_lookup", "emb_dim": 128, "num_embs": 100_000,
              "batch_size": 2048, "bag_size": 30},
             {"comms": "all_reduce", "in_msg_size": 1 << 20,
              "out_msg_size": 1 << 20, "dtype": "float32"}]
    path = os.path.join(tmp, "compute.json")
    with open(path, "w") as f:
        json.dump(trace, f)
    (rc, out, wall), launched = count(lambda: run_cli(replay, [
        "--trace-path", path, "--blocking", "--num-replays", "3"]))
    res = json.loads(out) if rc == 0 else {}
    if rc != 0 or launched.get("emb_gather", 0) <= 0 or \
            res["collectives"].get("compute:emb_lookup", {}).get("count") != 3:
        fail(f"phase 22 cli.replay with an emb_lookup op: rc {rc}, launches "
             f"{launched}:\n{out}")
    say(f"phase 22 cli.replay of a trace with an emb_lookup op (100000 x "
        f"128, 2048 bags x 30): launches {launched}; emb_lookup p50 "
        f"{res['collectives']['compute:emb_lookup']['p50_us']:.1f} us "
        f"(blocking) | {smi}")
    rec["replay_compute"] = dict(launches=launched, report=res)

    # -- the profiled quantized sweep's device-time split
    prof = os.path.join(tmp, "profile")
    rc, out, wall = run_cli(comms, ["--collective", "all_reduce", "--b", "1M",
                                    "--e", "16M", "--f", "4", "--n", "2",
                                    "--w", "1", "--bitwidth", "8",
                                    "--profile", prof])
    split = {k: (float(us), int(n)) for k, us, n in re.findall(
        r"^\s+(comm|quant|dequant|other):\s+([\d.]+) us .*n=(\d+)$", out,
        re.M)}
    if rc != 0 or len(split) != 4 or split["comm"][0] <= 0 or \
            split["quant"][0] <= 0:
        fail(f"phase 22 --profile --bitwidth 8: rc {rc}, split {split}:\n"
             f"{out[-6000:]}")
    say(f"phase 22 cli.comms --bitwidth 8 --profile: device-time split (us, "
        f"kernels) {split} | {smi}")
    rec["profile_split"] = split
    backend.shutdown()
    rec["launches"] = {k: v for k, v in rec["launches"].items() if v}
    return rec


def comms_remainder_world(cards: int, smi: str) -> dict:
    """``experiments.comms_remainder`` under torchrun, one rank per card on
    NCCL: the quantized all_reduce / reduce at 8 and 16 bits against f32,
    the overlap bench (same group; split-pgs at 4+ cards), comms-compute
    gemm, and a sweep recorded and replayed by the world."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(cards), "-m",
           "param_tpu_torch.experiments.comms_remainder"]
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        out = p.communicate(timeout=600)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, 9)
        p.communicate()
        fail(f"phase 22 torchrun world of {cards} timed out")
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if p.returncode != 0 or not lines or not json.loads(lines[-1])["ok"]:
        fail(f"phase 22 torchrun world of {cards}: rc {p.returncode}:\n"
             f"{out[-6000:]}")
    res = json.loads(lines[-1])
    say(f"phase 22 torchrun world of {cards} experiments.comms_remainder | "
        f"{wall:.1f} s | {smi}\n{json.dumps(res)}")
    res["wall_s"] = wall
    return res


def et_tier(smi: str) -> dict:
    """Phase 23: the execution-trace tier on the card at the trainer's full
    default width (see the module docstring).  Returns the records, with
    the replays' kernel launches in ``launches``."""
    import tempfile

    import torch

    from param_tpu_torch import kernels
    from param_tpu_torch.backend import DistBackend
    from param_tpu_torch.cli import et as et_cli
    from param_tpu_torch.cli import replay as replay_cli
    from param_tpu_torch.experiments import et_sharded
    from param_tpu_torch.models.dlrm import DlrmConfig, DlrmModel
    from param_tpu_torch.models.dlrm_data import RandomDataset
    from param_tpu_torch.ops.mlp import Sgd, tree_map
    from param_tpu_torch.trace.capture import (
        capture_execution_trace, inputs_for, tensor_leaves,
    )
    from param_tpu_torch.trace.comms_trace import comms_from_et
    from param_tpu_torch.trace.et_replay import EtReplayManager

    dev = torch.device("cuda", torch.cuda.current_device())

    def sync():
        torch.cuda.synchronize(dev)

    iters, warmup = 3, 1
    k1_node = "param_tpu_torch::emb_gather.default"
    k2_node = "param_tpu_torch::sparse_update.default"
    dd_node = "param_tpu_torch::dedup_sum.default"
    cfg = DlrmConfig()
    model = DlrmModel(cfg, device=dev)
    params = model.init_params(0)
    batch = model.place_batch(next(iter(RandomDataset(
        batch=cfg.batch, dense_dim=cfg.dense_dim, num_tables=cfg.num_tables,
        nnz=cfg.nnz, num_rows=cfg.rows_per_table, num_batches=1, seed=23))))
    rec = {"launches": {k: 0 for k in kernels.launch_counts}, "cases": {}}

    def add_launches():
        got = {k: v for k, v in kernels.launch_counts.items() if v}
        for k, v in got.items():
            rec["launches"][k] += v
        return got

    def fresh():
        return tree_map(lambda t: t.detach().clone().requires_grad_(True),
                        params)

    def forward(p, d, i):
        with torch.no_grad():
            return model.forward(p, d, i)

    def adagrad_args():
        p = fresh()
        return (p, model.init_adagrad_state(p), *batch)

    cases = {
        "forward": (forward, lambda: (fresh(), *batch[:2]), None),
        "dense_sgd": (model.make_train_step(Sgd(0.01)),
                      lambda: (fresh(), None, *batch), None),
        "sparse_sgd": (model.make_sparse_sgd_step(0.01),
                       lambda: (fresh(), *batch), "sparse_update_sgd"),
        "sparse_adagrad": (model.make_sparse_adagrad_step(0.01),
                           adagrad_args, "sparse_update_adagrad"),
    }
    for name, (fn, args, k2) in cases.items():
        a = args()
        kernels.reset_launch_counts()
        want = [t.detach().clone() for t in tensor_leaves(fn(*a))]
        sync()
        d_k1 = kernels.launch_counts["emb_gather"]
        d_k2 = kernels.launch_counts[k2] if k2 else 0
        d_dd = kernels.launch_counts["dedup_sum"]
        host = []
        for _ in range(5):
            sync()
            t0 = time.perf_counter()
            fn(*a)
            sync()
            host.append((time.perf_counter() - t0) * 1e3)
        del a
        et = capture_execution_trace(fn, *args())
        names = [n.name for n in et.get_nodes()]
        n_k1, n_k2 = names.count(k1_node), names.count(k2_node)
        n_dd = names.count(dd_node)
        if d_k1 <= 0 or n_k1 != d_k1 or n_k2 != d_k2 or n_dd != d_dd or (
                k2 and (d_k2 <= 0 or d_dd <= 0)):
            fail(f"phase 23 {name}: the direct call launched K1 {d_k1} / K2 "
                 f"{d_k2} / the dedup {d_dd} times, its graph holds {n_k1} / "
                 f"{n_k2} / {n_dd} kernel nodes")
        mgr = EtReplayManager(et, inputs=inputs_for(et, *args()), device=dev)
        kernels.reset_launch_counts()
        out = mgr.replay(iters=iters, warmup=warmup)
        launched = add_launches()
        n = iters + warmup
        if out["errors"] or out["num_skipped"] or (
                launched.get("emb_gather", 0) != n * d_k1
                or (k2 and launched.get(k2, 0) != n * d_k2)
                or launched.get("dedup_sum", 0) != n * d_dd):
            fail(f"phase 23 {name} replay: errors {out['errors']}, "
                 f"{out['num_skipped']} skipped, launches {launched} against "
                 f"{n} x (K1 {d_k1}, K2 {d_k2}, the dedup {d_dd})")
        got = mgr.outputs()
        if len(got) != len(want):
            fail(f"phase 23 {name}: {len(got)} replayed outputs against "
                 f"{len(want)}")
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        for i, (g, w) in enumerate(zip(got, want)):
            if not torch.allclose(g, w, rtol=1e-5, atol=1e-6):
                fail(f"phase 23 {name}: replayed output {i} differs from "
                     f"the direct call's by {(g - w).abs().max().item():.3e}")
        timed_ops = EtReplayManager(et, inputs=inputs_for(et, *args()),
                                    device=dev).replay(iters=1, warmup=1,
                                                       per_op=True)
        top5 = {k: round(v["total_us"], 1) for k, v in
                list(timed_ops["per_op_us"].items())[:5]}
        case = dict(num_ops=out["num_ops"], k1_nodes=n_k1, k2_nodes=n_k2,
                    launches=launched, iter_s=out["iter_s"], qps=out["qps"],
                    device_memory=out.get("device_memory"),
                    direct_host_ms=statistics.median(host),
                    direct_host_ms_all=host, max_abs_err=err,
                    per_op_top5_us=top5)
        if name == "forward":
            bad = args()
            with torch.no_grad():
                bad[0]["tables"][0, int(batch[1][0, 0, 0])] += 1
            faulty = EtReplayManager(et, inputs=inputs_for(et, *bad),
                                     device=dev)
            faulty.replay(iters=1)
            fault_err = (faulty.outputs()[0] - want[0]).abs().max().item()
            if torch.allclose(faulty.outputs()[0], want[0], rtol=1e-5,
                              atol=1e-6):
                fail("phase 23: a planted fault (one table row + 1 in the "
                     "replay's inputs) passed the forward's comparison")
            case["fault_max_abs_err"] = fault_err
            del bad, faulty
        rec["cases"][name] = case
        say(f"phase 23 ET {name}: {case['num_ops']} ops ({n_k1} K1, {n_k2} "
            f"K2 nodes, as the direct call's launches), replay {iters} iters "
            f"after {warmup}: iter_s {out['iter_s'] * 1e3:.3f} ms, qps "
            f"{out['qps']:.0f} ops/s against the direct call's "
            f"{case['direct_host_ms']:.3f} host ms | launches {launched} | "
            f"every output equal within rtol 1e-5, atol 1e-6 (max abs err "
            f"{err:.3e})"
            + (f"; planted fault (a table row + 1) caught, max abs err "
               f"{fault_err:.3e}" if name == "forward" else "")
            + f" | top per-op us {top5} | {smi}")
        del et, mgr, want, got
        torch.cuda.empty_cache()

    # -- cli.et at its own sizes, and a generated script in a subprocess
    tmp = tempfile.mkdtemp(prefix="chip_smoke_23_")
    rec["cli"] = {}
    for w in ("dlrm", "mlp", "dlrm_train"):
        path = os.path.join(tmp, f"{w}_et.json.gz")
        script = os.path.join(tmp, f"replay_{w}.py")
        rcs = [run_cli(et_cli, ["capture", "--workload", w, "-o", path,
                                "--device", "cuda"])[0],
               run_cli(et_cli, ["validate", path])[0]]
        kernels.reset_launch_counts()
        rc, out, wall = run_cli(et_cli, ["replay", path, "--iters", "3",
                                         "--per-op", "--device", "cuda"])
        launched = add_launches()
        rcs += [rc, run_cli(et_cli, ["codegen", path, "-o", script])[0]]
        report = json.loads(out) if rc == 0 else {}
        if any(rcs) or report.get("errors") or report.get("num_skipped") or \
                (w != "mlp" and launched.get("emb_gather", 0) <= 0):
            fail(f"phase 23 cli.et {w}: rcs {rcs}, launches {launched}:\n"
                 f"{out}")
        rec["cli"][w] = dict(num_ops=report["num_ops"],
                             iter_s=report["iter_s"], launches=launched)
        say(f"phase 23 cli.et capture / validate / replay / codegen {w}: "
            f"{report['num_ops']} ops, iter_s {report['iter_s'] * 1e3:.3f} "
            f"ms | launches {launched}")
    script = os.path.join(tmp, "replay_dlrm.py")
    code = (f"import runpy, sys; sys.argv = [{script!r}, '--device', "
            "'cuda']; "
            f"runpy.run_path({script!r}, run_name='__main__'); "
            "from param_tpu_torch import kernels; "
            "print('K1 launches', kernels.launch_counts['emb_gather'])")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    want_line = f"replayed {rec['cli']['dlrm']['num_ops']} ops OK"
    m = re.search(r"K1 launches (\d+)", r.stdout)
    if r.returncode != 0 or want_line not in r.stdout or not m or \
            int(m.group(1)) <= 0:
        fail(f"phase 23 generated dlrm script: rc {r.returncode}:\n"
             f"{r.stdout}\n{r.stderr[-4000:]}")
    rec["codegen_k1_launches"] = int(m.group(1))
    say(f"phase 23 generated dlrm script in a subprocess: '{want_line}', K1 "
        f"launched {m.group(1)} times")

    # -- the sharded dense step in a world of one on NCCL (dry-run path 4)
    backend = DistBackend("cuda")
    backend.initialize()
    try:
        kernels.reset_launch_counts()
        srec, et = et_sharded.check(backend, cfg)[:2]
        add_launches()
        if not srec["ok"]:
            fail(f"phase 23 sharded step (world 1): {srec}")
        path = os.path.join(tmp, "sharded_et.json.gz")
        et.save(path)
        want_ops = len(comms_from_et(et, 1))
        details = os.path.join(tmp, "sharded_details.json")
        rc, out, wall = run_cli(replay_cli, [
            "--trace-path", path, "--trace-type", "et", "--blocking",
            "--no-warm-up", "--output-path", details, "--device", "cuda"])
        replayed = json.load(open(details)) if rc == 0 else []
        if rc != 0 or want_ops != 6 or len(replayed) != want_ops:
            fail(f"phase 23 cli.replay --trace-type et: rc {rc}, "
                 f"{len(replayed)} ops replayed against comms_from_et's "
                 f"{want_ops}:\n{out}")
    finally:
        backend.shutdown()
    srec["cli_replay_ops"] = len(replayed)
    rec["sharded"] = srec
    say(f"phase 23 sharded dense step (world 1, NCCL): {srec['num_ops']} ops "
        f"({srec['comm_ops']} comm), replay equals the direct step (max abs "
        f"err {srec['max_abs_err']:.3e}), iter_s {srec['iter_s'] * 1e3:.3f} "
        f"ms against {srec['direct_host_ms']:.3f} host ms; cli.replay "
        f"--trace-type et --blocking replayed {len(replayed)} comm ops | "
        f"launches {srec['launches']} | {smi}")
    rec["launches"] = {k: v for k, v in rec["launches"].items() if v}
    return rec


def et_sharded_world(cards: int, smi: str) -> dict:
    """``experiments.et_sharded`` under torchrun, one rank per card on NCCL:
    each rank's replay of its captured sharded step equals its own direct
    step."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(cards), "-m",
           "param_tpu_torch.experiments.et_sharded"]
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        out = p.communicate(timeout=600)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, 9)
        p.communicate()
        fail(f"phase 23 torchrun world of {cards} timed out")
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if p.returncode != 0 or not lines or not json.loads(lines[-1])["ok"]:
        fail(f"phase 23 torchrun world of {cards}: rc {p.returncode}:\n"
             f"{out[-6000:]}")
    res = json.loads(lines[-1])
    say(f"phase 23 torchrun world of {cards} experiments.et_sharded | "
        f"{wall:.1f} s | {smi}\n{json.dumps(res)}")
    res["wall_s"] = wall
    return res


def softmax_turns_over(q, k, causal, scale):
    """(B, H, S_q) bool: rows of softmax(scale q k^T) whose top two scores
    are within 4 eps of each other, eps = D 2^-22 scale max_j |q| @ |k_j|
    (the bound of a D-term sum of products each rounded to 2^-22 relative,
    the split-TF32 products' error and above f32's): there a last-bit
    difference in the scores may move the weight to another row of V, and
    no elementwise bound applies.  Computed in f64 on the card."""
    import torch

    qd, kd = q.double(), k.double()
    s = torch.matmul(qd, kd.transpose(-1, -2)) * scale
    mag = torch.matmul(qd.abs(), kd.abs().transpose(-1, -2)) * scale
    sq, sk = s.shape[-2:]
    if causal:  # bottom-right aligned, as K6
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(
            sk - sq)
        s = s.masked_fill(~keep, -math.inf)
        mag = mag.masked_fill(~keep, 0)
    top = s.topk(2, dim=-1).values
    eps = q.shape[-1] * 2.0 ** -22 * mag.amax(-1)
    return (top[..., 0] - top[..., 1]) <= 4 * eps


PT_ET_RUNS = (("transformer_long_et", "attention"),
              ("transformer_train_long_et", "attention-train"))
PT_ET_WINDOWS = 4  # attention windows a direction in each fixture


def pt_et_tier(smi: str, details: str) -> dict:
    """Phase 24: the PyTorch-ET op replay at the fixtures' llama2-7B
    attention width (see the module docstring).  ``details`` is phase 22's
    replay details file.  Returns the records; ``by_cast`` holds the
    main-path runs' K6 / K7 launches, f32 and bf16."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from param_tpu_torch import kernels
    from param_tpu_torch.cli import analyze, pt_et, scaling
    from param_tpu_torch.kernels.flash_fwd import (
        flash_fwd_plain, flash_fwd_tolerance,
    )
    from param_tpu_torch.ops.attention import flash_attention
    from param_tpu_torch.trace.pytorch_et import tensor_key
    from param_tpu_torch.trace.pytorch_op_replay import PyTorchOpReplay

    dev = torch.device("cuda", torch.cuda.current_device())
    fixtures = os.path.join(ROOT, "tests", "fixtures")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_24_")
    gib = 2.0 ** 30
    rec = {"launches": {k: 0 for k in kernels.launch_counts}, "runs": {},
           "by_cast": {"f32": [], "bf16": []}}
    path_of = {"f32": "tf32x3", "bf16": "wgmma"}

    def fresh():
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    # -- a warm-up replay (not recorded): clocks, cuBLAS and K6 / K7's
    # builds come up before the runs that are compared
    rc, out, _ = run_cli(pt_et, [
        "--trace", os.path.join(fixtures, "transformer_train_et.json.gz"),
        "--device", "cuda", "--fuse", "attention-train"])
    if rc != 0:
        fail(f"phase 24 warm-up replay: rc {rc}:\n{out[-4000:]}")

    # -- cli.pt_et, unfused then fused, f32 and bf16 (the main path)
    for fixture, fuse in PT_ET_RUNS:
        trace = os.path.join(fixtures, f"{fixture}.json.gz")
        for cast in ("f32", "bf16"):
            for f in (None, fuse):
                name = f"{fixture} --fuse {f} {cast}" if f else \
                    f"{fixture} unfused {cast}"
                report_path = os.path.join(tmp, "report.json")
                argv = ["--trace", trace, "--device", "cuda", "--top", "5",
                        "--output-json", report_path]
                argv += ["--fuse", f] if f else []
                argv += ["--cast", "bf16"] if cast == "bf16" else []
                fresh()
                kernels.reset_launch_counts()
                rc, out, wall = run_cli(pt_et, argv)
                torch.cuda.synchronize(dev)
                launched = {k: v for k, v in kernels.launch_counts.items()
                            if v}
                peak = torch.cuda.max_memory_allocated(dev) / gib
                report = {}
                if rc == 0:
                    with open(report_path) as fh:
                        report = json.load(fh)
                per_op = report.get("per_op", {})
                m = re.search(r"^fused (\d+) attention windows", out, re.M)
                mb = re.search(r"^fused (\d+) attention BACKWARD", out, re.M)
                wins = (int(m.group(1)) if m else 0,
                        int(mb.group(1)) if mb else 0)
                want_wins = (PT_ET_WINDOWS if f else 0,
                             PT_ET_WINDOWS if f == "attention-train" else 0)
                counts = (
                    per_op.get("fused::flash_attention", {}).get("count", 0),
                    per_op.get("fused::flash_attention_bwd", {})
                    .get("count", 0))
                # one untimed and one timed call a window and iteration
                want = {"flash_fwd": 2 * counts[0],
                        f"flash_fwd_{path_of[cast]}": 2 * counts[0],
                        "flash_bwd": 2 * counts[1],
                        f"flash_bwd_{path_of[cast]}": 2 * counts[1]}
                flash = {k: v for k, v in launched.items()
                         if k.startswith("flash_")}
                if rc != 0 or report.get("skipped") != {} or \
                        wins != want_wins or counts != wins or \
                        flash != {k: v for k, v in want.items() if v}:
                    fail(f"phase 24 cli.pt_et {name}: rc {rc}, skipped "
                         f"{report.get('skipped')}, windows {wins} against "
                         f"{want_wins}, fused calls {counts}, launches "
                         f"{launched} against {want}:\n{out[-4000:]}")
                for k, v in launched.items():
                    rec["launches"][k] += v
                ms = sum(s["total_us"] for s in per_op.values()) / 1e3
                run = dict(ops=report["num_executed"],
                           selected=report["num_selected"], windows=wins,
                           ms_timed_calls=ms, wall_s=report["wall_s"],
                           cli_wall_s=wall, peak_gib=peak,
                           launches=launched,
                           top5_us={k: (v["count"], round(v["total_us"], 1))
                                    for k, v in list(per_op.items())[:5]})
                rec["runs"][name] = run
                if f:
                    rec["by_cast"][cast].append(run)
                say(f"phase 24 cli.pt_et {name}: {run['ops']} of "
                    f"{run['selected']} ops, none skipped, windows {wins}, "
                    f"{ms:.3f} ms in the timed calls ({run['wall_s']:.2f} s "
                    f"wall with the untimed calls; cli {wall:.1f} s) | peak "
                    f"{peak:.2f} GiB | launches {launched} | top "
                    f"{run['top5_us']} | {smi}")

    # -- one forward window's K6 output against the plain version
    data = pt_et.load_trace(os.path.join(fixtures, "transformer_long_et"
                                         ".json.gz"))
    rec["window"] = {}
    for cast in ("f32", "bf16"):
        fresh()
        r = PyTorchOpReplay(data, fuse="attention", device=dev,
                            cast="bf16" if cast == "bf16" else None)
        w = r.fused_windows[0]
        for node in r.nodes:
            r.run_node(node, timed=False)
            if node.id == w.anchor_id:
                got = r.registry[tensor_key(node.outputs[0])]
                break
        q, k, v = (r._resolve_tensor(*s[:3]) for s in (w.q, w.k, w.v))
        direct = flash_attention(q, k, v, causal=w.causal, scale=w.scale)
        want = flash_fwd_plain(q, k, v, w.causal, w.scale)
        tol = flash_fwd_tolerance(q, k, v, want, w.causal, w.scale)
        v_scale = max(1.0, v.abs().max().item())
        if q.dtype == torch.float32:
            # phase 13's bound is for unit-scale inputs; O is linear in V
            tol = tol * v_scale
        rows = softmax_turns_over(q, k, w.causal, w.scale)
        err = (got.float() - want.float()).abs()
        n_bad = int(((err > tol) & ~rows[..., None]).sum())
        share = 1.0 - rows.float().mean().item()
        if got.shape != want.shape or not torch.equal(got, direct) or \
                n_bad or share < 0.9:
            fail(f"phase 24 window 0 {cast}: the replay's K6 output "
                 f"{tuple(got.shape)}, bitwise a direct K6 call: "
                 f"{torch.equal(got, direct)}; {n_bad} elements of the "
                 f"{share:.4f} of rows whose softmax cannot turn over "
                 f"outside flash_fwd_tolerance of the plain version")
        max_err = err[~rows].max().item()
        rec["window"][cast] = dict(
            shape=list(w.shape), causal=w.causal, scale=w.scale,
            v_scale=v_scale, rows_checked=share, max_abs_err=max_err)
        say(f"phase 24 window 0 of transformer_long_et {cast} "
            f"{tuple(w.shape)} causal: the replay's K6 output is bitwise a "
            f"direct K6 call on the same q / k / v views, and within "
            f"flash_fwd_tolerance of the plain version (f32: x max|v| "
            f"{v_scale:.1f}) on the {share:.4f} of rows whose softmax "
            f"cannot turn over (max abs err {max_err:.3e})")
        del r, q, k, v, got, want, tol, err, direct, rows

    # -- the CUDA-graph chain of the bf16 train fixture
    fresh()
    data = pt_et.load_trace(os.path.join(fixtures, "transformer_train_long"
                                         "_et.json.gz"))
    r = PyTorchOpReplay(data, fuse="attention-train", cast="bf16",
                        device=dev)
    t0 = time.perf_counter()
    chain = r.build_chain()
    build_s = time.perf_counter() - t0
    chain(1)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chain(2)
        torch.cuda.synchronize(dev)
    names = {"flash_fwd_wgmma": 0, "flash_bwd_dq_wgmma": 0,
             "flash_bwd_dkv_wgmma": 0}
    kernels_seen = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels_seen += e.count
        for n in names:
            if re.search(rf"\b{n}\b", e.key):
                names[n] += e.count
    if any(v != 2 * PT_ET_WINDOWS for v in names.values()):
        fail(f"phase 24 chain: two graph replays ran {names} (profiler "
             f"kernel names; {kernels_seen} kernels in all), not "
             f"{2 * PT_ET_WINDOWS} of each")
    chain_ms = r.measure_chain_iteration(n=5, reps=3, chain=chain)
    carry = chain(1).item()
    peak = torch.cuda.max_memory_allocated(dev) / gib
    discrete = rec["runs"]["transformer_train_long_et --fuse "
                           "attention-train bf16"]
    rec["chain"] = dict(ms=chain_ms, build_s=build_s, peak_gib=peak,
                        profiler_kernels=names, kernels=kernels_seen,
                        carry=carry, discrete_ms=discrete["ms_timed_calls"],
                        discrete_wall_s=discrete["wall_s"])
    say(f"phase 24 --chain transformer_train_long_et --fuse attention-train "
        f"bf16: captured in {build_s:.1f} s; two replays ran {names} "
        f"(torch.profiler kernel names, {kernels_seen} kernels); "
        f"{chain_ms:.3f} ms an iteration (CUDA events) against discrete "
        f"mode's {discrete['ms_timed_calls']:.3f} ms in its timed calls "
        f"({discrete['wall_s']:.2f} s wall); carry {carry:.4g} | peak "
        f"{peak:.2f} GiB | {smi}")
    del r, chain, prof
    fresh()

    # -- codegen of transformer_train_et, run on the card
    r = PyTorchOpReplay(pt_et.load_trace(os.path.join(
        fixtures, "transformer_train_et.json.gz")), device=dev)
    src = r.codegen("transformer_train_et")
    script = os.path.join(tmp, "replay_transformer_train.py")
    with open(script, "w") as fh:
        fh.write(src)
    want_line = f"replayed {src.count('    _bind(')} ops OK"
    p = subprocess.run([sys.executable, script, "--device", "cuda"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    if p.returncode != 0 or want_line not in p.stdout:
        fail(f"phase 24 generated script: rc {p.returncode}, no "
             f"'{want_line}':\n{p.stdout}\n{p.stderr[-4000:]}")
    rec["codegen"] = p.stdout.strip()
    say(f"phase 24 generated transformer_train_et script on the card: "
        f"{' / '.join(p.stdout.strip().splitlines())}")

    # -- cli.analyze on phase 22's replay details, cli.scaling
    rc, out, _ = run_cli(analyze, [details, "--world-size", "1", "--json"],
                         log=False)
    res = json.loads(out) if rc == 0 else {}
    if rc != 0 or not res.get("collectives") or \
            not res.get("total_comm_us", 0) > 0:
        fail(f"phase 24 cli.analyze {details}: rc {rc}:\n{out}")
    rec["analyze"] = res
    say(f"phase 24 cli.analyze (phase 22's replay details): "
        f"{len(res['collectives'])} collectives, total "
        f"{res['total_comm_us']:.1f} us, shared bw "
        f"{res['shared_bw_gbs']:.2f} GB/s")
    rc, out, _ = run_cli(scaling, ["--collective", "all_reduce", "--size",
                                   "64M", "--worlds", "2", "4", "8", "16",
                                   "64", "--json"], log=False)
    rows = json.loads(out) if rc == 0 else []
    if rc != 0 or [row["world"] for row in rows] != [2, 4, 8, 16, 64] or \
            not all(0 < row["time_us"] < math.inf and
                    0 < row["bus_bw_gbs"] <= 450 for row in rows):
        fail(f"phase 24 cli.scaling: rc {rc}:\n{out}")
    rec["scaling"] = rows
    say("phase 24 cli.scaling --collective all_reduce --size 64M (the "
        "model, not a measurement): " + ", ".join(
            f"{row['world']} GPUs {row['time_us']} us "
            f"({row['bus_bw_gbs']} GB/s)" for row in rows))
    rec["launches"] = {k: v for k, v in rec["launches"].items() if v}
    return rec


# Phase 25: every registered microbench op on the card against the CPU:
# name -> (build args, input arg specs, tolerance kind); shapes from the
# configs where they have the op.  "ew": 1e-6 x max|want| (elementwise
# f32); "sum": 1e-4 x max|want| (f32 sums in another order: matmuls,
# convolutions, reductions, attention); "bf16": two bf16 ulps of max|want|
# (16-bit outputs, rounded once on each side from f32 math that may differ
# in its last bits).
def _t(shape, dtype="float32", **kw):
    return {"type": "tensor", "dtype": dtype, "shape": shape, **kw}


MICROBENCH_OPS = {
    "jnp.add": ([], [_t([256, 512, 2]), _t([256, 512, 2])], "ew"),
    "jnp.mul": ([], [_t([256, 512]), _t([512])], "ew"),
    "jnp.clamp": ([], [_t([256, 512]), {"type": "float", "value": 0.25},
                       {"type": "float", "value": 0.75}], "ew"),
    "jnp.matmul": ([], [_t([8, 512, 512], "bfloat16"),
                        _t([1, 512, 2048], "bfloat16")], "sum"),
    "jnp.mm": ([], [_t([128, 128]), _t([128, 128])], "sum"),
    "jnp.bmm": ([], [_t([32, 128, 64], "bfloat16"),
                     _t([32, 64, 128], "bfloat16")], "sum"),
    "jnp.relu": ([], [_t([256, 512])], "ew"),
    "jnp.gelu": ([], [_t([4096, 2048], "bfloat16")], "bf16"),
    "jnp.softmax": ([], [_t([32, 128, 128])], "sum"),
    "nn.sdpa": ([], [_t([4, 256, 8, 64], "bfloat16")] * 3, "bf16"),
    "jnp.reshape": ([], [_t([64, 96]), {"type": "tuple", "value": [
        {"type": "int", "value": 96}, {"type": "int", "value": 64}]}], "ew"),
    "nn.Linear": ([64, 32], [_t([16, 64])], "sum"),
    "nn.Conv2d": ([3, 64, 3, 2], [_t([8, 56, 56, 3])], "sum"),
    "jnp.baddbmm": ([], [_t([16, 64, 64]), _t([16, 64, 32]),
                         _t([16, 32, 64])], "sum"),
    "jnp.cat": ([], [{"type": "genericlist", "value": [
        _t([128, 64]), _t([256, 64])]}], "ew"),
    "jnp.mean": ([], [_t([512, 1024])], "sum"),
    "nn.MaxPool2d": ([3, 2, 1], [_t([8, 56, 56, 64])], "ew"),
    "nn.AdaptiveAvgPool2d": ([7], [_t([8, 56, 56, 64])], "sum"),
    "nn.ReLU": ([], [_t([256, 512])], "ew"),
}
# registered names phase 25 holds elsewhere: Dropout by structure only
# (its mask is drawn on the device it runs on; the CPU tests hold it), the
# convnets after the ops, BatchedEmbedding in (a) and (b)
MICROBENCH_ELSEWHERE = {"nn.Dropout", "torch.nn.Dropout", "AlexNet",
                        "ResNetSmall", "BatchedEmbedding",
                        "SplitTableBatchedEmbeddingBagsCodegen"}


def microbench_op_names() -> dict:
    """{registered op name: the MICROBENCH_OPS entry it runs under}: each
    name of the registry (auto-wrapped ``torch.*`` paths aside) runs under
    the entry that wraps the same function or constructor, the one of the
    same last name first (``torch.mm`` under ``jnp.mm``).  Fails on a
    registered name that neither has such an entry nor is held elsewhere."""
    from param_tpu_torch.microbench.operator import TorchPathOp, op_map

    def impl(op):
        return getattr(op, "fn", None) or getattr(op, "ctor", None)

    def last(name):
        return name.rsplit(".", 1)[-1].rstrip("_")

    names, missing = {}, []
    for name, op in sorted(op_map.items()):
        if isinstance(op, TorchPathOp) or name in MICROBENCH_ELSEWHERE:
            continue
        same = [c for c in MICROBENCH_OPS if impl(op_map[c]) is impl(op)]
        same.sort(key=lambda c: last(c) != last(name))
        if not same:
            missing.append(name)
        else:
            names[name] = same[0]
    if missing:
        fail(f"phase 25: registered ops with no card-against-CPU spec: "
             f"{missing}")
    return names


_TOL = {"ew": lambda ref: 1e-6 * ref, "sum": lambda ref: 1e-4 * ref,
        "bf16": lambda ref: 2.0 ** (math.floor(math.log2(max(ref, 1e-30))) - 6)}
# phase 25's K3 schedule tuner shapes, (name, m, n, k, dtype name)
TUNE_SHAPES = [("llama2 q-proj", 2048, 4096, 4096, "bfloat16"),
               ("GEMM_C", 1024, 1024, 4096, "float32"),
               ("split K", 128, 1024, 1024, "bfloat16")]


# Phase 25: the device's busy share of eager microbench calls, in a fresh
# process (in chip_smoke's own, after the earlier phases, torch.profiler
# records no device events; see phase 19): for each call, its time issued
# eagerly (CUDA events around 20 calls, median of 3 windows) and its device
# time (torch.profiler, the sum of its device operations' times a call over
# 10 calls); busy = device / eager.  The ops' calls are OpExecutor's own.
MICROBENCH_BUSY = """
import json
import os
from param_tpu_torch.microbench.benchmark import (
    BenchmarkConfig, OpExecutor, RunOptions)
from param_tpu_torch.microbench.data import DefaultDataGenerator
from param_tpu_torch.microbench.iterator import get_config_iterator
from param_tpu_torch.microbench.operator import get_operator, load_workloads
from param_tpu_torch.ops.cvt_convs import CVT_CONFIGS, layer_call
from param_tpu_torch.utils.device import resolve_device
from param_tpu_torch.utils.profiler import kernel_times
from param_tpu_torch.utils.timer import time_ms
dev = resolve_device("cuda")
load_workloads()
gen = DefaultDataGenerator(dev)


def op_call(config, run_id, pass_name):
    name, b, i = run_id.rsplit(":", 2)
    cfg = BenchmarkConfig.load_json_file(os.path.join("configs", config))
    oc = next(o for o in cfg.ops if o.name == name)
    builds = list(get_config_iterator(oc.build_iterator)(
        oc.configs, key="build")) or [{"args": [], "kwargs": {}}]
    inputs = list(get_config_iterator(oc.input_iterator)(
        oc.configs, key="input"))
    op = get_operator(name)
    op.device = dev
    b_args, b_kw = gen.get_data(builds[int(b)])
    op.build(*b_args, **b_kw)
    args, kw = gen.get_data(inputs[int(i)])
    return OpExecutor(name, op, RunOptions(device="cuda")).calls(
        args, kw)[pass_name]


def bag_forward():
    op = get_operator("BatchedEmbedding")
    op.device = dev
    op.build(8, 100_000, 64)
    ids = gen.get_data({"args": [{"type": "tensor", "dtype": "int32",
                                  "shape": [2048, 8, 10], "low": 0,
                                  "high": 100_000}]})[0][0]
    return lambda: op.forward(ids)


cases = [
    ("BatchedEmbedding 8 x 100000 x 64 f32, 2048 x 10, forward",
     bag_forward),
    ("basic_ops jnp.add:0:0 backward",
     lambda: op_call("basic_ops.json", "jnp.add:0:0", "backward")),
    ("transformer_ops jnp.matmul:0:3 backward",
     lambda: op_call("transformer_ops.json", "jnp.matmul:0:3", "backward")),
    ("transformer_ops jnp.gelu:0:0 backward",
     lambda: op_call("transformer_ops.json", "jnp.gelu:0:0", "backward")),
] + [(f"{CVT_CONFIGS[ci].name} f32 {what}",
      lambda ci=ci, fo=fo: layer_call(CVT_CONFIGS[ci], ci, fo, device=dev))
     for ci in (2, 8) for what, fo in (("forward", True),
                                       ("forward + backward", False))]
out = {}
for label, make in cases:
    call = make()
    eager = time_ms(call, 20, dev, reps=3)
    device, by_name = kernel_times(call, calls=10)
    out[label] = dict(eager_ms=eager, device_ms=device, busy=device / eager,
                      top=[[k[:60], v["ms"]] for k, v in
                           list(by_name.items())[:3]])
print(json.dumps(out))
"""


def microbench_busy() -> dict:
    """{call: {eager_ms, device_ms, busy, top}} of ``MICROBENCH_BUSY``."""
    r = subprocess.run([sys.executable, "-c", MICROBENCH_BUSY], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    if r.returncode != 0:
        fail(f"phase 25 busy share: rc {r.returncode}:\n{r.stdout[-3000:]}\n"
             f"{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def gemm_tolerance(want):
    """K3's tolerance (phase 7): f32: 1e-4 x max|out| (long sums in another
    order); bf16: one bf16 ulp of max|out| (one rounding of an f32 sum on
    each side)."""
    import torch

    ref = want.float().abs().max().item()
    if want.dtype == torch.float32:
        return 1e-4 * ref
    return 2.0 ** (math.floor(math.log2(ref)) - 7)


def expected_run_ids(cfg) -> list:
    """The run ids a config's run gives, from its iterators (build x input,
    in BuildExecutor's order)."""
    from param_tpu_torch.microbench.iterator import get_config_iterator

    ids = []
    for op in cfg.ops:
        builds = len(list(get_config_iterator(op.build_iterator)(
            op.configs, key="build"))) or 1
        inputs = len(list(get_config_iterator(op.input_iterator)(
            op.configs, key="input")))
        ids += [f"{op.name}:{b}:{i}" for b in range(builds)
                for i in range(inputs)]
    return ids


def microbench_tier(smi: str, timings=None, timing_text=None) -> dict:
    """Phase 25: the operator microbench tier on the card (see the module
    docstring).  ``timings`` and ``timing_text`` are main's (phase 4);
    with them, each tuned shape's default K3 schedule is timed for the
    kernels line (``timed``).
    Returns the records, with the main path's launches in ``launches``,
    its K1 launches by shape in ``k1_launches`` and the tuner's K3
    launches by path in ``tune_launches``."""
    import copy
    import tempfile

    import torch

    from param_tpu_torch import kernels
    from param_tpu_torch.cli import cvt, run_benchmark
    from param_tpu_torch.kernels.emb_gather import emb_gather_plain
    from param_tpu_torch.kernels.gemm import (
        aligned_operands, default_schedule, gemm_cuda, gemm_plain,
    )
    from param_tpu_torch.microbench.benchmark import (
        Benchmark, BenchmarkConfig, RunOptions,
    )
    from param_tpu_torch.microbench.data import DefaultDataGenerator
    from param_tpu_torch.microbench.operator import get_operator, load_workloads
    from param_tpu_torch.ops.cvt_convs import CVT_CONFIGS, layer_inputs
    from param_tpu_torch.ops.matmul_tune import candidate_blocks, tune_matmul
    from param_tpu_torch.utils.chip import bound_ms
    from param_tpu_torch.utils.device import resolve_device
    from param_tpu_torch.utils.dtypes import dtype_from_name
    from param_tpu_torch.utils.timer import time_samples

    resolve_device("cuda")  # TF32 off: the card's f32 sums are full f32
    dev = torch.device("cuda", torch.cuda.current_device())
    cpu = torch.device("cpu")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_25_")
    t_start = time.perf_counter()
    load_workloads()
    rec = {"launches": {k: 0 for k in kernels.launch_counts}, "configs": {}}

    def count(fn, main=True):
        """fn() with the launch counts set to 0 just before and read just
        after, added to the phase's main-path launches unless ``main`` is
        false (a call made to compare a kernel with its plain version)."""
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize(dev)
        got = dict(kernels.launch_counts)
        for k, v in got.items():
            rec["launches"][k] += v if main else 0
        return out, got

    def check_bag(cfg, label):
        """The BatchedEmbedding of ``cfg``'s first build and input rebuilt on
        the card: one K1 launch a table in a forward (not counted as the
        main path's), its output within phase 2's rtol 1e-5 of the plain
        bag on the same tables and ids.  Returns (launches a forward, max
        abs err, tol)."""
        op = get_operator("BatchedEmbedding")
        op.device = dev
        gen_d = DefaultDataGenerator(dev)
        b_args, b_kw = gen_d.get_data(cfg.ops[0].configs[0]["build"][0])
        op.build(*b_args, **b_kw)
        ids = gen_d.get_data(cfg.ops[0].configs[0]["input"][0])[0][0]
        out, per_call = count(lambda: op.forward(ids), main=False)
        n_t, _, dim = op.tables.shape
        if per_call["emb_gather"] != n_t:
            fail(f"phase 25 BatchedEmbedding {label}: one forward launched "
                 f"K1 {per_call['emb_gather']} times, not {n_t}")
        want = torch.stack([emb_gather_plain(op.tables[t],
                                             ids[:, t].contiguous())
                            for t in range(n_t)], dim=1)
        err = (out - want).abs().max().item()
        tol = 1e-5 * want.abs().max().item()
        if out.shape != (ids.shape[0], n_t, dim) or not err <= tol:
            fail(f"phase 25 BatchedEmbedding {label}: shape "
                 f"{tuple(out.shape)}, max abs err {err:.3e} > {tol:.3e} "
                 f"against the plain bag")
        op.cleanup()
        return per_call["emb_gather"], err, tol

    def lat_ok(pass_rec, mode):
        key = "lat_us" if mode == "chain" else "lat_us_p50"
        v = pass_rec.get(key)
        return isinstance(v, float) and math.isfinite(v) and v > 0

    # -- (a) the three configs through cli.run_benchmark
    cpu_ids = None
    for name, backward, mode in (("basic_ops", True, "chain"),
                                 ("transformer_ops", True, "chain"),
                                 ("llama2", False, "chain"),
                                 ("basic_ops", True, "discrete")):
        path = os.path.join(ROOT, "configs", f"{name}.json")
        out = os.path.join(tmp, f"{name}_{mode}.jsonl")
        argv = ["-c", path, "-o", out, "--mode", mode] + (
            ["-b"] if backward else [])
        (rc, text, wall), got = count(lambda: run_cli(run_benchmark, argv))
        with open(out) as f:
            recs = [json.loads(line) for line in f]
        want_ids = expected_run_ids(BenchmarkConfig.load_json_file(path))
        if name == "basic_ops" and cpu_ids is None:
            cpu_ids = [r["run_id"] for r in Benchmark(
                BenchmarkConfig.load_json_file(path),
                RunOptions(iters=1, device="cpu")).run()]
            if cpu_ids != want_ids:
                fail(f"phase 25 basic_ops CPU run ids {cpu_ids} != {want_ids}")
        bad = []
        for r in recs:
            for p in ("forward", "backward") if backward else ("forward",):
                pr = r.get(p, {})
                no_grad = (p == "backward" and r["name"] == "BatchedEmbedding"
                           and pr == {"error": "no differentiable tensor args"})
                if not no_grad and ("error" in pr or not lat_ok(pr, mode)):
                    bad.append((r["run_id"], p, pr))
        if rc != 0 or [r["run_id"] for r in recs] != want_ids or bad:
            fail(f"phase 25 cli.run_benchmark {name} {mode}: rc {rc}, run ids "
                 f"{[r['run_id'] for r in recs]} (want {want_ids}), bad "
                 f"records {bad}:\n{text[-3000:]}")
        key = "lat_us" if mode == "chain" else "lat_us_p50"
        rows = {r["run_id"]: (r["forward"][key],
                              r.get("backward", {}).get(key))
                for r in recs}
        rec["configs"][f"{name} {mode}"] = dict(wall_s=wall, launches={
            k: v for k, v in got.items() if v}, lat_us=rows)
        say(f"phase 25 cli.run_benchmark -c configs/{name}.json --mode {mode}"
            f"{' -b' if backward else ''}: {len(recs)} records, run ids as "
            f"the CPU run's, none in error (BatchedEmbedding's backward: no "
            f"differentiable tensor args, as in the JAX package) | {wall:.1f} "
            f"s | launches {rec['configs'][f'{name} {mode}']['launches']} | "
            f"{key} (fwd, bwd) " + "; ".join(
                f"{i} {f:.1f}" + (f" / {b:.1f}" if b else "")
                for i, (f, b) in rows.items()) + f" | {smi}")

    # the config's BatchedEmbedding (K1 at (1000, 16), 32 bags x 8) on the
    # card against the plain bag
    cfg_a = BenchmarkConfig.load_json_file(
        os.path.join(ROOT, "configs", "basic_ops.json"))
    cfg_a.ops = [o for o in cfg_a.ops if o.name == "BatchedEmbedding"]
    n_a, err_a, tol_a = check_bag(cfg_a, "of configs/basic_ops.json")
    rec["k1_launches"] = {"basic_ops": sum(
        c["launches"].get("emb_gather", 0) for c in rec["configs"].values())}
    rec["basic_ops_bag"] = dict(launches_per_forward=n_a, max_abs_err=err_a,
                                tol=tol_a)
    say(f"phase 25 BatchedEmbedding of configs/basic_ops.json rebuilt on the "
        f"card: {n_a} K1 launches a forward, max abs err {err_a:.3e} (tol "
        f"{tol_a:.3e}) against the plain bag; the config runs launched K1 "
        f"{rec['k1_launches']['basic_ops']} times at this shape")

    # -- (b) BatchedEmbedding at the DLRM trainer's default width
    T_, E_, D_, B_, N_ = 8, 100_000, 64, 2048, 10
    inline = json.dumps({"BatchedEmbedding": {"config": [{
        "build": [{"args": [{"type": "int", "value": v}
                            for v in (T_, E_, D_)]}],
        "input": [{"args": [_t([B_, T_, N_], "int32", low=0, high=E_)]}]}]}})
    cfg_b = BenchmarkConfig.loads(inline)
    (res_b,), got_b = count(lambda: Benchmark(
        cfg_b, RunOptions(iters=20, device="cuda")).run())
    if "error" in res_b["forward"] or not lat_ok(res_b["forward"], "chain"):
        fail(f"phase 25 BatchedEmbedding at the trainer's width: {res_b}")
    rec["k1_launches"]["trainer"] = got_b["emb_gather"]
    n_b, err, tol = check_bag(cfg_b, "at the trainer's width")
    # --profile-dir through the CLI in a fresh process (in this process,
    # after the earlier phases, torch.profiler records no device events;
    # see phase 19)
    cfg_path = os.path.join(tmp, "batched_embedding.json")
    with open(cfg_path, "w") as f:
        f.write(inline)
    prof_out = os.path.join(tmp, "batched_embedding_profile.jsonl")
    r = subprocess.run(
        [sys.executable, "-m", "param_tpu_torch.cli.run_benchmark", "-c",
         cfg_path, "-o", prof_out, "-i", "5", "--log", "WARNING",
         "--profile-dir", os.path.join(tmp, "profile")], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    with open(prof_out) as f:
        res_p = json.loads(f.readline())
    names = [d["name"] for d in res_p["forward"].get("profile", {}).get(
        "device_ops", [])]
    if r.returncode != 0 or not any("emb_gather" in n for n in names):
        fail(f"phase 25 cli.run_benchmark --profile-dir: rc {r.returncode}, "
             f"no K1 kernel among the device ops {names} "
             f"({res_p['forward'].get('profile')}):\n{r.stderr[-3000:]}")
    rec["batched_embedding"] = dict(
        lat_us=res_b["forward"]["lat_us"], launches_per_forward=n_b,
        max_abs_err=err, tol=tol, device_ops=names[:5])
    say(f"phase 25 BatchedEmbedding {T_} x {E_} x {D_} f32, batch {B_}, nnz "
        f"{N_} (inline config): {res_b['forward']['lat_us']:.1f} us a forward "
        f"(chain of 20; {got_b['emb_gather']} K1 launches in the run), {n_b} "
        f"K1 launches a forward, max abs err {err:.3e} (tol {tol:.3e}) "
        f"against the plain bag; --profile-dir device ops {names[:3]} | "
        f"{smi}")

    # -- (c) every registered op, AlexNet and ResNetSmall: card against CPU
    worst = {}
    op_names = microbench_op_names()
    for name, spec_name in op_names.items():
        b_args, specs, kind = MICROBENCH_OPS[spec_name]
        outs, grads = [], []
        for d in (cpu, dev):
            o = get_operator(name)
            o.device = d
            o.build(*b_args)
            a, _ = DefaultDataGenerator(d).get_data({"args": specs}, seed=25)
            with torch.no_grad():
                outs.append(o.forward(*a).float().cpu())
            if name in ("jnp.matmul", "jnp.bmm"):  # f32 sums of bf16: grads
                a = [t.requires_grad_(True) for t in a]
                grads.append([g.float().cpu() for g in torch.autograd.grad(
                    o.forward(*a).sum(), a)])
            o.cleanup()
        want, got = outs
        ref = want.abs().max().item()
        err = (got - want).abs().max().item()
        if got.shape != want.shape or not err <= _TOL[kind](ref):
            fail(f"phase 25 op {name} on the card against the CPU: shape "
                 f"{tuple(got.shape)} / {tuple(want.shape)}, max abs err "
                 f"{err:.3e} > {_TOL[kind](ref):.3e} ({kind})")
        for gw, gg in zip(*grads) if grads else ():
            gref = gw.abs().max().item()
            if not (gg - gw).abs().max().item() <= _TOL["bf16"](gref):
                fail(f"phase 25 op {name}: its gradient on the card is not "
                     f"the CPU's within two bf16 ulps")
        worst[name] = err / max(ref, 1e-30)
    for name in ("AlexNet", "ResNetSmall"):
        x = DefaultDataGenerator(cpu).get_data(
            {"args": [_t([32, 224, 224, 3])]}, seed=25)[0][0]
        o = get_operator(name)
        o.device = cpu
        o.build()
        with torch.no_grad():
            want = o.forward(x)  # builds the CPU model
            # the same weights carried to the card
            o.model, o.device = copy.deepcopy(o.model).to(dev), dev
            got = o.forward(x.to(dev)).cpu()
        o.cleanup()
        ref = want.abs().max().item()
        err = (got - want).abs().max().item()
        if got.shape != (32, 1000) or not err <= 1e-4 * ref:
            fail(f"phase 25 {name} (32 x 224 x 224 x 3) on the card against "
                 f"the CPU: max abs err {err:.3e} > {1e-4 * ref:.3e}")
        worst[name] = err / ref
    rec["card_vs_cpu"] = worst
    say(f"phase 25 card against CPU, same inputs and weights: "
        f"{len(op_names)} op names (all registered but Dropout) and AlexNet / "
        f"ResNetSmall at 32 x 224 x 224 x 3; largest error over max|out| "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(
            worst.items(), key=lambda kv: -kv[1])[:6]) + f" | {smi}")

    # -- (d) cli.cvt: all 11 layers, fwd and fwd+bwd, f32 and bf16
    rec["cvt"] = {}
    for flags in (["--forward-only"], []):
        for dt in ("float32", "bfloat16"):
            argv = flags + ["--dtype", dt]
            rc, text, wall = run_cli(cvt, argv)
            rows = [ln for ln in text.splitlines()
                    if ln.startswith("CVT-RES cvt.")]
            vals = [[float(v) for v in ln.split()[-3:]] for ln in rows]
            if rc != 0 or len(rows) != 11 or not all(
                    math.isfinite(v) and v >= 0 for r in vals for v in r) \
                    or not all(r[0] > 0 for r in vals):
                fail(f"phase 25 cli.cvt {' '.join(argv)}: rc {rc}, "
                     f"{len(rows)} rows:\n{text[-3000:]}")
            label = f"{'fwd' if flags else 'fwd+bwd'} {dt}"
            rec["cvt"][label] = {ln.split()[1]: float(ln.split()[-3])
                                 for ln in rows}
            say(f"phase 25 cli.cvt {' '.join(argv)}: 11 CVT-RES rows, elap us "
                + ", ".join(f"{k.split('cvt.')[1]} {v:.1f}" for k, v in
                            rec["cvt"][label].items()) + f" | {wall:.1f} s | "
                f"{smi}")
    for cfg in (CVT_CONFIGS[2], CVT_CONFIGS[8]):
        params, fn, x, _ = layer_inputs(cfg, 0, torch.float32, cpu)
        with torch.no_grad():
            want = fn(params, x)
            got = fn({k: v.to(dev) for k, v in params.items()},
                     x.to(dev)).cpu()
        ref = want.abs().max().item()
        err = (got - want).abs().max().item()
        if got.shape != want.shape or not err <= 1e-4 * ref:
            fail(f"phase 25 {cfg.name} on the card against the CPU: max abs "
                 f"err {err:.3e} > {1e-4 * ref:.3e}")
        rec["cvt"][f"{cfg.name} card vs cpu"] = err / ref
        say(f"phase 25 {cfg.name} {cfg.input_shape} f32 on the card against "
            f"the CPU: max abs err {err:.3e} (tol {1e-4 * ref:.3e})")

    # -- the device's busy share of eager calls, in a fresh process
    rec["busy"] = microbench_busy()
    for label, b in rec["busy"].items():
        if not b["device_ms"] > 0 or not b["eager_ms"] > 0:
            fail(f"phase 25 busy share of {label}: no device time recorded "
                 f"({b})")
        say(f"phase 25 busy share, {label}: {b['eager_ms']:.4f} ms a call "
            f"issued eagerly, {b['device_ms']:.4f} ms of device time "
            f"({100 * b['busy']:.1f}% busy); longest: " + ", ".join(
                f"{n} {ms:.4f}" for n, ms in b["top"]) + f" | {smi}")

    # -- (e) the K3 schedule tuner
    rec["tune"], rec["tune_launches"], tuned = {}, {}, {}
    gen = torch.Generator(device=dev).manual_seed(25)
    for label, m, n, k, dname in TUNE_SHAPES:
        dt = dtype_from_name(dname)
        a = torch.randn((m, k), generator=gen, device=dev).to(dt)
        b = torch.randn((k, n), generator=gen, device=dev).to(dt)
        want = gemm_plain(a, b)
        tol = gemm_tolerance(want)
        # five rounds, each one window per candidate in turns
        rounds, launched = count(lambda: [
            tune_matmul(a, b, reps=1, iters=10)[1] for _ in range(5)])
        med = {sc: statistics.median(r[sc] for r in rounds)
               for sc in rounds[0]}
        best = min(med, key=med.get)
        spread = {sc: (min(r[sc] for r in rounds), max(r[sc] for r in rounds))
                  for sc in med}
        est = {c.schedule(): c.est_us for c in candidate_blocks(
            m, n, k, dt, aligned_operands(a, b), top=10_000,
            sms=torch.cuda.get_device_properties(dev).multi_processor_count)}
        for key in ("gemm_wgmma", "gemm_mma_sync", "gemm_f32"):
            rec["tune_launches"][key] = rec["tune_launches"].get(key, 0) + \
                launched[key]
        errs = {}
        for sched in med:
            got = gemm_cuda(a, b, schedule=sched)
            torch.cuda.synchronize(dev)
            errs[sched] = (got.float() - want.float()).abs().max().item()
            if not errs[sched] <= tol:
                fail(f"phase 25 tune {label} {sched}: max abs err "
                     f"{errs[sched]:.3e} > {tol:.3e}")
        flat = b.view(-1)
        i = int(flat.abs().argmax())
        flat[i] = -flat[i]
        bad = gemm_cuda(a, b, schedule=best)
        torch.cuda.synchronize(dev)
        flat[i] = -flat[i]
        fault = (bad.float() - want.float()).abs().max().item()
        if not fault > tol:
            fail(f"phase 25 tune {label}: a planted fault (B element {i} "
                 f"negated) under {best} was not flagged: {fault:.3e}")
        dflt = default_schedule(m, n, k, dt, aligned_operands(a, b),
                                torch.cuda.get_device_properties(
                                    dev).multi_processor_count)
        lib = time_samples(lambda: torch.matmul(a, b), 10, dev, reps=5,
                           graph=True)
        lib_ms = statistics.median(lib)
        es = a.element_size()
        b_ms, b_by = bound_ms((m * k + k * n + m * n) * es, 2 * m * n * k,
                              fp32=dt == torch.float32)
        rec["tune"][label] = dict(
            shape=f"({m}, {k}) @ ({k}, {n}) {dname}", best=list(best),
            default=list(dflt), candidates={
                str(tuple(sc)): dict(median_us=us, min_us=spread[sc][0],
                                     max_us=spread[sc][1], est_us=est[sc],
                                     max_abs_err=errs[sc])
                for sc, us in med.items()},
            tol=tol, fault_err=fault, torch_matmul_us=lib_ms * 1e3,
            torch_matmul_spread_us=[min(lib) * 1e3, max(lib) * 1e3],
            bound_ms=b_ms, bound_by=b_by)
        tuned[label] = (dflt, a, b, launched[
            "gemm_" + ("f32" if dflt.path == "simt" else dflt.path)])
        say(f"phase 25 tune_matmul {label} ({m}, {k}) @ ({k}, {n}) {dname}: "
            f"path/splits[/rows first]: median us a call (min-max; model "
            f"us) over 5 rounds of graph replays in turns: " + "; ".join(
                f"{sc.path}/{sc.splits}{'/rows' if sc.rows_fastest else ''} "
                f"{us:.2f} ({spread[sc][0]:.2f}-{spread[sc][1]:.2f}; "
                f"{est[sc]:.2f}){' default' if sc == dflt else ''}"
                f"{' best' if sc == best else ''}"
                for sc, us in sorted(med.items(), key=lambda kv: kv[1]))
            + f" | torch.matmul {lib_ms * 1e3:.2f} ({min(lib) * 1e3:.2f}-"
            f"{max(lib) * 1e3:.2f}) | bound {b_ms * 1e3:.2f} "
            f"({b_by}) | every candidate within {tol:.3e} of the plain "
            f"version (largest {max(errs.values()):.3e}); planted fault "
            f"{fault:.3e} flagged | launches {launched['gemm_wgmma']} wgmma, "
            f"{launched['gemm_mma_sync']} mma_sync, {launched['gemm_f32']} "
            f"f32 | {smi}")
    # each shape's default schedule (gemm_schedule's pick: the same from
    # run to run, where the tuner's best changes within its spread), timed
    # as phase 7 times K3 for the kernels line, with the tuner's launches
    # of its path at that shape
    rec["timed"] = {}
    for label, (sched, a, b, n_launched) in (tuned.items() if timings
                                             else ()):
        want = gemm_plain(a, b)
        got = gemm_cuda(a, b, schedule=sched)
        err = (got.float() - want.float()).abs().max().item()
        m, k = a.shape
        n = b.shape[1]
        t = timings(lambda: gemm_cuda(a, b, schedule=sched),
                    lambda: gemm_plain(a, b), lambda: torch.matmul(a, b), 20)
        es = a.element_size()
        b_ms, b_by = bound_ms((m * k + k * n + m * n) * es, 2 * m * n * k,
                              fp32=a.dtype == torch.float32)
        t.update(shape=f"({m}, {k}) @ ({k}, {n}) {str(a.dtype)[6:]}, "
                       f"schedule {tuple(sched)}", max_abs_err=err,
                 bound_ms=b_ms, bound_by=b_by, path=sched.path,
                 splits=sched.splits, rows_fastest=sched.rows_fastest,
                 launches=n_launched)
        rec["timed"][label] = t
        say(f"phase 25 K3 {label}, default schedule {tuple(sched)}: "
            f"{t['shape']} max_abs_err {err:.3e} | "
            f"{timing_text(t, 'torch.matmul')} bound {b_ms:.4f} ms "
            f"({b_by}) | {smi}")
    if not rec["launches"].get("emb_gather") or not all(
            v[3] for v in tuned.values()):
        fail(f"phase 25: K1 / K3 not launched on the main path "
             f"({rec['launches']}, tuner {rec['tune_launches']})")
    rec["wall_s"] = time.perf_counter() - t_start
    rec["launches"] = {k: v for k, v in rec["launches"].items() if v}
    say(f"phase 25 done in {rec['wall_s']:.1f} s; main-path launches "
        f"{rec['launches']}")
    return rec


# phase 26's widths: MLP_A (layers, din, hidden, dout, batch), the small
# card-against-CPU MLP, and the inference bench's int4 MLP
MLP_A = (18, 4096, 4096, 4096, 1024)
MLP_SMALL = (3, 256, 512, 64, 128)
MLP_INT4 = (18, 4096, 4096, 4096, 512)


def mlp_dims(shape) -> list:
    layers, din, hidden, dout, _ = shape
    return [din] + [hidden] * (layers - 1) + [dout]


def bf16_ulp(top: float) -> float:
    """One bf16 ulp at magnitude ``top``."""
    return 2.0 ** (math.floor(math.log2(top)) - 7)


def mlp_param_tol(want, dtype, top=None) -> float:
    """The MLP tests' tolerance: f32 1e-5 x max |want| (beside rtol 1e-5),
    16-bit two bf16 ulps of max |want|, or of ``top`` when given."""
    top = want.float().abs().max().item() if top is None else top
    if dtype == "float32":
        return 1e-5 * top
    return 2 * bf16_ulp(top)


def mlp_steps_tier(smi: str) -> dict:
    """Phase 26: the MLP train and infer steps, the int4 MLP's one-off cast
    and a ``param_profile`` region on the card (see the module docstring).
    Returns the records, with the int4 forward's K5 launches in
    ``k5_launches``."""
    import torch

    from param_tpu_torch import kernels
    from param_tpu_torch.ops.inference import (
        cast_int4_mlp, mlp_forward_int4, quantize_weights_int4,
    )
    from param_tpu_torch.ops.mlp import (
        infer_step, init_mlp, make_optimizer, make_train_step, mlp_forward,
        tree_leaves,
    )
    from param_tpu_torch.utils.device import resolve_device
    from param_tpu_torch.utils.timer import ParamTimer, param_profile, time_ms

    dev = resolve_device("cuda")  # TF32 off: the card's f32 sums are full f32
    t_start = time.perf_counter()
    rec = {"full": {}, "small": {}}

    def hand_steps(params, opt, state, x, y, n):
        """``n`` steps written out as bench_mlp's inline step was: the
        leaves themselves require grad, MSE loss, autograd, the update."""
        for t in tree_leaves(params):
            t.requires_grad_(True)
        losses = []
        for _ in range(n):
            loss = torch.mean((mlp_forward(params, x).float() - y) ** 2)
            grads = torch.autograd.grad(loss, tree_leaves(params))
            opt.update(params, grads, state)
            losses.append(loss.detach())
        return losses

    # -- MLP_A: 3 steps bitwise equal to the same steps by hand, step ms
    dims = mlp_dims(MLP_A)
    batch = MLP_A[-1]
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        gen = torch.Generator(device=dev).manual_seed(26)
        base = init_mlp(gen, dims, dt, device=dev)
        x = torch.rand((batch, dims[0]), generator=gen, device=dev).to(dt)
        y = torch.rand((batch, dims[-1]), generator=gen, device=dev)
        for name in ("sgd", "adagrad"):
            label = f"{dtype} {name}"
            params = [tuple(t.clone() for t in wb) for wb in base]
            hand = [tuple(t.clone() for t in wb) for wb in base]
            opt = make_optimizer(name)
            step, state = make_train_step(opt), opt.init(params)
            kernels.reset_launch_counts()
            losses = [step(params, state, x, y)[2] for _ in range(3)]
            torch.cuda.synchronize()
            launched = {k: v for k, v in kernels.launch_counts.items() if v}
            want = hand_steps(hand, opt, opt.init(hand), x, y, 3)
            torch.cuda.synchronize()
            lv = [float(v) for v in losses]
            same = all(torch.equal(a, b.detach()) for a, b in zip(
                tree_leaves(params), tree_leaves(hand)))
            if launched or not all(map(math.isfinite, lv)) or not same or \
                    lv != [float(v) for v in want]:
                fail(f"phase 26 make_train_step {MLP_A} {label}: losses {lv} "
                     f"against by hand {[float(v) for v in want]}, params "
                     f"bitwise equal {same}, port kernels launched "
                     f"{launched} (want none: the products are torch.matmul)")
            del hand, want
            ms = time_ms(lambda: step(params, state, x, y), 5, dev, reps=5)
            flops = 6 * sum(a * b for a, b in zip(dims, dims[1:])) * batch
            rec["full"][label] = dict(losses=lv, step_ms=ms,
                                      tflops=flops / ms / 1e9)
            say(f"phase 26 make_train_step {MLP_A} {label}: 3 steps, losses "
                f"{lv}, params bitwise equal to the steps by hand (autograd "
                f"+ {type(opt).__name__}) | step {ms:.3f} ms, "
                f"{flops / ms / 1e9:.1f} TF/s (CUDA events, median of 5 "
                f"windows of 5 steps) | {smi}")
            del params, state
        with torch.no_grad():
            want = mlp_forward(base, x)
        got = infer_step(base, x)
        if got.requires_grad or not torch.equal(got, want) or \
                not torch.isfinite(got.float()).all():
            fail(f"phase 26 infer_step {MLP_A} {dtype}: not bitwise "
                 f"mlp_forward under no_grad, or not finite")
        ms = time_ms(lambda: infer_step(base, x), 10, dev, reps=5)
        rec["full"][f"{dtype} infer"] = dict(ms=ms)
        say(f"phase 26 infer_step {MLP_A} {dtype}: bitwise mlp_forward under "
            f"no_grad | {ms:.3f} ms a forward (CUDA events, median of 5 "
            f"windows of 10) | {smi}")
        del base, x, y, got, want
        torch.cuda.empty_cache()

    # -- the small MLP: 3 steps on the card against the CPU, both losses
    dims = mlp_dims(MLP_SMALL)
    batch = MLP_SMALL[-1]
    worst = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        g = torch.Generator().manual_seed(261)
        base = init_mlp(g, dims, dt, device="cpu")
        x = torch.randn((batch, dims[0]), generator=g).to(dt)
        ys = {"mse": torch.rand((batch, dims[-1]), generator=g),
              "xent": torch.randint(0, dims[-1], (batch,), generator=g,
                                    dtype=torch.int32)}
        for name in ("sgd", "adagrad"):
            for loss, y in ys.items():
                runs = {}
                for where in ("cpu", dev):
                    params = [tuple(t.to(where, copy=True) for t in wb)
                              for wb in base]
                    opt = make_optimizer(name)
                    step, state = make_train_step(opt, loss), opt.init(params)
                    ls = [float(step(params, state, x.to(where),
                                     y.to(where))[2]) for _ in range(3)]
                    runs[str(where)] = (params, ls)
                (cpu_p, cpu_l), (gpu_p, gpu_l) = runs["cpu"], runs[str(dev)]
                err, ulps = 0.0, []
                for i, (a, b) in enumerate(zip(tree_leaves(gpu_p),
                                               tree_leaves(cpu_p))):
                    d = (a.float().cpu() - b.float()).abs()
                    own = b.float().abs().max().item()
                    # f32: each leaf at its own scale; bf16: each leaf at its
                    # layer's (a bias starts at zero and is three updates
                    # made from cancelling bf16 gradient sums)
                    layer = max(t.float().abs().max().item()
                                for t in cpu_p[i // 2])
                    tol = (mlp_param_tol(b, dtype) + 1e-5 * b.float().abs()
                           if dtype == "float32"
                           else mlp_param_tol(b, dtype, layer))
                    if not bool((d <= tol).all()):
                        fail(f"phase 26 make_train_step {MLP_SMALL} {dtype} "
                             f"{name} {loss}: card against CPU, leaf {i} "
                             f"differs by {d.max().item():.3e} (max |leaf| "
                             f"{own:.3e}, its layer's {layer:.3e})")
                    err = max(err, d.max().item())
                    ulps.append(round(d.max().item() / bf16_ulp(own), 2))
                rtol = 1e-5 if dtype == "float32" else 2 ** -6
                if not all(abs(a - b) <= rtol * abs(b)
                           for a, b in zip(gpu_l, cpu_l)):
                    fail(f"phase 26 make_train_step {MLP_SMALL} {dtype} "
                         f"{name} {loss}: losses {gpu_l} on the card, "
                         f"{cpu_l} on the CPU")
                worst[f"{dtype} {name} {loss}"] = err
                rec["small"][f"{dtype} {name} {loss}"] = dict(
                    losses_card=gpu_l, losses_cpu=cpu_l, max_abs_err=err,
                    bf16_ulps_of_own_max=ulps)
                if dtype != "float32":
                    say(f"phase 26 {MLP_SMALL} {dtype} {name} {loss}: card "
                        f"against CPU, each leaf's max abs err in bf16 ulps "
                        f"of its own max |leaf| (W, b per layer): {ulps}")
        got = infer_step([tuple(t.to(dev) for t in wb) for wb in base],
                         x.to(dev)).cpu()
        want = infer_step(base, x)
        d = (got.float() - want.float()).abs().max().item()
        if not d <= mlp_param_tol(want, dtype) + (
                1e-5 * want.float().abs().max().item()):
            fail(f"phase 26 infer_step {MLP_SMALL} {dtype}: card against CPU "
                 f"max abs err {d:.3e}")
        worst[f"{dtype} infer"] = d
    say(f"phase 26 make_train_step {MLP_SMALL}: sgd / adagrad x mse / "
        f"cross-entropy x f32 / bf16, 3 steps on the card against the CPU "
        f"(f32 1e-5 x max|leaf| + rtol 1e-5, bf16 two ulps of the layer's "
        f"max|param|), "
        f"and infer_step: max abs err {worst} | {smi}")
    rec["small_worst"] = worst

    # -- cast_int4_mlp + mlp_forward_int4 at the inference bench's shape
    dims = mlp_dims(MLP_INT4)
    gen = torch.Generator(device=dev).manual_seed(262)
    q = quantize_weights_int4(init_mlp(gen, dims, device=dev))
    xq = torch.rand((MLP_INT4[-1], dims[0]), generator=gen,
                    device=dev).bfloat16()
    cast = cast_int4_mlp(q)
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = mlp_forward_int4(cast, xq)
    torch.cuda.synchronize()
    k5 = {k: v for k, v in kernels.launch_counts.items() if v}
    with torch.no_grad():
        raw = mlp_forward_int4(q, xq)
    layers = MLP_INT4[0]
    if k5.get("int4_gemm") != layers or k5.get("int4_gemm_wgmma") != layers \
            or set(k5) != {"int4_gemm", "int4_gemm_wgmma"} \
            or not torch.equal(out, raw) \
            or not torch.isfinite(out.float()).all():
        fail(f"phase 26 cast_int4_mlp + mlp_forward_int4 {MLP_INT4}: "
             f"launches {k5} (want {layers} int4_gemm, all wgmma), bitwise "
             f"the raw carriers' call {torch.equal(out, raw)}")
    with torch.no_grad():
        ms_cast = time_ms(lambda: mlp_forward_int4(cast, xq), 10, dev, reps=5)
        ms_raw = time_ms(lambda: mlp_forward_int4(q, xq), 10, dev, reps=5)
    rec["int4"] = dict(launches=k5, ms_cast=ms_cast, ms_raw=ms_raw)
    say(f"phase 26 cast_int4_mlp + mlp_forward_int4 {MLP_INT4}: launches "
        f"{k5} ({layers} layers: one K5 a layer, wgmma), output bitwise the "
        f"raw carriers' call | {ms_cast:.3f} ms a forward pre-cast, "
        f"{ms_raw:.3f} ms packing the carriers each call (CUDA events, "
        f"median of 5 windows of 10) | {smi}")
    del q, cast, xq, out, raw
    torch.cuda.empty_cache()

    # -- a param_profile region inside a CUDA torch.profiler session
    gen = torch.Generator(device=dev).manual_seed(263)
    dims = mlp_dims(MLP_SMALL)
    params = init_mlp(gen, dims, device=dev)
    x = torch.rand((MLP_SMALL[-1], dims[0]), generator=gen, device=dev)
    y = torch.rand((MLP_SMALL[-1], dims[-1]), generator=gen, device=dev)
    opt = make_optimizer("sgd")
    step, state = make_train_step(opt), opt.init(params)
    timer = ParamTimer()
    step(params, state, x, y)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with param_profile(timer, "phase26_train_step"):
            step(params, state, x, y)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    dev_us = sum(e.self_device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if "phase26_train_step" not in names or timer.elapsed_ns <= 0 or \
            dev_us <= 0:
        fail(f"phase 26 param_profile: region in the events "
             f"{'phase26_train_step' in names}, host time "
             f"{timer.elapsed_ns} ns, device time {dev_us} us")
    rec["profile"] = dict(host_us=timer.get_us(), device_us=dev_us)
    say(f"phase 26 param_profile('phase26_train_step') around a train step "
        f"in a CUDA torch.profiler session: the region is in its events; "
        f"host {timer.get_us():.1f} us (ParamTimer), device {dev_us:.1f} us "
        f"(profiler) | {smi}")
    rec["k5_launches"] = k5["int4_gemm_wgmma"]
    rec["wall_s"] = time.perf_counter() - t_start
    say(f"phase 26 done in {rec['wall_s']:.1f} s")
    return rec


# Phase 27: port_bench's dlrm-dcnv2-mlperf configuration (the five 40M
# tables capped at 10M rows) and its published bag sizes
DCN_ROWS = [10_000_000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63,
            10_000_000, 3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14,
            10_000_000, 10_000_000, 10_000_000, 590152, 12973, 108, 36]
DCN_SIZES = [3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
             100, 27, 10, 3, 1, 1]


DCN_STEP_ROWS = 1_000_000  # phase 27's step: tables capped to share the card


def dcn_ids(batch: int, gen, dev, rows=DCN_ROWS, flat=True):
    """(batch, 214) int32 ids of the DCN tables of ``rows``: each feature's
    uniform over its table, plus the table's first row in their flat view
    where ``flat`` (as the model's ids are the table's own without)."""
    import torch

    cols, start = [], 0
    for n, size in zip(rows, DCN_SIZES):
        cols.append(torch.randint(0, n, (batch, size), generator=gen,
                                  device=dev, dtype=torch.int32)
                    + (start if flat else 0))
        start += n
    return torch.cat(cols, dim=1)


def dcn_step_launches(gen, dev, smi: str, steps: int = 4) -> dict:
    """Phase 27's main path: ``DlrmModel``'s sparse Adagrad step at the
    DCN cell's widths, bag sizes and batch (tables capped at
    ``DCN_STEP_ROWS`` rows), the launch counts reset just before
    ``steps`` steps and read just after: each step has to launch K1, the
    dedup and K2's Adagrad once, and no other kernel of the port."""
    import torch

    from param_tpu_torch import kernels
    from param_tpu_torch.models.dlrm import DlrmConfig, DlrmModel

    B, rows = 8192, [min(n, DCN_STEP_ROWS) for n in DCN_ROWS]
    cfg = DlrmConfig(emb_dim=128, dense_dim=13, bot_mlp=[512, 256, 128],
                     top_mlp=[1024, 1024, 512, 256, 1], batch=B,
                     arch_interaction="dcn", num_embeddings_per_feature=rows,
                     multi_hot_sizes=DCN_SIZES, dcn_num_layers=3,
                     dcn_low_rank_dim=512)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # f32, as the cell runs
    try:
        model = DlrmModel(cfg, device=dev)
        params = model.init_params(27)
        acc = model.init_adagrad_state(params, 0.0)
        step = model.make_sparse_adagrad_step(0.004, eps=1e-8,
                                              initial_accumulator=0.0)
        batches = [(torch.randn((B, 13), generator=gen, device=dev),
                    dcn_ids(B, gen, dev, rows, flat=False),
                    torch.randint(0, 2, (B,), generator=gen,
                                  device=dev).float()) for _ in range(2)]
        for i in range(2):
            step(params, acc, *batches[i])
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        kernels.reset_launch_counts()
        t0.record()
        losses = [step(params, acc, *batches[i % 2])[2]
                  for i in range(steps)]
        t1.record()
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launch_counts.items() if v}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want = dict.fromkeys(("emb_gather", "dedup_sum",
                          "sparse_update_adagrad"), steps)
    losses = [float(x) for x in losses]
    if launches != want or not all(math.isfinite(x) for x in losses):
        fail(f"phase 27 DCN sparse Adagrad step: {steps} steps launched "
             f"{launches}, want {want}; losses {losses}")
    rec = dict(launches=launches, steps=steps, losses=losses,
               ms_a_step=t0.elapsed_time(t1) / steps, table_rows=sum(rows))
    say(f"phase 27 DCN sparse Adagrad step (DlrmModel, batch {B}, 26 "
        f"per-feature bags, 214 ids a sample, {sum(rows)} table rows of "
        f"128, 3 cross layers of rank 512): counts reset just before "
        f"{steps} steps, then {launches}: K1, the dedup and K2 once a "
        f"step | {rec['ms_a_step']:.3f} ms a step, losses "
        f"{', '.join(f'{x:.5f}' for x in losses)} | {smi}")
    del model, params, acc, batches
    torch.cuda.empty_cache()
    return rec


def multihot_tier(smi: str, iters: int = 50) -> dict:
    """Phase 27: K1 and the dedup over per-feature bags at the DCN cell's
    shape (module docstring)."""
    import torch

    from param_tpu_torch import kernels
    from param_tpu_torch.kernels import bindings
    from param_tpu_torch.kernels.dedup import (
        dedup_sum, dedup_sum_cuda, dedup_sum_plain,
    )
    from param_tpu_torch.kernels.emb_gather import (
        bag_layout, emb_gather, emb_gather_cuda, emb_gather_plain,
        launch_schedule,
    )
    from param_tpu_torch.utils.chip import bound_ms
    from param_tpu_torch.utils.timer import time_samples
    from torch.nn import functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    B, D, T, L = 8192, 128, len(DCN_SIZES), sum(DCN_SIZES)
    R = sum(DCN_ROWS)

    def timed(fn, n, graph=True):
        t = time_samples(fn, n, reps=5, graph=graph)
        return dict(ms=statistics.median(t), min=min(t), max=max(t))

    rec = {}
    table = torch.rand((R, D), generator=gen, device=dev)
    ids = [dcn_ids(B, gen, dev) for _ in range(4)]
    i0 = ids[0]
    before = kernels.launch_counts["emb_gather"]
    got = emb_gather_cuda(table, i0, None, DCN_SIZES)
    again = emb_gather_cuda(table, i0, None, DCN_SIZES)
    launches = kernels.launch_counts["emb_gather"] - before
    want = emb_gather_plain(table, i0, None, DCN_SIZES)
    err = float((got - want).abs().max())
    tol = 1e-5 * float(want.abs().max())
    if not (err <= tol and torch.equal(got.view(torch.int32),
                                       again.view(torch.int32))
            and launches == 2 and got.shape == (B * T, D)):
        fail(f"phase 27 K1 per-feature bags: max abs err {err:.3e} (tol "
             f"{tol:.3e}), launches {launches} for 2 calls, shape "
             f"{tuple(got.shape)}")
    del want
    uniq = int(torch.unique(i0).numel())
    nbytes = uniq * D * 4 + B * L * 4 + B * T * D * 4
    b_ms, b_by = bound_ms(nbytes)
    # the library's one call over the same layout: the flattened ids, a
    # bag starting at each feature's offset in each sample's row
    offsets, _ = bag_layout(DCN_SIZES, dev)
    lib_offsets = (torch.arange(B, device=dev)[:, None] * L
                   + offsets[:-1].long()).reshape(-1)
    lib_ids = [i.reshape(-1).long() for i in ids]
    lib = F.embedding_bag(lib_ids[0], table, lib_offsets, mode="sum")
    lib_err = float((lib - got).abs().max())
    if not lib_err <= tol:
        fail(f"phase 27 F.embedding_bag over the per-feature layout: max "
             f"abs err {lib_err:.3e} against K1 (tol {tol:.3e})")
    del lib
    nk, nl = itertools.cycle(ids), itertools.cycle(lib_ids)
    sched = launch_schedule(table, B * T, -(-L // T), bindings.vec_width(
        D, 4, table, got))._asdict()
    k1 = {"t_kernel": timed(lambda: emb_gather_cuda(table, next(nk), None,
                                                    DCN_SIZES), iters),
          "t_kernel_eager": timed(lambda: emb_gather_cuda(
              table, next(nk), None, DCN_SIZES), iters, graph=False),
          "t_op_eager": timed(lambda: emb_gather(table, next(nk), None,
                                                 DCN_SIZES), iters,
                              graph=False),
          "t_plain": timed(lambda: emb_gather_plain(table, next(nk), None,
                                                    DCN_SIZES), 3,
                           graph=False),
          "t_library": timed(lambda: F.embedding_bag(
              next(nl), table, lib_offsets, mode="sum"), iters)}
    k1.update(ms=k1["t_kernel"]["ms"], plain_ms=k1["t_plain"]["ms"],
              library_ms=k1["t_library"]["ms"], library_max_abs_err=lib_err,
              max_abs_err=err, tol=tol, bound_ms=b_ms, bound_by=b_by,
              unique_rows=uniq, bytes=nbytes, schedule=sched,
              gbps=nbytes / k1["t_kernel"]["ms"] / 1e6,
              shape=f"table ({R}, {D}) float32, {B} samples x {T} bags "
                    f"of {L} ids")
    rec["k1"] = k1
    say(f"phase 27 K1 per-feature bags: {k1['shape']} max_abs_err "
        f"{err:.3e} (tol {tol:.3e}), one launch a call, two launches "
        f"bitwise equal | schedule {sched['warps_per_bag']} warp(s) a bag, "
        f"{sched['rows_in_flight']} row load(s) in flight | kernel "
        f"{k1['t_kernel']['ms']:.4f} ms ({k1['t_kernel']['min']:.4f}-"
        f"{k1['t_kernel']['max']:.4f}) [issued eagerly "
        f"{k1['t_kernel_eager']['ms']:.4f}; through the op, eagerly "
        f"{k1['t_op_eager']['ms']:.4f}] plain {k1['t_plain']['ms']:.4f} "
        f"F.embedding_bag (1-D ids, offsets) {k1['library_ms']:.4f} "
        f"({k1['t_library']['min']:.4f}-{k1['t_library']['max']:.4f}; "
        f"max abs err against K1 {lib_err:.3e}) ({k1['gbps']:.0f} GB/s) "
        f"bound {b_ms:.4f} ms ({b_by}) | {smi}")
    del table, got, again, lib_ids, lib_offsets
    torch.cuda.empty_cache()

    g = torch.randn((B * T, D), generator=gen, device=dev)
    rows, tot = dedup_sum_cuda(i0, g, None, R, DCN_SIZES)
    rows2, tot2 = dedup_sum_cuda(i0, g, None, R, DCN_SIZES)
    same = bool(torch.equal(rows, rows2) and torch.equal(
        tot.view(torch.int32), tot2.view(torch.int32)))
    del rows2, tot2
    want_rows, want = dedup_sum_plain(i0, g, None, R, DCN_SIZES)
    mag = dedup_sum_plain(i0, g.abs(), None, R, DCN_SIZES)[1]
    err = (tot - want).abs_()
    bound = want.abs_().mul_(1e-4).add_(mag, alpha=1e-6)
    worst = float((err - bound).max())
    max_err = float(err.max())
    rows_ok = bool(torch.equal(rows, want_rows))
    tail_zero = not bool(tot[uniq:].any())
    del want, mag, err, bound, want_rows
    if not (same and rows_ok and worst <= 0 and tail_zero):
        fail(f"phase 27 dedup per-feature bags: same bits {same}, rows exact "
             f"{rows_ok}, sums over their bound by {worst:.3e}, zero tail "
             f"{tail_zero}")
    N = B * L
    nbytes = 4 * N + 4 * B * T * D + 4 * N + 4 * N * D
    b_ms, b_by = bound_ms(nbytes)
    nd = itertools.cycle(ids)
    dd = {"t_kernel": timed(lambda: dedup_sum_cuda(next(nd), g, None, R,
                                                   DCN_SIZES), iters),
          "t_kernel_eager": timed(lambda: dedup_sum_cuda(
              next(nd), g, None, R, DCN_SIZES), iters, graph=False),
          "t_op_eager": timed(lambda: dedup_sum(next(nd), g, None, R,
                                                DCN_SIZES), iters,
                              graph=False),
          "t_plain": timed(lambda: dedup_sum_plain(next(nd), g, None, R,
                                                   DCN_SIZES), 3,
                           graph=False)}
    dd.update(ms=dd["t_kernel"]["ms"], plain_ms=dd["t_plain"]["ms"],
              library_ms=None, max_abs_err=max_err, bound_ms=b_ms, bound_by=b_by,
              unique_rows=uniq, bytes=nbytes,
              shape=f"{B} samples x {T} bags of {L} ids over {R} rows of "
                    f"{D} f32, {uniq} distinct")
    rec["dedup"] = dd
    say(f"phase 27 dedup per-feature bags: {dd['shape']} max_abs_err "
        f"{max_err:.3e} (within rtol 1e-4 + 1e-6 x summed magnitudes), rows "
        f"exact, tail zero, two calls bitwise equal | kernel "
        f"{dd['t_kernel']['ms']:.4f} ms ({dd['t_kernel']['min']:.4f}-"
        f"{dd['t_kernel']['max']:.4f}) [issued eagerly "
        f"{dd['t_kernel_eager']['ms']:.4f}; through the op, eagerly "
        f"{dd['t_op_eager']['ms']:.4f}] plain {dd['t_plain']['ms']:.4f} "
        f"bound {b_ms:.4f} ms ({b_by}) | {smi}")
    del g, rows, tot, ids, i0
    torch.cuda.empty_cache()
    rec["step"] = dcn_step_launches(gen, dev, smi)
    return rec


# (B, m, D) of the dot interaction in the cells that run it:
# tb26.sgd.zipf (26 features of 128, batch 32768) and
# rm8x1m.adagrad.uniform (8 of 64, batch 16384); then a wider model, 40
# features of 256 (the forward in two chunks of columns, the backward
# tiled: 41 rows), and one feature past the backward's 32 rows
INTERACTION_CELLS = {"tb26": (32768, 27, 128), "rm8x1m": (16384, 9, 64),
                     "wide": (32768, 41, 256), "m33": (32768, 33, 128)}


def interaction_tier(smi: str, iters: int = 50) -> dict:
    """Phase 28: the dot interaction's kernels (``kernels/interaction.py``)
    at the dot cells' shapes (module docstring)."""
    import torch

    from param_tpu_torch.kernels.interaction import (
        dot_interaction_bwd_cuda, dot_interaction_bwd_plain,
        dot_interaction_cuda, dot_interaction_plain,
    )
    from param_tpu_torch.utils.chip import bound_ms
    from param_tpu_torch.utils.profiler import kernel_times
    from param_tpu_torch.utils.timer import time_samples

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)

    def timed(fn, n, graph=True):
        t = time_samples(fn, n, reps=5, graph=graph)
        return dict(ms=statistics.median(t), min=min(t), max=max(t))

    def fmt(t):
        return f"{t['ms']:.4f} ms ({t['min']:.4f}-{t['max']:.4f})"

    def worst(got, want, mag, terms):
        """Largest excess of |got - want| over 1e-5, or ``terms`` 2^-24
        where more, of the summed magnitudes (tests/test_torch_kernels.py's
        bound), and the largest error."""
        err = (got.double() - want).abs()
        bound = mag * max(1e-5, terms * 2.0 ** -24)
        return (float((err - bound).max().item()), float(err.max().item()))

    out = {}
    for cell, (B, m, D) in INTERACTION_CELLS.items():
        P = m * (m - 1) // 2
        bot = torch.randn((B, D), generator=gen, device=dev) * D ** -0.5
        pooled = torch.randn((B, m - 1, D), generator=gen,
                             device=dev) * D ** -0.5
        grad = torch.randn((B, D + P), generator=gen, device=dev)
        got = dot_interaction_cuda(bot, pooled)
        g_bot, g_pooled = dot_interaction_bwd_cuda(grad, bot, pooled)
        same = (torch.equal(got, dot_interaction_cuda(bot, pooled))
                and all(torch.equal(a, b) for a, b in zip(
                    (g_bot, g_pooled),
                    dot_interaction_bwd_cuda(grad, bot, pooled))))
        b64, p64, g64 = bot.double(), pooled.double(), grad.double()
        over_f, err_f = worst(got[:, D:], dot_interaction_plain(b64, p64)[
            :, D:], dot_interaction_plain(b64.abs(), p64.abs())[:, D:], D)
        copied = torch.equal(got[:, :D], bot)
        want = dot_interaction_bwd_plain(g64, b64, p64)
        mag = dot_interaction_bwd_plain(g64.abs(), b64.abs(), p64.abs())
        res = [worst(a, w, mg, m + 1) for a, w, mg in zip((g_bot, g_pooled),
                                                           want, mag)]
        over_b, err_b = max(r[0] for r in res), max(r[1] for r in res)
        del got, g_bot, g_pooled, b64, p64, g64, want, mag
        torch.cuda.empty_cache()
        if not (same and copied and over_f <= 0 and over_b <= 0):
            fail(f"phase 28 interaction {cell}: same bits on two calls "
                 f"{same}, bottom output copied {copied}, forward / "
                 f"backward over their bounds by {over_f:.3e} / "
                 f"{over_b:.3e}")
        # today's composition: the plain forward with autograd, and its
        # backward (the triangle gather's index backward, two bmm's, the
        # concatenation's slices)
        bt = bot.clone().requires_grad_(True)
        pt = pooled.clone().requires_grad_(True)
        comp = dot_interaction_plain(bt, pt)

        def comp_fwd():
            return dot_interaction_plain(bt, pt)

        def comp_bwd():
            return torch.autograd.grad(comp, (bt, pt), grad,
                                       retain_graph=True)

        shape = (f"bot_out ({B}, {D}), pooled ({B}, {m - 1}, {D}) f32, "
                 f"{P} pairs")
        fwd_bytes = 4 * (B * m * D + B * (D + P))
        bwd_bytes = 4 * (B * (D + P) + 2 * B * m * D)
        recs = {}
        for way, kernel, op, plain, composition, nbytes, flops in (
                ("fwd", lambda: dot_interaction_cuda(bot, pooled),
                 lambda: torch.ops.param_tpu_torch.dot_interaction.default(
                     bot, pooled),
                 lambda: dot_interaction_plain(bot, pooled), comp_fwd,
                 fwd_bytes, 2 * B * P * D),
                ("bwd", lambda: dot_interaction_bwd_cuda(grad, bot, pooled),
                 lambda: torch.ops.param_tpu_torch.dot_interaction_bwd.default(
                     grad, bot, pooled),
                 lambda: dot_interaction_bwd_plain(grad, bot, pooled),
                 comp_bwd, bwd_bytes, 4 * B * P * D)):
            b_ms, b_by = bound_ms(nbytes, flops)
            rec = dict(t_kernel=timed(kernel, iters),
                       t_kernel_eager=timed(kernel, iters, graph=False),
                       t_op_eager=timed(op, iters, graph=False),
                       t_plain=timed(plain, 10, graph=False),
                       t_library=timed(composition, 10, graph=False))
            rec.update(ms=rec["t_kernel"]["ms"], plain_ms=rec["t_plain"]["ms"],
                       library_ms=rec["t_library"]["ms"], bound_ms=b_ms,
                       bound_by=b_by, bytes=nbytes, flops=flops,
                       shape=shape + (" and its gradient" if way == "bwd"
                                      else ""),
                       max_abs_err=err_f if way == "fwd" else err_b,
                       share_of_bound=100.0 * b_ms / rec["t_kernel"]["ms"],
                       composition_kernels=kernel_times(composition)[1])
            recs[way] = rec
            say(f"phase 28 interaction {cell} {way}: {rec['shape']} | "
                f"kernel {fmt(rec['t_kernel'])} [issued eagerly "
                f"{fmt(rec['t_kernel_eager'])}, through the op "
                f"{fmt(rec['t_op_eager'])}] plain {fmt(rec['t_plain'])} "
                f"torch composition (eager) {fmt(rec['t_library'])} | bound "
                f"{b_ms:.4f} ms ({b_by}; {rec['share_of_bound']:.1f}%) | "
                f"max abs err {rec['max_abs_err']:.3e}, two calls bitwise "
                f"equal | composition by kernel " + "; ".join(
                    f"{k} {v['ms']:.4f} ({v['launches']:g})" for k, v in
                    list(rec["composition_kernels"].items())[:6])
                + f" | {smi}")
        out[cell] = recs
        del bot, pooled, grad, bt, pt, comp
        torch.cuda.empty_cache()
    return out


def main(out_path=None) -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        import param_tpu_torch  # noqa: F401
    except ImportError:
        fail(f"param_tpu_torch is not beside {__file__}: run from a checkout")

    import torch.nn.functional as F

    from param_tpu_torch import kernels
    from param_tpu_torch.kernels import bindings, build
    from param_tpu_torch.kernels.emb_gather import (
        emb_gather_cuda, emb_gather_plain, launch_schedule as k1_schedule,
    )
    from param_tpu_torch.kernels.sparse_update import (
        sparse_update_cuda, sparse_update_plain,
    )
    from param_tpu_torch.kernels.dedup import (
        dedup_sum, dedup_sum_cuda, dedup_sum_plain,
    )
    from param_tpu_torch.utils.chip import bound_ms
    from param_tpu_torch.utils.device import require_sm90, resolve_device
    from param_tpu_torch.utils.timer import time_samples

    dev = resolve_device("cuda")
    require_sm90(dev)
    result = {"phases": {}}
    REPS = 5

    def timed(fn, iters, graph=True):
        """Median and spread (ms) over REPS windows of ``iters`` calls."""
        t = time_samples(fn, iters, reps=REPS, graph=graph)
        return dict(ms=statistics.median(t), min=min(t), max=max(t))

    def fmt(t):
        return f"{t['ms']:.4f} ms ({t['min']:.4f}-{t['max']:.4f})"

    def timings(kernel, plain, library, iters, op=None):
        """Kernel (graph and eager), plain (eager) and library (graph);
        with ``op``, the same launch issued eagerly through its registered
        PyTorch op (``torch.ops.param_tpu_torch.*``, as the main path
        calls it) beside the wrapper's own eager time."""
        rec = {"t_kernel": timed(kernel, iters),
               "t_kernel_eager": timed(kernel, iters, graph=False),
               "t_plain": timed(plain, max(3, iters // 5), graph=False),
               "t_library": timed(library, iters) if library else None}
        if op is not None:
            rec["t_op_eager"] = timed(op, iters, graph=False)
        rec.update(ms=rec["t_kernel"]["ms"], plain_ms=rec["t_plain"]["ms"],
                   library_ms=rec["t_library"]["ms"] if library else None)
        return rec

    def timing_text(rec, lib_name):
        lib = (f"{lib_name} {fmt(rec['t_library'])}" if rec["t_library"]
               else "no library call")
        op = (f" [through the op, eagerly {fmt(rec['t_op_eager'])}]"
              if "t_op_eager" in rec else "")
        return (f"kernel {fmt(rec['t_kernel'])} [issued eagerly "
                f"{fmt(rec['t_kernel_eager'])}]{op} plain "
                f"{fmt(rec['t_plain'])} {lib}")

    # ---------------------------------------------------------------- 1
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    build_s = build.build_all()
    resources = {n: build.kernel_resources(n) for n in build.SOURCES}
    reg_counts = {n: [r.get("registers") for r in k.values()]
                  for n, k in resources.items()}
    spills = {n: [r.get("spill_stores") for r in k.values()]
              for n, k in resources.items()}
    say(f"phase 1 device: {kind} | nvidia-smi: {smi} | "
        f"capability {torch.cuda.get_device_capability(0)} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | kernels built in "
        f"{build_s:.1f} s | ptxas registers per kernel {reg_counts} | "
        f"spill-store bytes per kernel {spills}")
    flash_res = {}
    for lib in ("flash_fwd", "flash_bwd"):
        for mangled, res in resources[lib].items():
            m = re.search(r"flash_(?:fwd|bwd_dq|bwd_dkv)_(?:wgmma|tc|tf32x3)",
                          mangled)
            dims = re.search(r"Li(\d+)E", mangled)
            dt = ("bf16" if "bfloat16" in mangled else
                  "f16" if "__half" in mangled else "f32")
            label = (f"{m.group(0) if m else mangled}<{dt}, "
                     f"D={dims.group(1) if dims else '?'}>")
            flash_res[label] = res
    say("phase 1 K6 / K7 kernels (ptxas; wgmma kernels at launch, before "
        "setmaxnreg): " + "; ".join(
            f"{label} {r.get('registers')} registers, "
            f"{r.get('spill_stores')} / {r.get('spill_loads')} bytes spilled "
            f"(stores / loads)" for label, r in sorted(flash_res.items())))
    result["phases"]["device"] = dict(smi=smi, kind=kind, build_s=build_s,
                                      registers=reg_counts, spills=spills,
                                      flash_kernels=flash_res)

    gen = torch.Generator(device=dev).manual_seed(0)
    T, E, D, B, NNZ = 8, 100_000, 64, 2048, 10  # the CLI's default width

    def main_path_ids():
        """(B*T, NNZ) bags over the flat (T*E, D) table, as the trainer's
        lookup forms them."""
        per_table = torch.randint(0, E, (B, T, NNZ), generator=gen,
                                  device=dev, dtype=torch.int32)
        offs = (torch.arange(T, device=dev, dtype=torch.int32) * E)
        return (per_table + offs[None, :, None]).reshape(B * T, NNZ)

    # ---------------------------------------------------------------- 2 + 4
    k1 = {}

    def k1_case(name, table, idx_list, rtol, iters, phase="2/4", op=False):
        i0 = idx_list[0]
        got = emb_gather_cuda(table, i0)
        again = emb_gather_cuda(table, i0)
        want = emb_gather_plain(table, i0).float()
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"K1 {name}: non-finite output")
        err = (got.float() - want).abs().max().item()
        tol = rtol * want.abs().max().item()
        if not err <= tol:
            fail(f"K1 {name}: max abs err {err:.3e} > tolerance {tol:.3e}")
        bits = torch.int16 if table.element_size() == 2 else torch.int32
        if not torch.equal(got.view(bits), again.view(bits)):
            fail(f"K1 {name}: two launches on the same ids differ")
        nb, nnz = i0.shape
        dim, es = table.shape[1], table.element_size()
        sched = k1_schedule(table, nb, nnz, bindings.vec_width(
            dim, es, table, got))._asdict()
        uniq = torch.unique(i0).numel()  # shifts are bijections: same count
        nbytes = uniq * dim * es + nb * nnz * 4 + nb * dim * es
        b_ms, b_by = bound_ms(nbytes, nb * nnz * dim)
        n_k, n_p = itertools.cycle(idx_list), itertools.cycle(idx_list)
        n_l = itertools.cycle([i.long() for i in idx_list])
        n_o = itertools.cycle(idx_list)
        k1_op = torch.ops.param_tpu_torch.emb_gather.default
        rec = timings(lambda: emb_gather_cuda(table, next(n_k)),
                      lambda: emb_gather_plain(table, next(n_p)),
                      lambda: F.embedding_bag(next(n_l), table, mode="sum"),
                      iters,
                      (lambda: k1_op(table, next(n_o), None)) if op else None)
        rec.update(shape=f"table {tuple(table.shape)} {str(table.dtype)[6:]}, "
                         f"{nb} bags x {nnz}", max_abs_err=err, tol=tol,
                   bound_ms=b_ms, bound_by=b_by, unique_rows=uniq,
                   bytes=nbytes, gbps=nbytes / rec["ms"] / 1e6,
                   schedule=sched)
        k1[name] = rec
        say(f"phase {phase} K1 {name}: {rec['shape']} max_abs_err {err:.3e} "
            f"(tol {tol:.3e}), two launches bitwise equal | schedule "
            f"{sched['warps_per_bag']} warp(s) a bag, "
            f"{sched['rows_in_flight']} row load(s) in flight a lane group, "
            f"{sched['lanes_per_row']} lanes a row, {sched['blocks']} blocks "
            f"| {timing_text(rec, 'F.embedding_bag')} "
            f"({rec['gbps']:.0f} GB/s) bound {b_ms:.4f} ms ({b_by}) | {smi}")

    RH, DH, BH, NH = 1_000_000, 128, 8192, 30  # bench.py's headline shape
    head = torch.rand((RH, DH), generator=gen, device=dev)
    base = torch.randint(0, RH, (BH, NH), generator=gen, device=dev,
                         dtype=torch.int32)
    k1_case("headline_f32", head,
            [((base + s) % RH).to(torch.int32) for s in range(8)], 1e-5, 50)
    del head, base
    flat = torch.randn((T * E, D), generator=gen, device=dev) / math.sqrt(E)
    ids = [main_path_ids() for _ in range(8)]
    k1_case("dlrm_f32", flat, ids, 1e-5, 100, op=True)
    k1_case("dlrm_bf16", flat.to(torch.bfloat16), ids, 8e-3, 100, op=True)
    result["phases"]["k1"] = k1

    # ---------------------------------------------------------------- 3 + 4
    dedup = {}

    def dedup_case(name, ids, g, scale, R, iters):
        """The dedup kernel against its plain version on the same (M, nnz)
        ids and pooled gradient ``g`` (module docstring), then timed;
        returns its (rows, totals)."""
        rows, tot = dedup_sum_cuda(ids, g, scale, R)
        rows2, tot2 = dedup_sum_cuda(ids, g, scale, R)
        same_bits = bool(torch.equal(rows, rows2) and torch.equal(
            tot.view(torch.int32), tot2.view(torch.int32)))
        del rows2, tot2
        want_rows, want = dedup_sum_plain(ids, g, scale, R)
        u = int((want_rows != R).sum().item())
        rows_ok = bool(torch.equal(rows, want_rows))
        del want_rows
        mag = dedup_sum_plain(ids, g.abs(), None if scale is None
                              else abs(scale), R)[1]
        err = (tot - want).abs_()
        bound = want.abs_().mul_(1e-4).add_(mag, alpha=1e-6)
        del want, mag
        worst = float((err - bound).max().item())
        max_err = float(err.max().item())
        del err, bound
        tail_zero = not bool(tot[u:].any().item())
        if not (same_bits and rows_ok and worst <= 0 and tail_zero):
            fail(f"dedup {name}: same bits on two calls {same_bits}, rows "
                 f"exact {rows_ok}, sums over their bound by {worst:.3e}, "
                 f"zero tail {tail_zero}")
        M, nnz = ids.shape
        N, dim = M * nnz, g.shape[1]
        nbytes = 4 * N + 4 * M * dim + 4 * N + 4 * N * dim
        b_ms, b_by = bound_ms(nbytes)
        rec = timings(lambda: dedup_sum_cuda(ids, g, scale, R),
                      lambda: dedup_sum_plain(ids, g, scale, R), None, iters,
                      lambda: dedup_sum(ids, g, scale, R))
        rec.update(shape=f"{M} bags x {nnz} ids over {R} rows of {dim} f32, "
                         f"scale {scale}, {u} distinct",
                   max_abs_err=max_err, bound_ms=b_ms, bound_by=b_by,
                   bytes=nbytes, gbps=nbytes / rec["ms"] / 1e6,
                   unique_rows=u)
        dedup[name] = rec
        say(f"phase 3/4 dedup {name}: {rec['shape']} max_abs_err "
            f"{max_err:.3e} (within rtol 1e-4 + 1e-6 x summed magnitudes), "
            f"rows exact, tail zero, two calls bitwise equal | "
            f"{timing_text(rec, '')} ({rec['gbps']:.0f} GB/s) bound "
            f"{b_ms:.4f} ms ({b_by}) | {smi}")
        return rows, tot

    R = T * E
    g_pooled = torch.randn((B * T, D), generator=gen, device=dev) * 1e-3
    rows, totals = dedup_case("dlrm_f32", main_path_ids(), g_pooled, None,
                              R, 100)
    n_valid = int((rows < R).sum().item())
    valid_rows = rows[:n_valid].long()
    lr, eps = 0.01, 1e-7
    k2 = {}
    for mode in ("adagrad", "sgd"):
        upd = totals if mode == "adagrad" else -lr * totals
        t_k, t_p = flat.clone(), flat.clone()
        a_k = torch.full_like(flat, 0.1) if mode == "adagrad" else None
        a_p = a_k.clone() if a_k is not None else None
        sparse_update_cuda(t_k, rows, upd, a_k, lr=lr, eps=eps)
        sparse_update_plain(t_p, rows, upd, a_p, lr=lr, eps=eps)
        torch.cuda.synchronize()
        err = (t_k - t_p).abs().max().item()
        tol = 1e-5 * t_p.abs().max().item()
        if a_k is not None:
            err = max(err, (a_k - a_p).abs().max().item())
            tol = max(tol, 1e-5 * a_p.abs().max().item())
        changed = (t_k[valid_rows] != flat[valid_rows]).any(-1).float().mean()
        if not err <= tol or changed.item() < 0.99:
            fail(f"K2 {mode}: max abs err {err:.3e} (tol {tol:.3e}), "
                 f"share of rows changed {changed.item():.3f}")
        row_transfers = 5 if mode == "adagrad" else 3  # u, T (and A) in; T (A) out
        nbytes = rows.numel() * 4 + n_valid * D * 4 * row_transfers
        b_ms, b_by = bound_ms(nbytes, n_valid * D * (6 if mode == "adagrad"
                                                      else 1))
        vt = upd[:n_valid]
        k2_op = torch.ops.param_tpu_torch.sparse_update.default
        rec = timings(
            lambda: sparse_update_cuda(t_k, rows, upd, a_k, lr=lr, eps=eps),
            lambda: sparse_update_plain(t_p, rows, upd, a_p, lr=lr, eps=eps),
            (lambda: t_p.index_add_(0, valid_rows, vt)) if mode == "sgd"
            else None, 100,
            lambda: k2_op(t_k, rows, upd, a_k, lr, eps))
        rec.update(shape=f"table ({R}, {D}) f32, {rows.numel()} slots, "
                         f"{n_valid} valid", max_abs_err=err, tol=tol,
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                   gbps=nbytes / rec["ms"] / 1e6)
        k2[mode] = rec
        say(f"phase 3/4 K2 {mode}: {rec['shape']} max_abs_err {err:.3e} "
            f"(tol {tol:.3e}) | {timing_text(rec, 'index_add_')} "
            f"({rec['gbps']:.0f} GB/s) bound {b_ms:.4f} ms ({b_by}) | {smi}")
        del t_k, t_p, a_k, a_p
    result["phases"]["k2"] = k2
    del flat, ids, g_pooled, rows, totals, valid_rows
    torch.cuda.empty_cache()
    for name, TT, EE, BB, nnz, DD, kind, scale in DEDUP_CASES:
        ids = dedup_case_ids(TT, EE, BB, nnz, kind).to(dev)
        g = torch.randn((BB * TT, DD), generator=gen, device=dev)
        dedup_case(name, ids, g, scale, TT * EE, 5 if nnz > 1 else 20)
        del ids, g
        torch.cuda.empty_cache()
    by_kernel = dedup_profile()
    for name, kernels_ms in by_kernel.items():
        dedup[name]["by_kernel"] = kernels_ms
        say(f"phase 3 dedup {name}: device ms a call by kernel (launches a "
            f"call) " + "; ".join(
                f"{k} {v['ms']:.4f} ({v['launches']:g})"
                for k, v in kernels_ms.items()))
    result["phases"]["dedup"] = dedup

    # ---------------------------------------------------------------- 5
    from param_tpu_torch.models.dlrm import DlrmConfig, DlrmModel
    from param_tpu_torch.models.dlrm_data import RandomDataset
    from param_tpu_torch.ops.mlp import tree_map

    small = dict(num_tables=4, rows_per_table=1000, emb_dim=32, nnz=6,
                 dense_dim=16, bot_mlp=[64, 32], top_mlp=[64, 1], batch=256)
    cpu_m = DlrmModel(DlrmConfig(**small), device="cpu")
    gpu_m = DlrmModel(DlrmConfig(**small), device="cuda")
    batch = next(iter(RandomDataset(batch=256, dense_dim=16, num_tables=4,
                                    nnz=6, num_rows=1000, num_batches=1,
                                    seed=3)))
    worst = 0.0
    for opt in ("forward", "sparse_sgd", "sparse_adagrad"):
        p_c = cpu_m.init_params(0)
        p_g = tree_map(lambda t: t.detach().to(dev).requires_grad_(True), p_c)
        b_c, b_g = cpu_m.place_batch(batch), gpu_m.place_batch(batch)
        if opt == "forward":
            with torch.no_grad():
                outs = [(cpu_m.forward(p_c, *b_c[:2]),
                         gpu_m.forward(p_g, *b_g[:2]))]
        elif opt == "sparse_sgd":
            cpu_m.make_sparse_sgd_step(0.05)(p_c, *b_c)
            gpu_m.make_sparse_sgd_step(0.05)(p_g, *b_g)
            outs = [(p_c["tables"], p_g["tables"])]
        else:
            a_c, a_g = cpu_m.init_adagrad_state(p_c), gpu_m.init_adagrad_state(p_g)
            cpu_m.make_sparse_adagrad_step(0.05)(p_c, a_c, *b_c)
            gpu_m.make_sparse_adagrad_step(0.05)(p_g, a_g, *b_g)
            outs = [(p_c["tables"], p_g["tables"]),
                    (a_c["tables"], a_g["tables"])]
        for want, got in outs:
            want, got = want.detach(), got.detach().cpu()
            err = (want - got).abs().max().item()
            tol = 1e-4 * want.abs().max().item() + 1e-6
            worst = max(worst, err)
            if not err <= tol:
                fail(f"model parity {opt}: card vs CPU max abs err "
                     f"{err:.3e} > {tol:.3e}")
    say(f"phase 5 model parity: small DLRM logits and one sparse_sgd / "
        f"sparse_adagrad step on the card match the CPU plain path, max abs "
        f"err {worst:.3e} (tol 1e-4 x max|value| + 1e-6)")
    result["phases"]["model_parity_max_abs_err"] = worst

    # ---------------------------------------------------------------- 6
    from param_tpu_torch.cli import dlrm as cli

    runs = {}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for opt in ("sparse_adagrad", "sparse_sgd", "adagrad"):
        before = dict(kernels.launch_counts)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--train-batches", "5", "--optimizer", opt,
                           "--device", "cuda"])
        wall = time.perf_counter() - t0
        out = buf.getvalue()
        losses = [float(x) for x in re.findall(r"loss (\S+)", out)]
        e2e = [ln for ln in out.splitlines() if ln.startswith("DLRM-E2E")]
        if rc != 0 or len(losses) != 5 or not e2e:
            fail(f"trainer {opt}: rc {rc}, output:\n{out}")
        if not all(math.isfinite(x) for x in losses):
            fail(f"trainer {opt}: non-finite loss {losses}")
        delta = {k: kernels.launch_counts[k] - before[k] for k in before}
        if delta["emb_gather"] <= 0:
            fail(f"trainer {opt}: K1 was not launched ({delta})")
        if opt.startswith("sparse") and (
                delta[f"sparse_update_{opt[len('sparse_'):]}"] <= 0
                or delta["dedup_sum"] <= 0):
            fail(f"trainer {opt}: K2 / the dedup not launched ({delta})")
        fields = dict(re.findall(r"(\w[\w-]*)=(\S+)", e2e[0]))
        runs[opt] = dict(losses=losses, launches=delta, wall_s=wall,
                         step_ms=float(fields["step_ms"]),
                         qps=float(fields["QPS"]), auc=fields["AUC"])
        say(f"phase 6 trainer {opt}: full width (8 x 100000 x 64, batch "
            f"2048, nnz 10), 5 steps, losses {[round(x, 5) for x in losses]} "
            f"| steady step {runs[opt]['step_ms']:.3f} ms, QPS "
            f"{runs[opt]['qps']:.0f} | launches {delta} | {smi}")
    launches = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"phase 6 main path launches {launches}, peak device memory "
        f"{peak_gb:.2f} GB")
    result["phases"]["trainer"] = runs
    result["launches"] = launches
    result["peak_memory_gb"] = peak_gb

    # ---------------------------------------------------------------- 7
    from param_tpu_torch.kernels.gemm import (
        gemm_cuda, gemm_plain, gemm_schedule, gemm_wres_cuda, gemm_wres_plain,
    )
    from param_tpu_torch.kernels.int4_gemm import (
        int4_dequant, int4_gemm_cuda, int4_gemm_plain,
    )

    gemm_tol = gemm_tolerance

    def check(name, got, want, tol):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"{name}: shape {tuple(got.shape)} (want "
                 f"{tuple(want.shape)}) or non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        if not err <= tol:
            fail(f"{name}: max abs err {err:.3e} > tolerance {tol:.3e}")
        return err

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def with_path(fn):
        """fn() and the 16-bit path whose launch counter it moved (simt when
        neither moved)."""
        keys = ("gemm_wgmma", "gemm_mma_sync")
        before = [kernels.launch_counts[k] for k in keys]
        out = fn()
        moved = [k[5:] for k, b0 in zip(keys, before)
                 if kernels.launch_counts[k] != b0]
        return out, moved[0] if moved else "simt"

    k3 = {}
    for dt, shapes in ((torch.bfloat16, [(1024, 4096, 4096), (4096, 4096, 128),
                                         (128, 1024, 1024), (1024, 1024, 128),
                                         (100, 100, 100)]),
                       (torch.float16, [(1024, 4096, 4096)]),
                       (torch.float32, [(1024, 4096, 4096), (4096, 4096, 128),
                                        (128, 1024, 1024), (1024, 1024, 4096),
                                        (100, 100, 100)])):
        for m, n, k in shapes:
            a = torch.randn((m, k), generator=gen, device=dev).to(dt)
            b = torch.randn((k, n), generator=gen, device=dev).to(dt)
            want = gemm_plain(a, b)
            name = f"{str(dt)[6:]} {(m, n, k)}"
            got, path = with_path(lambda: gemm_cuda(a, b))
            err = check(f"K3 {name}", got, want, gemm_tol(want))
            vec = 16 // a.element_size()
            aligned = k % vec == 0 and n % vec == 0
            splits = gemm_schedule(m, n, k, dt, aligned, sms)[2]
            if dt != torch.float32 and aligned and path != "wgmma":
                fail(f"K3 {name}: an aligned 16-bit shape ran {path}, not "
                     f"wgmma")
            es = a.element_size()
            b_ms, b_by = bound_ms((m * k + k * n + m * n) * es, 2 * m * n * k,
                                  fp32=dt == torch.float32)
            rec = timings(lambda: gemm_cuda(a, b), lambda: gemm_plain(a, b),
                          lambda: torch.matmul(a, b), 20)
            rec.update(shape=f"({m}, {k}) @ ({k}, {n}) {str(dt)[6:]}",
                       max_abs_err=err, tol=gemm_tol(want), bound_ms=b_ms,
                       bound_by=b_by, tflops=2 * m * n * k / rec["ms"] / 1e9,
                       path=path, splits=splits)
            if name == "bfloat16 (1024, 4096, 4096)":
                # planted fault: negate B's largest element after the plain
                # call; the kernel's output must then break the tolerance
                flat = b.view(-1)
                i = int(flat.abs().argmax())
                flat[i] = -flat[i]
                bad, _ = with_path(lambda: gemm_cuda(a, b))
                torch.cuda.synchronize()
                flat[i] = -flat[i]
                fault = (bad.float() - want.float()).abs().max().item()
                if not fault > rec["tol"]:
                    fail(f"K3 {name}: the planted fault (B element {i} "
                         f"negated) was not flagged: err {fault:.3e} <= tol "
                         f"{rec['tol']:.3e}")
                rec["fault_err"] = fault
                say(f"phase 7 K3 {name} planted fault (B element {i} "
                    f"negated): max_abs_err {fault:.3e} > tol "
                    f"{rec['tol']:.3e}, flagged")
                del bad
            k3[name] = rec
            say(f"phase 7 K3 {rec['shape']}: path {path}, {splits} K "
                f"split(s) | max_abs_err {err:.3e} (tol "
                f"{rec['tol']:.3e}) | {timing_text(rec, 'torch.matmul')} "
                f"({rec['tflops']:.1f} TF/s) bound {b_ms:.4f} ms ({b_by}) | "
                f"{smi}")
            del a, b, want, got
    result["phases"]["k3"] = k3

    # ---------------------------------------------------------------- 8
    S, m, k, n = 8, 128, 4096, 4096
    a = torch.randn((S, m, k), generator=gen, device=dev).bfloat16()
    b = torch.randn((k, n), generator=gen, device=dev).bfloat16()
    want = gemm_wres_plain(a, b)
    got, path = with_path(lambda: gemm_wres_cuda(a, b))
    err = check("K4", got, want, gemm_tol(want))
    if path != "wgmma":
        fail(f"K4: the stacked bf16 GEMM ran {path}, not wgmma")
    a2 = a.reshape(S * m, k)
    b_ms, b_by = bound_ms((S * m * k + k * n + S * m * n) * 2,
                          S * 2 * m * n * k, fp32=False)
    k4 = timings(lambda: gemm_wres_cuda(a, b), lambda: gemm_wres_plain(a, b),
                 lambda: torch.matmul(a2, b), 20)
    k4.update(shape=f"S={S} x ({m}, {k}) @ ({k}, {n}) bf16", max_abs_err=err,
              tol=gemm_tol(want), bound_ms=b_ms, bound_by=b_by,
              per_gemm_ms=k4["ms"] / S,
              tflops=S * 2 * m * n * k / k4["ms"] / 1e9, path=path,
              splits=gemm_schedule(S * m, n, k, torch.bfloat16, True, sms)[2])
    say(f"phase 8 K4 {k4['shape']}: path {path}, {k4['splits']} K split(s) "
        f"| max_abs_err {err:.3e} (tol "
        f"{k4['tol']:.3e}) | {timing_text(k4, 'torch.matmul (stacked A)')} "
        f"| per GEMM {k4['per_gemm_ms']:.4f} ms ({k4['tflops']:.1f} TF/s) "
        f"bound {b_ms:.4f} ms ({b_by}) | {smi}")
    result["phases"]["k4"] = k4
    del a, b, a2, want, got

    # ---------------------------------------------------------------- 9
    import param_tpu_torch.kernels.int4_gemm as k5mod
    from torch.autograd import DeviceType

    k5 = {}
    G = 128
    k5_res = build.kernel_resources("int4_gemm")
    # the bf16-output kernel(s) of each K5 path, as ptxas names them
    K5_KERNELS = {"stream": r"st18int4_stream_kernelI13__nv_bfloat16",
                  "stream wgmma": r"int4_stream_wgmma_kernelILi(16|32)E13",
                  "wgmma": r"wq17int4_wgmma_kernelI13__nv_bfloat16",
                  "mma_sync": r"int4_mma_kernelILb1E|splitk_reduce_kernelI13"}

    def k5_resources(path, m):
        key = "stream wgmma" if path == "stream" and m > 8 else path
        out = {}
        for name, res in k5_res.items():
            if re.search(K5_KERNELS[key], name):
                label = re.search(r"int4_(stream_wgmma|stream|wgmma|mma)"
                                  r"_kernel|splitk_reduce_kernel",
                                  name).group(0)
                rows = re.search(r"kernelILi(\d+)E", name)
                out[label + (f"<{rows.group(1)}>" if rows else "")] = res
        return out

    def profiled_kernels(run):
        """Kernel ms per call of ``run`` from torch.profiler (10 calls after
        3 warm-ups), and its largest kernels."""
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                run()
            torch.cuda.synchronize()
        by_name = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                    ev.self_device_time_total / 1e3 / 10
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        return dict(ms=sum(by_name.values()),
                    kernels=[f"{nm[:60]} {ms:.4f} ms" for nm, ms in top])

    def k5_path(x, packed, scale):
        """The path (and K splits) K5 takes for these tensors."""
        (m, k), (kh, n) = x.shape, packed.shape
        aligned = (n % 16 == 0 and k % 8 == 0 and x.data_ptr() % 16 == 0
                   and packed.data_ptr() % 16 == 0
                   and scale.data_ptr() % 16 == 0)
        return k5mod.int4_schedule(m, n, kh, kh // scale.shape[0], aligned,
                                   sms)

    def int4pack_library(x, packed, scale, want):
        """torch._weight_int4pack_mm on K5's weights: signed nibble q as
        the unsigned q + 8 with zero point 0, (K/g, N, 2) bf16 scales and
        zeros.  Returns (callable, note), or (None, why not) where the call
        refuses the shape or does not compute the same function."""
        k, n = 2 * packed.shape[0], packed.shape[1]
        p = packed.to(torch.int32)
        q = torch.empty((k, n), dtype=torch.int32, device=dev)
        q[0::2] = (p & 15) - 8
        q[1::2] = p >> 4
        u = (q + 8).t().contiguous()  # (N, K) in [0, 15]
        w8 = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8)
        sz = torch.stack([scale, torch.zeros_like(scale)], dim=2) \
            .to(torch.bfloat16).contiguous()
        try:
            wp = torch._convert_weight_to_int4pack(w8, 8)
            got = torch._weight_int4pack_mm(x, wp, G, sz)
            torch.cuda.synchronize()
        except RuntimeError as e:  # the yardstick refuses; K5 is unaffected
            return None, f"none: torch._weight_int4pack_mm refused ({e})"[:200]
        err = (got.float() - want).abs().max().item()
        if not err <= 1e-2 * want.abs().max().item():
            return None, (f"none: torch._weight_int4pack_mm differs by "
                          f"{err:.3e}")
        return (lambda: torch._weight_int4pack_mm(x, wp, G, sz),
                "torch._weight_int4pack_mm")

    def k5_case(m, k, n, phase, fault=False):
        x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        packed = torch.randint(-128, 128, (k // 2, n), generator=gen,
                               device=dev, dtype=torch.int32).to(torch.int8)
        # bf16-exact scales, so the library call's bf16 scales are K5's
        scale = (torch.rand((k // G, n), generator=gen, device=dev)
                 * 0.02).bfloat16().float()
        want = int4_gemm_plain(x, packed, scale, torch.float32)
        tol = 1e-5 * want.abs().max().item()
        # the bf16-output kernels (the main path's) against the plain
        # version rounded to bf16: one bf16 ulp of max |want|
        want16 = int4_gemm_plain(x, packed, scale)
        tol16 = 2.0 ** -7 * want.abs().max().item()
        path, _, splits = k5_path(x, packed, scale)
        if m <= 32 and path != "stream" or m == 512 and path != "wgmma":
            fail(f"K5 {(m, k, n)}: took {path}, not its designed path")

        def held(label, run):
            """The f32- and bf16-output kernels of ``run``'s path against
            the plain version, each twice (bitwise repeat); returns the
            f32 error and the bf16 one, and the counters that moved."""
            before = dict(kernels.launch_counts)
            got, again = run(torch.float32), run(torch.float32)
            got16, again16 = run(torch.bfloat16), run(torch.bfloat16)
            moved = {c: v - before[c] for c, v in
                     kernels.launch_counts.items() if v != before[c]}
            err = check(f"K5 {(m, k, n)} {label}", got, want, tol)
            err16 = check(f"K5 {(m, k, n)} {label} bf16 out", got16, want16,
                          tol16)
            if not (torch.equal(got, again) and torch.equal(got16, again16)):
                fail(f"K5 {(m, k, n)} ({label}): two runs differ")
            return err, err16, moved

        err, err16, moved = held(
            path, lambda od: int4_gemm_cuda(x, packed, scale, od))
        if moved != {"int4_gemm": 4, f"int4_gemm_{path}": 4}:
            fail(f"K5 {(m, k, n)}: launches moved {moved}, not 4 on {path}")
        # the parent's design (mma_sync + its reduce kernel), still the
        # path of unaligned products, held to the same tolerances
        with k5mod.forced_path("mma_sync"):
            err_p, err16_p, moved_p = held(
                "mma_sync", lambda od: int4_gemm_cuda(x, packed, scale, od))
        if moved_p != {"int4_gemm": 4, "int4_gemm_mma_sync": 4}:
            fail(f"K5 {(m, k, n)}: the mma_sync design moved {moved_p}, "
                 f"not 4 launches on mma_sync")
        nbytes = k * n // 2 + (k // G) * n * 4 + m * k * 2 + m * n * 2
        b_ms, b_by = bound_ms(nbytes, 2 * m * n * k, fp32=False)
        w_bf16 = int4_dequant(packed, scale).bfloat16()
        lib, lib_note = int4pack_library(x, packed, scale, want)
        iters = 50 if m <= 32 else 10
        kernel = lambda: int4_gemm_cuda(x, packed, scale)  # noqa: E731
        rec = timings(kernel, lambda: int4_gemm_plain(x, packed, scale), lib,
                      iters)
        rec["library_note"] = lib_note
        rec["dequant_matmul"] = timed(lambda: torch.matmul(x, w_bf16), 50)
        prof = profiled_kernels(kernel)
        # the parent's design in this run
        with k5mod.forced_path("mma_sync"):
            rec["t_parent"] = timed(kernel, iters)
            rec["t_parent_eager"] = timed(kernel, iters, graph=False)
            prof_parent = profiled_kernels(kernel)
        rec.update(shape=f"({m}, {k}) @ int4 ({k}, {n}) g={G}, bf16 out",
                   max_abs_err=err, tol=tol, max_abs_err_bf16=err16,
                   tol_bf16=tol16, parent_max_abs_err=err_p,
                   parent_max_abs_err_bf16=err16_p, bound_ms=b_ms,
                   bound_by=b_by, gbps=nbytes / rec["ms"] / 1e6, path=path,
                   splits=splits, parent_ms=rec["t_parent"]["ms"],
                   profile=prof, profile_parent=prof_parent,
                   bitwise_repeat=True, ptxas=k5_resources(path, m))
        if fault:
            # planted fault: change one packed byte (the pair of rows with
            # the largest |x|) after the plain call; the kernel's output
            # must then break the tolerance
            i = int((x[0, 0::2].float().abs() + x[0, 1::2].float().abs())
                    .argmax())
            packed[i, 0] ^= 0x77
            bad = int4_gemm_cuda(x, packed, scale, torch.float32)
            torch.cuda.synchronize()
            packed[i, 0] ^= 0x77
            fault_err = (bad - want).abs().max().item()
            if not fault_err > tol:
                fail(f"K5 {(m, k, n)}: the planted fault (packed byte ({i}, "
                     f"0) changed) was not flagged: err {fault_err:.3e} <= "
                     f"tol {tol:.3e}")
            rec["fault_err"] = fault_err
            say(f"phase {phase} K5 {rec['shape']} planted fault (packed byte "
                f"({i}, 0) changed): max_abs_err {fault_err:.3e} > tol "
                f"{tol:.3e}, flagged")
        k5[f"{(m, k, n)}"] = rec
        say(f"phase {phase} K5 {rec['shape']}: path {path}, {splits} K "
            f"split(s), bitwise repeatable | max_abs_err {err:.3e} (tol "
            f"{tol:.3e}), bf16 out {err16:.3e} (tol {tol16:.3e}); mma_sync "
            f"design {err_p:.3e}, bf16 out {err16_p:.3e}, bitwise repeatable "
            f"| {timing_text(rec, lib_note)}"
            f"{'' if lib else f' ({lib_note})'} "
            f"({rec['gbps']:.0f} GB/s) bound {b_ms:.4f} ms ({b_by}) | "
            f"parent design (mma_sync + reduce) {fmt(rec['t_parent'])} "
            f"[issued eagerly {fmt(rec['t_parent_eager'])}] | profiler: "
            f"{'; '.join(prof['kernels'])} (parent: "
            f"{'; '.join(prof_parent['kernels'])}) | ptxas "
            + "; ".join(f"{nm} {r.get('registers')} registers, "
                        f"{r.get('spill_stores')} / {r.get('spill_loads')} "
                        f"bytes spilled" for nm, r in rec["ptxas"].items())
            + f" | not the same function: torch.matmul on the dequantized "
            f"bf16 weight {fmt(rec['dequant_matmul'])} | {smi}")

    for m, k, n in [(mm, kk, nn) for mm in (1, 8, 32)
                    for kk, nn in ((4096, 11008), (11008, 4096))] + \
            [(512, 4096, 4096)]:
        k5_case(m, k, n, 9, fault=(m, k, n) in ((1, 4096, 11008),
                                                (512, 4096, 4096)))
    result["phases"]["k5"] = k5
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 10
    from param_tpu_torch.cli import compute as compute_cli
    from param_tpu_torch.cli import inference as inference_cli
    from param_tpu_torch.ops.inference import (
        mlp_forward_int4, pack_int4_mlp, quantize_weights_int4,
    )
    from param_tpu_torch.ops.mlp import init_mlp

    def drive(label, cli_main, argv, table_rows, must, phase=10):
        """Run a CLI (median of 5 timed windows) with the counts reset just
        before and read just after; its table must have ``table_rows`` rows
        of finite numbers and every kernel of ``must`` must have launched."""
        kernels.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv + ["--reps", "5", "--device", "cuda"])
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in kernels.launch_counts.items() if v}
        out = buf.getvalue()
        rows = [ln for ln in out.splitlines()
                if re.match(r"\s*(gemm|emb|mlp|mlp_infer|att:\w+|decode|"
                            r"decode-gqa|serve|serve-\w+|tf-fwd:\w+|"
                            r"att-grad:\w+|tf:\w+)\s+\(",
                            ln)
                or re.match(r"\s*\d+\s+\d+\s+\d+\s+(torch|K3)\s", ln)]
        nums = [float(x) for ln in rows
                for x in re.findall(r"\s(-?[\d.]+(?:e[+-]?\d+)?)%?(?=\s|$)",
                                    ln.split(")")[-1])]
        if rc != 0 or len(rows) != table_rows or not nums or \
                not all(math.isfinite(v) for v in nums):
            fail(f"phase {phase} {label}: rc {rc}, {len(rows)} result rows "
                 f"(want {table_rows}), output:\n{out}")
        missing = [k for k in must if counts.get(k, 0) <= 0]
        if missing:
            fail(f"phase {phase} {label}: {missing} not launched ({counts})")
        say(f"phase {phase} {label}: {' '.join(argv)} | {wall:.1f} s | launches "
            f"{counts} | {smi}\n{out.rstrip()}")
        return dict(argv=argv, launches=counts, wall_s=wall, output=out)

    cli_runs = {
        "gemm_A_bf16_K3": drive(
            "gemm A bf16 K3", compute_cli.main,
            ["gemm", "--dataset", "A", "--dtype", "bfloat16", "--pallas"],
            15, ["gemm_bf16", "gemm_wgmma"]),
        "gemm_C_compare": drive(
            "gemm C compare", compute_cli.main,
            ["gemm", "--dataset", "C", "--compare"], 8, ["gemm_f32"]),
        "gemm_wres_K4": drive(
            "gemm weight-resident K4", compute_cli.main,
            ["gemm", "--weight-resident", "8", "--shape", "128,4096,4096",
             "--dtype", "bfloat16"], 1, ["gemm_wres", "gemm_wgmma"]),
        "emb_baseline_K1": drive(
            "emb baseline K1", compute_cli.main,
            ["emb", "--dataset", "baseline"], 1, ["emb_gather"]),
        "emb_trainer_bf16_K1": drive(
            "emb at the trainer's width, bf16 K1", compute_cli.main,
            ["emb", "--shape", "800000,64,10,16384", "--dtype", "bfloat16"],
            1, ["emb_gather"]),
        "linear": drive(
            "linear", compute_cli.main,
            ["linear", "--shape", "18,1024,1024,1024,512"], 1, []),
        "inference_int4_K5": drive(
            "inference int4 K5", inference_cli.main,
            ["--shape", "18,4096,4096,4096,512", "--dtype", "int4"], 1,
            ["int4_gemm"]),
    }
    # the rungs beside it (cuBLAS, no kernel of the port), and serving
    # batch 1, for the int4-against-int8 comparison
    for dtype, batch in (("int8", 512), ("bfloat16", 512), ("int4", 1),
                         ("int8", 1)):
        cli_runs[f"inference_{dtype}_b{batch}"] = drive(
            f"inference {dtype} batch {batch}", inference_cli.main,
            ["--shape", f"18,4096,4096,4096,{batch}", "--dtype", dtype], 1,
            ["int4_gemm"] if dtype == "int4" else [])
    n_inf = cli_runs["inference_int4_K5"]["launches"]
    if n_inf["int4_gemm"] % 18 or \
            n_inf.get("int4_gemm_wgmma", 0) != n_inf["int4_gemm"]:
        fail(f"phase 10: the int4 bench's K5 launches are not 18 per forward "
             f"on the wgmma path ({n_inf})")

    # one full-width int4 forward: exactly 18 K5 launches
    qp = pack_int4_mlp(quantize_weights_int4(init_mlp(
        torch.Generator(device=dev).manual_seed(0), [4096] * 19, device=dev)))
    xq = torch.rand((512, 4096), generator=gen, device=dev).bfloat16()
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = mlp_forward_int4(qp, xq)
    torch.cuda.synchronize()
    if kernels.launch_counts["int4_gemm"] != 18 or \
            kernels.launch_counts["int4_gemm_wgmma"] != 18 or \
            out.shape != (512, 4096) or not torch.isfinite(out.float()).all():
        fail(f"phase 10: one int4 forward launched K5 "
             f"{kernels.launch_counts['int4_gemm']} times, "
             f"{kernels.launch_counts['int4_gemm_wgmma']} on wgmma (want 18 "
             f"and 18), output {tuple(out.shape)}")
    del qp, xq, out
    # a small int4 MLP on the card (M 5 and 96: both K5 schedules) against
    # the CPU plain path; each layer's output is rounded to bf16 on both
    cpu_p = init_mlp(torch.Generator().manual_seed(1), [256, 512, 256, 128],
                     device="cpu")
    q_cpu = pack_int4_mlp(quantize_weights_int4(cpu_p))
    q_gpu = [tuple(t.to(dev) for t in layer) for layer in q_cpu]
    worst = 0.0
    for mm in (5, 96):
        xs = torch.rand((mm, 256), generator=torch.Generator().manual_seed(mm))
        want = mlp_forward_int4(q_cpu, xs.bfloat16()).float()
        got = mlp_forward_int4(q_gpu, xs.bfloat16().to(dev)).float().cpu()
        err = (got - want).abs().max().item()
        tol = 2e-2 * want.abs().max().item()
        worst = max(worst, err)
        if not err <= tol:
            fail(f"phase 10: int4 MLP card vs CPU (M={mm}) max abs err "
                 f"{err:.3e} > {tol:.3e}")
    say(f"phase 10 int4 forward: 18 K5 launches per full-width forward, all "
        f"on the wgmma path; "
        f"small int4 MLP card vs CPU max abs err {worst:.3e} (tol 2e-2 x "
        f"max|out|, one bf16 rounding per layer) | {smi}")
    result["phases"]["cli"] = cli_runs
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 11
    from param_tpu_torch.kernels.flash_fwd import (
        PATHS as FLASH_PATHS, attention_keep_mask, flash_fwd_cuda,
        flash_fwd_plain, flash_fwd_tolerance, flash_schedule, tma_takes,
    )

    def flash_path(kernel, fn, views):
        """fn() and the path of ``kernel`` whose launch counter it moved;
        fails unless that is the path flash_schedule gives ``views`` and,
        for dense 16-bit views at D 64 / 128, unless it is wgmma."""
        before = {p: kernels.launch_counts[f"{kernel}_{p}"]
                  for p in FLASH_PATHS}
        out = fn()
        moved = [p for p in FLASH_PATHS
                 if kernels.launch_counts[f"{kernel}_{p}"] != before[p]]
        q = views[0]
        want = flash_schedule(q.dtype, q.shape[-1],
                              all(tma_takes(t) for t in views))
        if moved != [want] or (q.dtype != torch.float32
                               and q.shape[-1] in (64, 128)
                               and want != "wgmma"):
            fail(f"{kernel}: ran {moved}, the schedule says {want}")
        return out, want

    def kept_pairs(sq, sk, causal, window):
        """(row, column) pairs the mask keeps: the work this run needs."""
        keep = attention_keep_mask(sq, sk, causal, window, "cpu")
        return sq * sk if keep is None else int(keep.sum())

    k6 = {}

    def check_k6(name, got, want, tol):
        """Every element within its own bound (``flash_fwd_tolerance``) and,
        for bf16 / f16, the largest error within 2e-2 as well; returns the
        largest error and the largest ratio of error to bound."""
        err = check(f"K6 {name}", got, want, 2e-2)
        ratio = ((got.float() - want.float()).abs() / tol).max().item()
        if not ratio <= 1.0:
            fail(f"K6 {name}: an element's error is {ratio:.3f} x its bound")
        return err, ratio

    def planted_fault(q, k, v, want, tol):
        """K6 with each row's diagonal kv entry dropped (row r attends
        0..r-1, the fault of an off-by-one in the diagonal tile), held to
        the bounds of the right output on the rows r >= S/2, where one
        kv entry of ~S moves O least."""
        bad = flash_fwd_cuda(q[:, :, 1:], k[:, :, :-1], v[:, :, :-1], True)
        late = slice(q.shape[2] // 2 - 1, None)
        diff = (bad[:, :, late].float()
                - want[:, :, 1:][:, :, late].float()).abs()
        over = int((diff > tol[:, :, 1:][:, :, late]).sum())
        rec = dict(elements=diff.numel(), over_bound=over,
                   over_flat=int((diff > 2e-2).sum()),
                   max_abs_err=diff.max().item())
        if over == 0:
            fail(f"K6 tolerance: a dropped diagonal kv entry is not flagged "
                 f"({rec})")
        return rec

    def k6_case(name, b, h, hkv, sq, sk, d, causal, window, dt, iters,
                fault=False):
        q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dt)
        k = torch.randn((b, hkv, sk, d), generator=gen, device=dev).to(dt)
        v = torch.randn((b, hkv, sk, d), generator=gen, device=dev).to(dt)
        (got, lse), path = flash_path(
            "flash_fwd",
            lambda: flash_fwd_cuda(q, k, v, causal, None, window, True),
            (q, k, v))
        want, want_lse = flash_fwd_plain(q, k, v, causal, None, window, True)
        tol = flash_fwd_tolerance(q, k, v, want, causal, None, window)
        err, ratio = check_k6(name, got, want, tol)
        lse_err = check(f"K6 {name} lse", lse, want_lse, 1e-4)
        fault_rec = planted_fault(q, k, v, want, tol) if fault else None
        del got, want, lse, want_lse, tol
        keep = attention_keep_mask(sq, sk, causal, window, dev)
        if window is not None or (causal and sq != sk):
            # SDPA's is_causal aligns top-left: give it the mask itself
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=keep, enable_gqa=hkv != h)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal, enable_gqa=hkv != h)
        rec = timings(lambda: flash_fwd_cuda(q, k, v, causal, None, window),
                      lambda: flash_fwd_plain(q, k, v, causal, None, window),
                      lib, iters)
        flops = 4 * b * h * d * kept_pairs(sq, sk, causal, window)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        b_ms, b_by = bound_ms(nbytes, flops, fp32=dt == torch.float32,
                              split_tf32=True)
        shape = (f"q ({b}, {h}, {sq}, {d}) k/v ({b}, {hkv}, {sk}, {d}) "
                 f"{str(dt)[6:]}{' causal' if causal else ''}"
                 f"{f' window {window}' if window else ''}")
        rec.update(shape=shape, max_abs_err=err, err_over_bound=ratio,
                   lse_err=lse_err, bound_ms=b_ms, bound_by=b_by, flops=flops,
                   bytes=nbytes, tflops=flops / rec["ms"] / 1e9,
                   planted_fault=fault_rec, path=path)
        k6[name] = rec
        bound_text = ("2e-5" if dt == torch.float32 else
                      "u (2|O| + |P||V|) per element, and 2e-2")
        say(f"phase 11 K6 {name}: {shape} | path {path} | max_abs_err "
            f"{err:.3e}, largest "
            f"error / bound {ratio:.3f} (bound {bound_text}), lse "
            f"{lse_err:.3e} (tol 1e-4) | "
            f"{timing_text(rec, 'F.scaled_dot_product_attention')} "
            f"({rec['tflops']:.1f} TF/s) bound {b_ms:.4f} ms ({b_by}) | {smi}")
        if fault_rec:
            say(f"phase 11 K6 {name} planted fault (diagonal kv entry "
                f"dropped), rows >= S/2: {fault_rec['over_bound']} of "
                f"{fault_rec['elements']} elements over their bound, "
                f"{fault_rec['over_flat']} over a flat 2e-2, max abs "
                f"err {fault_rec['max_abs_err']:.3e}")
        del q, k, v, keep

    bf16, f32 = torch.bfloat16, torch.float32
    k6_case("llama2_causal", 1, 32, 32, 2048, 2048, 128, True, None, bf16, 20,
            fault=True)
    k6_case("gpt2", 8, 12, 12, 1024, 1024, 64, False, None, bf16, 20)
    k6_case("gqa_causal", 1, 32, 8, 2048, 2048, 128, True, None, bf16, 20)
    k6_case("window_512", 1, 32, 32, 2048, 2048, 128, True, 512, bf16, 20)
    k6_case("rect_causal", 1, 32, 32, 128, 2048, 128, True, None, bf16, 20)
    # f32 (the tf32x3 path) at the attention CLIs' widths, and small
    k6_case("f32_llama2_causal", 1, 32, 32, 2048, 2048, 128, True, None, f32,
            10, fault=True)
    k6_case("f32_gpt2", 8, 12, 12, 1024, 1024, 64, False, None, f32, 10)
    k6_case("f32", 1, 4, 4, 512, 512, 64, True, None, f32, 20)
    k6_case("ragged_1000", 1, 4, 4, 1000, 1000, 128, True, None, bf16, 20)
    result["phases"]["k6"] = k6
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 12
    from param_tpu_torch.models import transformer as tfm

    def to_dev(params):
        return {key: (tuple(t.to(dev) if isinstance(t, torch.Tensor) else t
                            for t in val) if isinstance(val, tuple)
                      else val.to(dev)) for key, val in params.items()}

    def block_cfg(dtype, kv_heads, seq, attention="flash"):
        return tfm.TransformerConfig(batch=2, seq=seq, emb=512, heads=8,
                                     ffn=1024, attention=attention,
                                     dtype=dtype, kv_heads=kv_heads)

    parity = {}
    for dtype, kv_heads in (("float32", None), ("float32", 2),
                            ("bfloat16", None)):
        cfg = block_cfg(dtype, kv_heads, 192)
        p_cpu = tfm.init_params(torch.Generator().manual_seed(2), cfg, "cpu")
        x_cpu = (torch.randn((2, 192, 512),
                             generator=torch.Generator().manual_seed(3))
                 * 0.1).to(p_cpu["w1"].dtype)
        p_gpu, x_gpu = to_dev(p_cpu), x_cpu.to(dev)
        tol_rel = 1e-4 if dtype == "float32" else 2e-2
        kernels.reset_launch_counts()
        with torch.no_grad():
            outs = [("block_apply", tfm.block_apply(p_cpu, x_cpu, cfg),
                     tfm.block_apply(p_gpu, x_gpu, cfg))]
            pre = block_cfg(dtype, kv_heads, 160)
            o_c, c_c = tfm.prefill(p_cpu, x_cpu[:, :160], pre, 192)
            o_g, c_g = tfm.prefill(p_gpu, x_gpu[:, :160], pre, 192)
            outs.append(("prefill", o_c, o_g))
            step_cfg = block_cfg(dtype, kv_heads, 1)
            for t in range(160, 164):
                o_c, c_c = tfm.decode_step(p_cpu, c_c, x_cpu[:, t:t + 1], t,
                                           step_cfg, window=64)
                o_g, c_g = tfm.decode_step(p_gpu, c_g, x_gpu[:, t:t + 1], t,
                                           step_cfg, window=64)
                outs.append((f"decode_step {t}", o_c, o_g))
            if dtype == "float32":  # the int4 decode step: K5 on the card
                q4_c = tfm.cast_int4_params(
                    tfm.quantize_block_weights_int4(p_cpu))
                q4_g = to_dev(q4_c)
                outs.append(("int4 decode_step",
                             tfm.decode_step(q4_c, c_c, x_cpu[:, 164:165],
                                             164, step_cfg)[0],
                             tfm.decode_step(q4_g, c_g, x_gpu[:, 164:165],
                                             164, step_cfg)[0]))
        counts = {k: v for k, v in kernels.launch_counts.items() if v}
        if counts.get("flash_fwd", 0) != 2:
            fail(f"phase 12 {dtype} kv_heads {kv_heads}: K6 launches "
                 f"{counts} (want 2: block_apply and prefill)")
        worst = 0.0
        for label, want, got in outs:
            want, got = want.float(), got.float().cpu()
            err = (want - got).abs().max().item()
            tol = tol_rel * want.abs().max().item()
            worst = max(worst, err / want.abs().max().item())
            if not torch.isfinite(got).all() or not err <= tol:
                fail(f"phase 12 {dtype} kv_heads {kv_heads} {label}: card vs "
                     f"CPU max abs err {err:.3e} > {tol:.3e}")
        parity[f"{dtype}_kv{kv_heads}"] = dict(worst_rel_err=worst,
                                               launches=counts)
        say(f"phase 12 model parity {dtype} kv_heads {kv_heads}: block_apply "
            f"(flash), prefill, 4 windowed decode_steps"
            f"{', an int4 decode_step' if dtype == 'float32' else ''} on the "
            f"card vs the CPU: worst err {worst:.3e} x max|out| (tol "
            f"{tol_rel:.0e}) | launches {counts}")
    result["phases"]["transformer_parity"] = parity

    # ---------------------------------------------------------------- 13
    LLAMA2 = (4096, 32, 11008)  # emb, heads, ffn
    # the serve path's QKV and output projections at batch 1, 8 and 32
    # (phase 9 has its FFN projections)
    for mm in (1, 8, 32):
        k5_case(mm, 4096, 12288, 13)
        k5_case(mm, 4096, 4096, 13)
    serve_runs = {
        "attention_llama2": drive(
            "attention llama2", compute_cli.main,
            ["attention", "--dataset", "llama2", "--paths", "xla,flash,dpa"],
            9, ["flash_fwd"], 13),
        "transformer_llama2": drive(
            "transformer llama2 fwd", compute_cli.main,
            ["transformer", "--dataset", "llama2", "--fwd-only", "--paths",
             "flash,xla"], 2, ["flash_fwd"], 13),
        # f32 attention (K6's tf32x3 path) at both datasets' widths
        "attention_llama2_f32": drive(
            "attention llama2 f32", compute_cli.main,
            ["attention", "--dataset", "llama2", "--dtype", "float32",
             "--paths", "flash,dpa"], 6, ["flash_fwd_tf32x3"], 13),
        "attention_gpt2_f32": drive(
            "attention gpt2 f32", compute_cli.main,
            ["attention", "--dataset", "gpt2", "--dtype", "float32",
             "--paths", "flash,dpa"], 6, ["flash_fwd_tf32x3"], 13),
        "decode_llama3_gqa": drive(
            "decode llama3-gqa", compute_cli.main,
            ["decode", "--dataset", "llama3-gqa"], 3, [], 13),
        "serve_llama2_bf16": drive(
            "serve llama2 bf16", compute_cli.main,
            ["serve", "--dataset", "llama2"], 3, [], 13),
        "serve_llama2_int4": drive(
            "serve llama2 int4", compute_cli.main,
            ["serve", "--dataset", "llama2", "--dtype", "int4"], 3,
            ["int4_gemm"], 13),
    }
    # 3 shapes x 16 calls x (1 untimed + 5 timed windows) x 4 projections
    n_serve = serve_runs["serve_llama2_int4"]["launches"]["int4_gemm"]
    n_stream = serve_runs["serve_llama2_int4"]["launches"].get(
        "int4_gemm_stream", 0)
    if n_serve != 3 * 16 * 6 * 4 or n_stream != n_serve:
        fail(f"phase 13: serve int4 launched K5 {n_serve} times, {n_stream} "
             f"on the stream path, not 4 per decode step, all streamed "
             f"({3 * 16 * 6 * 4})")
    # one full-width int4 decode step: exactly 4 K5 launches
    e, h, ff = LLAMA2
    cfg = tfm.TransformerConfig(batch=1, seq=1, emb=e, heads=h, ffn=ff,
                                attention="xla")
    p4 = tfm.cast_int4_params(tfm.quantize_block_weights_int4(
        tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)))
    shape = (1, h, 2048, e // h)
    cache = {"k": torch.randn(shape, generator=gen, device=dev).bfloat16(),
             "v": torch.randn(shape, generator=gen, device=dev).bfloat16()}
    x1 = (torch.randn((1, 1, e), generator=gen, device=dev) * 0.1).bfloat16()
    kernels.reset_launch_counts()
    with torch.no_grad():
        out, _ = tfm.decode_step(p4, cache, x1, 2046, cfg)
    torch.cuda.synchronize()
    if kernels.launch_counts["int4_gemm"] != 4 or \
            kernels.launch_counts["int4_gemm_stream"] != 4 or \
            out.shape != (1, 1, e) or not torch.isfinite(out.float()).all():
        fail(f"phase 13: one int4 decode step launched K5 "
             f"{kernels.launch_counts['int4_gemm']} times, "
             f"{kernels.launch_counts['int4_gemm_stream']} on the stream path "
             f"(want 4 and 4)")
    say(f"phase 13 int4 decode step: 4 K5 launches, all on the stream path, "
        f"per full-width llama2 "
        f"decode step; the serve bench launched K5 {n_serve} times for "
        f"{3 * 16 * 6} steps | {smi}")
    del p4, cache, x1, out
    result["phases"]["serve_cli"] = serve_runs

    def breakdown(label, fn, n=20, grad=False, phase=13):
        """Host-clock ms per call (unprofiled, synchronised), and the
        card's kernel time per call from torch.profiler with its top
        kernels: how far the host holds the card back.  ``grad`` runs
        ``fn`` with autograd on (a train step)."""
        with contextlib.nullcontext() if grad else torch.no_grad():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
        by_name = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                    ev.self_device_time_total / 1e3 / n
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        say(f"phase {phase} breakdown {label}: {wall:.4f} ms per call (host "
            f"clock), kernels {busy:.4f} ms ({100 * busy / wall:.1f}% of it) "
            f"| top kernels per call: "
            + "; ".join(f"{name[:70]} {ms:.4f} ms" for name, ms in top)
            + f" | {smi}")
        return dict(wall_ms=wall, device_ms=busy, top=top, by_name=by_name)

    rows = {}
    for path in ("flash", "xla"):
        cfg = tfm.TransformerConfig(batch=1, seq=2048, emb=e, heads=h,
                                    ffn=ff, attention=path)
        p_bf = tfm.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, dev)
        x = (torch.randn((1, 2048, e), generator=gen, device=dev)
             * 0.1).bfloat16()
        rows[f"tf_fwd_{path}"] = breakdown(
            f"transformer fwd {path} (1, 2048, 4096, 32, 11008) bf16",
            lambda: tfm.block_apply(p_bf, x, cfg), 10)
    cfg = tfm.TransformerConfig(batch=1, seq=1, emb=e, heads=h, ffn=ff,
                                attention="xla")
    p_int4 = tfm.cast_int4_params(tfm.quantize_block_weights_int4(p_bf))
    for b in (1, 32):
        shape = (b, h, 2048, e // h)
        cache = {"k": torch.randn(shape, generator=gen, device=dev).bfloat16(),
                 "v": torch.randn(shape, generator=gen, device=dev).bfloat16()}
        x1 = (torch.randn((b, 1, e), generator=gen, device=dev)
              * 0.1).bfloat16()
        for name, params in (("bf16", p_bf), ("int4", p_int4)):
            rows[f"serve_{name}_b{b}"] = breakdown(
                f"serve decode_step {name} batch {b} (cache 2048, llama2)",
                lambda: tfm.decode_step(params, cache, x1, 2046, cfg))
        # the int4 step with K5 on the parent's design, in this run
        with k5mod.forced_path("mma_sync"):
            rows[f"serve_int4_b{b}_parent_k5"] = breakdown(
                f"serve decode_step int4 batch {b}, K5 on the parent's design "
                f"(mma_sync + reduce)",
                lambda: tfm.decode_step(p_int4, cache, x1, 2046, cfg))
        del cache, x1
    del p_bf, p_int4, x
    result["phases"]["breakdown"] = rows

    # ---------------------------------------------------------------- 14
    from param_tpu_torch.kernels.flash_bwd import (
        flash_bwd_cuda, flash_bwd_plain, flash_bwd_tolerance,
    )

    k7 = {}
    aten = torch.ops.aten

    def check_k7(name, got, want, tols):
        """Every element of dq, dk and dv within its own bound; returns the
        largest error and the largest ratio of error to bound."""
        torch.cuda.synchronize()
        err = ratio = 0.0
        for label, g, w, t in zip(("dq", "dk", "dv"), got, want, tols):
            if g.shape != w.shape or not torch.isfinite(g.float()).all():
                fail(f"K7 {name} {label}: shape {tuple(g.shape)} (want "
                     f"{tuple(w.shape)}) or non-finite output")
            diff = (g.float() - w.float()).abs()
            err = max(err, diff.max().item())
            ratio = max(ratio, (diff / t).max().item())
        if not ratio <= 1.0:
            fail(f"K7 {name}: an element's error is {ratio:.3f} x its bound")
        return err, ratio

    def k7_fault(q, k, v, o, lse, do, want, tols):
        """K7 with each row's diagonal kv entry dropped (row r attends
        0..r-1, the true lse kept): elements of dq, dk and dv over the
        bounds of the right gradients."""
        bad = flash_bwd_cuda(q[:, :, 1:], k[:, :, :-1], v[:, :, :-1],
                             o[:, :, 1:], lse[:, :, 1:].contiguous(),
                             do[:, :, 1:], True)
        rec = {}
        for i, (label, cut) in enumerate((("dq", slice(1, None)),
                                          ("dk", slice(None, -1)),
                                          ("dv", slice(None, -1)))):
            diff = (bad[i].float() - want[i][:, :, cut].float()).abs()
            rec[label] = int((diff > tols[i][:, :, cut]).sum())
        rec["elements"] = bad[0].numel()
        if min(rec["dq"], rec["dk"], rec["dv"]) == 0:
            fail(f"K7 tolerance: a dropped diagonal kv entry is not flagged "
                 f"in every gradient ({rec})")
        return rec

    def sdpa_backward_kernels(q, k, v, do, causal):
        """SDPA's backward through autograd (enable_gqa when H_kv < H), the
        library call where no graph-timed aten backward takes the inputs:
        kernel ms per call from torch.profiler, and its largest kernels
        (which name the backend PyTorch picked)."""
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = F.scaled_dot_product_attention(
            *leaves, is_causal=causal, enable_gqa=k.shape[1] != q.shape[1])
        return profiled_kernels(lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True))

    def k7_case(name, b, h, hkv, sq, sk, d, causal, dt, iters, fault=False,
                no_library=None, fused=False, repeat=False,
                sdpa_autograd=False):
        """``fused``: q, k, v are the strided head views of one (b, s,
        (h + 2 hkv) d) projection and dO the transposed-head view of a
        (b, s, h d) gradient, as the train step hands them to K7.
        ``repeat``: a second run must give bitwise-equal gradients.
        ``sdpa_autograd``: the library column is SDPA's backward through
        autograd (``sdpa_backward_kernels``)."""
        if fused:
            y = torch.randn((b, sq, (h + 2 * hkv) * d), generator=gen,
                            device=dev).to(dt)
            cfg = tfm.TransformerConfig(batch=b, seq=sq, emb=h * d, heads=h,
                                        ffn=1, kv_heads=hkv)
            q, k, v = tfm._split_heads(y, cfg, b, sq)
            do = torch.randn((b, sq, h * d), generator=gen,
                             device=dev).to(dt).reshape(b, sq, h, d)
            do = do.transpose(1, 2)
            if any(t.is_contiguous() for t in (q, k, v, do)):
                fail(f"K7 {name}: an input is not a strided view")
        else:
            q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dt)
            k = torch.randn((b, hkv, sk, d), generator=gen, device=dev).to(dt)
            v = torch.randn((b, hkv, sk, d), generator=gen, device=dev).to(dt)
            do = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dt)
        o, lse = flash_fwd_cuda(q, k, v, causal, None, None, True)  # K6
        ins = (q, k, v, o, lse, do)
        got, path = flash_path("flash_bwd",
                               lambda: flash_bwd_cuda(*ins, causal),
                               (q, k, v, o, do))
        want = flash_bwd_plain(*ins, causal)
        tols = flash_bwd_tolerance(*ins, want, causal)
        err, ratio = check_k7(name, got, want, tols)
        fault_rec = k7_fault(*ins, want, tols) if fault else None
        if repeat:
            again = flash_bwd_cuda(*ins, causal)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"K7 {name}: two runs on the same inputs differ")
            del again
        del got, want, tols
        torch.cuda.empty_cache()
        autograd_lib = None
        if sdpa_autograd:
            autograd_lib = sdpa_backward_kernels(q, k, v, do, causal)
            lib, no_library = None, "no graph-timed call"
        elif no_library is None:
            # SDPA's flash backward on SDPA's own forward residuals
            res = aten._scaled_dot_product_flash_attention(q, k, v, 0.0,
                                                           causal, False)
            out, lse_lib, cq, ck, mq, mk, seed, off, _ = res
            lib = lambda: aten._scaled_dot_product_flash_attention_backward(  # noqa: E731
                do, q, k, v, out, lse_lib, cq, ck, mq, mk, 0.0, causal, seed,
                off)
        else:
            lib = None
        rec = timings(lambda: flash_bwd_cuda(*ins, causal),
                      lambda: flash_bwd_plain(*ins, causal), lib, iters)
        if autograd_lib is not None:
            rec["library_ms"] = autograd_lib["ms"]
            rec["library_kernels"] = autograd_lib["kernels"]
            # the kernel timed the library's way too, for a like-for-like
            # ratio
            rec["profiled_ms"] = profiled_kernels(
                lambda: flash_bwd_cuda(*ins, causal))["ms"]
        flops = 10 * b * h * d * kept_pairs(sq, sk, causal, None)
        nbytes = ((2 * (q.numel() + k.numel() + v.numel()) + o.numel()
                   + do.numel()) * q.element_size() + lse.numel() * 4)
        b_ms, b_by = bound_ms(nbytes, flops, fp32=dt == torch.float32,
                              split_tf32=True)
        shape = (f"q ({b}, {h}, {sq}, {d}) k/v ({b}, {hkv}, {sk}, {d}) "
                 f"{str(dt)[6:]}{' causal' if causal else ''}"
                 f"{' strided (fused qkv, transposed dO)' if fused else ''}")
        rec.update(shape=shape, max_abs_err=err, err_over_bound=ratio,
                   bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
                   tflops=flops / rec["ms"] / 1e9, planted_fault=fault_rec,
                   no_library=no_library, path=path)
        k7[name] = rec
        bound_text = ("2^-14 (|X| + m) + 1e-6" if dt == torch.float32 else
                      "u (2|X| + m) per element")
        lib_text = ("aten._scaled_dot_product_flash_attention_backward"
                    if lib else f"none ({no_library})")
        text = timing_text(rec, lib_text)
        if autograd_lib is not None:
            text += (f"; library: SDPA's backward through autograd "
                     f"(enable_gqa={hkv != h}) {autograd_lib['ms']:.4f} ms of "
                     f"kernel time a call (torch.profiler), largest kernels "
                     f"{autograd_lib['kernels']}; K7 timed the same way "
                     f"{rec['profiled_ms']:.4f} ms")
        say(f"phase 14 K7 {name}: {shape} | path {path} | max_abs_err "
            f"{err:.3e} over dq, dk, dv, largest error / bound {ratio:.3f} "
            f"(bound {bound_text}) | {text} ({rec['tflops']:.1f} TF/s) bound "
            f"{b_ms:.4f} ms ({b_by}) | {smi}")
        if fault_rec:
            say(f"phase 14 K7 {name} planted fault (diagonal kv entry "
                f"dropped): elements over their bound dq {fault_rec['dq']}, "
                f"dk {fault_rec['dk']}, dv {fault_rec['dv']} of "
                f"{fault_rec['elements']} each")
        del q, k, v, do, o, lse, ins
        torch.cuda.empty_cache()

    k7_case("llama2_causal", 1, 32, 32, 2048, 2048, 128, True, bf16, 20,
            fault=True, repeat=True)
    # the train step's layout, and the other two ATTN_LLAMA2 shapes of
    # attention --dataset llama2 --grad
    k7_case("llama2_fused", 1, 32, 32, 2048, 2048, 128, True, bf16, 20,
            fused=True)
    k7_case("llama2_s4096", 1, 32, 32, 4096, 4096, 128, True, bf16, 10)
    k7_case("llama2_b4", 4, 32, 32, 2048, 2048, 128, True, bf16, 10)
    k7_case("gpt2", 8, 12, 12, 1024, 1024, 64, False, bf16, 20)
    k7_case("gqa_causal", 1, 32, 8, 2048, 2048, 128, True, bf16, 20,
            sdpa_autograd=True)
    k7_case("rect_causal", 1, 32, 32, 128, 2048, 128, True, bf16, 20,
            no_library="SDPA's causal mask aligns top-left, the reference's "
                       "bottom-right for S_q < S_k")
    k7_case("f32_llama2_causal", 1, 32, 32, 2048, 2048, 128, True, f32, 10,
            fault=True, repeat=True, sdpa_autograd=True)
    k7_case("f32_gpt2", 8, 12, 12, 1024, 1024, 64, False, f32, 10,
            sdpa_autograd=True)
    k7_case("f32", 1, 4, 4, 512, 512, 64, True, f32, 20, sdpa_autograd=True)
    k7_case("ragged_1000", 1, 4, 4, 1000, 1000, 128, True, bf16, 20)
    k7_case("d32", 4, 16, 16, 1024, 1024, 32, True, bf16, 20)
    result["phases"]["k7"] = k7

    # ---------------------------------------------------------------- 15
    def bf16_ulp(x):
        return torch.exp2(torch.floor(torch.log2(
            x.abs().clamp_min(2.0 ** -126))) - 7)

    train_parity = {}
    for dtype, kv_heads in (("float32", None), ("float32", 2),
                            ("bfloat16", None)):
        cfg = block_cfg(dtype, kv_heads, 192)
        lr = 0.1 if dtype == "float32" else 1.0
        p_cpu = tfm.init_params(torch.Generator().manual_seed(4), cfg, "cpu")
        x_cpu = (torch.randn((2, 192, 512),
                             generator=torch.Generator().manual_seed(5))
                 * 0.1).to(p_cpu["w1"].dtype)
        p_gpu, x_gpu = to_dev(p_cpu), x_cpu.to(dev)
        step = tfm.make_train_step(cfg, lr=lr)
        p0 = tfm.leaves(p_cpu)
        worst_loss = worst_param = 0.0
        for t in range(2):
            p_cpu, l_cpu = step(p_cpu, x_cpu)
            kernels.reset_launch_counts()
            p_gpu, l_gpu = step(p_gpu, x_gpu)
            torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts.items() if v}
            if counts.get("flash_fwd") != 1 or counts.get("flash_bwd") != 1:
                fail(f"phase 15 {dtype} kv_heads {kv_heads} step {t}: "
                     f"launches {counts} (want K6 once and K7 once)")
            rel = abs(l_gpu.item() - l_cpu.item()) / l_cpu.item()
            worst_loss = max(worst_loss, rel)
            if not rel <= (1e-5 if dtype == "float32" else 2e-3):
                fail(f"phase 15 {dtype} kv_heads {kv_heads} step {t}: loss "
                     f"card {l_gpu.item()} CPU {l_cpu.item()}")
        for got, want, before in zip(tfm.leaves(p_gpu), tfm.leaves(p_cpu),
                                     p0):
            got, want = got.float().cpu(), want.float()
            diff = (got - want).abs()
            if dtype == "float32":
                tol = 1e-5 * want.abs().max().item() + 1e-7
            else:
                # two bf16 ulps (each step's rounding of the update may
                # flip), plus 5e-2 of the largest update: the card's K6 / K7
                # round P and dS to bf16 where the CPU's plain versions
                # do not, and its GEMMs sum in another order
                tol = 2 * bf16_ulp(torch.maximum(got.abs(), want.abs())) + \
                    5e-2 * (want - before.float()).abs().max().item()
            ratio = (diff / tol).max().item()
            worst_param = max(worst_param, ratio)
            if not ratio <= 1.0 or not torch.isfinite(got).all():
                fail(f"phase 15 {dtype} kv_heads {kv_heads}: a parameter "
                     f"after two steps is {ratio:.3f} x its bound from the "
                     f"CPU's")
        train_parity[f"{dtype}_kv{kv_heads}"] = dict(
            worst_loss_rel=worst_loss, worst_param_over_bound=worst_param)
        say(f"phase 15 train-step parity {dtype} kv_heads {kv_heads} (batch "
            f"2, seq 192, emb 512, 8 heads, ffn 1024, lr {lr}): two steps on "
            f"the card (K6 and K7 once each per step) vs the CPU: loss rel "
            f"err {worst_loss:.3e}, largest param error / bound "
            f"{worst_param:.3f} | {smi}")
    result["phases"]["train_parity"] = train_parity
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 16
    train_runs = {
        "attention_llama2_grad": drive(
            "attention llama2 grad", compute_cli.main,
            ["attention", "--dataset", "llama2", "--grad", "--paths",
             "xla,flash,dpa"], 9, ["flash_fwd", "flash_bwd"], 16),
        "transformer_llama2_train": drive(
            "transformer llama2 train", compute_cli.main,
            ["transformer", "--dataset", "llama2", "--paths", "flash,xla"], 2,
            ["flash_fwd", "flash_bwd"], 16),
        # f32 (K6 and K7 on their tf32x3 path)
        "attention_llama2_f32_grad": drive(
            "attention llama2 f32 grad", compute_cli.main,
            ["attention", "--dataset", "llama2", "--dtype", "float32",
             "--grad", "--paths", "flash,dpa"], 6,
            ["flash_fwd_tf32x3", "flash_bwd_tf32x3"], 16),
    }
    # 8 steps x (1 untimed + 5 timed windows) on the flash path
    tl = train_runs["transformer_llama2_train"]["launches"]
    if tl.get("flash_fwd") != 48 or tl.get("flash_bwd") != 48:
        fail(f"phase 16: transformer train launched {tl}, not K6 and K7 "
             f"once per flash step (48)")
    al = train_runs["attention_llama2_grad"]["launches"]
    if al.get("flash_bwd") != al.get("flash_fwd"):
        fail(f"phase 16: attention --grad launched {al}, not one K7 per K6")

    def shares(row):
        """Kernel ms per step of K6, K7, the cuBLAS GEMMs (nvjet, xmma,
        cutlass kernels) and everything else (elementwise, reductions)."""
        by = row["by_name"]
        pick = lambda f: sum(ms for nm, ms in by.items() if f(nm))  # noqa: E731
        rec = dict(
            k6=pick(lambda nm: "flash_fwd" in nm),
            k7=pick(lambda nm: "flash_bwd" in nm),
            cublas=pick(lambda nm: any(t in nm.lower() for t in (
                "gemm", "cutlass", "xmma", "nvjet", "cublas"))))
        rec["other"] = row["device_ms"] - sum(rec.values())
        return rec

    for path in ("flash", "xla"):
        cfg = tfm.TransformerConfig(batch=1, seq=2048, emb=e, heads=h,
                                    ffn=ff, attention=path)
        state = {"p": tfm.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg, dev)}
        x = (torch.randn((1, 2048, e), generator=gen, device=dev)
             * 0.1).bfloat16()
        step = tfm.make_train_step(cfg)

        def train(state=state, step=step, x=x):
            state["p"], loss = step(state["p"], x)
            return loss

        row = breakdown(f"train step {path} (1, 2048, 4096, 32, 11008) bf16",
                        train, 10, grad=True, phase=16)
        row.update(shares(row))
        rows[f"tf_train_{path}"] = row
        say(f"phase 16 train step {path}: kernel ms per step K6 "
            f"{row['k6']:.4f}, K7 {row['k7']:.4f}, cuBLAS GEMMs "
            f"{row['cublas']:.4f}, other {row['other']:.4f} of "
            f"{row['device_ms']:.4f} | {smi}")
        del state, x
        torch.cuda.empty_cache()
    result["phases"]["train_cli"] = train_runs

    # ---------------------------------------------------------------- 17
    from param_tpu_torch.kernels import ring as k8
    from param_tpu_torch.ops import ring_collectives as rings

    ring_kernels = {  # kernel: (wrapper, plain version, launch count)
        "all_gather": (k8.ring_all_gather_cuda, k8.ring_all_gather_plain,
                       "ring_all_gather"),
        "reduce_scatter": (k8.ring_reduce_scatter_cuda,
                           k8.ring_reduce_scatter_plain,
                           "ring_reduce_scatter"),
        "bidir": (k8.ring_all_gather_bidir_cuda,
                  k8.ring_all_gather_bidir_plain, "ring_bidir_all_gather"),
        "loopback": (k8.ring_loopback_cuda, k8.ring_loopback_plain,
                     "ring_loopback"),
    }
    ops_api = {"all_gather": rings.ring_all_gather,
               "all_reduce": rings.ring_all_reduce,
               "bidir": rings.ring_all_gather_bidir,
               "loopback": rings.loopback_remote_copy}

    def ring_shards(n, nbytes, dt):
        elems = nbytes // torch.empty((), dtype=dt).element_size()
        return [torch.randn((elems,), generator=gen, device=dev).to(dt)
                for _ in range(n)]

    def same_bytes(name, got, want):
        """Every byte of every rank's result equal; returns 0.0, the
        largest error."""
        torch.cuda.synchronize()
        if len(got) != len(want):
            fail(f"{name}: {len(got)} results for {len(want)} ranks")
        for r, (g, w) in enumerate(zip(got, want)):
            if g.shape != w.shape or not torch.equal(
                    g.view(torch.uint8), w.to(g.device).view(torch.uint8)):
                err = (g.float() - w.to(g.device).float()).abs().max().item() \
                    if g.shape == w.shape else float("nan")
                fail(f"{name}: rank {r} differs from the plain version "
                     f"(shape {tuple(g.shape)} vs {tuple(w.shape)}, max abs "
                     f"err {err:.3e})")
        return 0.0

    KIB, MIB = 1 << 10, 1 << 20

    # the op API, the path a user of the rings calls: every kernel launches,
    # K8a / K8b on each of their routes (at 8 MiB a rank K8b's cluster one)
    kernels.reset_launch_counts()
    for n, nbytes in ((1, MIB), (2, MIB), (4, MIB), (8, MIB), (8, 8 * MIB)):
        xs = ring_shards(n, nbytes, torch.float32)
        for name, fn in ops_api.items():
            if name == "all_reduce":
                want = rings.ring_all_reduce([x.cpu() for x in xs])
            else:
                want = ring_kernels[name][1](xs)
            same_bytes(f"phase 17 {name} n={n} {nbytes} B (op API)", fn(xs),
                       want)
        del xs
    ring_launches = {k: v for k, v in kernels.launch_counts.items()
                     if k.startswith("ring_")}
    if min(ring_launches.values()) <= 0:
        fail(f"phase 17: a ring kernel or route was not launched by the op "
             f"API ({ring_launches})")
    say(f"phase 17 op API (ring_all_gather, ring_all_reduce, "
        f"ring_all_gather_bidir, loopback_remote_copy at n 1, 2, 4, 8, 1 MiB "
        f"f32 per rank, and at n 8, 8 MiB): every result equal to the plain "
        f"rings | launches {ring_launches}")

    k8_rows = {}

    def ring_library(coll, xs):
        """One PyTorch call computing the same function on a stacked copy
        of the shards made here, outside any timed window: every rank's
        gather (shift 0) as one expand of the stack, the reduce-scatter's
        chunk sums as one sum over the ranks (rank r's result is row
        (r + 1) % n; the sums may differ from the ring's in the last bit,
        so this row compares time only); the loopback's copies as one
        ``X.clone()``.  Over one rank the gather is a copy, and
        ``expand().contiguous()`` of the stack a view, so the call there
        is ``X.clone()``."""
        n = len(xs)
        x = torch.stack(xs)
        if coll == "loopback" or (coll in ("all_gather", "bidir") and
                                  n == 1):
            return lambda: x.clone()
        if coll in ("all_gather", "bidir"):
            return lambda: x.expand(n, n, x.shape[1]).contiguous()
        return lambda: x.view(n, n, -1).sum(0)

    def k8_case(coll, n, nbytes, dt):
        cuda_fn, plain_fn, _ = ring_kernels[coll]
        xs = ring_shards(n, nbytes, dt)
        err = same_bytes(f"K8 {coll} n={n} {nbytes} B", cuda_fn(xs),
                         plain_fn(xs))
        plan = k8.launch_plan(coll, xs, nbytes // n
                              if coll == "reduce_scatter" else nbytes)
        # a window of about 1 GiB of input or more: 3 calls of a 64 MiB
        # copy are 0.15 ms, too short to read
        iters = 50 if nbytes <= MIB else max(3, (1 << 30) // (n * nbytes))
        rec = timings(lambda: cuda_fn(xs, check=False),
                      lambda: plain_fn(xs), ring_library(coll, xs), iters)
        k8.check_errors(xs)  # no wait ran out while timing
        if coll in ("all_gather", "bidir"):
            nbytes_io = n * nbytes + n * n * nbytes
        elif coll == "reduce_scatter":
            nbytes_io = n * nbytes + nbytes
        else:
            nbytes_io = 2 * n * nbytes
        adds = (n - 1) * nbytes // xs[0].element_size() \
            if coll == "reduce_scatter" else 0  # (n - 1) adds per element
        b_ms, b_by = bound_ms(nbytes_io, adds)
        size = f"{nbytes // MIB} MiB" if nbytes >= MIB else \
            f"{nbytes // KIB} KiB"
        rec.update(shape=f"n={n} ranks (one card), {size} {str(dt)[6:]} per "
                         f"rank", max_abs_err=err, bound_ms=b_ms,
                   bound_by=b_by, bytes=nbytes_io,
                   gbps=nbytes_io / rec["ms"] / 1e6, plan=plan.text())
        k8_rows[f"{coll} n={n} {size} {str(dt)[6:]}"] = rec
        lib = {"all_gather": "X.expand(n, n, L).contiguous()",
               "bidir": "X.expand(n, n, L).contiguous()",
               "reduce_scatter": "X.view(n, n, c).sum(0)",
               "loopback": "X.clone()"}[coll]
        if n == 1 and coll in ("all_gather", "bidir"):
            lib = "X.clone()"
        copy = ""
        if coll == "loopback" and n == 1 and nbytes == 64 * MIB:
            # the same copy without the handshake: the kernel K8a-c take
            # over one rank, timed in this call
            rec["t_copy_kernel"] = timed(
                lambda: k8.ring_all_gather_cuda(xs, check=False), iters)
            k8.check_errors(xs)
            copy = (f" | ring_copy_kernel (K8a over one rank) "
                    f"{fmt(rec['t_copy_kernel'])}")
        say(f"phase 17 K8 {coll}: {rec['shape']}: every byte equal | plan "
            f"{plan.text()} | {timing_text(rec, lib)}{copy} "
            f"({rec['gbps']:.0f} GB/s of HBM: inputs read + outputs "
            f"written) bound {b_ms:.4f} ms ({b_by}) | {smi}")
        if coll == "reduce_scatter" and 2 <= n <= 8:
            # K8b's other route, held and timed too, with its own plain and
            # library times on the same inputs
            other = "memory" if plan.route == "cluster" else "cluster"
            with k8.forced_route(other):
                same_bytes(f"K8 {coll} n={n} {nbytes} B ({other} route)",
                           cuda_fn(xs), plain_fn(xs))
                orec = timings(lambda: cuda_fn(xs, check=False),
                               lambda: plain_fn(xs), ring_library(coll, xs),
                               iters)
                k8.check_errors(xs)
                oplan = k8.launch_plan(coll, xs, nbytes // n)
            orec.update(shape=rec["shape"], max_abs_err=err, bound_ms=b_ms,
                        bound_by=b_by, plan=oplan.text(),
                        gbps=nbytes_io / orec["ms"] / 1e6)
            rec[f"{other}_route"] = orec
            say(f"phase 17 K8 {coll}: {rec['shape']}, {other} route: every "
                f"byte equal | plan {oplan.text()} | "
                f"{timing_text(orec, lib)} | {smi}")
        del xs
        torch.cuda.empty_cache()
        return rec

    for coll in ring_kernels:
        for n in (1, 2, 4, 8):
            for nbytes, dt in ((4 * KIB, torch.float32),
                               (MIB, torch.float32),
                               (64 * MIB, torch.float32),
                               (MIB, torch.bfloat16)):
                k8_case(coll, n, nbytes, dt)
    # K8b's two routes about where ring_plan switches between them
    for n in (2, 4, 8):
        for nbytes in (2 * MIB, 4 * MIB, 16 * MIB):
            k8_case("reduce_scatter", n, nbytes, torch.float32)

    # a planted fault: rank 0 sends its first hop to right + 1
    fault_rec = {}
    for coll, route in (("all_gather", None), ("reduce_scatter", "memory"),
                        ("reduce_scatter", "cluster"), ("bidir", None)):
        cuda_fn, plain_fn, _ = ring_kernels[coll]
        name = coll if route is None else f"{coll} ({route} route)"
        xs = ring_shards(4, MIB, torch.float32)
        with (k8.forced_route(route) if route else contextlib.nullcontext()):
            t0 = time.perf_counter()
            try:
                cuda_fn(xs, fault=1, timeout_s=0.05)
            except RuntimeError as e:
                fault_rec[name] = dict(raised=str(e),
                                       seconds=time.perf_counter() - t0)
            else:
                fail(f"phase 17 K8 {name}: the planted fault was not "
                     f"flagged")
            same_bytes(f"K8 {name} after the fault", cuda_fn(xs),
                       plain_fn(xs))
        say(f"phase 17 K8 {name} planted fault (rank 0's first hop to "
            f"right + 1, n=4, 1 MiB): raised after "
            f"{fault_rec[name]['seconds']:.3f} s: {fault_rec[name]['raised']}"
            f" | the next call is right again")
    cards = torch.cuda.device_count()
    if cards >= 2:
        k8_rows.update(ring_across_cards(min(cards, 8), smi))
    else:
        say("phase 17: one card: the rings ran all ranks on it; the wire "
            "between cards (peer writes over NVLink) is unchecked")
    result["phases"]["k8"] = dict(rows=k8_rows, fault=fault_rec,
                                  launches=ring_launches, cards=cards)

    # ---------------------------------------------------------------- 18
    from param_tpu_torch.cli import comms as comms_cli

    def comms_run(argv, n_tables):
        rc, out, wall = run_cli(comms_cli, argv)
        rows = comms_rows_ok(out, n_tables)
        if rc != 0 or not rows:
            fail(f"phase 18 cli.comms {' '.join(argv)}: rc {rc}, dcheck not "
                 f"OK on every row or a table missing:\n{out}")
        say(f"phase 18 cli.comms {' '.join(argv)} | {wall:.1f} s | {smi}\n"
            f"{out.rstrip()}")
        return dict(argv=argv, wall_s=wall, output=out, rows=len(rows))

    comms_runs = {
        "dispatch": comms_run(
            ["--collective", "all_reduce,all_gather,reduce_scatter,"
             "all_to_all,broadcast,pt2pt", "--b", "8", "--e", "64M",
             "--c", "1"], 6),
        "graph": comms_run(
            ["--collective", "all_reduce,all_gather", "--b", "1K", "--e",
             "64M", "--f", "8", "--c", "1", "--mode", "graph"], 2),
    }
    if cards >= 2:
        torch.cuda.empty_cache()  # card 0 hosts the world's rank 0 too
        comms_runs["torchrun"] = comms_world(cards, smi)
    result["phases"]["comms_cli"] = comms_runs

    # ---------------------------------------------------------------- 19
    import numpy as np

    from param_tpu_torch import bench as port_bench
    from param_tpu_torch.experiments import coalesce as coal
    from param_tpu_torch.kernels import coalesce as kc

    torch.cuda.empty_cache()
    CE, CD = coal.E, coal.D
    ctab = torch.rand((CE, CD), generator=gen, device=dev)
    k9, k9_fault = {}, {}
    for k in coal.KS:
        n = coal.K_ROWS // k
        starts = torch.randint(0, CE - k, (n,), generator=gen, device=dev,
                               dtype=torch.int32)
        shifted = [((starts + s) % (CE - k)).int() for s in range(8)]
        want = kc.desc_fetch_plain(ctab, starts, k)
        tol = 1e-4 * want.abs().max().item()
        err = check(f"K9 k={k}", kc.desc_fetch_cuda(ctab, starts, k), want,
                    tol)
        if k == 8:  # a planted fault: one start shifted by one row
            bad = starts.clone()
            bad[0] = (bad[0] + 1) % (CE - k)
            bad_err = (kc.desc_fetch_cuda(ctab, bad, k) - want).abs().max() \
                .item()
            if not bad_err > tol:
                fail(f"K9: a start shifted by one row is not flagged (err "
                     f"{bad_err:.3e}, tol {tol:.3e})")
            k9_fault = dict(max_abs_err=bad_err, tol=tol)
            say(f"phase 19 K9 planted fault (k 8, start 0 moved one row): "
                f"max abs err {bad_err:.3e} > tol {tol:.3e}, flagged")
        n_tiles = coal.K_ROWS // coal.ROWS_PER_TILE
        nbytes = coal.K_ROWS * CD * 4 + n * 4 + n_tiles * CD * 4
        b_ms, b_by = bound_ms(nbytes, coal.K_ROWS * CD)
        nk, npl = itertools.cycle(shifted), itertools.cycle(shifted)
        # the library call: F.embedding_bag over each tile's row ids
        nl = itertools.cycle([(st.long()[:, None] + torch.arange(
            k, device=dev)).reshape(n_tiles, -1) for st in shifted])
        rec = timings(lambda: kc.desc_fetch_cuda(ctab, next(nk), k),
                      lambda: kc.desc_fetch_plain(ctab, next(npl), k),
                      lambda: F.embedding_bag(next(nl), ctab, mode="sum"),
                      20)
        rec.update(shape=f"table ({CE}, {CD}) f32, {n} starts x {k} rows "
                         f"({coal.ROWS_PER_TILE} rows a tile)",
                   max_abs_err=err, tol=tol, bound_ms=b_ms, bound_by=b_by,
                   bytes=nbytes, gbps=nbytes / rec["ms"] / 1e6,
                   ns_per_copy=rec["ms"] * 1e6 / n)
        k9[k] = rec
        say(f"phase 19 K9 k={k}: {rec['shape']} max_abs_err {err:.3e} (tol "
            f"{tol:.3e}) | {timing_text(rec, 'F.embedding_bag')} "
            f"({rec['gbps']:.0f} GB/s, "
            f"{rec['ns_per_copy']:.3f} ns per copy) bound {b_ms:.4f} ms "
            f"({b_by}) | {smi}")
        del starts, shifted, want

    k10 = {}
    k10_kernels = k10_profile()
    crng = np.random.default_rng(0)
    for dist in ("uniform", "zipf"):
        idx = torch.from_numpy(coal.stage_b_ids(crng, dist, rows=CE)).to(dev)
        ids = [((idx.long() + s) % CE).int() for s in range(8)]
        longs = [i.long() for i in ids]

        def bag(i, n_blocks=None):
            return kc.coalesced_bag_cuda(ctab, i, coal.R_BLK, coal.TILE_BAGS,
                                         n_blocks)

        want = emb_gather_plain(ctab, ids[0])
        tol = 1e-5 * want.abs().max().item()
        plan_blocks = kc.coalesce_plan(ids[0], CE, coal.R_BLK,
                                       coal.TILE_BAGS).n_blocks
        fetched = torch.full_like(plan_blocks, -1)
        got = bag(ids[0], fetched)
        err = check(f"K10 {dist}", got, want, tol)
        k1_err = check(f"K1 {dist} (stage B's ids)",
                       emb_gather_cuda(ctab, ids[0]), want, tol)
        if not torch.equal(fetched, plan_blocks):
            fail(f"K10 {dist}: the kernel fetched {int(fetched.sum())} "
                 f"blocks ({(fetched != plan_blocks).sum().item()} tiles "
                 f"differ), the scheme needs {int(plan_blocks.sum())}")
        if not torch.equal(bag(ids[0]), got):
            fail(f"K10 {dist}: two calls on the same ids differ")
        # NaN bags: an id past the table and one below -R; -1 wraps
        odd = ids[0].clone()
        odd[5, 3], odd[9, 0], odd[7, 2] = CE, -CE - 1, -1
        got_odd, want_odd = bag(odd), emb_gather_plain(ctab, odd)
        nan_rows = torch.isnan(want_odd).all(1)
        torch.cuda.synchronize()
        if not (torch.equal(torch.isnan(got_odd).all(1), nan_rows)
                and nan_rows.sum().item() == 2):
            fail(f"K10 {dist}: NaN bags differ from K1's plain version")
        check(f"K10 {dist} beside NaN bags", got_odd[~nan_rows],
              want_odd[~nan_rows], tol)
        # a planted fault: one id moved by one row, against the unmoved bag
        moved = ids[0].clone()
        moved[0, 0] = (moved[0, 0] + 1) % CE
        bad_err = (bag(moved) - want).abs().max().item()
        if not bad_err > tol:
            fail(f"K10 {dist}: an id moved by one row is not flagged (err "
                 f"{bad_err:.3e}, tol {tol:.3e})")
        # the whole call on the card: K10 once and nothing else
        ran = k10_kernels[dist]
        if len(ran) != 1 or "coalesced_bag_kernel" not in next(iter(ran)) \
                or next(iter(ran.values()))["launches"] != 1:
            fail(f"K10 {dist}: a coalesced_bag call ran {ran}, not K10 "
                 f"alone once")
        uniq = torch.unique(ids[0]).numel()  # shifts are bijections
        blocks = int(plan_blocks.sum().item())
        ends = idx.numel() * 4 + coal.B * CD * 4  # ids in, bags out
        nbytes = uniq * CD * 4 + ends
        b_ms, b_by = bound_ms(nbytes, idx.numel() * CD)
        scheme_ms = bound_ms(blocks * coal.R_BLK * CD * 4 + ends)[0]
        n1, n3 = itertools.cycle(ids), itertools.cycle(longs)
        n2, n4 = itertools.cycle(ids), itertools.cycle(ids)
        rec = timings(lambda: bag(next(n1)),
                      lambda: emb_gather_plain(ctab, next(n2)),
                      lambda: F.embedding_bag(next(n3), ctab, mode="sum"), 20)
        rec["t_k1"] = timed(lambda: emb_gather_cuda(ctab, next(n4)), 20)
        parent = K10_PARENT[dist]
        rec.update(shape=f"table ({CE}, {CD}) f32, {coal.B} bags x "
                         f"{coal.NNZ} {dist} ids, r_blk {coal.R_BLK}, "
                         f"{coal.TILE_BAGS} bags a tile",
                   max_abs_err=err, tol=tol, k1_max_abs_err=k1_err,
                   moved_id_err=bad_err,
                   bound_ms=b_ms, bound_by=b_by, scheme_bound_ms=scheme_ms,
                   unique_rows=uniq, blocks=blocks, bytes=nbytes,
                   profiled_kernels=ran, parent=parent,
                   gbps=nbytes / rec["ms"] / 1e6)
        k10[dist] = rec
        say(f"phase 19 K10 {dist}: {rec['shape']}: max_abs_err {err:.3e} "
            f"(tol {tol:.3e}), K1 at these ids {k1_err:.3e}; blocks "
            f"fetched = the plan's {blocks}; two calls bitwise equal; NaN "
            f"bags as K1's; an id moved one row flagged ({bad_err:.3e}); a "
            f"profiled call: {next(iter(ran))[:40]} alone | "
            f"{timing_text(rec, 'F.embedding_bag')} | K1 "
            f"{fmt(rec['t_k1'])} | parent (pre-pass + K10 {parent['call']} "
            f"ms, K10 alone {parent['alone']} ms; {parent['origin']}) | "
            f"{uniq} distinct rows in {blocks} blocks of {coal.R_BLK} | bound "
            f"{b_ms:.4f} ms ({b_by}; {b_ms / rec['ms']:.1%}), the scheme's "
            f"blocks {scheme_ms:.4f} ms ({scheme_ms / rec['ms']:.1%}) | {smi}")
        del idx, ids, longs, want
    del ctab
    torch.cuda.empty_cache()

    # the main path: the headline bench and the experiment, as a user runs
    # them, with the launch counts reset just before and read just after
    kernels.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rcs = [port_bench.main([]), coal.main(["--verify"]), coal.main([])]
    wall = time.perf_counter() - t0
    main19 = {k: v for k, v in kernels.launch_counts.items() if v}
    out19 = buf.getvalue()
    lines = out19.splitlines()
    bench_lines = [ln for ln in lines if ln.startswith("{")]
    bench_rec = json.loads(bench_lines[0]) if bench_lines else {}
    missing = [k for k in ("emb_gather", "desc_fetch", "coalesced_bag")
               if main19.get(k, 0) <= 0]
    k_lines = [ln for ln in lines if ln.strip().startswith("K=")]
    verdicts = [ln for ln in lines if " -> " in ln]
    if any(rcs) or missing or len(bench_lines) != 1 or \
            bench_rec.get("metric") != "torch_emb_lookup_bw_1Mx128_b8192_nnz30" \
            or not (math.isfinite(bench_rec.get("value", math.nan))
                    and bench_rec["value"] > 0) \
            or len(k_lines) != len(coal.KS) or len(verdicts) != 2 \
            or "verify: both kernels match" not in out19:
        fail(f"phase 19 bench / experiment: rcs {rcs}, not launched "
             f"{missing} ({main19}), output:\n{out19}")
    say(f"phase 19 param_tpu_torch.bench.main() and experiments.coalesce."
        f"main() (--verify, then stages A and B) | {wall:.1f} s | launches "
        f"{main19} | {smi}\n{out19.rstrip()}")
    result["phases"]["coalesce"] = dict(k9=k9, k9_fault=k9_fault, k10=k10,
                                        main_launches=main19, bench=bench_rec,
                                        output=out19, wall_s=wall)

    # ---------------------------------------------------------------- 20
    dlrm20 = sharded_dlrm(smi, breakdown)
    if cards >= 2:
        dlrm20["torchrun"] = dlrm_world(
            cards, smi, {o: result["phases"]["trainer"][o]["losses"][0]
                         for o in DLRM_OPTS})
    else:
        say("phase 20: one card: the sharded DLRM ran as a world of one; "
            "the all-to-alls and all-reduces between cards are unchecked")
    result["phases"]["sharded_dlrm"] = dlrm20
    main20 = dlrm20["launches"]

    # ---------------------------------------------------------------- 21
    par21 = parallel_tier(smi, breakdown)
    if cards >= 2:
        par21["torchrun"] = parallel_world(cards, smi)
    else:
        say("phase 21: one card: the parallel tier ran as a world of one "
            "and its shard schedules in one process; the KV ring, the "
            "all-to-alls, the tp all-reduces and the pipeline hops between "
            "cards are unchecked")
    result["phases"]["parallel_tier"] = par21
    main21 = [par21[key] for key in ("ring_world1", "tp_world1", "pp_world1")]

    # ---------------------------------------------------------------- 22
    # K1 at the comms-compute bench's and the replay's lookup shape
    RC, DC, BC, NC = 100_000, 128, 2048, 30
    ctab = torch.rand((RC, DC), generator=gen, device=dev)
    cbase = torch.randint(0, RC, (BC, NC), generator=gen, device=dev,
                          dtype=torch.int32)
    k1_case("comms_compute_f32", ctab,
            [((cbase + s) % RC).to(torch.int32) for s in range(8)], 1e-5,
            100, phase="22")
    del ctab, cbase
    rem22 = comms_remainder(smi)
    if cards >= 2:
        rem22["torchrun"] = comms_remainder_world(cards, smi)
    else:
        say("phase 22: one card: the quantized collectives, the overlap and "
            "comms-compute benches and the replay ran in a world of one; "
            "their traffic between cards is unchecked")
    result["phases"]["comms_remainder"] = rem22
    main22 = rem22["launches"]

    # ---------------------------------------------------------------- 23
    et23 = et_tier(smi)
    if cards >= 2:
        et23["torchrun"] = et_sharded_world(cards, smi)
    else:
        say("phase 23: one card: the sharded step's trace was captured and "
            "replayed in a world of one; its collectives between cards are "
            "unchecked")
    result["phases"]["et_tier"] = et23
    main23 = et23["launches"]

    # ---------------------------------------------------------------- 24
    pt24 = pt_et_tier(smi, rem22["replay"]["basic"]["details"])
    result["phases"]["pt_et_tier"] = pt24

    # ---------------------------------------------------------------- 25
    # K1 at the two shapes BatchedEmbedding gives it: a table of
    # configs/basic_ops.json's (1000 x 16 f32, 32 bags x 8: 4 lanes a row,
    # 8 rows a warp) and one at the trainer's width
    for name, (MT, MD, MB, MN) in (("microbench_basic_ops_f32",
                                    (1000, 16, 32, 8)),
                                   ("microbench_table_f32",
                                    (100_000, 64, 2048, 10))):
        mtab = torch.randn((MT, MD), generator=gen, device=dev)
        mids = torch.randint(0, MT, (MB, MN), generator=gen, device=dev,
                             dtype=torch.int32)
        k1_case(name, mtab, [((mids + s) % MT).to(torch.int32)
                             for s in range(8)], 1e-5, 100, phase="25")
    del mtab, mids
    mb25 = microbench_tier(smi, timings, timing_text)
    result["phases"]["microbench"] = mb25

    # ---------------------------------------------------------------- 26
    mlp26 = mlp_steps_tier(smi)
    result["phases"]["mlp_steps"] = mlp26

    # ---------------------------------------------------------------- 27
    mh27 = multihot_tier(smi)
    result["phases"]["multihot"] = mh27

    # ---------------------------------------------------------------- 28
    dot28 = interaction_tier(smi)
    result["phases"]["interaction"] = dot28

    # ---------------------------------------------------------------- report
    def entry(name, source, replaces, n_launches, rec):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "shape": rec["shape"], "ms_min": rec["t_kernel"]["min"],
                "ms_max": rec["t_kernel"]["max"],
                "ms_issued_eagerly": rec["t_kernel_eager"]["ms"],
                "ms_issued_eagerly_through_op":
                    rec["t_op_eager"]["ms"] if "t_op_eager" in rec else None}

    def cli_launches(run, key):
        return cli_runs[run]["launches"].get(key, 0)

    def main_path_flash(runs, kernel, path="wgmma"):
        """Launches of ``kernel`` in the main path's runs, all of which
        must have taken ``path``."""
        total = sum(r["launches"].get(kernel, 0) for r in runs)
        on_path = sum(r["launches"].get(f"{kernel}_{path}", 0) for r in runs)
        if on_path != total:
            fail(f"{kernel}: {total - on_path} of {total} launches on the "
                 f"main path did not take the {path} path")
        return on_path

    k6_launches = main_path_flash([serve_runs["attention_llama2"],
                                   serve_runs["transformer_llama2"]],
                                  "flash_fwd")
    k7_launches = main_path_flash([train_runs["attention_llama2_grad"],
                                   train_runs["transformer_llama2_train"]],
                                  "flash_bwd")
    f32_runs = [serve_runs["attention_llama2_f32"],
                serve_runs["attention_gpt2_f32"],
                train_runs["attention_llama2_f32_grad"]]
    k6_f32_launches = main_path_flash(f32_runs, "flash_fwd", "tf32x3")
    k7_f32_launches = main_path_flash(f32_runs, "flash_bwd", "tf32x3")
    k6_par_launches = main_path_flash(main21, "flash_fwd")
    k7_par_launches = main_path_flash(main21, "flash_bwd")
    pt_f32, pt_bf16 = pt24["by_cast"]["f32"], pt24["by_cast"]["bf16"]
    k6_pt_f32 = main_path_flash(pt_f32, "flash_fwd", "tf32x3")
    k7_pt_f32 = main_path_flash(pt_f32, "flash_bwd", "tf32x3")
    k6_pt_bf16 = main_path_flash(pt_bf16, "flash_fwd")
    k7_pt_bf16 = main_path_flash(pt_bf16, "flash_bwd")
    src = "param_tpu_torch/kernels/csrc/"
    report = {"kernels": [
        entry("emb_gather (K1)", src + "emb_gather.cu",
              "param_tpu/ops/embedding.py:185", launches["emb_gather"],
              k1["dlrm_f32"]),
        entry("sparse_update adagrad (K2)", src + "sparse_update.cu",
              "param_tpu/ops/sparse_update.py:117",
              launches["sparse_update_adagrad"], k2["adagrad"]),
        entry("sparse_update sgd (K2)", src + "sparse_update.cu",
              "param_tpu/ops/sparse_update.py:117",
              launches["sparse_update_sgd"], k2["sgd"]),
        entry("dedup_sum (dedup; no TPU kernel)", src + "dedup.cu",
              "param_tpu/ops/sparse_update.py:44 (XLA)",
              launches["dedup_sum"], dedup["dlrm_f32"]),
        entry("gemm f32 (K3)", src + "gemm.cu", "param_tpu/ops/matmul.py:97",
              cli_launches("gemm_C_compare", "gemm_f32"),
              k3["float32 (1024, 1024, 4096)"]),
        entry("gemm bf16 (K3)", src + "gemm.cu", "param_tpu/ops/matmul.py:97",
              cli_launches("gemm_A_bf16_K3", "gemm_bf16"),
              k3["bfloat16 (1024, 4096, 4096)"]),
        entry("gemm weight-resident bf16 (K4)", src + "gemm.cu",
              "param_tpu/ops/matmul.py:38",
              cli_launches("gemm_wres_K4", "gemm_wres"), k4),
        entry("int4 gemm (K5), wgmma path", src + "int4_gemm.cu",
              "param_tpu/ops/matmul.py:196",
              cli_launches("inference_int4_K5", "int4_gemm_wgmma"),
              k5["(512, 4096, 4096)"]),
        entry("int4 gemm, cast_int4_mlp + mlp_forward_int4 (K5), wgmma "
              "path", src + "int4_gemm.cu", "param_tpu/ops/matmul.py:196",
              mlp26["k5_launches"], k5["(512, 4096, 4096)"]),
        entry("int4 gemm, serve decode step (K5), stream path",
              src + "int4_gemm.cu", "param_tpu/ops/matmul.py:196", n_stream,
              k5["(1, 4096, 12288)"]),
        entry("flash attention forward (K6), wgmma path",
              src + "flash_fwd.cu", "param_tpu/ops/attention.py:251",
              k6_launches, k6["llama2_causal"]),
        entry("flash attention backward (K7), wgmma path",
              src + "flash_bwd.cu", "param_tpu/ops/attention.py:809, :841",
              k7_launches, k7["llama2_causal"]),
        entry("flash attention forward f32 (K6), tf32x3 path",
              src + "flash_fwd.cu", "param_tpu/ops/attention.py:251",
              k6_f32_launches, k6["f32_llama2_causal"]),
        entry("flash attention backward f32 (K7), tf32x3 path",
              src + "flash_bwd.cu", "param_tpu/ops/attention.py:809, :841",
              k7_f32_launches, k7["f32_llama2_causal"]),
        entry("ring all-gather (K8a), memory route", src + "ring.cu",
              "param_tpu/ops/ring_collectives.py:55",
              ring_launches["ring_all_gather_memory"],
              k8_rows["all_gather n=8 64 MiB float32"]),
        entry("ring reduce-scatter (K8b), cluster route", src + "ring.cu",
              "param_tpu/ops/ring_collectives.py:112",
              ring_launches["ring_reduce_scatter_cluster"],
              k8_rows["reduce_scatter n=8 64 MiB float32"]),
        entry("ring reduce-scatter (K8b), memory route", src + "ring.cu",
              "param_tpu/ops/ring_collectives.py:112",
              ring_launches["ring_reduce_scatter_memory"],
              k8_rows["reduce_scatter n=8 64 MiB float32"]["memory_route"]),
        entry("ring copy, one rank (K8a-c at n = 1)", src + "ring.cu",
              "param_tpu/ops/ring_collectives.py:55, :112, :181",
              ring_launches["ring_all_gather_copy"]
              + ring_launches["ring_reduce_scatter_copy"]
              + ring_launches["ring_bidir_all_gather_copy"],
              k8_rows["all_gather n=1 64 MiB float32"]),
        entry("both-direction ring all-gather (K8c), memory route",
              src + "ring.cu", "param_tpu/ops/ring_collectives.py:181",
              ring_launches["ring_bidir_all_gather_memory"],
              k8_rows["bidir n=8 64 MiB float32"]),
        entry("loopback remote copy (K8d)", src + "ring.cu",
              "param_tpu/ops/ring_collectives.py:261",
              ring_launches["ring_loopback"],
              k8_rows["loopback n=1 64 MiB float32"]),
        entry("emb_gather, sharded DLRM (K1)", src + "emb_gather.cu",
              "param_tpu/ops/embedding.py:185", main20["emb_gather"],
              k1["dlrm_f32"]),
        entry("sparse_update adagrad, sharded DLRM (K2)",
              src + "sparse_update.cu", "param_tpu/ops/sparse_update.py:117",
              main20["sparse_update_adagrad"], k2["adagrad"]),
        entry("sparse_update sgd, sharded DLRM (K2)", src + "sparse_update.cu",
              "param_tpu/ops/sparse_update.py:117",
              main20["sparse_update_sgd"], k2["sgd"]),
        entry("dedup_sum, sharded DLRM (dedup)", src + "dedup.cu",
              "param_tpu/ops/sparse_update.py:44 (XLA)",
              main20["dedup_sum"], dedup["dlrm_f32"]),
        entry("dot_interaction forward, sharded DLRM, tb26.sgd.zipf's "
              "shape", src + "interaction.cu",
              "param_tpu/models/dlrm.py:105 (XLA)",
              main20["dot_interaction"], dot28["tb26"]["fwd"]),
        entry("dot_interaction backward, sharded DLRM, tb26.sgd.zipf's "
              "shape", src + "interaction.cu",
              "param_tpu/models/dlrm.py:105 (XLA)",
              main20["dot_interaction_bwd"], dot28["tb26"]["bwd"]),
        entry("dot_interaction forward, sharded DLRM, "
              "rm8x1m.adagrad.uniform's shape", src + "interaction.cu",
              "param_tpu/models/dlrm.py:105 (XLA)",
              main20["dot_interaction"], dot28["rm8x1m"]["fwd"]),
        entry("dot_interaction backward, sharded DLRM, "
              "rm8x1m.adagrad.uniform's shape", src + "interaction.cu",
              "param_tpu/models/dlrm.py:105 (XLA)",
              main20["dot_interaction_bwd"], dot28["rm8x1m"]["bwd"]),
        entry("flash attention forward, parallel tier: ring attention, tp "
              "and pp steps (K6), wgmma path", src + "flash_fwd.cu",
              "param_tpu/ops/attention.py:251", k6_par_launches,
              k6["llama2_causal"]),
        entry("flash attention backward, parallel tier: tp and pp steps "
              "(K7), wgmma path", src + "flash_bwd.cu",
              "param_tpu/ops/attention.py:809, :841", k7_par_launches,
              k7["llama2_causal"]),
        entry("emb_gather, comms-compute bench and trace replay (K1)",
              src + "emb_gather.cu", "param_tpu/ops/embedding.py:185",
              main22.get("emb_gather", 0), k1["comms_compute_f32"]),
        entry("emb_gather, ET replay (K1)", src + "emb_gather.cu",
              "param_tpu/ops/embedding.py:185", main23.get("emb_gather", 0),
              k1["dlrm_f32"]),
        entry("sparse_update sgd, ET replay (K2)", src + "sparse_update.cu",
              "param_tpu/ops/sparse_update.py:117",
              main23.get("sparse_update_sgd", 0), k2["sgd"]),
        entry("sparse_update adagrad, ET replay (K2)",
              src + "sparse_update.cu", "param_tpu/ops/sparse_update.py:117",
              main23.get("sparse_update_adagrad", 0), k2["adagrad"]),
        entry("dedup_sum, ET replay (dedup)", src + "dedup.cu",
              "param_tpu/ops/sparse_update.py:44 (XLA)",
              main23.get("dedup_sum", 0), dedup["dlrm_f32"]),
        entry("flash attention forward, PyTorch-ET op replay (K6), tf32x3 "
              "path", src + "flash_fwd.cu", "param_tpu/ops/attention.py:251",
              k6_pt_f32, k6["f32_llama2_causal"]),
        entry("flash attention backward, PyTorch-ET op replay (K7), tf32x3 "
              "path", src + "flash_bwd.cu",
              "param_tpu/ops/attention.py:809, :841", k7_pt_f32,
              k7["f32_llama2_causal"]),
        entry("flash attention forward, PyTorch-ET op replay (K6), wgmma "
              "path", src + "flash_fwd.cu", "param_tpu/ops/attention.py:251",
              k6_pt_bf16, k6["llama2_causal"]),
        entry("flash attention backward, PyTorch-ET op replay (K7), wgmma "
              "path", src + "flash_bwd.cu",
              "param_tpu/ops/attention.py:809, :841", k7_pt_bf16,
              k7["llama2_causal"]),
        entry("emb_gather, bench headline shape (K1)", src + "emb_gather.cu",
              "param_tpu/ops/embedding.py:185", main19["emb_gather"],
              k1["headline_f32"]),
        entry("emb_gather bf16, trainer's width (K1)", src + "emb_gather.cu",
              "param_tpu/ops/embedding.py:185",
              cli_launches("emb_trainer_bf16_K1", "emb_gather"),
              k1["dlrm_bf16"]),
        entry("emb_gather per-feature bags, DCN sparse Adagrad step (K1)",
              src + "emb_gather.cu", "param_tpu/ops/embedding.py:185",
              mh27["step"]["launches"]["emb_gather"], mh27["k1"]),
        entry("dedup_sum per-feature bags, DCN sparse Adagrad step (dedup)",
              src + "dedup.cu", "param_tpu/ops/sparse_update.py:44 (XLA)",
              mh27["step"]["launches"]["dedup_sum"], mh27["dedup"]),
        entry("sparse_update adagrad, DCN sparse Adagrad step (K2)",
              src + "sparse_update.cu", "param_tpu/ops/sparse_update.py:117",
              mh27["step"]["launches"]["sparse_update_adagrad"],
              k2["adagrad"]),
    ] + [entry(f"desc_fetch k={k} (K9)", src + "coalesce.cu",
               "scripts/coalesce_experiment.py:55", main19["desc_fetch"],
               k9[k]) for k in coal.KS]
      + [entry(f"coalesced_bag {dist} ids (K10)", src + "coalesce.cu",
               "scripts/coalesce_experiment.py:162", main19["coalesced_bag"],
               k10[dist]) for dist in ("uniform", "zipf")]
      + [entry(f"emb_gather, operator microbench BatchedEmbedding {what} "
               f"(K1)", src + "emb_gather.cu",
               "param_tpu/ops/embedding.py:185",
               mb25["k1_launches"][key], k1[case])
         for what, key, case in (
             ("of configs/basic_ops.json", "basic_ops",
              "microbench_basic_ops_f32"),
             ("at the trainer's width", "trainer", "microbench_table_f32"))]
      + [entry(f"gemm (K3), schedule tuner at {label}, default schedule "
               f"{rec['path']}/{rec['splits']}"
               f"{'/rows' if rec['rows_fastest'] else ''}",
               src + "gemm.cu", "param_tpu/ops/matmul.py:97",
               rec["launches"], rec)
         for label, rec in mb25["timed"].items()]}
    result.update(report)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    say(smi)
    say(json.dumps(report))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the full results as JSON to PATH")
    args = ap.parse_args()
    sys.exit(main(args.out))

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, with no arguments, on a machine with a
CUDA card and ``nvcc``. In order:

1. Device: the card's name and power limit (``nvidia-smi``), CUDA version.
   Deterministic algorithms (cuDNN's deterministic mode and
   ``torch.use_deterministic_algorithms``, with ``CUBLAS_WORKSPACE_CONFIG``
   set before CUDA starts) are on only around the calls held to bit
   equality; everything timed runs in PyTorch's default settings, as the
   entry points do.
2. Build: compiles every kernel of ``zookeeper_tpu_torch/csrc`` with
   ``nvcc`` for ``sm_90a``, one process per source, in parallel.
3. Kernels: K1 ``pack_rows``, K3 ``conv_gemm_popcount`` and K4
   ``packed_weight_matmul`` at every shape the batch-8 QuickNet-Large
   forward gives them plus a ragged shape; K3 (and K1) also at
   BinaryAlexNet's four binary convs (slice C, 5x5 and 3x3), BinaryNet's
   five (E_AUTO), QuickNet's sections at batch 1 and small convs (M 50
   to 144), each row giving the same bits on a second call; K4 also at slice D's dense
   shapes (M 8 and 1, K 9216 and 4096, N 4096) and at rows across its
   variant threshold and tile edges (M 8 and 9, M not a multiple of
   the tile, N 33 and 130, Kw 1, K not a multiple of 32); K1 also at
   its wire-format edges (+-0, +-inf, NaN, +-subnormals), at bases
   that are not 16-byte aligned (a view with a storage offset: its
   scalar-load path) and at the rows slice C (bf16) and E_AUTO (fp32)
   pack (``ablate.K1_SHAPES``, with their sums per forward), beside the
   floor of back-to-back launches (an empty ``torch.cuda._sleep(0)``
   timed as K1 is): each must
   EQUAL its plain PyTorch version on the card (exact integers, or one
   fp32 multiply of one), and each is timed beside its plain version
   and, where one PyTorch call computes the same function, that call
   (K4: ``torch._int_mm``, M padded where it refuses a small M). Every
   K4 row must take the design ``packed_weight_matmul_variant`` names
   for it: "mma" (the int8 tensor-core tiles) for slice B's conv GEMMs
   and every M > 8, "small_m" for slice D's dense shapes and M <= 8.
4. Residual kernels: K6 ``pack_resid`` (sign and mask mode), K7
   ``unpack_resid_pm1`` and K8 ``mask_mul_resid`` at the four
   QuickNet-Large section shapes of a batch-128 bf16 training step, and
   at ragged and edge cases (batch 37, a 2-D fp32 residual, a 5-D one,
   values mixing +-0, +-inf, NaN, +-1 and +-1e-40): each must equal its
   plain version bit for bit, and is timed beside it.
5. Popcount GEMMs: K5 ``xnor_matmul_packed`` and K2
   ``xnor_matmul_packed_scaled`` at BinaryAlexNet's dense shapes (M 1
   and 8, K 9216 and 4096, N 4096), BinaryNet's batch-8 shapes (K5: the
   per-tap and fused convs and the dense layers; K2: E_AUTO's two dense
   layers) and ragged shapes: each must equal its plain version bit for
   bit, give the same bits on a second call, and K2 must equal K5's
   output ``.float() * scale`` bit for bit; each is timed beside its
   plain version and ``torch._int_mm`` on int8 +-1 operands (M padded
   where ``_int_mm`` refuses a small M; the line says so). Both also run
   ragged rows at M <= 8 (M 3 to 8; Kw 7 to 288; N 8 to 4100: rows past
   M, the scalar weight loads of N % 4 != 0, a Kw below one block's
   share, K split over a cluster of each size from 2 to 8, partial
   column tiles) and on both sides of K5's "popc"/"mma" threshold (M
   64 and 65, 129, 300; Kw 1, 7 and 37; N 8, 72 and 130), so K2's
   CUDA-core tiles are held bit for bit to K5's tensor-core output
   there. Every row must take the design ``xnor_matmul_packed_variant``
   / ``xnor_matmul_packed_scaled_variant`` names for it: "small_m" (the
   int8 tensor cores, K split over a cluster) for both at M <= 8, then
   "popc" (K5 up to M 64, K2 at every larger M), and "mma" (the int8
   tensor-core tiles) for K5 past M 64, slice E's conv GEMMs included.
   The ptxas report (registers, spills) of the K4 and K5 kernels is
   printed after the build, and so is that of K3's kernels and the
   K12/K13 row split.
6. The int8 conv's forward at the four section shapes must give the
   exact integer sums (against a float64 conv, exact for these sums).
7. Serving slices (``SLICES``), each ``ServingConfig.run()`` over 16
   seeded requests at buckets (1, 8): every forward must launch its
   slice's binary kernels (by its bucket) and no other, and one batch's
   logits must equal the plain path's bit for bit. A: QuickNet-Large,
   224x224x3, 1000 classes, bf16, ``binary_compute="xnor_popcount"``,
   packed and BN-folded weights (K1, K3: 32 each). B: the same with
   ``"xnor"`` (K4: 32). C: BinaryAlexNet, 224, bf16, ``"xnor_popcount"``
   packed, no fold (K1 6, K3 4, K2 2). D: BinaryAlexNet with "mxu" convs
   and the packed, BN-folded "xnor" dense stage (K4 2); without the fold
   the same build converts exactly the two dense kernels. E: BinaryNet
   (default widths), 32x32x3, 10 classes, fp32, ``"xnor_popcount"``
   packed, ``binary_flavor="reference"`` (K5 15 per batch-8 forward, 7
   at batch 1); its logits must also equal the same model's under
   ``binary_flavor="auto"`` (K1 7, K3 5, K2 2) bit for bit. The
   ResNet-topology zoo (``ZOO``: 224x224x3, 1000 classes, bf16,
   ``"xnor_popcount"``): F Bi-Real-Net-18 packed and BN-folded with its
   mean|w| scales (K1, K3: 16 each, three convs at stride 2), G the same
   on ``"xnor"`` (K4 16), H BinaryResNetE18 packed and folded (K1, K3
   16), I XNORNet packed and folded (K1 6, K3 4, K2 2), J RealToBinaryNet
   (K1, K3 16) and K ReActNet-A (K1, K3 31) with latent kernels.
8. Training: ``TrainImageNet`` with QuickNet-Large, 224x224x3, 1000
   classes, bf16, batch 128, ``binary_compute="int8"`` and
   ``pack_residuals=True``. One step from a fixed state (Adam's count at
   1, where the schedule's rate is not 0) must launch K6, K7 and K8 64,
   32 and 32 times, give a finite loss, move the parameters, and give
   the same loss, gradients, parameters, BatchNorm statistics and Adam
   moments bit for bit as the step with the three wrappers swapped for
   their plain versions and as the step with ``pack_residuals=False``.
   Prints the
   step's device time, peak memory with the residuals packed and not,
   the profiler's top device items, and images/s through ``run()``.
   Then Bi-Real-Net-18: K1 and K3 at its 16 convs (batch 8 and 1) and K4
   at slice G's GEMMs, K6 and K7 at its conv inputs' shapes of a
   batch-128 step, each against its plain version; the same training
   step checks with ``model=BiRealNet`` (K6 16, K7 16, K8 0: approx_sign
   keeps its float input). Then ResNet-50 (BASELINE config 5) in bf16
   and fp32 at batch 128 (six steps on one batch, the loss falling; step
   time, peak memory, one step's profile, images/s through ``run()``)
   and ``TrainMnist``
   (config 1: three epochs on the card, the loss falling, steps/s).
   Then the dense zoo: K1, K3 and K4 at each of the 28 binary-conv
   shapes of a batch-8 BinaryDenseNet-28 and MeliusNet-22 forward (N =
   64 over 64 to 512 channels at 56, 28, 14 and 7; read by hooks from a
   forward on the ``meta`` device; K4 per tap where the fused patch
   matrix passes the 32 MiB limit, as the model runs it), K1 and K3 at
   the DenseNet batch-128 training step's shapes (401408 rows at 56x56)
   and K2 at BinaryAlexNet's dense layers at M 128 (the "popc" design,
   beside an unpadded ``torch._int_mm``), each equal to its plain
   version, the same bits twice, timed beside it and its yardstick;
   ``xnor_dense`` under autograd at those dense shapes on the fused,
   "reference" and "xnor" flavors (output and both gradients equal to
   the plain kernels' bit for bit); slices L (BinaryDenseNet-28 packed,
   popcount: K1, K3 23 a forward), M (the same on "xnor": K4 87 at batch
   8, 23 at batch 1), N (MeliusNet-22, latent kernels: K1, K3 34) and O
   (BinaryDenseNet-37-dilated on "mxu": no port kernel) in the serving
   slices above, with ``profile_forward``'s device time and busy share
   for each; BinaryDenseNet-28 trained through ``"xnor_popcount"``
   (batch 128, bf16, Adam under WarmupCosine at 1e-3: K1 23, K3 23 a
   step, bit identity of the step against the plain kernels' from one
   fixed state, step time, peak memory, the loss falling over six steps
   on one batch, the busy share and top items, images/s through
   ``run()``); one BinaryAlexNet popcount step (K1 6, K3 4, K2 2, bit
   identity, step time, peak memory).
9. LM kernels: K9 ``flash_attention`` (bf16 causal at the prefill
   buckets [1, 512, 8, 64] and [1, 2048, 8, 64] and at the long-context
   [4, 8192, 8, 64]; fp32 [1, 512, 8, 64]; ragged s=999; causal=False),
   K12 ``paged_decode_attention`` ([8, 8192, 8, 64] slot caches, lengths
   mixing 0, 1, 15, 16, 2047, 8191 and 9000, bf16 and fp32) and K13
   ``pool_paged_decode_attention`` (a pool of 4096 pages of 16, shuffled
   tables with -1 entries, bf16, fp32 and int8 rows), both at those
   lengths and at the edges of their row split's 256-row chunks, each
   call giving the same bits twice, on two streams at once the bits of
   one call, and taking the "split" design ``decode_variant`` names
   ("wide" past head_dim 256), and K12/K13 again
   at head_dims 20 and 100 (not multiples of 8) and 264 and 384 (past
   256, in chunks), each against its plain
   version (K9 in bf16 within 2^-6 of each output value plus 2e-3, and
   3e-2 overall, 2e-5 in fp32; K12/K13 2e-6 in fp32 and one bf16
   rounding step in bf16), timed beside it and beside SDPA where one
   call computes the same function. The library's
   ``zk_flash_forward_variant`` must send every bf16 K9 shape to the
   tensor-core kernel and fp32 to the FMA one.
10. LM serving: ``LMServingConfig.run()`` streams 32 requests (prompts
   up to 2048 tokens, 64 new tokens each) through a TransformerLM of 4
   layers, d_model 512, 8 heads, vocab 1024, seq_len 8192, bf16, on 8
   slots, three times: the slot layout (K9 + K12), the paged layout
   (K9 + K13) and the paged layout with int8 rows. Each run must launch
   K9 4 times per prefill and K12 or K13 4 times per decode step;
   prints its result line and one decode step's profiler breakdown,
   and holds K12/K13 on a mid-run step's cache, lengths and table to
   their plain versions (one bf16 rounding step, the same bits twice),
   timing them there (K13 in the paged and the paged-int8 run), with
   each wrapper's host time per call (``host_us``).
11. LM parity (deterministic mode): the same model in fp32 serves a
   12-request stream with slot refills through the kernels and through
   the plain functions, in both layouts: the tokens must be identical
   to each other and to ``greedy_decode``. In bf16 the agreeing tokens
   are counted, and a disagreement is allowed only where the plain
   path's top-two logit gap is below 0.05.
12. LM training kernels: K9 with lse (``flash_forward_lse``), K10
   ``flash_backward_dq`` and K11 ``flash_backward_dkv`` at the training
   step's [4, 8192, 8, 64] bf16 causal, at [1, 2048, 8, 64] bf16 and fp32,
   causal and full, at s=999, at head_dims 128 and 32, at the ragged
   bf16 head_dims 40 and 72 and at head_dim 128 full and at s=999, and
   at [1, 1024, 4, 256] and [1, 512, 2, 320] in bf16 and fp32 (past 128,
   in chunks), at bf16 head_dims 20 and 100 (not multiples of 8: the
   tensor-core kernels copy element by element) and with q, k and v
   strided views of one fused [b, s, 3 h d] product (as the model splits
   it), each against
   its plain version: K9's out equal bit for bit to the no-lse K9's, lse
   within 1e-5, gradients per element (fp32: 5e-5 + 5e-5|want|, the JAX
   package's flash-gradient tolerance; bf16: 2^-6|want| + 2^-7
   max|want| per element and 2^-7 of |want| in norm, see ``_grad_use``);
   K10 and K11 called twice must give the same bits; the library's
   ``zk_flash_forward_variant`` and ``zk_flash_backward_variant`` must
   send every bf16 shape of head_dim <= 128 to the tensor-core kernels
   and no other (their registers and spills, from ptxas, are printed
   after the build);
   the fp32 gradients of ``flash_attention`` under autograd
   against the dense oracle's; each timed beside its plain version, its
   bound and SDPA (K10 and K11 together beside SDPA's backward).
13. LM training: ``TrainLM`` (the long-context line of
   examples/lm_experiment.py: 4 layers, d_model 512, 8 heads of 64,
   seq_len 8192, batch 4, vocab 1024, bf16) through ``run()`` for 8
   steps and one validation batch. Each step must launch K9-lse, K10 and
   K11 4 times and no other kernel, the eval only the no-lse K9; the
   loss must be finite and fall from the first step to the last. Prints
   the step's device and host time, tokens/s, busy share, peak memory
   and profile. Before it, one fp32 step (2 layers, [2, 2048]) through
   the kernels must match the same step through their plain versions
   (loss within 1e-5 relative, each gradient within 1e-4 of its largest
   magnitude), and so must one bf16 step (the same shape, through the
   tensor-core K10/K11: loss within 2^-7 relative, each gradient within
   2^-6 of its norm in norm, see ``_bf16_step_use``).
14. Head_dim 256: TransformerLM with d_model 1024 and 4 heads (2 layers,
   seq_len 2048, bf16) serves 6 requests through
   ``LMServingConfig.run()`` in the slot and paged layouts (2 K9 per
   prefill, 2 K12/K13 per decode step) and takes one training step
   (2 K9-lse, 2 K10, 2 K11).
15. The binary-net recipe (DistillImageNet's geometry: 224x224x3, 1000
   classes, bf16, batch 128): ``TrainImageNet`` trains a ResNet-50 teacher
   for 2 steps and exports it; ``DistillImageNet`` distills a
   RealToBinaryNet on "xnor_popcount" from it for 3 steps through
   ``run()`` (Bop with Adam under WarmupCosine at 2.5e-3 on the fp side,
   alpha 0.4, temperature 2, the flip ratio, EMA 0.999,
   ``nan_policy=skip``) and exports it: K1 and K3 16 times a step, the
   loss, ``kd_loss`` and ``flip_ratio`` of each step. From one fixed state
   (one warm step in): the step equal bit for bit to the step through the
   plain kernels (metrics, gradients, parameters, statistics, EMA, Bop's
   memory and count, Adam's moments and count), and remat "full", "dots"
   and "quant" each equal to "none" (their K1/K3 launches doubled by the
   recompute); a batch holding a NaN leaves every state tensor as it was
   (``skipped_steps`` 1), and under "halt" ``DistillImageNet`` raises
   ``NonFiniteLossError``. Then the step's device and host time, busy
   share, the teacher's forward, each remat policy's peak memory and time,
   the step without and with each of the EMA, the flip ratio and the NaN
   guard; ``EvalExperiment`` on the export (weights "auto") equal to
   ``make_eval_step(use_ema=True)`` on the final state; and
   ``ServingConfig`` serving the export (16 requests, K1 and K3 16 a
   forward), its logits equal bit for bit to an engine bound to the EMA
   weights directly, images/s and p50/p99. K1 and K3 also at the
   student's 16 conv shapes of the batch-128 step, against their plain
   versions.
16. Checkpoint and resume (deterministic mode where bits are compared):
   QuickNet-Large's TrainImageNet step (int8, packed residuals, batch
   128, bf16) for 6 steps of one epoch, uninterrupted twice (their
   spread); then saved every 2 steps and killed under
   ``run_with_recovery``: mode sync with ``FaultPlan(kill_at_step=3)``
   (Preempted once, steps 2 and 3 on disk, resumed at start_batch 3);
   mode async with ``kill_during_async_write=4`` and the process dying
   at step 5 (step 2 on disk beside step 4's remnant, resumed from step
   2); mode async killed at step 3 (the preemption drains the writer).
   Each ends equal to the uninterrupted run in every tensor (parameters,
   statistics, Adam's moments and count, the step), K6, K7 and K8
   launched 64, 32, 32 a step on both sides of the resume. Then the
   checkpoint's bytes, the sync save, the async snapshot's stall on the
   training thread and its write, the restore, and the step with async
   saves every 2 steps against none. At a smaller depth the same for the
   recipe student (RealToBinaryNet, one block a section: K1 and K3 4 a
   step; Bop + Adam, EMA, flip ratio, ``nan_policy=skip`` with a NaN at
   step counter 4, a seeded ResNet-50 teacher's export) and TrainLM (2
   layers: K9-lse, K10, K11 2 a step); ``EvalExperiment`` and
   ``ServingConfig`` on the recipe run's directory give the metrics and,
   bit for bit, the logits of the same state's export (K1, K3 4 a
   forward).
17. The example tasks and the tools around a run (deterministic mode
   where bits are compared): ``TrainCifar`` at its own width (BinaryNet
   (128, 128, 256, 256) + (512,), batch 128, pad-and-crop by 4, Adam; no
   port kernel: its convs train on "mxu") for one epoch of 8 steps with
   a ``JsonlMetricsWriter`` (its epoch line equal to ``run()``'s
   metrics), ``profile_dir`` (the window's ``op_time_breakdown`` printed
   and held within 10% of one traced step's busy time, with the same
   leading kernels) and ``export_model_to``; the same 8 steps from a
   ``MemmapDataset`` store of the same splits (written in chunks) equal
   in every tensor and every step's metrics; ``ConvertPacked`` of the
   export to the "xnor" twin (K4) and the popcount twin (K1, K3, K2; its
   float side on the same popcount path) at ``verify_atol=0``, and to the
   BN-folded dense-stage twins (K4; K1, K2) at 1e-4, each probe on the
   card through those kernels, the ones-padded popcount twin of the
   "mxu" model refused at 0; ``LatencyBench`` on each export at batch 1
   and 8; ``ServingConfig`` on the "xnor" export (16 requests), its
   logits equal to ``EvalExperiment``'s forward bit for bit. Then
   ``TrainDigits`` -> ``ServeDigits`` -> ``LatencyBench`` on real digits
   when scikit-learn imports (served accuracy equal to
   ``EvalExperiment``'s), else one line saying so.
18. The fused loop (``unroll_phase``): first what counts on the card must
   reproduce, a division by a host float (a product by its float32
   reciprocal on the card, which ``optimizer._foreach_div`` matches for a
   0-d divisor) and the host's bias corrections (the table's values; the
   card's ``torch.pow`` counted where it differs); then ``TrainImageNet`` (QuickNet-Large,
   batch 128, bf16, int8 + packed residuals, Adam under WarmupCosine:
   K6-K8), ``DistillImageNet`` (the recipe at full width from a seeded
   ResNet-50 teacher: K1 + K3) and ``TrainLM`` (2 layers, seq 8192, d 512,
   8x64, batch 4, bf16: K9-lse, K10, K11), each 14 steps at ``unroll`` 4
   (slabs of 4, 4, 4, 2: an eager warm-up slab, then two replays of the
   4-step CUDA graph and one of the 2-step graph) against the eager loop
   on the same seed and batches, in deterministic mode: every per-step
   metric and every state tensor equal bit for bit; the kernels' launches
   the eager run's, and the warm-up slab's plus each graph's captured
   launches times its replays; the profiler's kernels over two replays
   the graph's captured ones (a window short of them, as the profiler
   can lose records, is taken again, up to 3) (and, for the LM, the
   experiment's
   ``profile_dir`` window over whole slabs finds K9-K11); then, in the
   default settings, the eager step's and the fused loop's wall ms per
   step (``measure_fused_loop_time``), the fused loop's busy ms and share
   from that profiler window, capture seconds and peak memory of both
   runs. Then
   ``TrainImageNet``'s input pipeline: the native library must build and
   engage on the card's host, its batches equal the per-example path's
   bit for bit, and ``run()``'s examples/s (epoch 2 of 2, unroll 4) with
   the native and the per-example assembly at ``prefetch`` 1 and 2.
19. Data and sequence parallelism (``parallel_phase``, deterministic
   mode where bits are compared): ``TrainLM`` at full width (4 layers,
   seq 8192, d 512, 8x64, batch 4, bf16), 3 steps with no validation,
   through ``run()``: (a) with no group (the default
   ``DataParallelPartitioner`` at world size 1); then
   ``initialize_distributed`` forms a world-size-1 NCCL group on the card
   (backend printed, one all-reduce checked) and (b) the same run under
   ``DataParallelPartitioner`` must equal (a) in every state tensor and
   loss bit for bit; ``SequenceParallelPartitioner sp=1`` ring-flash (the
   slice's main path: K9-lse, K10 and K11 counted from 0 around the run,
   LM_LAYERS each per step) and Ulysses flash must meet (a) within the
   LM step's bf16 limits (losses 2^-7 relative, each weight 2^-6 of its
   norm). (c) The sp=4 ring composed in one process from
   ``ring_flash_step`` on [4, 8192, 8, 64] bf16 causal shards of 2048,
   forward and backward (the merge gives K10/K11 a nonzero lse
   cotangent), against ``flash_attention`` over the whole sequence: the
   output and each of the q/k/v gradients within 2^-6 |want| + 2^-7
   max|want| per element and 2^-7 of the reference's norm as a whole
   (``_grad_use``'s bf16 limits), which the same ring with each
   block's lse cut from the graph must fail; 10 K9-lse, 10 K10 and 10
   K11 (4 diagonal and 6 past blocks), timed beside the whole-sequence
   call.
   The overlap schedule's rotations run only across ranks, so it is
   checked by the CPU tests over gloo, not here. (d) K9-lse, K10
   and K11 at the ring's shard shape [4, 2048, 8, 64] bf16, causal (the
   diagonal block) and full (a past block), K10/K11 with ``D' = D -
   dlse`` for a random dlse, each held to its plain version and timed
   beside it, its bound and SDPA.
20. Sharded parameters (``sharded_phase``, deterministic mode where bits
   are compared): (a) on a world-size-1 NCCL group, ``FsdpPartitioner
   (min_weight_size=1)`` and a ``(1, 1)`` data x model
   ``MeshPartitioner`` (``transformer_tp_rules`` / ``conv_model_tp_rules``)
   on ``TrainLM`` at phase 19's width (3 steps) and on ``TrainImageNet``
   (QuickNet-Large, batch 128, int8, packed residuals, 5 steps), and
   ``SequenceParallelPartitioner tp=1 sp=1``, each through ``run()``:
   every state tensor and loss equal bit for bit to the run with no
   group, the same launches (K9-lse, K10, K11 4 a step; K6, K7, K8 64, 32,
   32), the step's device ms and peak memory beside the no-group run's;
   the TP TrainLM again at ``unroll`` 4 (8 steps: the collectives
   captured in a CUDA graph) against the no-group run at ``unroll`` 4.
   (b) tp=4 composed in one process: K9-lse, K10 and K11 on each rank's
   heads [4, 8192, 2, 64] equal the same heads of the whole call bit for
   bit (each shard's ms beside the whole call's ms / 4); a TrainLM block
   whose four ranks' shards the port's own plan builds (head-aligned
   ``qkv``), forward and backward with the row-parallel outputs summed in
   rank order, within the bf16 limits (``_grad_use``) of the whole block
   (4 K9-lse, 4 K10, 4 K11). (c) A QuickNet-Large binary conv (int8,
   packed residuals, [128, 14, 14, 256]) at tp=4 composed: each rank's
   output channels equal the whole layer's bit for bit, K6-K8 launched
   per rank; its kernel gradient (cuDNN's, whose algorithm follows the
   channel count) and the summed input gradient within the bf16 limits,
   the kernel gradients' bits counted.
21. Serving under partitioners (``served_sharded_phase``, deterministic
   mode where bits are compared): (a) with no group, then on a
   world-size-1 NCCL group, ``LMServingConfig`` at phase 10's model (4
   requests x 8 tokens, prompts up to 512) in the slot, paged and
   paged-int8 layouts under ``FsdpPartitioner(min_weight_size=1)``, a
   ``(1, 1)`` data x model ``MeshPartitioner`` with ``transformer_tp_rules``
   and ``SequenceParallelPartitioner sp=1 tp=1``: the tokens equal the run
   with no group bit for bit with the same K9/K12/K13 launches (each
   run's median decode step ms printed beside the no-group run's);
   ``ServingConfig`` on slices A and B (4 requests) under
   ``DataParallelPartitioner`` and the (1, 1) mesh with
   ``conv_model_tp_rules``: a batch-8 request's logits and the K1/K3/K4
   launches equal the run with no group's; ``TrainLM`` (phase 19's width)
   2 steps under the (1, 1) TP mesh exports, and ``LMServingConfig``
   under TP serves the export: the tokens equal serving it with no group.
   (b) Composed in one process: K12, K13 and K13 on int8 rows at phase
   10's decode geometry on each of 4 ranks' head shards [8, 1, 2, 64]
   and on each rank's [4, 1, 4, 64] block of a dp=2 x tp=2 mesh, each
   equal to the whole call's block bit for bit; K3 and K4 on each
   co / 4 block of every QuickNet-Large conv shape at batch 8 (blocks of
   16 to 128 channels), each equal to the whole call's channels bit for
   bit; each shard's ms beside the whole call's ms / 4, its bound, its
   plain version and its library call.
22. The decode engine's serving features (``features_phase``):
   phase 10's stream (32 requests) through ``LMServingConfig.run()`` on
   the paged layout at its defaults (the radix prefix cache on), K9 4 a
   cold prefill dispatch and K13 4 a decode step; then at phase 10's
   model (bf16, the kernels on): (a) 32 requests sharing a 1536-token
   prefix with seeded 1-512-token suffixes, then 32 sharing a 1537-token
   one (copies forced), served cold (``prefix_cache=False``) and warm:
   TTFT and prefill-dispatch p50/p99 of each, the hit rate, the copies,
   no leaked page, and K9 launched only by the cold prefills; (b) a
   2048-token prompt arriving while 7 streams decode, with
   ``prefill_chunk_tokens=512`` and without: the 7 streams' inter-token
   p50/p99/max; (c) ``LMServingConfig.run()`` (16 requests of up to 512
   tokens, 32 new) plain, then with ``speculative.k=4`` and a fresh
   1-layer draft, then with the teacher's own export (written to a
   temporary directory) as the draft: tokens/s, the acceptance rate,
   ``speculative`` true, the share of tokens equal to the plain run's,
   and each engine's K9/K12/K13 launches; (d) deterministic fp32 at
   phase 11's model: warm = cold, chunked = monolithic, speculative
   (the teacher as its draft, and a fresh 1-layer draft) = plain greedy
   tokens; (e) on a world-size-1 NCCL group under FSDP and the (1, 1)
   mesh with ``transformer_tp_rules``: a warm, chunked, speculative run's
   tokens and launches equal the run with no group's bit for bit.
23. Per-host sharded checkpoints and group recovery (``group_phase``,
   deterministic mode where bits are compared): ``TrainLM`` at the LM
   training width with 2 layers (K9-lse, K10, K11 2 each a step), 24
   steps at ``unroll`` 4. (b) Uninterrupted once; then as host 0 of a
   2-host ``FileCoordinator`` group under ``run_with_recovery(
   coordinator=...)``, a stub thread as host 1 starting a drain at step
   0: host 0 stops at 0 + the margin 16, saved, restarts once, resumes,
   and ends on the uninterrupted run's bits, the kernels launched 24
   steps x 2 layers each. (a) Two ``Checkpointer``s as hosts 0 and 1
   (``process_count=2``) save the trained state on the card, commit,
   and restore it bit for bit into fresh states; a ``fail_host_finalize``
   step stays invisible and both walk back; each host's bytes and write
   ms, the commit ms and the restore ms (split into the npz reads, the
   agreement's rounds, the load into the state and the rest; beside one
   thread's read of a host's file alone and bare exchange rounds) beside
   the bare layout's save and restore of the same state. (c) The wall ms
   a step (epochs 2-9 of three runs each, graph replays) with a 2-host
   coordinator wired and no flag, against none, as medians and quartiles;
   and one ``poll_flags`` of the boundary alone.
24. Disaggregated prefill/decode and hot weight swaps (``disagg_phase``,
   deterministic mode where bits are compared): (a)
   ``DisaggServingConfig.run()`` on phase 10's model and stream (32
   requests x 64 tokens; the prefill role 4 lanes batched (1, 2, 4) wide,
   the decode role 8 slots; both on the one card, the overlap flagged,
   and a line saying that disjoint roles need two cards) with bf16 and
   int8 rows: K9 4 a prefill dispatch of the prefill role and none on the
   decode role, K13 4 a decode step of the decode role and none on the
   prefill role, one handoff a request, both pools leak-free; its TTFT,
   inter-token and step p50/p99 beside ``LMServingConfig``'s paged engine
   on the same stream, with the share of equal tokens and the first
   position where they diverge. (b) One 2048-token prompt's 128 pages
   moved alone 20 times by the direct copy and through host memory: the
   moved pages equal the source's bit for bit, ms p50/p99, bytes and
   GB/s. (c) fp32 at phase 22 (d)'s model and prompts: the
   disaggregated tokens equal the single paged engine's, plain and with
   a fresh 1-layer draft on the decode role (K12); ``fail_page_transfer=1``
   fails one victim, ``prefill_role_crash_at=2`` the prefill side's
   streams, the survivors' tokens equal, both pools leak-free; a swap
   staged mid-stream keeps the 4 in-flight streams on the old weights and
   the rest on the new (their tokens the single engine's on them, one
   checked against ``greedy_decode``). (d) A staged swap of
   ``LMServingConfig`` (paged, bf16) with no group, then under FSDP and
   the (1, 1) TP mesh on a world-size-1 NCCL group: equal bit for bit,
   the same launches. (e) ``ServingConfig(watch=True)`` on slice A
   (packed QuickNet-Large, K1 + K3 32 each a forward) over a
   ``Checkpointer`` directory that gains a step between the halves of 8
   requests: the step is swapped in (load + placement ms), no bucket
   warmed again, and the answers equal a cold load of the step bit for
   bit. (f) ``serving_worker_crash`` on an async ``MicroBatcher`` and
   ``decode_worker_crash`` on an async ``DecodeScheduler``: the request
   fails, the next submit serves on a restarted worker.
25. Observability on both serving paths (``obs_phase``; deterministic
   mode where bits are compared): (a) phase 10's model and stream (32
   requests x 64 tokens, paged) through ``LMServingConfig`` built twice,
   with everything off and with ``metrics_port=0``, a flight recorder and
   tracing on: ``/metrics`` and ``/statusz`` scraped over HTTP while the
   stream is served and after; the tokens equal bit for bit and K9 and K13
   launched equally; every exposition line valid and every ``zk_decode_*``
   series (and the ``zk_spec_*``, ``zk_prefill_*``, ``zk_kv_pool_*``,
   ``zk_transfer_*`` and ``zk_hbm_*`` families) present; ``0 <
   zk_decode_mbu <= 1.05``; ``0 < zk_hbm_bytes_in_use <= zk_hbm_bytes_limit
   = torch.cuda.mem_get_info()[1]``; ``/statusz["programs"]`` one row per
   warmed program; ``zk_serving_recompiles_total`` 0. (c) Tokens/s and
   inter-token p50/p99 of three runs each, off and on in turns (printed,
   no threshold). (d) ``FaultPlan.decode_worker_crash`` mid-stream with
   the recorder armed: exactly one bundle, whose RequestLog tail carries
   the victims' rids as "crashed" and whose trace ring carries the same
   rids. (b) Slice A (K1 + K3) through ``ServingConfig`` off and with
   ``metrics_port=0``: the answers equal bit for bit, K1/K3 launched
   equally, ``0 < zk_serve_mfu_int8 <= 1.05`` and ``zk_serve_mfu`` too.
   (e) One batch-8 forward of slice A's module on a warmed engine whose
   bucket 8 was dropped from its cache of run programs (a private seam):
   the recompile counter reads 1 and one ``recompile_detected`` bundle
   is written.
26. Observability on the training paths (``obs_train_phase``;
   deterministic mode where bits are compared): (a) ``TrainLM`` at phase
   13's full width (4 layers, 8 steps, no validation) with async saves
   every 4 steps, run with everything off and with ``trace_export``,
   ``metrics_port=0``, a flight recorder and ``log_every=1``: the final
   states equal bit for bit, K9-lse, K10 and K11 launched 32 times each
   in both runs; ``/metrics`` and ``/statusz`` scraped over HTTP at each
   save, every exposition line valid, ``zk_train_step_time_ms > 0``,
   ``0 < zk_train_mfu <= 1.05``, ``zk_prefetch_occupancy``,
   ``zk_train_steps_total``, ``zk_ckpt_queue_depth`` and ``zk_hbm_*``
   served, ``/statusz["programs"]`` one ``train_step`` row; the exported
   trace holds ``data_wait``, ``dispatch``, ``readback`` and
   ``checkpoint`` spans and a ``ckpt_write`` span and ``ckpt_finalized``
   event a save; the ``train_step`` watchdog counts no anomaly. (c) The
   same run's step time (the median of its readback-to-readback steps at
   ``log_every=1``), three runs a side in turns (printed, no threshold),
   and the ``torch.profiler`` counts of three steady iterations' host
   operators and device events (one profiler, a warm-up iteration before
   each window), off and on: each event's largest count over the three
   windows, host-to-device copies apart (the prefetch thread's land in
   any window), equal off and on, device-to-host copies and fills
   included. (b) Phase 18's
   QuickNet-Large leg (int8, packed residuals, batch 128) at ``unroll``
   4 over 12 steps, off and on: the states equal bit for bit, K6-K8
   launched equally, one ``multi_step`` ledger row of 4 steps,
   ``zk_train_mfu`` and ``zk_train_mfu_int8`` in (0, 1.05]. (d) A
   2-layer ``TrainLM`` with ``nan_policy=halt`` under ``FaultPlan(
   nan_at_step=3)`` and ``run_with_recovery``, the recorder armed: one
   restart, exactly one ``nan_halt`` and one ``supervisor_restart``
   bundle, and the trace ring holds ``fault_injected{kind=nan_at_step}``
   and ``restore_done``.
27. Serving under overload and across replicas (``guard_fleet_phase``):
   (a) phase 10's LM (paged, no prefix cache) behind an async
   ``DecodeScheduler``: a seeded ``loadgen.poisson_burst`` trace of 64
   requests (prompts 64-2048 tokens, 64 new) replayed open-loop with the
   guard off gives the sustained rate, the reference tokens and the
   median per-request service time; the same requests, their rates scaled
   to 0.5x and 3x the sustained rate, are replayed at ``time_scale=1.0``
   through ``LMServingConfig`` with ``guard.enabled``, ``brownout_after``
   4, ``brownout_release`` 16 and ``default_deadline_ms`` 6x the service
   time: at 0.5x nothing is shed or late and the tokens equal the
   reference; at 3x some are shed, every request is terminal, each
   finished stream's tokens equal the reference; the brown-out engages,
   is applied at the drain and is released by 17 admissions into the
   empty queue (the first capped at 8 tokens, a prefix of the
   reference, the last whole); K9 = 4 x the prefill dispatches and K13 =
   4 x the decode steps; the pool's pages all free. Each run's
   ``SLOReport`` (TTFT and latency p50/p99, goodput, outcomes) is
   printed. (b) Two worker processes on the card (``spawn_fleet_workers``
   through ``python chip_smoke.py --fleet-worker``, which also writes each
   worker's K9/K13 launches and dispatch counts), the prefix cache on,
   behind a ``FleetRouter`` under affinity: a ``session_mix`` trace (4
   sessions x 3 turns, a 1024-token shared prefix, 128 tokens a turn, 32
   new) all ok, >= 8 affinity hits, every later turn warm, the tokens
   equal an in-process ``LMServingConfig`` oracle's that serves each
   replica's requests in its order (so each takes its warm or cold path).
   (c) The kill leg on (b)'s fleet: ``fleet_replica_kill_at=5`` SIGKILLs
   a worker; every request terminal, the retried ones equal the oracle,
   the victim's breaker open, the survivor's pages free or the prefix
   cache's. The gray leg on a fresh fleet under round-robin whose w0
   stalls its first forward 1.5 s (``delay_forward_ms``): w0 stays
   healthy, its breaker opens, one half-open probe, closed; the tokens
   equal the affinity run's and the oracle's. Counted from the end of its
   warm-up, each worker's K9 = 4 x its prefills and K13 = 4 x its decode
   steps, at least one of them where it served a request; a worker that
   served none launched and dispatched nothing.
28. One JSON line of the kernels (14 rows; K1, K3, K4, K6 and K7 also
   with their sums on Bi-Real-Net's path under ``bireal``; K1, K3 and K4
   under ``densenet`` and ``melius``, K1 and K3 under ``xnor_train`` per
   DenseNet training step, K2 under ``xnor_train`` per BinaryAlexNet
   step, K1 and K3 under ``recipe`` per distillation step; K1, K3, K6-K11
   under ``checkpoint``, their launches over the killed-and-resumed
   runs; K1-K4 under ``cifar``, their launches on each path of phase
   17; K1, K3, K6-K11 under ``unroll``, phase 18's launches, graphs and
   step times; K9-lse, K10 and K11 under ``parallel``, phase 19's
   launches on the sequence-parallel run and in the composed ring, and
   their times at the ring's shard shapes; K6-K11 under ``sharded``,
   phase 20's launches and step times, and K9-lse/K10/K11's head-shard
   times; K1, K3, K4, K9, K12 and K13 under ``served_sharded``, phase 21's
   launches and the block times; K9, K12 and K13 under ``features``,
   phase 22's launches on each path; K9-lse, K10 and K11 under ``group``,
   phase 23's launches in the supervised run; K9, K12 and K13 under
   ``disagg``, phase 24's launches on each path, and K1 and K3 under
   ``hot_swap``, its watched service's; K9, K13, K1 and K3 under ``obs``,
   phase 25's launches with observability off and on; K6-K11 under
   ``obs_train``, phase 26's; K9 and K13 under ``guard_fleet``, phase 27's
   guarded service's and each worker's), then the result line.
"""

import contextlib
import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Peak rates of an H100 SXM (NVIDIA data sheet, dense): HBM bytes/s, and
#: int8 tensor-core ops/s (the binary +-1 products are counted at the
#: int8 rate, the cheapest type that computes them on tensor cores) and
#: fp32 ops/s outside the tensor cores (K1's compares).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12
#: bf16 tensor-core products (the flash forward in bf16).
BF16_OPS_PER_S = 989e12

#: The rate each kernel's operations are counted at (the residual
#: kernels: one fp32 compare or multiply per value).
OPS_RATE = {
    "pack_rows": FP32_OPS_PER_S,
    "conv_gemm_popcount": INT8_OPS_PER_S,
    "packed_weight_matmul": INT8_OPS_PER_S,
    "pack_resid": FP32_OPS_PER_S,
    "unpack_resid_pm1": FP32_OPS_PER_S,
    "mask_mul_resid": FP32_OPS_PER_S,
    # The decode kernels' vector products, and the flash forward in
    # fp32, count at the fp32 rate; the flash forward in bf16 at the
    # bf16 tensor-core rate (``bound_ms``'s ``rate`` argument).
    "flash_forward": FP32_OPS_PER_S,
    "paged_decode_attention": FP32_OPS_PER_S,
    "pool_paged_decode_attention": FP32_OPS_PER_S,
    # The flash backward, like the forward: bf16 calls at the bf16
    # tensor-core rate, fp32 calls at the fp32 rate.
    "flash_forward_lse": FP32_OPS_PER_S,
    "flash_backward_dq": FP32_OPS_PER_S,
    "flash_backward_dkv": FP32_OPS_PER_S,
    # The popcount GEMMs' +-1 products, like K3's, at the int8 rate.
    "xnor_matmul_packed": INT8_OPS_PER_S,
    "xnor_matmul_packed_scaled": INT8_OPS_PER_S,
}

#: Each kernel's source and the TPU kernel it replaces.
KERNELS = {
    "pack_rows": ("pack_rows.cu", "zookeeper_tpu/ops/binary_compute.py:527"),
    "conv_gemm_popcount": ("conv_gemm_popcount.cu", "zookeeper_tpu/ops/binary_compute.py:938"),
    "packed_weight_matmul": ("packed_weight_matmul.cu", "zookeeper_tpu/ops/binary_compute.py:745"),
    "pack_resid": ("resid_pack.cu", "zookeeper_tpu/ops/binary_compute.py:204"),
    "unpack_resid_pm1": ("resid_pack.cu", "zookeeper_tpu/ops/binary_compute.py:236"),
    "mask_mul_resid": ("resid_pack.cu", "zookeeper_tpu/ops/binary_compute.py:264"),
    "flash_forward": ("flash_forward.cu", "zookeeper_tpu/ops/attention.py:1163"),
    "paged_decode_attention": ("decode_attention.cu", "zookeeper_tpu/ops/attention.py:222"),
    "pool_paged_decode_attention": ("decode_attention.cu", "zookeeper_tpu/ops/attention.py:503"),
    "flash_forward_lse": ("flash_forward.cu", "zookeeper_tpu/ops/attention.py:1163"),
    "flash_backward_dq": ("flash_backward.cu", "zookeeper_tpu/ops/attention.py:1474"),
    "flash_backward_dkv": ("flash_backward.cu", "zookeeper_tpu/ops/attention.py:1492"),
    "xnor_matmul_packed": ("xnor_gemm.cu", "zookeeper_tpu/ops/binary_compute.py:351"),
    "xnor_matmul_packed_scaled": ("xnor_gemm.cu", "zookeeper_tpu/ops/binary_compute.py:600"),
}
XNOR_KERNELS = ("xnor_matmul_packed", "xnor_matmul_packed_scaled")
LM_KERNELS = ("flash_forward", "paged_decode_attention", "pool_paged_decode_attention")
LM_TRAIN_KERNELS = ("flash_forward_lse", "flash_backward_dq", "flash_backward_dkv")
RESID_KERNELS = ("pack_resid", "unpack_resid_pm1", "mask_mul_resid")

#: QuickNet-Large at batch 8, 224x224: per section (binary convs, spatial
#: size, channels).
SECTIONS = ((6, 56, 64), (8, 28, 128), (12, 14, 256), (6, 7, 512))
BATCH = 8
#: The training step's batch, and K6, K7, K8 launches per binary conv.
TRAIN_BATCH = 128
RESID_PER_CONV = {"pack_resid": 2, "unpack_resid_pm1": 1, "mask_mul_resid": 1}
#: Synthetic ImageNet examples generated for the training phase: three
#: batches (the model is not cut; only the dataset is).
TRAIN_EXAMPLES = 3 * TRAIN_BATCH

#: The classifier-serving slices: ServingConfig settings, and the binary
#: kernels each forward must launch, by batch bucket. A and B serve
#: QuickNet-Large (32 binary convs); C serves BinaryAlexNet packed
#: throughout (K1 before each of its 4 binary convs and 2 binary dense
#: layers, K3 in each conv, K2 in each dense layer; no fold: its conv
#: BNs follow a maxpool); D BASELINE's BinaryAlexNet deployment ("mxu"
#: convs, the packed "xnor" dense stage with its BNs folded: K4 in each
#: dense layer); E BinaryNet (default widths) on the "reference" flavor:
#: one K5 per fused conv and dense layer, and 9 per-tap K5 for the first
#: binary conv at batch 8, whose fused patch matrix (8192 x 9 x 128 x 4
#: B = 37.7 MB) is over the 32 MiB fusion limit.
IMAGENET = {"height": 224, "width": 224, "channels": 3, "num_classes": 1000}
SLICES = {
    "A": ({"model": "QuickNetLarge", "model.compute_dtype": "bfloat16",
           "model.binary_compute": "xnor_popcount", "model.packed_weights": True,
           "model.fold_bn": True, "model.binary_flavor": "auto", **IMAGENET},
          lambda bucket: {"pack_rows": 32, "conv_gemm_popcount": 32}),
    "B": ({"model": "QuickNetLarge", "model.compute_dtype": "bfloat16",
           "model.binary_compute": "xnor", "model.packed_weights": True,
           "model.fold_bn": True, "model.binary_flavor": "auto", **IMAGENET},
          lambda bucket: {"packed_weight_matmul": 32}),
    "C": ({"model": "BinaryAlexNet", "model.compute_dtype": "bfloat16",
           "model.binary_compute": "xnor_popcount", "model.packed_weights": True, **IMAGENET},
          lambda bucket: {"pack_rows": 6, "conv_gemm_popcount": 4,
                          "xnor_matmul_packed_scaled": 2}),
    "D": ({"model": "BinaryAlexNet", "model.compute_dtype": "bfloat16",
           "model.binary_compute": "mxu", "model.dense_binary_compute": "xnor",
           "model.dense_packed_weights": True, "model.fold_bn": True, **IMAGENET},
          lambda bucket: {"packed_weight_matmul": 2}),
    "E": ({"model": "BinaryNet", "model.compute_dtype": "float32",
           "model.binary_compute": "xnor_popcount", "model.packed_weights": True,
           "model.binary_flavor": "reference",
           "height": 32, "width": 32, "channels": 3, "num_classes": 10},
          lambda bucket: {"xnor_matmul_packed": 15 if bucket == BATCH else 7}),
}
#: The ResNet-topology zoo's slices, all 224x224x3, 1000 classes, bf16,
#: "xnor_popcount" unless named: F Bi-Real-Net-18 packed and BN-folded
#: (its mean|w| scales; K1 + K3 in each of its 16 binary convs, three at
#: stride 2); G the same on "xnor" (K4 in each); H BinaryResNetE18 packed
#: and folded; I XNORNet packed and folded (K1 before each of its 4 binary
#: convs and 2 binary dense layers, K3 in each conv, K2 in each dense
#: layer); J RealToBinaryNet and K ReActNet-A with latent kernels packed at
#: each call (ReActNet: 13 binary 3x3 convs and 18 binary 1x1 convs).
ZOO = {"model.compute_dtype": "bfloat16", "model.binary_compute": "xnor_popcount", **IMAGENET}
SLICES.update({
    "F": ({"model": "BiRealNet", **ZOO, "model.packed_weights": True, "model.fold_bn": True},
          lambda bucket: {"pack_rows": 16, "conv_gemm_popcount": 16}),
    "G": ({"model": "BiRealNet", **ZOO, "model.binary_compute": "xnor",
           "model.packed_weights": True, "model.fold_bn": True},
          lambda bucket: {"packed_weight_matmul": 16}),
    "H": ({"model": "BinaryResNetE18", **ZOO, "model.packed_weights": True,
           "model.fold_bn": True},
          lambda bucket: {"pack_rows": 16, "conv_gemm_popcount": 16}),
    "I": ({"model": "XNORNet", **ZOO, "model.packed_weights": True, "model.fold_bn": True},
          lambda bucket: {"pack_rows": 6, "conv_gemm_popcount": 4,
                          "xnor_matmul_packed_scaled": 2}),
    "J": ({"model": "RealToBinaryNet", **ZOO},
          lambda bucket: {"pack_rows": 16, "conv_gemm_popcount": 16}),
    "K": ({"model": "ReActNet", **ZOO},
          lambda bucket: {"pack_rows": 31, "conv_gemm_popcount": 31}),
})
#: Bi-Real-Net-18's binary convs at 224x224: (convs, input size, channels
#: in, out, stride). Each section's first conv past the first section
#: halves the size (56 -> 28, 28 -> 14, 14 -> 7).
BIREAL_CONVS = ((4, 56, 64, 64, 1), (1, 56, 64, 128, 2), (3, 28, 128, 128, 1),
                (1, 28, 128, 256, 2), (3, 14, 256, 256, 1), (1, 14, 256, 512, 2),
                (3, 7, 512, 512, 1))
#: Its binary convs' inputs in a training step by shape: (convs, size,
#: channels), where K6 packs each (sign mode) and K7 unpacks it.
BIREAL_RESID = ((5, 56, 64), (4, 28, 128), (4, 14, 256), (3, 7, 512))
BIREAL_TRAIN = {"pack_resid": 16, "unpack_resid_pm1": 16}
#: Slice E's fused-flavor twin: K1 + K3 in its 5 binary convs, K1 + K2 in
#: its 2 dense layers.
E_AUTO = {"pack_rows": 7, "conv_gemm_popcount": 5, "xnor_matmul_packed_scaled": 2}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


@contextlib.contextmanager
def deterministic(torch):
    """Deterministic algorithms for the calls inside, so that two runs of
    the same work can be held to bit equality; the settings before are
    restored after."""
    cudnn = torch.backends.cudnn
    saved = (torch.are_deterministic_algorithms_enabled(), cudnn.deterministic,
             cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        cudnn.deterministic, cudnn.benchmark = saved[1], saved[2]


def bound_ms(name: str, nbytes: float, ops: float, rate: float = None):
    """(least time in ms, "bytes" or "operations") for the work, its
    operations at ``rate`` (default: the kernel's ``OPS_RATE``)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / (rate or OPS_RATE[name]) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def time_ms(torch, fn, reps: int = 21, inner: int = 10) -> float:
    """Median device time of one call, over ``reps`` runs of ``inner``
    back-to-back calls. A device-side sleep first lets the host queue
    the calls ahead of the card, so the events time the card, not the
    host's launch rate."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _binary_totals():
    """Empty per-kernel totals of K1, K3 and K4 (K1 has no library call)."""
    totals = {
        name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
               "ops": 0.0, "max_abs_err": 0.0}
        for name in ("pack_rows", "conv_gemm_popcount", "packed_weight_matmul")
    }
    totals["pack_rows"]["library_ms"] = None
    return totals


def _recorder(torch, totals, plain_reps: int = 21, plain_inner: int = 2, log=None):
    """``record(name, count, kernel, plain, library, nbytes, ops, shape)``:
    check a kernel call equal to its plain version and the same bits on a
    second call, time it beside its plain version (``plain_reps`` runs of
    ``plain_inner`` calls) and the library call, print the row and add
    ``count`` launches of it to ``totals``; ``log`` (a list) gets
    ``(name, kernel ms, plain ms, library ms, bytes, ops)`` of each row.
    Returns the kernel's time."""

    def record(name, count, kernel, plain, library, nbytes, ops, shape):
        with deterministic(torch):
            got, want = kernel(), plain()
            again = kernel()
            torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
        check(torch.equal(got, want),
              f"{name} at {shape} disagrees with its plain version (max err {err})")
        check(_same_bits(torch, got, again), f"{name} at {shape}: two calls differ")
        k_ms = time_ms(torch, kernel)
        p_ms = time_ms(torch, plain, reps=plain_reps, inner=plain_inner)
        l_ms = time_ms(torch, library) if library is not None else None
        b_ms, b_by = bound_ms(name, nbytes, ops)
        if log is not None:
            log.append((name, k_ms, p_ms, l_ms, nbytes, ops))
        print(f"kernel {name} {shape}: equal, kernel {k_ms:.6f} ms, plain "
              f"{p_ms:.6f} ms, library {l_ms if l_ms is None else round(l_ms, 6)} ms, "
              f"bound {b_ms:.6f} ms by {b_by} ({nbytes} B, {ops} ops), "
              f"launches/forward {count}", flush=True)
        t = totals[name]
        t["max_abs_err"] = max(t["max_abs_err"], err)
        if count:
            t["ms"] += count * k_ms
            t["plain_ms"] += count * p_ms
            t["bytes"] += count * nbytes
            t["ops"] += count * ops
            if library is not None and t["library_ms"] is not None:
                t["library_ms"] += count * l_ms
        return k_ms

    return record


def _signs(torch, g, *shape):
    return torch.where(torch.rand(*shape, generator=g) < 0.5, -1.0, 1.0)


def _conv_rows(torch, bc, record, cases, g) -> None:
    """K1 and K3 at each conv case (launches per forward, batch, height,
    width, channels in, co, kernel size, stride): the +-1 bf16 input
    ones-padded SAME and packed, the weights +-1 times a per-channel scale;
    K3's yardstick is the cuDNN bf16 conv of the +-1 operands times the
    scale."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    for count, b, h, w, ci, co, k, s in cases:
        x = _signs(torch, g, b, h, w, ci).to(torch.bfloat16).to(dev)
        q = _signs(torch, g, k, k, ci, co) * (torch.rand(co, generator=g) + 0.1)
        packed, scale = bc.pack_conv_kernel(q)
        packed, scale = packed.to(dev), scale.to(dev)
        ciw = packed.shape[2]
        xp, ho, wo = bc._spatial_pad(x, k, k, (s, s), "SAME", 1.0)
        xpc = F.pad(xp, (0, ciw * 32 - ci), value=1.0)
        rows = xpc.reshape(-1, ciw * 32).contiguous()
        m = rows.shape[0]
        record("pack_rows", count, lambda: bc.pack_rows(rows),
               lambda: bc.pack_rows_plain(rows), None,
               m * ciw * 32 * 2 + m * ciw * 4, m * ciw * 32, (m, ciw * 32))
        xq = bc.pack_rows_plain(rows).reshape(*xpc.shape[:3], ciw)
        k_true = k * k * ci
        x_nchw = xp.permute(0, 3, 1, 2)  # +-1 bf16, ones-padded, channels_last
        w_oihw = (q.sign().permute(3, 2, 0, 1).to(torch.bfloat16).to(dev)
                  .contiguous(memory_format=torch.channels_last))
        record("conv_gemm_popcount", count,
               lambda: bc.conv_gemm_popcount(xq, packed, scale, (s, s), k_true),
               lambda: bc.conv_gemm_popcount_plain(xq, packed, scale, (s, s), k_true),
               lambda: F.conv2d(x_nchw, w_oihw, stride=s) * scale[:, None, None],
               xq.numel() * 4 + packed.numel() * 4 + co * 4 + b * ho * wo * co * 4,
               2 * b * ho * wo * co * k_true,
               (*xq.shape, f"{k}x{k}/{s}", co, f"M={b * ho * wo}"))


def _gemm_rows(torch, bc, record, cases, g) -> None:
    """K4 at each GEMM case (launches per forward, M, K, N): int8 +-1
    activations with 5% zeros (the spatial padding's) against packed +-1
    weights, each row taking the design ``packed_weight_matmul_variant``
    names ("small_m" up to M 8, "mma" past it); the yardstick is
    ``torch._int_mm``."""
    dev = torch.device("cuda")
    for count, m, k, n in cases:
        a = _signs(torch, g, m, k)
        a[torch.rand(m, k, generator=g) < 0.05] = 0.0  # zeros of the spatial padding
        a = a.to(torch.int8).to(dev)
        w = _signs(torch, g, k, n)
        bp = bc.pack_dense_kernel(w)[0].to(dev)
        kw = bp.shape[0]
        variant = bc.packed_weight_matmul_variant(m, n, kw)
        wanted = "small_m" if m <= SMALL_M else "mma"
        check(variant == wanted, f"packed_weight_matmul at {(m, k, n)}: variant {variant}, "
                                 f"want {wanted}")
        library, rows = _int_mm_yardstick(torch, m, 32 * kw, n, dev, g)
        if rows not in (None, m):
            print(f"kernel packed_weight_matmul {(m, k, n)}: _int_mm at M padded {m} -> "
                  f"{rows} (it refuses M={m})", flush=True)
        record("packed_weight_matmul", count, lambda: bc.packed_weight_matmul(a, bp),
               lambda: bc.packed_weight_matmul_plain(a, bp), library,
               m * k + kw * n * 4 + m * n * 4, 2 * m * n * k, (m, k, n, variant))


def kernel_phase(torch, bc):
    """Check and time K1, K3 and K4 at the main path's shapes. Returns
    {kernel: {"ms", "plain_ms", "library_ms", "bytes", "ops",
    "max_abs_err"}} summed over one batch-8 forward's launches."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    totals = _binary_totals()
    record = _recorder(torch, totals)

    # (launches per forward, batch, height, width, channels in, co,
    # kernel size, stride): slice A's four sections, then K3_EXTRA_CASES.
    conv_cases = [(n, BATCH, h, h, c, c, 3, 1) for n, h, c in SECTIONS] + list(K3_EXTRA_CASES)
    _conv_rows(torch, bc, record, conv_cases, g)

    # The per-launch floor of back-to-back launches: an empty kernel
    # (``torch.cuda._sleep(0)``) timed as K1 is. K1's 32 launches a
    # forward cannot take less than 32 of these, whatever the design.
    floor = time_ms(torch, lambda: torch.cuda._sleep(0))
    launches_a = sum(n for n, _, _ in SECTIONS)
    totals["pack_rows"]["launch_floor_ms"] = launches_a * floor
    print(f"kernel pack_rows: launch floor (torch.cuda._sleep(0) back to back) {floor:.6f} ms "
          f"a launch, {launches_a * floor:.6f} ms for the {launches_a} launches of a forward "
          f"(K1 {totals['pack_rows']['ms']:.6f} ms)", flush=True)

    # K1 on the other serving paths (launches 0 here: they are counted
    # per slice-A forward), at the rows their batch-8 forwards pack
    # (``ablate.K1_SHAPES``): slice C in bf16, E_AUTO in fp32. Their
    # sums per forward are printed.
    from zookeeper_tpu_torch.ablate import K1_BATCH, K1_SHAPES

    for path in ("C", "E_AUTO"):
        dtype, shapes = K1_SHAPES[path]
        per_forward, launches = 0.0, 0
        for m, k, n in shapes:
            rows = torch.randn(K1_BATCH * m, k, generator=g).to(getattr(torch, dtype)).to(dev)
            per_forward += n * record(
                "pack_rows", 0, lambda: bc.pack_rows(rows), lambda: bc.pack_rows_plain(rows),
                None, rows.numel() * rows.element_size() + rows.numel() // 8, rows.numel(),
                (*rows.shape, dtype, path))
            launches += n
        print(f"kernel pack_rows: {per_forward:.6f} ms per batch-{K1_BATCH} {path} forward "
              f"({launches} launches; the floor {launches * floor:.6f} ms)", flush=True)

    # K1's wire-format edges, off the main path, in both dtypes it takes
    # and at ragged word counts: normal values mixed with +-0, +-inf, NaN
    # and +-subnormals (bit 1 for +-0, bit 0 for NaN and every negative).
    # Then bases that are not 16-byte aligned (contiguous views with a
    # storage offset of one value), which take the scalar-load path of
    # the same launch function: the edge rows, and slice A's first
    # section shape.
    edges = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"),
                          1e-40, -1e-40])
    for dtype, (m, k), offset in ((torch.float32, (37, 96), 0), (torch.bfloat16, (53, 64), 0),
                                  (torch.float32, (37, 96), 1), (torch.bfloat16, (53, 64), 1),
                                  (torch.float32, (BATCH * 58 * 58, 64), 1),
                                  (torch.bfloat16, (BATCH * 58 * 58, 64), 1)):
        v = torch.randn(m * k + offset, generator=g)
        pick = torch.rand(m * k + offset, generator=g) < 0.3
        v[pick] = edges[torch.randint(len(edges), (int(pick.sum()),), generator=g)]
        rows = v.to(dtype).to(dev)[offset:].view(m, k)
        check(rows.is_contiguous() and (rows.data_ptr() % 16 != 0) == (offset != 0),
              f"pack_rows row {(m, k, str(dtype))}: base {rows.data_ptr()} offset {offset}")
        record("pack_rows", 0, lambda: bc.pack_rows(rows),
               lambda: bc.pack_rows_plain(rows), None,
               rows.numel() * rows.element_size() + m * k // 8, m * k,
               (m, k, str(dtype), f"base +{offset * rows.element_size()} B" if offset else "aligned"))

    gemm_cases = [(n, BATCH * h * h, 9 * c, c) for n, h, c in SECTIONS] + list(K4_EXTRA_CASES)
    _gemm_rows(torch, bc, record, gemm_cases, g)
    return totals


#: K3 rows off slice A's main path (launches per forward 0), as
#: ``kernel_phase``'s conv cases: BinaryAlexNet's four binary convs at
#: batch 8 (slice C: 5x5 at 27 from 64 channels, 3x3 at 13 from 192, 384,
#: 384), BinaryNet's five (E_AUTO: 32x32 at 128, 16x16 at 128 and 256,
#: 8x8 at 256 and 512), QuickNet's four sections at batch 1 (M 49 at 512
#: channels), small convs (M*N*Kw 1.5e5 to 2.9e5 word products; M 64 and
#: 65, a row of 5x13), and the ragged (ci 17, co 33) conv at stride 2.
K3_EXTRA_CASES = (
    (0, BATCH, 27, 27, 64, 192, 5, 1), (0, BATCH, 13, 13, 192, 384, 3, 1),
    (0, BATCH, 13, 13, 384, 384, 3, 1), (0, BATCH, 13, 13, 384, 256, 3, 1),
    (0, BATCH, 32, 32, 128, 128, 3, 1), (0, BATCH, 16, 16, 128, 256, 3, 1),
    (0, BATCH, 16, 16, 256, 256, 3, 1), (0, BATCH, 8, 8, 256, 512, 3, 1),
    (0, BATCH, 8, 8, 512, 512, 3, 1),
    *((0, 1, h, h, c, c, 3, 1) for _, h, c in SECTIONS),
    (0, 1, 8, 8, 128, 64, 3, 1), (0, 1, 12, 12, 64, 64, 3, 1), (0, 1, 7, 7, 128, 128, 3, 1),
    (0, 1, 8, 8, 128, 128, 3, 1), (0, 1, 16, 16, 64, 64, 3, 1),
    (0, 1, 8, 8, 64, 64, 3, 1), (0, 1, 5, 13, 64, 64, 3, 1), (0, 2, 9, 9, 17, 33, 3, 2),
)
#: K4 rows off slice B's main path (launches per forward 0): slice D's
#: dense stage at batch 8 and 1 (K 9216 and 4096, N 4096), both sides of
#: the "small_m"/"mma" threshold (M 8 and 9), M not a multiple of the
#: 64-row tile (9, 17, 37, 100, 130), N 33 and 130 (ragged column tiles
#: and unaligned rows of words), Kw 1 (K 32) and K not a multiple of 32
#: (70, 1000: the wrapper pads A with zeros). (launches, M, K, N).
K4_EXTRA_CASES = ((0, 8, 9216, 4096), (0, 8, 4096, 4096), (0, 1, 9216, 4096),
                  (0, 1, 4096, 4096), (0, 8, 4096, 256), (0, 9, 4096, 256),
                  (0, 3, 70, 130), (0, 9, 32, 33), (0, 17, 32, 33), (0, 37, 70, 33),
                  (0, 100, 32, 33), (0, 130, 576, 64), (0, 65, 1000, 130))
#: K4, K5 and K2 take "small_m" up to this M; past it K4 takes the
#: tensor-core tiles ("mma"), K5 "popc" up to K5_POPC_M and "mma" past
#: it, K2 "popc".
SMALL_M = 8
K5_POPC_M = 64


#: K2 and K5 checks: (M, Kw, N, launches per main-path forward). K2's
#: main path is slice C's batch-8 forward (BinaryAlexNet's two dense
#: layers, K 9216 and 4096, N 4096), K5's slice E's batch-8 forward
#: (BinaryNet: 9 per-tap GEMMs of its first binary conv, one fused GEMM
#: for each of the other four, the two dense layers). Then, off the main
#: path: K2 at E_AUTO's two dense layers (BinaryNet's on the fused
#: flavor), the dense shapes at batch 1, ragged rows at M <= 8 (rows past
#: M, N % 4 != 0, a Kw below one block's share, K split over a cluster of
#: each size from 2 to 7 on partial column tiles: the M <= 8 rows are
#: ``ablate.XNOR_ROWS``), and rows on both sides of K5's "popc"/"mma"
#: threshold (M 64), where K5 runs "mma", so the check "K2 = K5 .float()
#: * scale" holds K2's CUDA-core tiles against the tensor-core design
#: bit for bit.
K2_CASES = ((8, 288, 4096, 1), (8, 128, 4096, 1), (8, 256, 1024, 0), (8, 32, 1024, 0),
            (1, 288, 4096, 0), (1, 128, 4096, 0), (3, 288, 4096, 0), (6, 37, 72, 0),
            (8, 7, 130, 0), (8, 64, 8, 0), (5, 96, 130, 0), (8, 160, 72, 0), (7, 190, 130, 0),
            (3, 224, 4100, 0), (37, 7, 130, 0), (64, 7, 130, 0), (65, 7, 130, 0),
            (300, 37, 72, 0))
K5_CASES = ((8192, 4, 128, 9), (2048, 36, 256, 1), (2048, 72, 256, 1), (512, 72, 512, 1),
            (512, 144, 512, 1), (8, 256, 1024, 1), (8, 32, 1024, 1),
            (8, 288, 4096, 0), (8, 128, 4096, 0), (1, 288, 4096, 0), (1, 128, 4096, 0),
            (3, 288, 4096, 0), (6, 37, 72, 0), (8, 7, 130, 0), (8, 64, 8, 0), (5, 96, 130, 0),
            (8, 160, 72, 0), (7, 190, 130, 0), (3, 224, 4100, 0), (37, 7, 130, 0),
            (64, 7, 130, 0), (65, 7, 130, 0), (129, 1, 8, 0), (300, 37, 72, 0))


def _int_mm_yardstick(torch, m, k, n, dev, g):
    """``torch._int_mm`` on int8 +-1 operands of the same product, with M
    padded to the least size the installed ``_int_mm`` takes (it refuses
    small M); returns (call, the M it ran at) or (None, None) where it
    takes no such shape."""
    if k % 8 or n % 8:
        return None, None
    b8 = torch.where(torch.rand(k, n, generator=g) < 0.5, -1, 1).to(torch.int8).to(dev)
    b8 = b8.t().contiguous().t()  # column-major, as cuBLASLt's int8 path wants it
    for rows in (m, 17, 24, 32):
        if rows < m:
            continue
        a8 = torch.where(torch.rand(rows, k, generator=g) < 0.5, -1, 1).to(torch.int8).to(dev)
        try:
            torch._int_mm(a8, b8)
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return (lambda: torch._int_mm(a8, b8)), rows
    return None, None


def xnor_kernel_phase(torch, bc, smi):
    """Check and time K5 and K2 against their plain versions (bit for bit)
    at the shapes of ``K5_CASES``/``K2_CASES``, K2 also against K5's
    output ``.float() * scale``; each beside ``torch._int_mm`` on int8
    +-1 operands (for K2, ``_int_mm(...).float() * scale``). Returns
    per-kernel totals over one main-path forward, as ``kernel_phase``."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(6)
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
                     "ops": 0.0, "max_abs_err": 0.0} for name in XNOR_KERNELS}

    def words(*shape):
        return (torch.randint(0, 2**32, shape, generator=g) - 2**31).to(torch.int32).to(dev)

    for name, cases in (("xnor_matmul_packed", K5_CASES), ("xnor_matmul_packed_scaled", K2_CASES)):
        for m, kw, n, count in cases:
            a, b = words(m, kw), words(kw, n)
            scale = (torch.randn(n, generator=g) * 0.1).to(dev)
            k_true = 32 * kw - 5
            if name == "xnor_matmul_packed":
                kernel = lambda: bc.xnor_matmul_packed(a, b, k_true=k_true)  # noqa: E731
                plain = lambda: bc.xnor_matmul_packed_plain(a, b, k_true=k_true)  # noqa: E731
            else:
                kernel = lambda: bc.xnor_matmul_packed_scaled(a, b, scale, k_true=k_true)  # noqa: E731
                plain = lambda: bc.xnor_matmul_packed_scaled_plain(  # noqa: E731
                    a, b, scale, k_true=k_true)
            variant = getattr(bc, f"{name}_variant")(m, n, kw)
            if m <= SMALL_M:
                wanted = "small_m"
            elif m <= K5_POPC_M or name == "xnor_matmul_packed_scaled":
                wanted = "popc"
            else:
                wanted = "mma"
            check(variant == wanted, f"{name} at {(m, kw, n)}: variant {variant}, want {wanted}")
            with deterministic(torch):
                got, again, want = kernel(), kernel(), plain()
                k5 = bc.xnor_matmul_packed(a, b, k_true=k_true)
                torch.cuda.synchronize()
            err = _max_abs_err(torch, got, want)
            check(_same_bits(torch, got, want),
                  f"{name} at {(m, kw, n)} disagrees with its plain version (max err {err})")
            check(_same_bits(torch, got, again),
                  f"{name} at {(m, kw, n)}: two calls gave other bits")
            if name == "xnor_matmul_packed_scaled":
                check(_same_bits(torch, got, k5.float() * scale[None, :]),
                      f"K2 at {(m, kw, n)} is not K5 .float() * scale bit for bit")
            mm, rows = _int_mm_yardstick(torch, m, 32 * kw, n, dev, g)
            library = None
            if mm is not None:
                library = mm if name == "xnor_matmul_packed" else (
                    lambda mm=mm: mm().float() * scale[None, :])
            k_ms = time_ms(torch, kernel)
            p_ms = time_ms(torch, plain, reps=5, inner=2)
            l_ms = time_ms(torch, library) if library is not None else None
            nbytes = m * kw * 4 + kw * n * 4 + m * n * 4 + (
                n * 4 if name == "xnor_matmul_packed_scaled" else 0)
            ops = 2 * m * n * 32 * kw
            b_ms, b_by = bound_ms(name, nbytes, ops)
            pad = "" if rows in (None, m) else f" (M padded {m} -> {rows}: _int_mm refuses M={m})"
            print(f"kernel {name} M={m} Kw={kw} N={n} ({variant}) on {smi}: equal bits"
                  f"{', = K5 .float() * scale' if name.endswith('scaled') else ''}, the same "
                  f"bits twice, kernel "
                  f"{k_ms:.6f} ms, plain {p_ms:.6f} ms, _int_mm "
                  f"{None if l_ms is None else round(l_ms, 6)} ms{pad}, bound {b_ms:.6f} ms by "
                  f"{b_by} ({nbytes} B, {ops} ops), launches/forward {count}", flush=True)
            t = totals[name]
            t["max_abs_err"] = max(t["max_abs_err"], err)
            if count:
                t["ms"] += count * k_ms
                t["plain_ms"] += count * p_ms
                t["bytes"] += count * nbytes
                t["ops"] += count * ops
                if l_ms is None or t["library_ms"] is None:
                    t["library_ms"] = None
                else:
                    t["library_ms"] += count * l_ms
            del a, b, got, again, want, k5
    torch.cuda.empty_cache()
    return totals


def _same_bits(torch, a, b) -> bool:
    """Equal dtype, shape and bits: a float's bit pattern tells -0 from
    +0 and compares a NaN by its bits (``torch.equal`` calls no NaN
    equal)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = torch.int16 if a.element_size() == 2 else torch.int32
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)


def _max_abs_err(torch, got, want) -> float:
    """Largest finite difference (0 for tensors with equal bits)."""
    if not got.is_floating_point():
        got, want = got.to(torch.int64), want.to(torch.int64)
    d = (got.double() - want.double()).abs()
    d = d[torch.isfinite(d)]
    return d.max().item() if d.numel() else 0.0


def resid_kernel_phase(torch, bc):
    """Check and time K6 (sign and mask mode), K7 and K8 at the four
    section shapes of the batch-128 bf16 training step, and at ragged and
    edge cases off the main path. Returns per-kernel totals over one
    training step's launches, as :func:`kernel_phase` does."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    totals = {
        name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bytes": 0.0,
               "ops": 0.0, "max_abs_err": 0.0}
        for name in RESID_KERNELS
    }

    def record(name, count, kernel, plain, nbytes, ops, label):
        with deterministic(torch):
            got, want = kernel(), plain()
            torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        check(_same_bits(torch, got, want),
              f"{name} at {label} disagrees with its plain version (max err {err})")
        k_ms, p_ms = time_ms(torch, kernel), time_ms(torch, plain, reps=21, inner=2)
        b_ms, b_by = bound_ms(name, nbytes, ops)
        print(f"kernel {name} {label}: equal bits, kernel {k_ms:.6f} ms, plain "
              f"{p_ms:.6f} ms, library none, bound {b_ms:.6f} ms by {b_by} "
              f"({nbytes} B, {ops} ops), launches/step {count}", flush=True)
        t = totals[name]
        t["max_abs_err"] = max(t["max_abs_err"], err)
        t["ms"] += count * k_ms
        t["plain_ms"] += count * p_ms
        t["bytes"] += count * nbytes
        t["ops"] += count * ops

    edges = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"),
                          1.0, -1.0, 1e-40, -1e-40])

    def values(shape, dtype, with_edges):
        v = torch.randn(*shape, generator=g) * 1.5
        if with_edges:
            pick = torch.rand(*shape, generator=g) < 0.25
            v[pick] = edges[torch.randint(len(edges), (int(pick.sum()),), generator=g)]
        return v.to(dtype).to(dev)

    def run_cases(count, shape, dtype, with_edges):
        b, h, w, c = bc._to_4d_shape(shape)
        n, groups, esize = h * w * c, -(-b // 32), torch.tensor([], dtype=dtype).element_size()
        label = f"{tuple(shape)} {str(dtype).split('.')[-1]}"
        x = values(shape, dtype, with_edges)  # the block input (mask mode)
        if with_edges:
            x_sign = values(shape, dtype, True)  # sign mode beyond +-1
        else:
            x_sign = torch.where(torch.rand(*shape, generator=g) < 0.5, -1.0, 1.0).to(dtype).to(dev)
        io = b * n * esize + groups * n * 4
        record("pack_resid", count, lambda: bc.pack_resid(x_sign),
               lambda: bc.pack_resid_plain(x_sign), io, b * n, f"{label} sign")
        record("pack_resid", count, lambda: bc.pack_resid(x, mask_mode=True),
               lambda: bc.pack_resid_plain(x, mask_mode=True), io, b * n, f"{label} mask")
        words = bc.pack_resid_plain(x_sign)
        if with_edges:  # every bit random, the batch pad's included
            words = (torch.randint(0, 2**32, words.shape, generator=g) - 2**31).to(torch.int32).to(dev)
        record("unpack_resid_pm1", count, lambda: bc.unpack_resid_pm1(words, shape, dtype),
               lambda: bc.unpack_resid_pm1_plain(words, shape, dtype), io, b * n, label)
        cot = values(shape, dtype, with_edges)
        mask = bc.pack_resid_plain(x, mask_mode=True)
        record("mask_mul_resid", count, lambda: bc.mask_mul_resid(cot, mask),
               lambda: bc.mask_mul_resid_plain(cot, mask), io + b * n * esize, b * n, label)

    for convs, h, c in SECTIONS:
        run_cases(convs, (TRAIN_BATCH, h, h, c), torch.bfloat16, False)
    for shape, dtype in (((37, 5, 7, 24), torch.bfloat16), ((37, 96), torch.float32),
                         ((33, 2, 3, 5, 7), torch.bfloat16)):
        run_cases(0, shape, dtype, True)
    for name in RESID_KERNELS:
        print(f"kernel {name}: {RESID_PER_CONV[name] * sum(s[0] for s in SECTIONS)} "
              f"launches per training step", flush=True)
    return totals


def int8_exact_phase(torch, bc):
    """The int8 conv's forward on the card (a float32 conv of the +-1
    operands, TF32 allowed, then one fp32 scale multiply) must give the
    exact integer sums at every section shape of the batch-128 step:
    held bit for bit against a float64 conv, exact for |sums| <= 9 * 512,
    times the same scale."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(2)
    print(f"int8 conv: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    for _, h, c in SECTIONS:
        x = torch.where(torch.rand(TRAIN_BATCH, h, h, c, generator=g) < 0.5, -1.0, 1.0)
        x = x.to(torch.bfloat16).to(dev)
        sign = torch.where(torch.rand(3, 3, c, c, generator=g) < 0.5, -1.0, 1.0)
        scale = torch.rand(c, generator=g) + 0.1
        k = (sign * scale).to(dev)
        got = bc._int8_conv_forward(x, k, (1, 1), "SAME", 1, True)
        with deterministic(torch):
            sums = F.conv2d(x.double().permute(0, 3, 1, 2),
                            sign.double().permute(3, 2, 0, 1).to(dev), padding=1)
            want = sums.permute(0, 2, 3, 1).float() * k.abs().amax(dim=(0, 1, 2))
            torch.cuda.synchronize()
        check(_same_bits(torch, got, want),
              f"int8 conv at {tuple(x.shape)}: not the exact integer sums "
              f"(max err {_max_abs_err(torch, got, want)})")
        ms = time_ms(torch, lambda: bc._int8_conv_forward(x, k, (1, 1), "SAME", 1, True),
                     reps=5, inner=3)
        print(f"int8 conv {tuple(x.shape)}: exact integer sums "
              f"(max |sum| {sums.abs().max().item():.0f}), {ms:.6f} ms", flush=True)


def _plain_binary(bc):
    """The binary kernels' wrappers swapped for their plain versions."""
    return mock.patch.multiple(
        bc, pack_rows=bc.pack_rows_plain, conv_gemm_popcount=bc.conv_gemm_popcount_plain,
        packed_weight_matmul=bc.packed_weight_matmul_plain,
        xnor_matmul_packed=bc.xnor_matmul_packed_plain,
        xnor_matmul_packed_scaled=bc.xnor_matmul_packed_scaled_plain,
    )


def slice_phase(torch, bc, label: str, smi: str):
    """Serve seeded requests through the port's ServingConfig with slice
    ``label``'s settings; check every forward's launches (by its batch
    bucket), the logits, and that they equal the plain path's. Returns
    (launches by kernel, timings, the config)."""
    import numpy as np

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving import InferenceEngine, ServingConfig

    settings, per_forward = SLICES[label]
    cfg = ServingConfig()
    configure(cfg, {
        "engine.batch_buckets": (1, BATCH), "requests": 16, "max_request": BATCH,
        "seed": 0, "device": "cuda", "verbose": False, **settings,
    })
    buckets = []
    real_infer = InferenceEngine.infer

    def spy(engine, x):
        buckets.append(engine.bucket_for(len(x)))
        return real_infer(engine, x)

    t0 = time.perf_counter()
    bc.reset_launches()
    with mock.patch.object(InferenceEngine, "infer", spy):
        result = cfg.run()  # build, pack, warm both buckets, serve the stream
    torch.cuda.synchronize()
    launches = dict(bc.LAUNCHES)
    print(f"slice {label}: served {result['requests']} requests in "
          f"{int(result['dispatches'])} dispatches, {len(buckets)} forwards (buckets "
          f"{ {b: buckets.count(b) for b in sorted(set(buckets))} }), launches {launches}, "
          f"run {time.perf_counter() - t0:.1f} s", flush=True)
    for name in bc.LAUNCHES:
        want = sum(per_forward(b).get(name, 0) for b in buckets)
        check(launches[name] == want,
              f"slice {label}: {name} launched {launches[name]} times, want {want}")

    engine = cfg.engine
    shape = (BATCH, *cfg.input_shape)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    with deterministic(torch):
        logits = engine.infer(x)
        torch.cuda.synchronize()
        check(tuple(logits.shape) == (BATCH, cfg.num_classes),
              f"slice {label}: logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), f"slice {label}: non-finite logits")
        before = dict(bc.LAUNCHES)
        with _plain_binary(bc):
            plain = engine.infer(x)
        torch.cuda.synchronize()
    check(bc.LAUNCHES == before,
          f"slice {label}: the plain-path forward launched kernels "
          f"({before} -> {bc.LAUNCHES}), so it is no plain reference")
    check(torch.equal(logits, plain),
          f"slice {label}: kernel-path logits differ from the plain path "
          f"(max {(logits - plain).abs().max().item()})")
    if label == "E":
        _e_flavor_check(torch, bc, engine, x, logits)
    if label == "D":
        _d_conversion_check(cfg)

    steps = 20
    engine.infer(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.infer(x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    stats = {
        "images_per_s": BATCH * steps / dt,
        "batch8_forward_ms": dt / steps * 1e3,
        "p50_ms": result["latency_p50_ms"],
        "p99_ms": result["latency_p99_ms"],
    }
    print(f"slice {label} on {smi}: logits equal to the plain path; " + json.dumps(stats),
          flush=True)
    del cfg, engine
    torch.cuda.empty_cache()
    return launches, stats


def _e_flavor_check(torch, bc, engine, x, logits):
    """Slice E's model under binary_flavor="auto" (the same weights):
    K1 + K3 convs and K1 + K2 dense instead of K5, and the same logits bit
    for bit (the flavors share their integer sums and their one fp32
    multiply)."""
    layers = [m for m in engine._module.modules() if hasattr(m, "binary_flavor")]
    for m in layers:
        m.binary_flavor = "auto"
    try:
        with deterministic(torch):
            bc.reset_launches()
            auto = engine.infer(x)
            torch.cuda.synchronize()
        got = {k: v for k, v in bc.LAUNCHES.items() if v}
    finally:
        for m in layers:
            m.binary_flavor = "reference"
    check(got == E_AUTO, f"slice E under binary_flavor=auto launched {got}, want {E_AUTO}")
    check(_same_bits(torch, auto, logits),
          f"slice E: binary_flavor=auto logits differ from reference's "
          f"(max {_max_abs_err(torch, auto, logits)})")
    print(f"slice E: the same model under binary_flavor=auto launched {got} and gave the "
          f"reference flavor's logits bit for bit", flush=True)


def _d_conversion_check(cfg):
    """Slice D's deployment without the fold converts exactly the two
    dense kernels, as the JAX package's test asserts."""
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.models import BinaryAlexNet
    from zookeeper_tpu_torch.models.convert import to_flax_variables
    from zookeeper_tpu_torch.ops.packed import pack_quantconv_params

    model = BinaryAlexNet()
    configure(model, {"compute_dtype": "bfloat16", "binary_compute": "mxu",
                      "dense_binary_compute": "xnor", "dense_packed_weights": True},
              name="model")
    module = model.build(cfg.input_shape, cfg.num_classes)
    params, _ = to_flax_variables(model.initialize(module.float_twin(), seed=0))
    template, _ = to_flax_variables(module)
    packed = pack_quantconv_params(params, template=template)
    converted = sorted(k for k, v in packed.items() if "kernel_packed" in v)
    check(converted == ["QuantDense_0", "QuantDense_1"],
          f"slice D without the fold converted {converted}")
    print(f"slice D: without the fold the template converts exactly {converted}", flush=True)


def _snapshot(state):
    """Copies of everything a train step changes."""
    clone = lambda d: {k: v.detach().clone() for k, v in d.items()}  # noqa: E731
    opt = state.opt_state
    return (clone(state.module.state_dict()), clone(opt["mu"]), clone(opt["nu"]),
            opt["count"], state.step)


def _restore(state, snap) -> None:
    module_state, mu, nu, count, step = snap
    state.module.load_state_dict(module_state)
    for key, saved in (("mu", mu), ("nu", nu)):
        for name, t in state.opt_state[key].items():
            t.copy_(saved[name])
    state.opt_state["count"], state.step = count, step


def _profile_train_step(torch, run_step, step_ms: float, tag: str, top: int = 15,
                        keys=None):
    """Trace one ``run_step()`` with ``torch.profiler`` and print its device
    activities' summed time against the step's device time ``step_ms``
    (the busy share) and the ``top`` items (their names appended to
    ``keys`` when given). Returns (busy ms, device activities)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_step()
        torch.cuda.synchronize()
    attr = ("self_device_time_total" if hasattr(prof.key_averages()[0], "self_device_time_total")
            else "self_cuda_time_total")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(getattr(e, attr) for e in kernels) / 1e3
    launched = sum(e.count for e in kernels)
    print(f"{tag} profile: {launched} device activities, {busy_ms:.3f} ms "
          f"busy, {100 * busy_ms / step_ms:.1f}% of the {step_ms:.3f} "
          f"ms step; top items:", flush=True)
    for e in sorted(kernels, key=lambda e: getattr(e, attr), reverse=True)[:top]:
        t = getattr(e, attr) / 1e3
        if keys is not None:
            keys.append(e.key)
        print(f"  {t:9.3f} ms {100 * t / busy_ms:5.1f}% x{e.count:<5d} {e.key[:110]}",
              flush=True)
    return busy_ms, launched


def training_phase(torch, bc, smi, model="QuickNetLarge", per_step=None, tag="training"):
    """TrainImageNet's int8 step with 1-bit residuals of ``model``
    (QuickNet-Large; Bi-Real-Net-18 too): launches (``per_step``, by
    default QuickNet-Large's K6, K7 and K8 per binary conv), finiteness
    and bit equality against the plain-kernel step and the unpacked step
    from one fixed state; then device time, peak memory, the profiler's
    top items and images/s through ``run()``. Returns (launches per
    step, stats)."""
    if per_step is None:
        per_step = {name: n * sum(s[0] for s in SECTIONS) for name, n in RESID_PER_CONV.items()}
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.training.imagenet import TrainImageNet

    dev = torch.device("cuda")

    def experiment(pack: bool, epochs: int = 1):
        exp = TrainImageNet()
        configure(exp, {
            "model": model,
            "model.compute_dtype": "bfloat16",
            "model.binary_compute": "int8",
            "model.pack_residuals": pack,
            "loader.dataset.num_train_examples": TRAIN_EXAMPLES,
            "batch_size": TRAIN_BATCH, "epochs": epochs, "steps_per_epoch": 3,
            "validate": False, "seed": 0, "device": "cuda", "verbose": False,
        }, name="experiment")
        return exp

    t0 = time.perf_counter()
    exp = experiment(True, epochs=2)
    state = exp.build_state(dev)
    batches = exp.loader.batches("train", device=dev, epoch=0, max_batches=1)
    batch = next(batches)
    batches.close()
    step = exp._train_step_fn()
    # The fixed state takes Adam's count at 1: the warmup schedule's rate
    # is 0 at count 0, and the parameters would not move.
    state.opt_state["count"] = 1
    init = _snapshot(state)
    param_names = [name for name, _ in state.module.named_parameters()]
    n_params = sum(p.numel() for p in state.module.parameters())
    print(f"{tag}: {model} ({n_params} parameters) built, "
          f"{TRAIN_EXAMPLES} synthetic ImageNet examples made and one batch "
          f"{tuple(batch['input'].shape)} staged in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def traced_step(st):
        """One step from ``st``; returns its loss, gradients, module state
        (parameters and BatchNorm statistics) and Adam moments."""
        grads = {}
        real = st.tx.update

        def spy(g, opt_state, params):
            grads.update({k: v.detach().clone() for k, v in g.items()})
            real(g, opt_state, params)

        st.tx.update = spy
        try:
            _, metrics = step(st, batch)
        finally:
            del st.tx.update
        torch.cuda.synchronize()
        out = {"loss": metrics["loss"].clone()}
        out.update({f"grad {k}": v for k, v in grads.items()})
        out.update({f"state {k}": v.detach().clone() for k, v in st.module.state_dict().items()})
        for key in ("mu", "nu"):
            out.update({f"{key} {k}": v.clone() for k, v in st.opt_state[key].items()})
        return out

    def same(a, b, label):
        bad = [k for k in a if not _same_bits(torch, a[k], b[k])]
        check(set(a) == set(b) and not bad,
              f"{tag}: {label} differs from the kernel step in {len(bad)} of "
              f"{len(a)} tensors, e.g. {bad[:4]}")
        print(f"{tag}: {label} equals the kernel step bit for bit "
              f"({len(a)} tensors: loss, gradients, parameters, BN statistics, "
              f"Adam moments)", flush=True)

    exp_off = experiment(False)
    state_off = exp_off.build_state(dev)
    with deterministic(torch):
        # (a) the kernel path, from the fixed state.
        _restore(state, init)
        bc.reset_launches()
        res_a = traced_step(state)
        launches = {name: bc.LAUNCHES[name] for name in RESID_KERNELS}
        copies = dict(bc.COPIES)
        for name in bc.LAUNCHES:
            want = per_step.get(name, 0)
            check(bc.LAUNCHES[name] == want,
                  f"{tag}: {name} launched {bc.LAUNCHES[name]} times in one step, want {want}")
        loss = res_a["loss"].item()
        check(math.isfinite(loss), f"{tag}: loss {loss} is not finite")
        moved = sum(not _same_bits(torch, res_a[f"state {n}"], init[0][n]) for n in param_names)
        check(moved > 0, f"{tag}: the step moved no parameter")
        print(f"{tag}: one step, loss {loss:.6f}, launches {launches}, "
              f"strided inputs copied {copies}, {moved} of {len(param_names)} "
              f"parameter tensors moved", flush=True)

        # (b) the three wrappers swapped for their plain versions.
        _restore(state, init)
        before = dict(bc.LAUNCHES)
        with mock.patch.multiple(
            bc, pack_resid=bc.pack_resid_plain,
            unpack_resid_pm1=bc.unpack_resid_pm1_plain,
            mask_mul_resid=bc.mask_mul_resid_plain,
        ):
            res_b = traced_step(state)
        check(bc.LAUNCHES == before,
              f"{tag}: the plain-kernel step launched kernels ({before} -> {bc.LAUNCHES})")
        same(res_a, res_b, "the plain-kernel step")
        del res_b

        # (c) pack_residuals=False, from the same state.
        _restore(state_off, init)
        bc.reset_launches()
        res_c = traced_step(state_off)
        check(all(bc.LAUNCHES[n] == 0 for n in RESID_KERNELS),
              f"{tag}: the unpacked step launched residual kernels {bc.LAUNCHES}")
        same(res_a, res_c, "the pack_residuals=False step")
        del res_a, res_c

    # Peak memory of one step from the fixed state, pack on and off, in
    # the default settings.
    peaks = {}
    for pack, st in ((True, state), (False, state_off)):
        _restore(st, init)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(st, batch)
        torch.cuda.synchronize()
        peaks[pack] = (base, torch.cuda.max_memory_allocated())
    (base_on, peak_on), (base_off, peak_off) = peaks[True], peaks[False]
    gib = 2.0**30
    memory = {
        "peak_gib_pack_on": peak_on / gib, "peak_gib_pack_off": peak_off / gib,
        "step_gib_pack_on": (peak_on - base_on) / gib,
        "step_gib_pack_off": (peak_off - base_off) / gib,
    }
    # The step's own memory (peak over what was allocated before it) is
    # compared: both peaks also hold the two train states and the
    # snapshot.
    check(peak_on - base_on < peak_off - base_off,
          f"{tag}: the step's peak memory with packed residuals "
          f"{peak_on - base_on} B is not below the unpacked step's "
          f"{peak_off - base_off} B")
    print(f"{tag}: peak memory {json.dumps(memory)}", flush=True)

    # Device time of one step on a device-resident batch, pack on and off
    # in turns (on, off, off, on), three steps each after a warm step;
    # the host clock around step + synchronize beside it.
    times = {True: [], False: []}
    walls = {True: [], False: []}
    for pack in (True, False, False, True):
        st = state if pack else state_off
        step(st, batch)
        torch.cuda.synchronize()
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            start.record()
            step(st, batch)
            end.record()
            end.synchronize()
            walls[pack].append((time.perf_counter() - t1) * 1e3)
            times[pack].append(start.elapsed_time(end))
    step_ms = {"step_ms_pack_on": statistics.median(times[True]),
               "step_ms_pack_off": statistics.median(times[False]),
               "step_wall_ms_pack_on": statistics.median(walls[True]),
               "step_wall_ms_pack_off": statistics.median(walls[False])}
    print(f"{tag}: time per step {json.dumps(step_ms)} (device, all: "
          f"{json.dumps({str(k): v for k, v in times.items()})})", flush=True)
    del state_off, exp_off
    torch.cuda.empty_cache()

    # The profiler's kernels for one step (pack on).
    busy_ms, launched = _profile_train_step(torch, lambda: step(state, batch),
                                      step_ms["step_ms_pack_on"], tag)
    busy_share = busy_ms / step_ms["step_ms_pack_on"]

    # images/s through run(): two epochs of three steps, host pipeline
    # (RandomResizedCrop on 8 worker threads, pinned prefetch) included.
    bc.reset_launches()
    history = exp.run()
    torch.cuda.synchronize()
    steps = 2 * 3
    for name in RESID_KERNELS:
        want = per_step.get(name, 0) * steps
        check(bc.LAUNCHES[name] == want,
              f"{tag} run(): {name} launched {bc.LAUNCHES[name]} times, want {want}")
    losses = [e["loss"] for e in history["train"]]
    check(all(math.isfinite(v) for v in losses), f"{tag} run(): losses {losses}")
    run_stats = {f"images_per_s_epoch{i + 1}": e["examples_per_sec"]
                 for i, e in enumerate(history["train"])}
    print(f"{tag} run(): losses {losses}, {json.dumps(run_stats)}", flush=True)
    stats = {**step_ms, **memory, **run_stats, "device_busy_ms": busy_ms,
             "device_busy_share": busy_share, "device_activities_per_step": launched}
    print(f"{tag} on {smi}: {json.dumps(stats)}", flush=True)
    del exp, state
    torch.cuda.empty_cache()
    return launches, stats


def bireal_kernel_phase(torch, bc):
    """K1 and K3 at Bi-Real-Net-18's 16 binary convs (slice F), at batch 8
    (launches per forward) and 1, the three stride-2 convs included, and
    K4 at its slice-G GEMMs (the nine taps fused: M = batch x output
    pixels, K = 9 x channels in, N = channels out), each equal to its plain
    version and the same bits twice, timed beside it and its yardstick.
    Returns per-kernel totals over one batch-8 forward of F (K1, K3) and
    of G (K4)."""
    g = torch.Generator().manual_seed(7)
    totals = _binary_totals()
    record = _recorder(torch, totals)
    _conv_rows(torch, bc, record, [
        (n if b == BATCH else 0, b, h, h, ci, co, 3, s)
        for b in (BATCH, 1) for n, h, ci, co, s in BIREAL_CONVS], g)
    _gemm_rows(torch, bc, record, [
        (n if b == BATCH else 0, b * (h // s) ** 2, 9 * ci, co)
        for b in (BATCH, 1) for n, h, ci, co, s in BIREAL_CONVS], g)
    return totals


def bireal_resid_phase(torch, bc):
    """K6 (sign mode) and K7 at the shapes of Bi-Real-Net-18's binary conv
    inputs in a batch-128 bf16 step (approx_sign keeps its float input, so
    no mask is packed and K8 has no work), each equal to its plain version
    bit for bit, timed beside it. Returns per-kernel totals over one
    step."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(8)
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bytes": 0.0,
                     "ops": 0.0, "max_abs_err": 0.0} for name in BIREAL_TRAIN}
    for count, h, c in BIREAL_RESID:
        shape = (TRAIN_BATCH, h, h, c)
        x = _signs(torch, g, *shape).to(torch.bfloat16).to(dev)
        words = bc.pack_resid_plain(x)
        n = h * h * c
        io = TRAIN_BATCH * n * 2 + -(-TRAIN_BATCH // 32) * n * 4
        for name, kernel, plain in (
            ("pack_resid", lambda: bc.pack_resid(x), lambda: bc.pack_resid_plain(x)),
            ("unpack_resid_pm1", lambda: bc.unpack_resid_pm1(words, shape, torch.bfloat16),
             lambda: bc.unpack_resid_pm1_plain(words, shape, torch.bfloat16)),
        ):
            with deterministic(torch):
                got, want = kernel(), plain()
                torch.cuda.synchronize()
            check(_same_bits(torch, got, want),
                  f"{name} at {shape}: disagrees with its plain version "
                  f"(max err {_max_abs_err(torch, got, want)})")
            k_ms, p_ms = time_ms(torch, kernel), time_ms(torch, plain, reps=21, inner=2)
            b_ms, b_by = bound_ms(name, io, TRAIN_BATCH * n)
            print(f"kernel {name} {shape} bfloat16 (Bi-Real): equal bits, kernel {k_ms:.6f} ms, "
                  f"plain {p_ms:.6f} ms, library none, bound {b_ms:.6f} ms by {b_by}, "
                  f"launches/step {count}", flush=True)
            t = totals[name]
            t["ms"] += count * k_ms
            t["plain_ms"] += count * p_ms
            t["bytes"] += count * io
            t["ops"] += count * TRAIN_BATCH * n
    return totals


def resnet_training_phase(torch, bc, smi):
    """ResNet-50 (BASELINE config 5) through TrainImageNet at batch 128, in
    bf16 and fp32: six steps on one staged batch from a fixed state (Adam
    at a constant 1e-3), the loss finite and lower after them than before;
    each step's device time (CUDA events), peak memory, one step's profile
    (busy share, top items), and images/s through ``run()`` (one epoch of three steps, the host pipeline
    included). It launches no kernel of the port. Returns stats by
    dtype."""
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.training.imagenet import TrainImageNet

    dev = torch.device("cuda")
    out = {}
    for dtype in ("bfloat16", "float32"):
        exp = TrainImageNet()
        configure(exp, {
            "model": "ResNet50", "model.compute_dtype": dtype,
            "optimizer.schedule": "ConstantSchedule", "optimizer.schedule.base_lr": 1e-3,
            "loader.dataset.num_train_examples": TRAIN_EXAMPLES, "batch_size": TRAIN_BATCH,
            "epochs": 1, "steps_per_epoch": 3, "validate": False, "seed": 0,
            "device": "cuda", "verbose": False,
        }, name="experiment")
        state = exp.build_state(dev)
        batches = exp.loader.batches("train", device=dev, epoch=0, max_batches=1)
        batch = next(batches)
        batches.close()
        step = exp._train_step_fn()
        bc.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(7):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, metrics = step(state, batch)
            end.record()
            end.synchronize()
            losses.append(metrics["loss"].item())
            times.append(start.elapsed_time(end))
        check(sum(bc.LAUNCHES.values()) == 0, f"ResNet-50 launched kernels {bc.LAUNCHES}")
        check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
              f"ResNet-50 {dtype}: losses {losses} not finite or not falling")
        step_ms = statistics.median(times[1:])
        peak = torch.cuda.max_memory_allocated() / 2.0**30
        busy_ms, _ = _profile_train_step(torch, lambda: step(state, batch), step_ms,
                                   f"resnet50 {dtype}", top=10)
        history = exp.run()
        run_ips = history["train"][0]["examples_per_sec"]
        out[dtype] = {"step_ms": step_ms, "images_per_s_step": TRAIN_BATCH / step_ms * 1e3,
                      "images_per_s_run": run_ips, "peak_gib": peak,
                      "device_busy_share": busy_ms / step_ms,
                      "loss_first": losses[0], "loss_last": losses[-1]}
        print(f"resnet50 {dtype} on {smi}: losses {[round(v, 4) for v in losses]}, step times "
              f"{[round(t, 3) for t in times]} ms; {json.dumps(out[dtype])}", flush=True)
        del exp, state, batch
        torch.cuda.empty_cache()
    return out


def mnist_phase(torch, smi):
    """TrainMnist (BASELINE config 1: SimpleCnn on synthetic MNIST, batch
    64) through ``run()`` on the card for three epochs of 16 steps: the
    epoch loss finite and falling; steps/s per epoch."""
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.training.mnist import TrainMnist

    exp = TrainMnist()
    configure(exp, {"epochs": 3, "device": "cuda", "verbose": False}, name="experiment")
    history = exp.run()
    losses = [e["loss"] for e in history["train"]]
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"TrainMnist: epoch losses {losses} not finite or not falling")
    stats = {"losses": losses, "val": history["validation"][-1],
             "steps_per_s": [e["examples_per_sec"] / exp.batch_size for e in history["train"]]}
    print(f"mnist on {smi}: {json.dumps(stats)}", flush=True)
    return stats


#: The dense zoo's serving slices (``ZOO``: 224x224x3, 1000 classes,
#: bf16): L BinaryDenseNet-28 packed (no fold: the family is
#: pre-activation; K1 + K3 in each of its 23 binary convs), M the same on
#: "xnor" (K4 in each), N MeliusNet-22 with latent kernels packed at each
#: call (K1 + K3 in each of its 34 binary convs), O BinaryDenseNet-37
#: dilated on "mxu" (its dilated convs run there only, on cuDNN: none of
#: the port's kernels).
DENSE_SLICES = {
    "L": ({"model": "BinaryDenseNet28", **ZOO, "model.packed_weights": True},
          lambda bucket: {"pack_rows": 23, "conv_gemm_popcount": 23}),
    "M": ({"model": "BinaryDenseNet28", **ZOO, "model.binary_compute": "xnor",
           "model.packed_weights": True},
          lambda bucket: {"packed_weight_matmul": DENSE_K4[bucket]}),
    "N": ({"model": "MeliusNet22", **ZOO},
          lambda bucket: {"pack_rows": 34, "conv_gemm_popcount": 34}),
    "O": ({"model": "BinaryDenseNet37Dilated", **ZOO, "model.binary_compute": "mxu"},
          lambda bucket: {}),
}
SLICES.update(DENSE_SLICES)
#: K4 launches per slice-M forward by bucket: one fused GEMM per conv,
#: except where the patch matrix (M x 9 x channels, counted in the bf16
#: input's 2 bytes) passes the 32 MiB fusion limit: at batch 8 the five
#: 56x56 convs from 128 channels and the three 28x28 convs from 352 run
#: one GEMM per tap (9 each), 15 + 72 = 87 (``dense_gemm_cases``).
DENSE_K4 = {1: 23, BATCH: 87}
#: profile_forward's model and binary_compute for each dense slice (the
#: dilated model runs "mxu" whatever it is given).
DENSE_PROFILES = {"L": ("BinaryDenseNet28", "xnor_popcount"), "M": ("BinaryDenseNet28", "xnor"),
                  "N": ("MeliusNet22", "xnor_popcount"),
                  "O": ("BinaryDenseNet37Dilated", "xnor_popcount")}
#: Training through the packed kernels: BinaryDenseNet-28 on
#: "xnor_popcount" (K1 + K3 in each binary conv's forward), and one
#: BinaryAlexNet step (K1 + K3 in its 4 convs, K1 + K2 in its 2 dense
#: layers at M = the batch, K2's "popc" design).
DENSE_TRAIN = {"pack_rows": 23, "conv_gemm_popcount": 23}
ALEXNET_TRAIN = {"pack_rows": 6, "conv_gemm_popcount": 4, "xnor_matmul_packed_scaled": 2}
#: BinaryAlexNet's dense layers at the training batch: (M, K, N).
ALEXNET_DENSE = ((TRAIN_BATCH, 9216, 4096), (TRAIN_BATCH, 4096, 4096))


def dense_conv_shapes(torch, model: str, batch: int = BATCH):
    """{(height, width, channels in, channels out): binary convs of that
    shape in one forward} of ``model`` (the dense zoo at its default
    widths, 224x224), read by hooks from a forward on the ``meta`` device
    (on "mxu": no kernel, nothing allocated)."""
    from zookeeper_tpu_torch import models
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.models.summary import meta_module
    from zookeeper_tpu_torch.ops.layers import QuantConv

    m = getattr(models, model)()
    configure(m, {"compute_dtype": "bfloat16", "binary_compute": "mxu"}, name="model")
    module = meta_module(m, (224, 224, 3), 1000)
    shapes = {}

    def hook(conv, args):
        _, h, w, ci = args[0].shape
        key = (h, w, ci, conv.latent.shape[-1])
        shapes[key] = shapes.get(key, 0) + 1

    for conv in module.modules():
        if isinstance(conv, QuantConv):
            conv.register_forward_pre_hook(hook)
    with torch.no_grad():
        module(torch.zeros(batch, 224, 224, 3, device="meta"))
    return shapes


def dense_gemm_cases(bc, shapes, batch: int = BATCH):
    """K4's GEMMs in one "xnor" forward of convs ``shapes`` (as
    :func:`dense_conv_shapes` gives them) at ``batch``: (launches, M, K,
    N), the nine taps fused into one GEMM where the patch matrix fits
    ``_FUSE_TAPS_MAX_BYTES`` (counted in the bf16 input's bytes), one GEMM
    per tap otherwise, as ``_packed_conv_forward`` decides it."""
    cases = []
    for (h, w, ci, co), n in sorted(shapes.items()):
        m, ci_pad = batch * h * w, -(-ci // 32) * 32
        if m * 9 * ci_pad * 2 <= bc._FUSE_TAPS_MAX_BYTES:
            cases.append((n, m, 9 * ci, co))
        else:
            cases.append((9 * n, m, ci, co))
    return cases


def _add_row(totals, name, count, k_ms, p_ms, l_ms, nbytes, ops) -> None:
    t = totals[name]
    t["ms"] += count * k_ms
    t["plain_ms"] += count * p_ms
    t["bytes"] += count * nbytes
    t["ops"] += count * ops
    if t["library_ms"] is not None:
        t["library_ms"] = None if l_ms is None else t["library_ms"] + count * l_ms


def dense_kernel_phase(torch, bc):
    """K1 and K3 at every binary-conv shape of a batch-8 BinaryDenseNet-28
    and MeliusNet-22 forward (N = 64 over 64 to 512 channels at 56, 28, 14
    and 7), K4 at the same convs' GEMMs (M = 8 x pixels, K = 9 x channels
    in, N = 64); K1 and K3 at the batch-128 training step's shapes
    (401408 rows at 56x56); K2 at BinaryAlexNet's dense layers at M 128
    ("popc"). Each equal to its plain version and the same bits twice,
    timed beside its plain version and its yardstick (cuDNN's conv x
    scale, ``torch._int_mm``). Returns per-entry totals: "densenet" (K1,
    K3 per slice-L forward, K4 per slice-M forward), "melius" (per
    slice-N forward; K4 per forward of the same model on "xnor", which no
    slice serves), "xnor_train" (K1, K3 per DenseNet training step, K2
    per BinaryAlexNet step)."""
    g = torch.Generator().manual_seed(9)
    dev = torch.device("cuda")
    dn, ml = dense_conv_shapes(torch, "BinaryDenseNet28"), dense_conv_shapes(torch, "MeliusNet22")
    print(f"dense zoo convs (h, w, ci, co): count per forward: densenet {dn}, melius {ml}",
          flush=True)
    check(sum(dn.values()) == 23 and sum(ml.values()) == 34,
          f"dense zoo: {sum(dn.values())} and {sum(ml.values())} binary convs, want 23 and 34")
    out = {"densenet": _binary_totals(), "melius": _binary_totals(),
           "xnor_train": _binary_totals()}
    del out["xnor_train"]["packed_weight_matmul"]  # no "xnor" conv trains here
    out["xnor_train"].update({"xnor_matmul_packed_scaled": {
        "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "ops": 0.0,
        "max_abs_err": 0.0}})
    for batch in (1, BATCH):
        k4 = sum(n for n, *_ in dense_gemm_cases(bc, dense_conv_shapes(torch, "BinaryDenseNet28",
                                                                       batch), batch))
        check(k4 == DENSE_K4[batch], f"slice M: {k4} K4 GEMMs at batch {batch}, "
                                     f"DENSE_K4 says {DENSE_K4[batch]}")
    log = []
    record = _recorder(torch, out["densenet"], plain_reps=3, plain_inner=1, log=log)
    for key in sorted(set(dn) | set(ml)):
        h, w, ci, co = key
        start = len(log)
        _conv_rows(torch, bc, record, [(dn.get(key, 0), BATCH, h, w, ci, co, 3, 1)], g)
        ((n, m, k, nn),) = dense_gemm_cases(bc, {key: 1})
        _gemm_rows(torch, bc, record, [(n * dn.get(key, 0), m, k, nn)], g)
        for row in log[start:]:
            per_conv = n if row[0] == "packed_weight_matmul" else 1
            _add_row(out["melius"], row[0], per_conv * ml.get(key, 0), *row[1:])
    for name in ("pack_rows", "conv_gemm_popcount", "packed_weight_matmul"):
        out["melius"][name]["max_abs_err"] = out["densenet"][name]["max_abs_err"]

    train = dense_conv_shapes(torch, "BinaryDenseNet28", batch=TRAIN_BATCH)
    record = _recorder(torch, out["xnor_train"], plain_reps=1, plain_inner=1)
    _conv_rows(torch, bc, record, [(n, TRAIN_BATCH, h, w, ci, co, 3, 1)
                                   for (h, w, ci, co), n in sorted(train.items())], g)
    torch.cuda.empty_cache()

    name = "xnor_matmul_packed_scaled"
    for m, k, n in ALEXNET_DENSE:
        a = bc.pack_rows_plain(_signs(torch, g, m, k).to(dev))
        b = bc.pack_dense_kernel(_signs(torch, g, k, n))[0].to(dev)
        scale = (torch.rand(n, generator=g) + 0.1).to(dev)
        kw = b.shape[0]
        variant = bc.xnor_matmul_packed_scaled_variant(m, n, kw)
        check(variant == "popc", f"K2 at the training step's {(m, k, n)}: variant {variant}, "
                                 "want popc")
        mm, rows = _int_mm_yardstick(torch, m, k, n, dev, g)
        check(rows == m, f"_int_mm at {(m, k, n)} ran at M {rows}")
        record(name, 1, lambda: bc.xnor_matmul_packed_scaled(a, b, scale, k_true=k),
               lambda: bc.xnor_matmul_packed_scaled_plain(a, b, scale, k_true=k),
               lambda: mm().float() * scale[None, :],
               m * kw * 4 + kw * n * 4 + n * 4 + m * n * 4, 2 * m * n * k,
               (m, k, n, variant))
    return out


def xnor_dense_vjp_phase(torch, bc):
    """``xnor_dense`` under autograd at BinaryAlexNet's dense shapes (M 128,
    bf16 +-1 inputs, sign x scale kernels) on the fused flavor (K1 + K2),
    "reference" (K5) and "xnor" (K4): the output and both gradients equal
    bit for bit to the same call with the plain kernels patched in
    (deterministic mode), one launch of each kernel per call."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(10)
    want_launches = {"auto": {"pack_rows": 1, "xnor_matmul_packed_scaled": 1},
                     "reference": {"xnor_matmul_packed": 1},
                     "xnor": {"packed_weight_matmul": 1}}
    for m, k, n in ALEXNET_DENSE:
        x0 = _signs(torch, g, m, k).to(torch.bfloat16).to(dev)
        q0 = (_signs(torch, g, k, n) * (torch.rand(n, generator=g) + 0.1)).to(dev)
        cot = torch.randn(m, n, generator=g).to(dev)
        for flavor, launches in want_launches.items():
            def run():
                x = x0.clone().requires_grad_()
                q = q0.clone().requires_grad_()
                y = bc.xnor_dense(x, q, flavor != "xnor",
                                  "auto" if flavor == "xnor" else flavor)
                y.backward(cot)
                torch.cuda.synchronize()
                return y.detach(), x.grad, q.grad

            with deterministic(torch):
                bc.reset_launches()
                got = run()
                seen = {k2: v for k2, v in bc.LAUNCHES.items() if v}
                with _plain_binary(bc):
                    want = run()
            check(seen == launches, f"xnor_dense {flavor} at {(m, k, n)} launched {seen}, "
                                    f"want {launches}")
            for what, a, b in zip(("output", "dx", "dk"), got, want):
                check(_same_bits(torch, a, b),
                      f"xnor_dense {flavor} at {(m, k, n)}: {what} differs from the plain "
                      f"kernels' (max {_max_abs_err(torch, a, b)})")
            print(f"xnor_dense {flavor} at M={m} K={k} N={n}: launches {seen}; output, dx "
                  f"[{m}, {k}] {got[1].dtype} and dk [{k}, {n}] {got[2].dtype} equal to the "
                  f"plain kernels' bit for bit", flush=True)


def xnor_training_phase(torch, bc, smi, model, per_step, tag, full=True):
    """TrainImageNet's step through the packed kernels: ``model`` on
    "xnor_popcount", bf16, batch 128, Adam under WarmupCosine (base rate
    1e-3). From one fixed state (Adam's count at 1): the step's launches
    (``per_step``), a finite loss that moves the parameters, and the same
    loss, gradients, parameters, BatchNorm statistics and Adam moments bit
    for bit as the step with the plain kernels patched in (deterministic
    mode); then the step's device time, host time and peak memory. With
    ``full``: the loss falling over six steps on the one batch, the
    profiler's busy share and top items, and images/s through ``run()``.
    Returns (launches per step, stats)."""
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.training.imagenet import TrainImageNet

    dev = torch.device("cuda")

    def experiment(epochs):
        exp = TrainImageNet()
        configure(exp, {
            "model": model, "model.compute_dtype": "bfloat16",
            "model.binary_compute": "xnor_popcount",
            "optimizer.schedule.base_lr": 1e-3,
            "loader.dataset.num_train_examples": TRAIN_EXAMPLES,
            "batch_size": TRAIN_BATCH, "epochs": epochs, "steps_per_epoch": 3,
            "validate": False, "seed": 0, "device": "cuda", "verbose": False,
        }, name="experiment")
        return exp

    t0 = time.perf_counter()
    exp = experiment(epochs=4)
    state = exp.build_state(dev)
    batches = exp.loader.batches("train", device=dev, epoch=0, max_batches=1)
    batch = next(batches)
    batches.close()
    step = exp._train_step_fn()
    state.opt_state["count"] = 1
    init = _snapshot(state)
    param_names = [name for name, _ in state.module.named_parameters()]
    print(f"{tag}: {model} ({sum(p.numel() for p in state.module.parameters())} parameters) "
          f"built and one batch {tuple(batch['input'].shape)} staged in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def traced_step():
        grads = {}
        real = state.tx.update

        def spy(g, opt_state, params):
            grads.update({k: v.detach().clone() for k, v in g.items()})
            real(g, opt_state, params)

        state.tx.update = spy
        try:
            _, metrics = step(state, batch)
        finally:
            del state.tx.update
        torch.cuda.synchronize()
        out = {"loss": metrics["loss"].clone()}
        out.update({f"grad {k}": v for k, v in grads.items()})
        out.update({f"state {k}": v.detach().clone()
                    for k, v in state.module.state_dict().items()})
        for key in ("mu", "nu"):
            out.update({f"{key} {k}": v.clone() for k, v in state.opt_state[key].items()})
        return out

    with deterministic(torch):
        _restore(state, init)
        bc.reset_launches()
        got = traced_step()
        launches = {k: v for k, v in bc.LAUNCHES.items() if v}
        check(launches == per_step, f"{tag}: one step launched {launches}, want {per_step}")
        loss = got["loss"].item()
        check(math.isfinite(loss), f"{tag}: loss {loss} is not finite")
        moved = sum(not _same_bits(torch, got[f"state {n}"], init[0][n]) for n in param_names)
        check(moved > 0, f"{tag}: the step moved no parameter")
        _restore(state, init)
        before = dict(bc.LAUNCHES)
        with _plain_binary(bc):
            want = traced_step()
        check(bc.LAUNCHES == before, f"{tag}: the plain-kernel step launched kernels")
        bad = [k for k in got if not _same_bits(torch, got[k], want[k])]
        check(set(got) == set(want) and not bad,
              f"{tag}: the plain-kernel step differs in {len(bad)} of {len(got)} tensors, "
              f"e.g. {bad[:4]}")
        print(f"{tag}: one step, loss {loss:.6f}, launches {launches}, {moved} of "
              f"{len(param_names)} parameter tensors moved; equal to the plain-kernel step bit "
              f"for bit ({len(got)} tensors: loss, gradients, parameters, BN statistics, Adam "
              f"moments)", flush=True)
        del got, want

    _restore(state, init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    times, walls = [], []
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        step(state, batch)
        end.record()
        end.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
        times.append(start.elapsed_time(end))
    step_ms = statistics.median(times[1:])
    stats = {"step_ms": step_ms, "step_wall_ms": statistics.median(walls[1:]),
             "images_per_s_step": TRAIN_BATCH / step_ms * 1e3,
             "peak_gib": peak / 2.0**30, "step_gib": (peak - base) / 2.0**30}
    if full:
        _restore(state, init)
        losses = [step(state, batch)[1]["loss"].item() for _ in range(6)]
        check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
              f"{tag}: losses {losses} over six steps on one batch not finite or not falling")
        busy_ms, launched = _profile_train_step(torch, lambda: step(state, batch), step_ms, tag)
        run_exp = experiment(epochs=1)
        bc.reset_launches()
        history = run_exp.run()
        torch.cuda.synchronize()
        for name, n in per_step.items():
            check(bc.LAUNCHES[name] == 3 * n,
                  f"{tag} run(): {name} launched {bc.LAUNCHES[name]} times, want {3 * n}")
        stats.update({"losses_one_batch": losses, "device_busy_ms": busy_ms,
                      "device_busy_share": busy_ms / step_ms,
                      "device_activities_per_step": launched,
                      "images_per_s_run": history["train"][0]["examples_per_sec"],
                      "run_loss": history["train"][0]["loss"]})
        del run_exp
    print(f"{tag} on {smi}: {json.dumps(stats)}", flush=True)
    del exp, state, batch
    torch.cuda.empty_cache()
    return launches, stats


#: The binary-net recipe (phase 16), at DistillImageNet's geometry: a
#: ResNet-50 teacher trained for TEACHER_STEPS steps and exported, a
#: RealToBinaryNet student (bf16, "xnor_popcount": K1 + K3 in each of its
#: 16 binary convs, three at stride 2) distilled from it for RECIPE_STEPS
#: steps with Bop (Adam under WarmupCosine on the fp side), the flip
#: ratio, the EMA and ``nan_policy=skip``, then exported, scored and
#: served. Bop's ``schedule`` must stay unconfigured (it has no learning
#: rate), so the ImageNet task's WarmupCosine moves to the fp optimizer.
TEACHER_STEPS, RECIPE_STEPS = 2, 3
RECIPE = {
    "model.binary_compute": "xnor_popcount", "alpha": 0.4, "temperature": 2.0,
    "optimizer": "Bop", "optimizer.schedule": "ConstantSchedule",
    "optimizer.fp_optimizer.schedule": "WarmupCosine",
    "optimizer.fp_optimizer.schedule.base_lr": 2.5e-3,
    "track_flip_ratio": True, "ema_decay": 0.999, "nan_policy": "skip",
}
RECIPE_PER_STEP = {"pack_rows": 16, "conv_gemm_popcount": 16}
REMAT = ("none", "full", "dots", "quant")


def recipe_kernel_phase(torch, bc):
    """K1 and K3 at the 16 binary convs of the student's batch-128
    training step (RealToBinaryNet's are Bi-Real-Net-18's shapes), each
    equal to its plain version and the same bits twice, timed beside it
    and cuDNN's conv. Returns per-kernel totals over one step."""
    g = torch.Generator().manual_seed(15)
    totals = _binary_totals()
    del totals["packed_weight_matmul"]
    record = _recorder(torch, totals, plain_reps=1, plain_inner=1)
    _conv_rows(torch, bc, record, [(n, TRAIN_BATCH, h, h, ci, co, 3, s)
                                   for n, h, ci, co, s in BIREAL_CONVS], g)
    torch.cuda.empty_cache()
    return totals


def _recipe_tensors(state):
    """Every tensor a recipe step changes, by name: the module's
    parameters and statistics, the EMA and the optimizer state (Bop's
    memory and count, Adam's moments and count)."""
    from zookeeper_tpu_torch.training.optimizer import state_tensors

    out = {f"state {k}": v for k, v in state.module.state_dict().items()}
    out.update({f"ema {k}": v for k, v in state.ema_params.items()})
    out.update({f"opt {i}": t for i, t in enumerate(state_tensors(state.opt_state))})
    return out


def _recipe_snapshot(state):
    import copy

    return (copy.deepcopy(state.module.state_dict()),
            {k: v.clone() for k, v in state.ema_params.items()},
            copy.deepcopy(state.opt_state), state.step)


def _recipe_restore(state, snap) -> None:
    import copy

    module_state, ema, opt, step = snap
    state.module.load_state_dict(module_state)
    for k, v in ema.items():
        state.ema_params[k].copy_(v)
    state.opt_state, state.step = copy.deepcopy(opt), step


def recipe_phase(torch, bc, smi):
    """The binary-net recipe at full width through its entry points: a
    ResNet-50 teacher exported by ``TrainImageNet``, a RealToBinaryNet
    distilled from it by ``DistillImageNet`` (Bop, EMA, flip ratio,
    ``nan_policy=skip``; K1 and K3 16 times a step) and exported, one
    step held bit for bit to the plain kernels' and every remat policy's
    to "none", a NaN batch skipped with the state unchanged (and
    ``NonFiniteLossError`` under "halt"), ``EvalExperiment`` on the export
    equal to the EMA eval step, and ``ServingConfig`` serving the export
    (K1, K3 16 a forward) with the logits of an engine bound to the EMA
    weights. Returns (launches per step, per forward, stats)."""
    import tempfile

    import numpy as np

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.data.pipeline import DataLoader
    from zookeeper_tpu_torch.resilience import NonFiniteLossError
    from zookeeper_tpu_torch.serving import InferenceEngine, ServingConfig
    from zookeeper_tpu_torch.training import EvalExperiment, make_eval_step, make_train_step
    from zookeeper_tpu_torch.training.experiment import run_weighted_eval
    from zookeeper_tpu_torch.training.imagenet import DistillImageNet, TrainImageNet

    dev = torch.device("cuda")
    tag = "recipe"
    common = {"loader.dataset.num_train_examples": TRAIN_EXAMPLES,
              "loader.dataset.num_validation_examples": TRAIN_BATCH,
              "batch_size": TRAIN_BATCH, "seed": 0, "device": "cuda", "verbose": False,
              "validate": False}
    stats = {}
    with tempfile.TemporaryDirectory(prefix="zk_recipe_") as tmp:
        teacher_dir, student_dir = os.path.join(tmp, "teacher"), os.path.join(tmp, "student")

        # 1. The teacher: TrainImageNet model=ResNet50, exported.
        t0 = time.perf_counter()
        teacher = TrainImageNet()
        configure(teacher, {**common, "model": "ResNet50", "model.compute_dtype": "bfloat16",
                            "epochs": 1, "steps_per_epoch": TEACHER_STEPS,
                            "export_model_to": teacher_dir}, name="teacher")
        bc.reset_launches()
        losses = [e["loss"] for e in teacher.run()["train"]]
        check(all(math.isfinite(v) for v in losses), f"{tag}: teacher losses {losses}")
        check(not any(bc.LAUNCHES.values()), f"{tag}: the teacher launched {bc.LAUNCHES}")
        check(os.path.isfile(os.path.join(teacher_dir, "model.pt")), f"{tag}: no teacher export")
        print(f"{tag}: ResNet50 teacher, {TEACHER_STEPS} steps (loss {losses}), exported in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del teacher
        torch.cuda.empty_cache()

        # 2. The student: DistillImageNet through run(), one step an epoch.
        def distill(**overrides):
            exp = DistillImageNet()
            configure(exp, {**common, **RECIPE, "teacher_checkpoint": teacher_dir,
                            "epochs": RECIPE_STEPS, "steps_per_epoch": 1,
                            "export_model_to": student_dir, **overrides}, name="distill")
            return exp

        t0 = time.perf_counter()
        exp = distill()
        bc.reset_launches()
        history = exp.run()
        torch.cuda.synchronize()
        launches = {k: v for k, v in bc.LAUNCHES.items() if v}
        want = {k: n * RECIPE_STEPS for k, n in RECIPE_PER_STEP.items()}
        check(launches == want, f"{tag} run(): launched {launches} in {RECIPE_STEPS} steps, "
                                f"want {want}")
        rows = [{k: e[k] for k in ("loss", "kd_loss", "flip_ratio", "skipped_steps",
                                   "examples_per_sec")} for e in history["train"]]
        check(all(math.isfinite(r["loss"]) and math.isfinite(r["kd_loss"])
                  and 0.0 < r["flip_ratio"] < 1.0 and r["skipped_steps"] == 0.0 for r in rows),
              f"{tag} run(): per step {rows}")
        check(os.path.isfile(os.path.join(student_dir, "model.pt")), f"{tag}: no student export")
        final = exp.final_state
        print(f"{tag}: DistillImageNet RealToBinaryNet <- ResNet50, {RECIPE_STEPS} steps in "
              f"{time.perf_counter() - t0:.1f} s, K1/K3 per step "
              f"{ {k: v // RECIPE_STEPS for k, v in launches.items()} }; per step "
              f"{json.dumps(rows)}", flush=True)
        stats["run_steps"] = rows

        # 3-6 run from one fixed state of a second experiment: one warm step
        # (Adam's count at 1, where WarmupCosine's rate is not 0; the
        # counts then live on the card), then every comparison from it.
        step_exp = distill(epochs=2, steps_per_epoch=2)
        state = step_exp.build_state(dev)
        teacher_module = step_exp._teacher_fn()
        kwargs = step_exp._train_step_kwargs()
        steps = {p: make_train_step(**{**kwargs, "remat": p},
                                    distill=(teacher_module, RECIPE["alpha"],
                                             RECIPE["temperature"])) for p in REMAT}
        batches = step_exp.loader.batches("train", device=dev, epoch=0, max_batches=1)
        batch = next(batches)
        batches.close()
        steps["none"](state, batch)
        init = _recipe_snapshot(state)
        n_params = sum(p.numel() for p in state.module.parameters())

        def traced(step_fn, b=batch):
            grads = {}
            real = state.tx.update

            def spy(g, opt_state, params):
                grads.update({k: v.detach().clone() for k, v in g.items()})
                return real(g, opt_state, params)

            state.tx.update = spy
            try:
                _, metrics = step_fn(state, b)
            finally:
                del state.tx.update
            torch.cuda.synchronize()
            out = {f"metric {k}": v.clone() for k, v in metrics.items()}
            out.update({f"grad {k}": v for k, v in grads.items()})
            out.update({k: v.detach().clone() for k, v in _recipe_tensors(state).items()})
            return out

        def same(a, b, label):
            bad = [k for k in a if not _same_bits(torch, a[k], b[k])]
            check(set(a) == set(b) and not bad,
                  f"{tag}: {label} differs in {len(bad)} of {len(a)} tensors, e.g. {bad[:4]}")

        with deterministic(torch):
            # 3. The kernel step against the plain-kernel step.
            _recipe_restore(state, init)
            bc.reset_launches()
            got = traced(steps["none"])
            step_launches = {k: v for k, v in bc.LAUNCHES.items() if v}
            check(step_launches == RECIPE_PER_STEP,
                  f"{tag}: one step launched {step_launches}, want {RECIPE_PER_STEP}")
            _recipe_restore(state, init)
            before = dict(bc.LAUNCHES)
            with _plain_binary(bc):
                plain = traced(steps["none"])
            check(bc.LAUNCHES == before, f"{tag}: the plain-kernel step launched kernels")
            same(got, plain, "the plain-kernel step")
            print(f"{tag}: one step ({n_params} parameters), loss "
                  f"{got['metric loss'].item():.6f}, kd_loss {got['metric kd_loss'].item():.6f}, "
                  f"flip_ratio {got['metric flip_ratio'].item():.6f}, launches {step_launches}; "
                  f"equal to the plain-kernel step bit for bit ({len(got)} tensors: metrics, "
                  "gradients, parameters, BN statistics, EMA, Bop memory and count, Adam "
                  "moments and count)", flush=True)
            del plain

            # 4. Every remat policy against "none".
            remat_launches = {"none": step_launches}
            for p in REMAT[1:]:
                _recipe_restore(state, init)
                bc.reset_launches()
                res = traced(steps[p])
                remat_launches[p] = {k: v for k, v in bc.LAUNCHES.items() if v}
                # The forward runs again for the backward: K1, K3 twice.
                want = {k: 2 * n for k, n in RECIPE_PER_STEP.items()}
                check(remat_launches[p] == want,
                      f"{tag}: remat={p} launched {remat_launches[p]}, want {want}")
                same(got, res, f"the remat={p} step")
                del res
            print(f"{tag}: remat full, dots and quant equal to none bit for bit "
                  f"({len(got)} tensors); launches {json.dumps(remat_launches)}", flush=True)

            # 5. A batch holding a NaN under nan_policy=skip.
            _recipe_restore(state, init)
            before = {k: v.detach().clone() for k, v in _recipe_tensors(state).items()}
            bad_input = batch["input"].clone()
            bad_input[0, 0, 0, 0] = float("nan")
            _, metrics = steps["none"](state, {**batch, "input": bad_input})
            torch.cuda.synchronize()
            check(metrics["skipped_steps"].item() == 1.0,
                  f"{tag}: the NaN step reports skipped_steps {metrics['skipped_steps'].item()}")
            after = {k: v.detach() for k, v in _recipe_tensors(state).items()}
            same(before, after, "the state after the NaN step")
            check(state.step == init[3] + 1, f"{tag}: the NaN step did not advance state.step")
            print(f"{tag}: the NaN step skipped (skipped_steps 1), {len(before)} state tensors "
                  "unchanged bit for bit", flush=True)
            del got, before, after

        real_batches = DataLoader.batches

        def nan_batches(loader, split, *args, **kw):
            for b in real_batches(loader, split, *args, **kw):
                yield {**b, "input": b["input"] * float("nan")}

        halt = distill(epochs=1, steps_per_epoch=1, nan_policy="halt", export_model_to=None)
        try:
            with mock.patch.object(DataLoader, "batches", nan_batches):
                halt.run()
            fail(f"{tag}: nan_policy=halt did not raise on a NaN batch")
        except NonFiniteLossError as e:
            print(f"{tag}: nan_policy=halt raised NonFiniteLossError: {e}", flush=True)
        del halt
        torch.cuda.empty_cache()

        # 6. Time, peak memory and busy share, in the default settings.
        def timed(step_fn, n=4):
            step_fn(state, batch)
            torch.cuda.synchronize()
            times, walls = [], []
            for _ in range(n):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t1 = time.perf_counter()
                start.record()
                step_fn(state, batch)
                end.record()
                end.synchronize()
                walls.append((time.perf_counter() - t1) * 1e3)
                times.append(start.elapsed_time(end))
            return statistics.median(times), statistics.median(walls)

        peaks = {}
        for p in REMAT:
            _recipe_restore(state, init)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            steps[p](state, batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            peaks[p] = {"peak_gib": peak / 2.0**30, "step_gib": (peak - base) / 2.0**30}
        # The step with all of the recipe's options and without some, in
        # turns (forward order, then backward), three timed steps each.
        distill_only = (teacher_module, RECIPE["alpha"], RECIPE["temperature"])
        variants = {
            "recipe": steps["none"],
            "bop_distill_only": make_train_step(kwargs["loss_fn"], distill=distill_only),
            "plus_ema": make_train_step(kwargs["loss_fn"], distill=distill_only,
                                        ema_decay=RECIPE["ema_decay"]),
            "plus_flip_ratio": make_train_step(kwargs["loss_fn"], distill=distill_only,
                                               flip_ratio_pattern=kwargs["flip_ratio_pattern"]),
            "plus_nan_skip": make_train_step(kwargs["loss_fn"], distill=distill_only,
                                             nan_policy="skip"),
        }
        _recipe_restore(state, init)
        turns = {k: [] for k in variants}
        for k in list(variants) + list(reversed(variants)):
            turns[k].append(timed(variants[k], n=3))
        variant_ms = {k: statistics.median(t[0] for t in v) for k, v in turns.items()}
        step_ms = variant_ms["recipe"]
        wall_ms = statistics.median(t[1] for t in turns["recipe"])
        remat_ms = {p: timed(steps[p], n=2)[0] for p in REMAT[1:]}
        x = batch["input"]
        with torch.no_grad():
            teacher_ms = time_ms(torch, lambda: teacher_module(x), reps=5, inner=1)
        busy_ms, launched = _profile_train_step(torch, lambda: steps["none"](state, batch),
                                                step_ms, tag)
        base_busy, base_launched = _profile_train_step(
            torch, lambda: variants["bop_distill_only"](state, batch),
            variant_ms["bop_distill_only"], f"{tag} (Bop and distillation only)", top=5)
        stats.update({
            "step_ms": step_ms, "step_wall_ms": wall_ms,
            "images_per_s_step": TRAIN_BATCH / step_ms * 1e3,
            "device_busy_ms": busy_ms, "device_busy_share": busy_ms / step_ms,
            "device_activities_per_step": launched, "teacher_forward_ms": teacher_ms,
            "remat_step_ms": remat_ms, "remat_peak": peaks, "feature_step_ms": variant_ms,
            "bop_distill_only_busy_ms": base_busy,
            "bop_distill_only_activities": base_launched,
            "images_per_s_run": [r["examples_per_sec"] for r in rows],
        })
        print(f"{tag}: step {step_ms:.3f} ms device ({wall_ms:.3f} host), busy "
              f"{100 * busy_ms / step_ms:.1f}%, teacher forward {teacher_ms:.3f} ms, remat "
              f"{json.dumps(remat_ms)}, peaks {json.dumps(peaks)}, features (in turns) "
              f"{json.dumps(variant_ms)}", flush=True)
        del state, steps, variants, step_exp
        torch.cuda.empty_cache()

        # 7. EvalExperiment on the export against the EMA eval step.
        ev = EvalExperiment()
        configure(ev, {
            "loader.dataset": "SyntheticImageNet",
            "loader.dataset.num_train_examples": TRAIN_EXAMPLES,
            "loader.dataset.num_validation_examples": TRAIN_BATCH,
            "loader.preprocessing": "ImageClassificationPreprocessing",
            "loader.preprocessing.height": 224, "loader.preprocessing.width": 224,
            "loader.preprocessing.channels": 3, "loader.preprocessing.augment": True,
            "loader.preprocessing.random_resized_crop": True, "loader.num_workers": 8,
            "model": "RealToBinaryNet", "model.compute_dtype": "bfloat16",
            "model.binary_compute": "xnor_popcount", "checkpoint": student_dir,
            "weights": "auto", "batch_size": TRAIN_BATCH, "seed": 0, "track_top5": True,
            "device": "cuda", "verbose": False,
        }, name="evaluate")
        with deterministic(torch):
            scored = ev.run()
            want = run_weighted_eval(exp.loader, "validation",
                                     make_eval_step(use_ema=True, top5=True), final, dev)
        check(scored == want, f"{tag}: EvalExperiment {scored} differs from the EMA eval "
                              f"step's {want}")
        print(f"{tag}: EvalExperiment on the export (weights=auto) equals the EMA eval step: "
              f"{json.dumps(scored)}", flush=True)
        stats["eval"] = scored

        # 8. ServingConfig serving the export.
        cfg = ServingConfig()
        configure(cfg, {"model": "RealToBinaryNet", "model.compute_dtype": "bfloat16",
                        "model.binary_compute": "xnor_popcount", **IMAGENET,
                        "checkpoint": student_dir, "engine.batch_buckets": (1, BATCH),
                        "requests": 16, "max_request": BATCH, "seed": 0, "device": "cuda",
                        "verbose": False}, name="serving")
        buckets = []
        real_infer = InferenceEngine.infer

        def spy(engine, xb):
            buckets.append(engine.bucket_for(len(xb)))
            return real_infer(engine, xb)

        bc.reset_launches()
        with mock.patch.object(InferenceEngine, "infer", spy):
            result = cfg.run()
        torch.cuda.synchronize()
        served = {k: v for k, v in bc.LAUNCHES.items() if v}
        want = {k: n * len(buckets) for k, n in RECIPE_PER_STEP.items()}
        check(served == want, f"{tag} serving: {len(buckets)} forwards launched {served}, "
                              f"want {want}")
        module = cfg.model.build(cfg.input_shape, cfg.num_classes)
        module.load_state_dict({**final.module.state_dict(), **final.ema_params})
        direct = InferenceEngine()
        configure(direct, {"batch_buckets": (1, BATCH)}, name="engine")
        direct.bind(module, cfg.input_shape, dtype=torch.bfloat16, device="cuda")
        xb = np.random.default_rng(1).normal(size=(BATCH, *cfg.input_shape)).astype(np.float32)
        with deterministic(torch):
            logits, bound = cfg.engine.infer(xb), direct.infer(xb)
            torch.cuda.synchronize()
        check(bool(torch.isfinite(logits).all()) and _same_bits(torch, logits, bound),
              f"{tag} serving: the export's logits differ from the EMA-bound engine's")
        cfg.engine.infer(xb)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(20):
            cfg.engine.infer(xb)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        stats["serving"] = {"images_per_s": BATCH * 20 / dt, "batch8_forward_ms": dt / 20 * 1e3,
                            "p50_ms": result["latency_p50_ms"], "p99_ms": result["latency_p99_ms"]}
        print(f"{tag} serving: {result['requests']} requests, {len(buckets)} forwards, "
              f"launches {served} (16 + 16 a forward), logits equal to the EMA-bound engine's "
              f"bit for bit; {json.dumps(stats['serving'])}", flush=True)
        del cfg, direct, module, exp, final
    torch.cuda.empty_cache()
    print(f"{tag} on {smi}: {json.dumps(stats)}", flush=True)
    return step_launches, stats


#: The checkpoint phase: QuickNet-Large's TrainImageNet step as the
#: training phase runs it (int8, packed residuals, batch 128, bf16: K6
#: twice, K7 and K8 once in each of its 32 binary convs), one epoch of
#: CKPT_STEPS steps saved every CKPT_EVERY steps, killed and resumed.
CKPT_STEPS, CKPT_EVERY = 6, 2
CKPT = {"model": "QuickNetLarge", "model.compute_dtype": "bfloat16",
        "model.binary_compute": "int8", "model.pack_residuals": True,
        "loader.dataset.num_train_examples": CKPT_STEPS * TRAIN_BATCH,
        "batch_size": TRAIN_BATCH, "epochs": 1, "steps_per_epoch": CKPT_STEPS,
        "validate": False, "seed": 0, "device": "cuda", "verbose": False}
CKPT_PER_STEP = {name: n * sum(s[0] for s in SECTIONS) for name, n in RESID_PER_CONV.items()}
#: Its smaller-depth legs: the recipe student (RealToBinaryNet with one
#: block a section, K1 + K3 in its 4 binary convs, Bop + Adam, EMA, flip
#: ratio, nan_policy=skip with a NaN at step counter CKPT_NAN) under a
#: seeded ResNet-50 teacher's export, and TrainLM at 2 layers (K9-lse, K10,
#: K11 2 each a step; ``checkpoint_phase`` cuts ``LM_TRAIN_CONFIG``).
CKPT_NAN = 4
CKPT_RECIPE = {**RECIPE, "model.blocks_per_section": (1, 1, 1, 1),
               "loader.dataset.num_train_examples": CKPT_STEPS * TRAIN_BATCH,
               "loader.dataset.num_validation_examples": TRAIN_BATCH,
               "batch_size": TRAIN_BATCH, "epochs": 1, "steps_per_epoch": CKPT_STEPS,
               "validate": False, "seed": 0, "device": "cuda", "verbose": False}


class _ProcessDied(Exception):
    """An injected crash at a step boundary: no preemption save, as when
    the process is killed outright."""

    def __init__(self, step: int):
        self.step = step
        super().__init__(f"injected crash at step {step}")


def _flat_state(torch, state):
    """Every tensor and count the next step reads, by name, copied to the
    host: the module's parameters and statistics, the optimizer state
    with its counts, the EMA and the step."""
    out = {f"module {k}": v for k, v in state.module.state_dict().items()}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"opt {prefix}{k}"] = v

    walk(state.opt_state, "")
    out.update({f"ema {k}": v for k, v in (state.ema_params or {}).items()})
    out["step"] = state.step
    return {k: (v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor)
                else torch.tensor(int(v), dtype=torch.int64)) for k, v in out.items()}


def _state_spread(torch, got, want):
    """(tensors whose bits differ, largest difference) between two
    ``_flat_state`` results."""
    check(set(got) == set(want), f"checkpoint: state names differ: {sorted(set(got) ^ set(want))[:4]}")
    bad = [k for k in want if not _same_bits(torch, got[k], want[k])]
    return bad, max([_max_abs_err(torch, got[k], want[k]) for k in bad] or [0.0])


def _kill_and_resume(torch, make, counters, names, directory, plan, crash_at=None, conf=None):
    """``make(conf)`` checkpointing into ``directory`` every CKPT_EVERY
    steps, run by ``run_with_recovery`` under ``plan``; ``crash_at`` raises
    ``_ProcessDied`` at that step boundary of the first attempt. Returns
    (experiment, result, attempts): per attempt the loader's start batches,
    the kernels' launches (counts set to 0 just before it) and the steps
    finalized on disk after it."""
    from zookeeper_tpu_torch.data.pipeline import DataLoader
    from zookeeper_tpu_torch.resilience import RECOVERABLE, faults, run_with_recovery
    from zookeeper_tpu_torch.training import finalized_steps

    exp = make({"checkpointer.directory": directory,
                "checkpointer.save_every_steps": CKPT_EVERY, **(conf or {})})
    attempts = []
    real_run, real_check, real_batches = exp.run, exp._boundary_check, DataLoader.batches

    def run():
        for name in counters:
            counters[name] = 0
        attempts.append({"start_batches": []})
        try:
            return real_run()
        finally:
            torch.cuda.synchronize()
            attempts[-1]["launches"] = {n: counters[n] for n in names}
            attempts[-1]["finalized"] = finalized_steps(directory)
            attempts[-1]["remnants"] = sorted(n for n in os.listdir(directory) if ".tmp-" in n)

    def boundary(state, global_step):
        if global_step == crash_at and len(attempts) == 1:
            raise _ProcessDied(global_step)
        return real_check(state, global_step)

    def batches(loader, split="train", **kw):
        if split == "train":
            attempts[-1]["start_batches"].append(kw.get("start_batch", 0))
        return real_batches(loader, split, **kw)

    exp.run, exp._boundary_check = run, boundary
    with faults.injected(plan), mock.patch.object(DataLoader, "batches", batches):
        result = run_with_recovery(exp, backoff_s=0.0, sleep=lambda s: None,
                                   recover_on=RECOVERABLE + (_ProcessDied,))
    return exp, result, attempts


def _resume_leg(torch, tag, make, counters, names, per_step, tmp, ref_plan_kw, legs):
    """One model's kill-and-resume legs against its uninterrupted run: the
    reference twice (its spread), then each leg ``(label, conf, plan
    fields, crash_at, want_resume)`` killed and resumed, held to the
    reference within that spread (bitwise when it is 0), with its launches
    per attempt. Returns (reference experiment, stats, legs' results)."""
    from zookeeper_tpu_torch.resilience import FaultPlan, faults

    refs = []
    for _ in range(2):
        for name in counters:
            counters[name] = 0
        exp = make({})
        with faults.injected(FaultPlan(**ref_plan_kw)):
            exp.run()
        torch.cuda.synchronize()
        ref_launches = {n: counters[n] for n in names}
        refs.append(_flat_state(torch, exp.final_state))
        if len(refs) == 1:
            del exp
            torch.cuda.empty_cache()
    want = {n: k * CKPT_STEPS for n, k in per_step.items()}
    check(ref_launches == want, f"{tag}: the uninterrupted run launched {ref_launches}, want {want}")
    bad, spread = _state_spread(torch, refs[1], refs[0])
    print(f"{tag}: uninterrupted run twice, {len(refs[0])} tensors, {len(bad)} differ, "
          f"spread {spread}", flush=True)
    stats = {"tensors": len(refs[0]), "reference_spread": spread, "reference_differ": len(bad)}
    results = {}
    for label, conf, plan_kw, crash_at, want_resume in legs:
        directory = os.path.join(tmp, f"{tag}-{label}".replace(" ", "-"))
        got_exp, result, attempts = _kill_and_resume(
            torch, make, counters, names, directory, FaultPlan(**ref_plan_kw, **plan_kw),
            crash_at=crash_at, conf=conf)
        check(result.restarts == 1 and len(attempts) == 2,
              f"{tag} {label}: {result.restarts} restarts, causes {result.causes}")
        cause = result.causes[0]
        resumed_at = attempts[1]["start_batches"][0]
        check(resumed_at == want_resume,
              f"{tag} {label}: resumed at start_batch {resumed_at}, want {want_resume}")
        first_steps = cause.step
        for i, (a, n_steps) in enumerate(zip(attempts, (first_steps, CKPT_STEPS - resumed_at))):
            want_a = {n: k * n_steps for n, k in per_step.items()}
            check(a["launches"] == want_a,
                  f"{tag} {label}: attempt {i + 1} launched {a['launches']}, want {want_a}")
        bad, diff = _state_spread(torch, _flat_state(torch, got_exp.final_state), refs[0])
        ok = not bad if spread == 0.0 else diff <= spread
        check(ok, f"{tag} {label}: the resumed run differs from the uninterrupted one in "
                  f"{len(bad)} of {len(refs[0])} tensors (largest {diff}, the reference's "
                  f"spread {spread}), e.g. {bad[:4]}")
        got_exp.checkpointer.close()
        results[label] = {
            "cause": type(cause).__name__, "stopped_at": cause.step, "directory": directory,
            "finalized_after_kill": attempts[0]["finalized"],
            "remnants_after_kill": attempts[0]["remnants"], "resumed_at_batch": resumed_at,
            "launches_before": attempts[0]["launches"], "launches_after": attempts[1]["launches"],
            "restore_ms": result.restore_ms, "save_wait_ms": result.save_wait_ms,
            "skipped_steps": sum(e.get("skipped_steps", 0.0) for e in result.history["train"]),
            "differ": len(bad), "max_abs_diff": diff, "experiment": got_exp,
        }
        print(f"{tag} {label}: {type(cause).__name__} at step {cause.step} (steps on disk "
              f"{attempts[0]['finalized']}), resumed at start_batch {resumed_at}, launches "
              f"{attempts[0]['launches']} before and {attempts[1]['launches']} after, restore "
              f"{result.restore_ms} ms, save wait {result.save_wait_ms} ms; final state "
              f"{'bit-identical to' if not bad else f'within {diff} of'} the uninterrupted "
              f"run's ({len(refs[0])} tensors)", flush=True)
    return exp, stats, results


def checkpoint_phase(torch, bc, A, smi):
    """The Checkpointer through its entry points on the card. QuickNet-Large
    TrainImageNet at full width: (a) CKPT_STEPS steps uninterrupted (twice,
    their spread); (b) saved every CKPT_EVERY steps, mode sync, killed by
    ``FaultPlan(kill_at_step=3)`` under ``run_with_recovery``: Preempted
    once, step 3 saved, resumed at start_batch 3; (c) mode async with
    ``kill_during_async_write=4`` and the process dying at step 5: resumed
    from step 2; (c2) mode async killed at step 3 (the preemption drains
    the writer); each ends equal to (a) in every tensor, K6/K7/K8 launched
    on both sides of the resume. Then the save's bytes and times, the
    async snapshot's stall and write, the step with async saves against
    none, and the restore. (d) the recipe student and TrainLM (2 layers)
    killed and resumed the same way; (e) EvalExperiment and ServingConfig
    on (d)'s recipe directory against the same state's export. Returns
    (launches over each main path, stats)."""
    import tempfile

    import numpy as np

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.models import ResNet50
    from zookeeper_tpu_torch.serving import ServingConfig
    from zookeeper_tpu_torch.training import Checkpointer, EvalExperiment, finalized_steps
    from zookeeper_tpu_torch.training.checkpoint import STATE_FILE, export_trees, save_model
    from zookeeper_tpu_torch.training.imagenet import DistillImageNet, TrainImageNet
    from zookeeper_tpu_torch.training.lm import TrainLM

    tag = "checkpoint"
    dev = torch.device("cuda")
    stats, launches = {}, {}

    def quicknet(conf):
        exp = TrainImageNet()
        configure(exp, {**CKPT, **conf}, name="experiment")
        return exp

    with tempfile.TemporaryDirectory(prefix="zk_ckpt_") as tmp:
        t0 = time.perf_counter()
        with deterministic(torch):
            ref, stats["quicknet"], legs = _resume_leg(
                torch, tag, quicknet, bc.LAUNCHES, RESID_KERNELS, CKPT_PER_STEP, tmp, {}, [
                    ("sync", {"checkpointer.mode": "sync"}, {"kill_at_step": 3}, None, 3),
                    ("async", {"checkpointer.mode": "async"}, {"kill_during_async_write": 4},
                     5, 2),
                    ("async_preempted", {"checkpointer.mode": "async"}, {"kill_at_step": 3},
                     None, 3),
                ])
        sync, asyn = legs["sync"], legs["async"]
        check(sync["cause"] == "Preempted" and sync["stopped_at"] == 3
              and sync["finalized_after_kill"] == [2, 3],
              f"{tag} sync: stopped by {sync['cause']} at {sync['stopped_at']}, steps on disk "
              f"{sync['finalized_after_kill']}, want Preempted at 3 with steps [2, 3]")
        check(asyn["cause"] == "_ProcessDied" and asyn["finalized_after_kill"] == [2]
              and any(n.startswith("4.tmp-") for n in asyn["remnants_after_kill"]),
              f"{tag} async: steps on disk {asyn['finalized_after_kill']} and remnants "
              f"{asyn['remnants_after_kill']} after the killed write, want [2] and step 4's")
        for label, leg in legs.items():
            launches[f"quicknet {label}"] = {
                n: leg["launches_before"][n] + leg["launches_after"][n] for n in RESID_KERNELS}
            stats["quicknet"][label] = {k: v for k, v in leg.items()
                                        if k not in ("experiment", "directory")}
        print(f"{tag}: QuickNet-Large legs in {time.perf_counter() - t0:.1f} s", flush=True)

        # Save, snapshot, write and restore times on the final state, in the
        # default settings.
        state = ref.final_state
        step_fn = ref._train_step_fn()
        batches = ref.loader.batches("train", device=dev, epoch=0, max_batches=1)
        batch = next(batches)
        batches.close()
        for name in list(legs):
            legs[name].pop("experiment")
        del legs
        torch.cuda.empty_cache()

        def checkpointer(name, **conf):
            ck = Checkpointer()
            configure(ck, {"directory": os.path.join(tmp, name), "max_to_keep": 2, **conf},
                      name="checkpointer")
            return ck

        ck_sync, ck_async = checkpointer("timing-sync"), checkpointer("timing-async", mode="async")
        sync_ms, stall_ms, write_ms = [], [], []
        for i in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ck_sync.save(state, step=100 + i)
            sync_ms.append((time.perf_counter() - t1) * 1e3)
            t1 = time.perf_counter()
            ck_async.save(state, step=100 + i)
            stall_ms.append((time.perf_counter() - t1) * 1e3)
            ck_async.wait()
            write_ms.append(ck_async._writer().stats["last_write_ms"])
        nbytes = os.path.getsize(os.path.join(tmp, "timing-sync", "102", STATE_FILE))
        t1 = time.perf_counter()
        ck_sync.restore_state(state)
        torch.cuda.synchronize()
        restore_read_ms = (time.perf_counter() - t1) * 1e3

        def steps(every, n=16):
            """Per step over ``n`` steps with an async save every ``every``
            steps (0: none): (device ms between events, host ms)."""
            step_fn(state, batch)
            torch.cuda.synchronize()
            ck_async.wait()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            start.record()
            for i in range(n):
                step_fn(state, batch)
                if every and i % every == every - 1:
                    ck_async.save(state, step=200 + state.step)
            end.record()
            end.synchronize()
            wall = (time.perf_counter() - t1) * 1e3 / n
            ck_async.wait()
            return start.elapsed_time(end) / n, wall

        # Every 2 steps the writer (one write ~ 5 steps) falls behind and the
        # "wait" queue holds the training thread back; every 8 it keeps up,
        # so only the snapshot and the writer's host time remain.
        turns = {0: [], CKPT_EVERY: [], 8: []}
        for every in (0, CKPT_EVERY, 8, 8, CKPT_EVERY, 0):
            turns[every].append(steps(every))
        ck_async.close()
        step_stats = {}
        for every, label in ((0, "no_saves"), (CKPT_EVERY, f"async_every_{CKPT_EVERY}"),
                             (8, "async_every_8")):
            step_stats[f"step_ms_{label}"] = statistics.median(t[0] for t in turns[every])
            step_stats[f"step_wall_ms_{label}"] = statistics.median(t[1] for t in turns[every])
        stats["quicknet"].update({
            "checkpoint_bytes": nbytes, "sync_save_ms": sync_ms, "async_snapshot_stall_ms": stall_ms,
            "async_write_ms": write_ms, "restore_read_ms": restore_read_ms, **step_stats,
            "restore_ms_sync_leg": stats["quicknet"]["sync"]["restore_ms"],
            "save_wait_ms_async_leg": stats["quicknet"]["async_preempted"]["save_wait_ms"],
        })
        print(f"{tag} timing on {smi}: {nbytes} B a step, sync save {sync_ms} ms, async "
              f"snapshot stall {stall_ms} ms, write {write_ms} ms, restore (read + copy) "
              f"{restore_read_ms:.1f} ms, {json.dumps(step_stats)}", flush=True)
        del state, step_fn, batch, ref, ck_sync, ck_async
        torch.cuda.empty_cache()

        # (d) the recipe student under a seeded ResNet-50 teacher's export.
        teacher_dir, student_dir = os.path.join(tmp, "teacher"), os.path.join(tmp, "student")
        teacher = ResNet50()
        configure(teacher, {"compute_dtype": "bfloat16"}, name="teacher")
        module = teacher.build((224, 224, 3), 1000)
        teacher.initialize(module, seed=0)
        save_model(teacher_dir, *export_trees(module))
        del module

        def recipe(conf):
            exp = DistillImageNet()
            configure(exp, {**CKPT_RECIPE, "teacher_checkpoint": teacher_dir, **conf},
                      name="distill")
            return exp

        t0 = time.perf_counter()
        recipe_steps = {"pack_rows": 4, "conv_gemm_popcount": 4}
        with deterministic(torch):
            _, stats["recipe"], rlegs = _resume_leg(
                torch, f"{tag} recipe", recipe, bc.LAUNCHES, tuple(recipe_steps), recipe_steps,
                tmp, {"nan_at_step": CKPT_NAN}, [
                    ("sync", {"export_model_to": student_dir}, {"kill_at_step": 3}, None, 3)])
        leg = rlegs["sync"]
        check(leg["skipped_steps"] == 1.0,
              f"{tag} recipe: the resumed run skipped {leg['skipped_steps']} steps, want the "
              f"NaN at step counter {CKPT_NAN}")
        launches["recipe"] = {n: leg["launches_before"][n] + leg["launches_after"][n]
                              for n in recipe_steps}
        recipe_dir = leg.pop("directory")
        final = leg.pop("experiment").final_state
        stats["recipe"]["sync"] = leg
        check(finalized_steps(recipe_dir)[-1] == final.step == CKPT_STEPS,
              f"{tag} recipe: steps on disk {finalized_steps(recipe_dir)}")

        # (e) EvalExperiment and ServingConfig on the run's directory against
        # the same state's export.
        model_conf = {"model": "RealToBinaryNet", "model.compute_dtype": "bfloat16",
                      "model.binary_compute": "xnor_popcount",
                      "model.blocks_per_section": (1, 1, 1, 1)}
        scores = {}
        for label, path in (("directory", recipe_dir), ("export", student_dir)):
            ev = EvalExperiment()
            configure(ev, {
                "loader.dataset": "SyntheticImageNet",
                "loader.dataset.num_train_examples": TRAIN_BATCH,
                "loader.dataset.num_validation_examples": TRAIN_BATCH,
                "loader.preprocessing": "ImageClassificationPreprocessing",
                "loader.preprocessing.height": 224, "loader.preprocessing.width": 224,
                "loader.preprocessing.channels": 3, **model_conf, "checkpoint": path,
                "batch_size": TRAIN_BATCH, "seed": 0, "device": "cuda", "verbose": False,
            }, name="evaluate")
            with deterministic(torch):
                scores[label] = ev.run()
        check(scores["directory"] == scores["export"],
              f"{tag} recipe: EvalExperiment on the directory {scores['directory']} differs "
              f"from the export's {scores['export']}")
        xb = np.random.default_rng(2).normal(size=(BATCH, 224, 224, 3)).astype(np.float32)
        logits, served = {}, {}
        for label, path in (("directory", recipe_dir), ("export", student_dir)):
            cfg = ServingConfig()
            configure(cfg, {**model_conf, **IMAGENET, "checkpoint": path,
                            "engine.batch_buckets": (1, BATCH), "seed": 0, "device": "cuda",
                            "verbose": False}, name="serving")
            engine, batcher = cfg.build_service()
            bc.reset_launches()
            with deterministic(torch):
                logits[label] = engine.infer(xb)
                torch.cuda.synchronize()
            served[label] = {k: v for k, v in bc.LAUNCHES.items() if v}
            batcher.close()
            del cfg, engine
        check(served["directory"] == served["export"] == recipe_steps
              and bool(torch.isfinite(logits["directory"]).all())
              and _same_bits(torch, logits["directory"], logits["export"]),
              f"{tag} recipe: served logits from the directory differ from the export's "
              f"(launches {served})")
        stats["recipe"].update({"eval": scores["directory"], "serving_launches": served["directory"]})
        print(f"{tag} recipe: EvalExperiment on the directory equals the export's "
              f"{json.dumps(scores['directory'])}; ServingConfig on the directory serves the "
              f"export's logits bit for bit, launches {served['directory']} a forward; legs "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        del final
        torch.cuda.empty_cache()

        # (d) TrainLM at 2 layers.
        def lm(conf):
            exp = TrainLM()
            configure(exp, {**LM_TRAIN_CONFIG, "model.num_layers": 2,
                            "steps_per_epoch": CKPT_STEPS, "validate": False, **conf},
                      name="experiment")
            return exp

        t0 = time.perf_counter()
        lm_steps = dict.fromkeys(LM_TRAIN_KERNELS, 2)
        with deterministic(torch):
            _, stats["lm"], llegs = _resume_leg(
                torch, f"{tag} lm", lm, A.LAUNCHES, LM_TRAIN_KERNELS, lm_steps, tmp, {}, [
                    ("sync", {}, {"kill_at_step": 3}, None, 3)])
        leg = llegs["sync"]
        leg.pop("experiment"), leg.pop("directory")
        launches["lm"] = {n: leg["launches_before"][n] + leg["launches_after"][n]
                          for n in LM_TRAIN_KERNELS}
        stats["lm"]["sync"] = leg
        print(f"{tag} lm: legs in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    print(f"{tag} on {smi}: {json.dumps(stats)}", flush=True)
    return launches, stats


def dense_profile_phase(smi):
    """profile_forward of each dense slice's deployment: the device time
    of a batch-8 forward and the device's busy share."""
    from zookeeper_tpu_torch.serving import profile_forward

    out = {}
    for label, (model, mode) in DENSE_PROFILES.items():
        result = profile_forward.main(["--model", model, "--binary-compute", mode, "--top", "5"])
        check(result["device_ms_per_forward"] is not None,
              f"profile_forward {model} {mode}: no device time")
        out[label] = {"device_ms_per_forward": result["device_ms_per_forward"],
                      "busy_share": result["busy_share"], "forward_ms": result["forward_ms"]}
    print(f"dense slices' profiles on {smi}: {json.dumps(out)}", flush=True)
    return out


#: The LM serving slice: the long-context TransformerLM of
#: examples/lm_experiment.py served as examples/serve_lm.py serves it.
LM_CONFIG = {
    "model.num_layers": 4, "model.d_model": 512, "model.num_heads": 8,
    "model.mlp_ratio": 4, "model.compute_dtype": "bfloat16",
    "seq_len": 8192, "vocab_size": 1024,
    "engine.slots": 8, "engine.seq_buckets": (512, 2048), "engine.prefill_buckets": (1,),
    "engine.page_size": 16, "engine.decode_attention": "auto",
    "requests": 32, "max_prompt": 2048, "new_tokens": 64, "seed": 0,
    "device": "cuda", "verbose": False,
}
LM_LAYERS, LM_HEADS, LM_HEAD_DIM, LM_SLOTS, LM_CAP, LM_PAGE = 4, 8, 64, 8, 8192, 16
PAGED = {"engine.kv_layout": "paged", "engine.prefix_cache": False}
LM_RUNS = (("slots", {}), ("paged", PAGED), ("paged-int8", {**PAGED, "engine.kv_quant": "int8"}))
#: Lengths of the K12/K13 checks: row-0-only, page edges, the capacity
#: edge, and one past capacity (clamped).
LM_CHECK_LENGTHS = (0, 1, 15, 16, 2047, 8191, 9000, 4000)
#: K12's and K13's row split takes chunks of this many rows
#: (``SPLIT_ROWS`` in ``csrc/decode_attention.cu``); their extra check
#: lengths sit at the chunk edges (chunk - 1, chunk, chunk + 1, two
#: chunks - 1 and two chunks), with slots whose rows end in the first
#: chunk (1, 0) beside one whose rows fill every chunk (8191).
SPLIT_ROWS = 256
LM_SPLIT_LENGTHS = (SPLIT_ROWS - 1, SPLIT_ROWS, SPLIT_ROWS + 1,
                    2 * SPLIT_ROWS - 1, 2 * SPLIT_ROWS, 1, 8191, 0)


def _bf16_step_ok(torch, got, want) -> bool:
    """bf16 outputs of two fp32 computations that differ only in the
    order of their sums: equal up to one bf16 rounding step of the
    value (2^-7 relative), plus 1e-5 for values near 0."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= w.abs() * 2.0**-7 + 1e-5).all())


def _bf16_flash_use(torch, got, want) -> float:
    """How much of the bf16 K9 limit the worst element uses: max of
    |got - want| / (2^-6 |want| + 2e-3). The limit scales with each
    output value (a causal row over n keys of unit-variance values has
    |o| near sqrt(e / n)), with 2e-3 for values that cancel to near 0;
    ok when at most 1."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (w.abs() * 2.0**-6 + 2e-3)).max())


def lm_kernel_phase(torch, A):
    """Check K9, K12 and K13 against their plain versions and time them
    beside it and beside SDPA. Returns {label: per-launch record}."""
    import torch.nn.functional as F

    from zookeeper_tpu_torch.ops.quantizers import quantize_kv_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    records = {}
    max_err = dict.fromkeys(LM_KERNELS, 0.0)

    def record(name, label, kernel, plain, library, nbytes, ops, rate, dtype, heavy=False):
        with deterministic(torch):
            got, want = kernel(), plain()
            again = kernel()
            torch.cuda.synchronize()
        check(_same_bits(torch, got, again), f"{name} at {label}: two calls differ")
        err = _max_abs_err(torch, got, want)
        if dtype == torch.float32:
            tol = 2e-5 if name == "flash_forward" else 2e-6
            ok = err <= tol
        elif name == "flash_forward":
            use = _bf16_flash_use(torch, got, want)
            tol, ok = f"2^-6|want| + 2e-3 per element (used {use:.3g})", use <= 1 and err <= 3e-2
        else:
            tol, ok = "one bf16 step", _bf16_step_ok(torch, got, want)
        check(ok, f"{name} at {label} disagrees with its plain version (max err {err}, "
                  f"tolerance {tol})")
        reps, inner = (5, 3) if heavy else (21, 10)
        k_ms = time_ms(torch, kernel, reps=reps, inner=inner)
        p_ms = time_ms(torch, plain, reps=5, inner=2)
        l_ms = time_ms(torch, library, reps=reps, inner=inner) if library is not None else None
        b_ms, b_by = bound_ms(name, nbytes, ops, rate)
        print(f"kernel {name} {label}: max err {err:.3g} (tol {tol}), kernel {k_ms:.6f} ms, "
              f"plain {p_ms:.6f} ms, library {l_ms if l_ms is None else round(l_ms, 6)} ms, "
              f"bound {b_ms:.6f} ms by {b_by} ({nbytes} B, {ops} ops)", flush=True)
        max_err[name] = max(max_err[name], err)
        records[(name, label)] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                  "bound_ms": b_ms, "bound_by": b_by,
                                  "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                                  "ops_ms": ops / rate * 1e3}

    # K9: (b, s, dtype, causal); the prefill buckets first.
    for b, s, dtype, causal in ((1, 512, torch.bfloat16, True), (1, 2048, torch.bfloat16, True),
                                (4, 8192, torch.bfloat16, True), (1, 512, torch.float32, True),
                                (1, 999, torch.bfloat16, True), (1, 2048, torch.bfloat16, False)):
        h, d = LM_HEADS, LM_HEAD_DIM
        variant = A.flash_forward_variant(dtype, d)
        wanted = _flash_variant_wanted(torch, dtype, d)
        check(variant == wanted, f"flash_forward at [{b}, {s}, {h}, {d}] {dtype}: variant "
                                 f"{variant}, want {wanted}")
        q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
        size = q.element_size()
        record("flash_forward", f"[{b}, {s}, {h}, {d}] {str(dtype)[6:]} causal={causal}",
               lambda: A.flash_attention(q, k, v, causal=causal),
               lambda: A.flash_attention_plain(q, k, v, causal=causal),
               lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
               4 * b * s * h * d * size, 4 * d * pairs,
               BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S, dtype,
               heavy=s >= 8192)

    # K12: slot caches [8, 8192, 8, 64], lengths at the edges, then at
    # the row split's chunk edges.
    lengths = torch.tensor(LM_CHECK_LENGTHS, dtype=torch.int32, device=dev)
    split_lengths = torch.tensor(LM_SPLIT_LENGTHS, dtype=torch.int32, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        variant = A.decode_variant(dtype, LM_HEAD_DIM)
        check(variant == "split", f"paged_decode_attention {dtype}: variant {variant}, "
                                  f"want split")
        shape = (LM_SLOTS, LM_CAP, LM_HEADS, LM_HEAD_DIM)
        q = torch.randn(LM_SLOTS, 1, LM_HEADS, LM_HEAD_DIM, generator=g, device=dev).to(dtype)
        kc = torch.randn(*shape, generator=g, device=dev).to(dtype)
        vc = torch.randn(*shape, generator=g, device=dev).to(dtype)
        for lens, lens_label in ((lengths, ""), (split_lengths, ", chunk-edge lengths")):
            live = int((lens.clamp(0, LM_CAP - 1) + 1).sum())
            record("paged_decode_attention",
                   f"{list(shape)} {str(dtype)[6:]}{lens_label} ({variant})",
                   lambda: A.paged_decode_attention(q, kc, vc, lens),
                   lambda: A.cached_attention(q, kc, vc, lens),
                   _sdpa_decode(torch, q, kc, vc, lens),
                   *_decode_work(q, live, kc.element_size()), FP32_OPS_PER_S, dtype)
        _two_streams_check(
            torch, lambda: A.paged_decode_attention(q, kc, vc, split_lengths),
            f"paged_decode_attention at {list(shape)} {str(dtype)[6:]}")
        del kc, vc

    # K13: a pool of 4096 pages of 16, shuffled tables with -1 entries;
    # the edge lengths above, then those at the row split's chunk edges.
    pages, max_pages = 4096, LM_CAP // LM_PAGE
    cpu_g = torch.Generator().manual_seed(3)
    table = torch.randperm(pages, generator=cpu_g)[: LM_SLOTS * max_pages].reshape(LM_SLOTS, max_pages)
    table[torch.rand(LM_SLOTS, max_pages, generator=cpu_g) < 0.1] = -1
    table = table.to(torch.int32).to(dev)
    for dtype, quant in ((torch.bfloat16, False), (torch.float32, False),
                         (torch.bfloat16, True), (torch.float32, True)):
        variant = A.decode_variant(dtype, LM_HEAD_DIM)
        check(variant == "split", f"pool_paged_decode_attention {dtype}: variant {variant}, "
                                  f"want split")
        shape = (pages, LM_PAGE, LM_HEADS, LM_HEAD_DIM)
        q = torch.randn(LM_SLOTS, 1, LM_HEADS, LM_HEAD_DIM, generator=g, device=dev).to(dtype)
        kp = torch.randn(*shape, generator=g, device=dev).to(dtype)
        vp = torch.randn(*shape, generator=g, device=dev).to(dtype)
        kw = {}
        if quant:
            (kp, ks), (vp, vs) = quantize_kv_rows(kp), quantize_kv_rows(vp)
            kw = {"k_scale": ks, "v_scale": vs}
        for lens, lens_label in ((lengths, ""), (split_lengths, ", chunk-edge lengths")):
            rows = int((lens.clamp(0, LM_CAP - 1) + 1).sum())
            nbytes, ops = _decode_work(q, rows, kp.element_size(), scales=quant)
            record("pool_paged_decode_attention",
                   f"{list(shape)} {'int8 rows, q ' if quant else ''}{str(dtype)[6:]}"
                   f"{lens_label} ({variant})",
                   lambda: A.pool_paged_decode_attention(q, kp, vp, table, lens, **kw),
                   lambda: A.pool_decode_attention(q, kp, vp, table, lens, **kw),
                   None, nbytes + table.numel() * 4, ops, FP32_OPS_PER_S, dtype)
        _two_streams_check(
            torch, lambda: A.pool_paged_decode_attention(q, kp, vp, table, split_lengths, **kw),
            f"pool_paged_decode_attention at {list(shape)} {'int8 rows, ' if quant else ''}"
            f"{str(dtype)[6:]}")
        del kp, vp

    # K12/K13 at head_dims that are not multiples of 8 (off the JAX
    # kernel's geometry; the port's kernels serve any head_dim, so the
    # engine never leaves them) and past 256 (264 and 384 run in 256-dim
    # chunks; 264 int8 rows are not 16-byte multiples): 8 slots, capacity
    # 512, 4 heads.
    cap, heads = 512, 4
    odd_lengths = torch.tensor((0, 1, 15, 16, 100, 511, 600, 300), dtype=torch.int32, device=dev)
    odd_live = int((odd_lengths.clamp(0, cap - 1) + 1).sum())
    pages = 256
    table = torch.randperm(pages, generator=cpu_g)[: LM_SLOTS * (cap // LM_PAGE)].reshape(
        LM_SLOTS, cap // LM_PAGE)
    table[torch.rand(table.shape, generator=cpu_g) < 0.1] = -1
    table = table.to(torch.int32).to(dev)
    for d in (20, 100, 264, 384):
        for dtype in (torch.bfloat16, torch.float32):
            # One dispatch rule for K12 and K13.
            variant = A.decode_variant(dtype, d)
            check(variant == ("split" if d <= 256 else "wide"),
                  f"paged_decode_attention / pool_paged_decode_attention at head_dim {d}: "
                  f"variant {variant}")
            q = torch.randn(LM_SLOTS, 1, heads, d, generator=g, device=dev).to(dtype)
            kc, vc = (torch.randn(LM_SLOTS, cap, heads, d, generator=g, device=dev).to(dtype)
                      for _ in range(2))
            record("paged_decode_attention",
                   f"[{LM_SLOTS}, {cap}, {heads}, {d}] {str(dtype)[6:]} ({variant})",
                   lambda: A.paged_decode_attention(q, kc, vc, odd_lengths),
                   lambda: A.cached_attention(q, kc, vc, odd_lengths),
                   _sdpa_decode(torch, q, kc, vc, odd_lengths),
                   *_decode_work(q, odd_live, kc.element_size()), FP32_OPS_PER_S, dtype)
            for quant in (False, True):
                kp, vp = (torch.randn(pages, LM_PAGE, heads, d, generator=g, device=dev).to(dtype)
                          for _ in range(2))
                kw = {}
                if quant:
                    (kp, ks), (vp, vs) = quantize_kv_rows(kp), quantize_kv_rows(vp)
                    kw = {"k_scale": ks, "v_scale": vs}
                nbytes, ops = _decode_work(q, odd_live, kp.element_size(), scales=quant)
                record("pool_paged_decode_attention",
                       f"[{pages}, {LM_PAGE}, {heads}, {d}] "
                       f"{'int8 rows, q ' if quant else ''}{str(dtype)[6:]}",
                       lambda: A.pool_paged_decode_attention(q, kp, vp, table, odd_lengths, **kw),
                       lambda: A.pool_decode_attention(q, kp, vp, table, odd_lengths, **kw),
                       None, nbytes + table.numel() * 4, ops, FP32_OPS_PER_S, dtype)
    torch.cuda.empty_cache()
    return records, max_err


def _two_streams_check(torch, fn, label: str, rounds: int = 20) -> None:
    """``fn`` launched on two streams at once, ``rounds`` times each, must
    give the bits of one call on the current stream: K12's and K13's row
    split keeps its workspace per stream, so concurrent launches share no
    ticket."""
    want = fn()
    streams = [torch.cuda.Stream() for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(rounds):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(fn())
    torch.cuda.synchronize()
    bad = sum(not _same_bits(torch, o, want) for o in outs)
    check(bad == 0, f"{label}: {bad} of {len(outs)} calls on two streams differ from one call")
    print(f"kernel {label}: {len(outs)} calls on two streams at once, the same bits", flush=True)


def _decode_work(q, live_rows: int, kv_size: int, scales: bool = False):
    """(bytes, ops) of one decode-attention call: q read and o written
    once, each live K/V row (and its scales) read once, lengths; 4
    flops per K/V value (a multiply-add each for q.k and p.v)."""
    b, _, h, d = q.shape
    per_row = 2 * h * (d * kv_size + (4 if scales else 0))
    return 2 * b * h * d * q.element_size() + live_rows * per_row + 4 * b, 4 * live_rows * h * d


def _sdpa_decode(torch, q, k_cache, v_cache, lengths):
    """The library yardstick of K12: SDPA with a boolean mask over the
    whole capacity (it reads every row)."""
    import torch.nn.functional as F

    cap = k_cache.shape[1]
    mask = (torch.arange(cap, device=q.device)[None, :]
            <= lengths.long()[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def _lm_config(overrides):
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving.decode import LMServingConfig

    cfg = LMServingConfig()
    configure(cfg, {**LM_CONFIG, **overrides})
    return cfg


def _profile_step(torch, engine, tokens, lengths):
    """One decode step under torch.profiler: (wall ms, device busy ms,
    device activities, top items)."""
    from torch.profiler import ProfilerActivity, profile

    engine.decode(tokens, lengths)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.decode(tokens, lengths)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(getattr(e, attr) for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: getattr(e, attr), reverse=True)[:8]
    return wall_ms, busy_ms, sum(e.count for e in kernels), [
        (getattr(e, attr) / 1e3, e.count, e.key[:100]) for e in top]


def lm_serving_phase(torch, A, smi):
    """Drive LMServingConfig.run() in the three layouts; check launches
    and outputs; profile one decode step; time K12/K13 at a mid-run
    step's real cache, lengths and table. Returns (launches by kernel,
    per-run stats, main-path records)."""
    import numpy as np

    from zookeeper_tpu_torch.serving.decode import DecodeEngine

    launches = dict.fromkeys(LM_KERNELS, 0)
    stats, main = {}, {}
    for label, overrides in LM_RUNS:
        cfg = _lm_config(overrides)
        steps = []
        real_decode = DecodeEngine.decode

        def spy(engine, tokens, lengths, _real=real_decode):
            pool = engine.page_pool
            steps.append((np.array(tokens), np.array(lengths),
                          None if pool is None else pool.table.copy()))
            return _real(engine, tokens, lengths)

        A.reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(DecodeEngine, "decode", spy):
            result = cfg.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        got = dict(A.LAUNCHES)
        kernel = "paged_decode_attention" if label == "slots" else "pool_paged_decode_attention"
        prefills = int(result["prefills_total"]) + 2  # + the warmup of both buckets
        decodes = int(result["decode_steps_total"]) + 1  # + the warmup step
        print(f"lm {label}: {json.dumps(result)}", flush=True)
        print(f"lm {label}: launches {got}; per prefill dispatch "
              f"{got['flash_forward'] / prefills}, per decode step {got[kernel] / decodes} "
              f"({prefills} prefills, {decodes} decode steps with warmup; run {run_s:.1f} s "
              f"with build and warmup)", flush=True)
        check(result["decode_attention"] == "kernel",
              f"lm {label}: decode attention resolved to {result['decode_attention']}")
        for name in LM_KERNELS:
            want = (LM_LAYERS * prefills if name == "flash_forward"
                    else LM_LAYERS * decodes if name == kernel else 0)
            check(got[name] == want, f"lm {label}: {name} launched {got[name]} times, want {want}")
            launches[name] += got[name]
        check(all(got[name] == 0 for name in LM_TRAIN_KERNELS),
              f"lm {label}: serving launched training kernels {got}")
        check(result["generated_tokens"] == LM_CONFIG["requests"] * LM_CONFIG["new_tokens"],
              f"lm {label}: {result['generated_tokens']} tokens generated")
        outputs = np.concatenate(cfg.outputs)
        check(outputs.min() >= 0 and outputs.max() < LM_CONFIG["vocab_size"],
              f"lm {label}: tokens outside the vocabulary")

        engine = cfg.engine
        tokens, lengths, table = steps[len(steps) // 2]
        if table is not None:
            engine.page_pool.table[:] = table
        wall_ms, busy_ms, acts, top = _profile_step(torch, engine, tokens, lengths)
        print(f"lm {label} decode step profile (lengths {lengths.tolist()}): wall "
              f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
              f"{acts} device activities; top items:", flush=True)
        for t, count, key in top:
            print(f"  {t:9.4f} ms x{count:<4d} {key}", flush=True)
        stats[label] = {
            "tokens_per_sec": result["tokens_per_sec"], "ttft_p50_ms": result["ttft_p50_ms"],
            "ttft_p99_ms": result["ttft_p99_ms"], "itl_p50_ms": result["itl_p50_ms"],
            "itl_p99_ms": result["itl_p99_ms"], "token_p50_ms": result["token_p50_ms"],
            "decode_mbu": result["decode_mbu"], "step_wall_ms": wall_ms,
            "step_busy_ms": busy_ms, "step_busy_share": busy_ms / wall_ms,
            "step_device_activities": acts,
        }
        variant = A.decode_variant(torch.bfloat16, LM_HEAD_DIM)
        check(variant == "split", f"lm {label}: {kernel} variant {variant}, want split")
        key = kernel if label != "paged-int8" else f"{kernel} int8"
        main[key] = _time_main_step(torch, A, engine, kernel, lengths, table)
        if label == "slots":
            buckets = [engine.seq_bucket_for(p.shape[0])
                       for p in cfg.prompts(min(cfg.max_prompt, engine.max_prompt))]
            main["buckets"] = {sb: buckets.count(sb) / len(buckets) for sb in set(buckets)}
        del cfg, engine
        torch.cuda.empty_cache()
    print(f"lm serving on {smi}: {json.dumps(stats)}", flush=True)
    return launches, stats, main


def _host_us(torch, fn, calls=200) -> float:
    """Host microseconds per call of ``fn``: the wrapper's own work and the
    launch, with the card's queue far from full (medians of 5 runs)."""
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def _time_main_step(torch, A, engine, kernel, lengths, table):
    """K12 or K13 at one decode step of the run: layer 0's real cache,
    the step's lengths (and table), a seeded q. Per launch."""
    import numpy as np

    dev = engine.device
    layer = engine.cache[0]
    q = torch.randn(LM_SLOTS, 1, LM_HEADS, LM_HEAD_DIM,
                    generator=torch.Generator().manual_seed(4)).to(torch.bfloat16).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    live = int((np.clip(lengths, 0, engine.capacity - 1) + 1).sum())
    if kernel == "paged_decode_attention":
        fn = lambda: A.paged_decode_attention(q, layer["k"], layer["v"], lens)  # noqa: E731
        plain = lambda: A.cached_attention(q, layer["k"], layer["v"], lens)  # noqa: E731
        library = _sdpa_decode(torch, q, layer["k"], layer["v"], lens)
        nbytes, ops = _decode_work(q, live, 2)
    else:
        tab = torch.from_numpy(table).to(dev)
        scales = {k: layer[k] for k in ("k_scale", "v_scale") if k in layer}
        fn = lambda: A.pool_paged_decode_attention(  # noqa: E731
            q, layer["k"], layer["v"], tab, lens, **scales)
        plain = lambda: A.pool_decode_attention(  # noqa: E731
            q, layer["k"], layer["v"], tab, lens, **scales)
        library = None
        nbytes, ops = _decode_work(q, live, layer["k"].element_size(), scales=bool(scales))
        nbytes += tab.numel() * 4
    with deterministic(torch):
        got, want, again = fn(), plain(), fn()
        err = _max_abs_err(torch, got, want)
    check(_bf16_step_ok(torch, got, want),
          f"{kernel} at a mid-run decode step disagrees with its plain version (max err "
          f"{err}, tolerance one bf16 step)")
    check(_same_bits(torch, got, again), f"{kernel} at a mid-run decode step: two calls differ")
    rec = {"ms": time_ms(torch, fn), "plain_ms": time_ms(torch, plain, reps=5, inner=2),
           "library_ms": time_ms(torch, library) if library is not None else None,
           "host_us": _host_us(torch, fn)}
    rec["bound_ms"], rec["bound_by"] = bound_ms(kernel, nbytes, ops)
    print(f"kernel {kernel} at a mid-run decode step ({live} live rows of {LM_SLOTS} slots"
          f"{', int8 rows' if 'k_scale' in layer else ''}): "
          f"max err {err:.3g}, {json.dumps(rec)}", flush=True)
    return rec


def _serve_stream(engine_cls, sched_cls, configure, module, layout, prompts, budgets):
    engine = engine_cls()
    configure(engine, {"slots": LM_SLOTS, "seq_buckets": (512, 2048), "page_size": LM_PAGE,
                       "decode_attention": "kernel", **layout}, name="engine")
    engine.bind(module, device="cuda")
    sched = sched_cls()
    configure(sched, {}, name="sched")
    sched.bind(engine)
    streams = [sched.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    sched.drain()
    out = [s.result() for s in streams]
    del engine, sched
    return out


def _plain_attention(A):
    """The three kernel wrappers swapped for their plain versions."""
    return mock.patch.multiple(A, flash_attention=A.flash_attention_plain,
                               paged_decode_attention=A.cached_attention,
                               pool_paged_decode_attention=A.pool_decode_attention)


def lm_parity_phase(torch, A):
    """fp32: kernel path == plain path == greedy_decode, both layouts,
    with slot refills. bf16: count agreeing tokens; each disagreement
    must sit where the plain path's top-two logit gap is below 0.05."""
    import numpy as np

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.models.transformer import TransformerLM, greedy_decode
    from zookeeper_tpu_torch.serving.decode import DecodeEngine, DecodeScheduler

    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 1024, size=int(n)).astype(np.int32)
               for n in rng.integers(1, 700, size=12)]
    budgets = [int(b) for b in rng.integers(1, 17, size=12)]
    summary = {}
    for dtype in ("float32", "bfloat16"):
        model = TransformerLM()
        configure(model, {"num_layers": 4, "d_model": 512, "num_heads": 8, "mlp_ratio": 4,
                          "compute_dtype": dtype}, name="model")
        module = model.initialize(model.build((8192,), 1024), seed=0).cuda()
        for label, layout in (("slots", {}), ("paged", {"kv_layout": "paged",
                                                        "prefix_cache": False})):
            with deterministic(torch):
                A.reset_launches()
                kern = _serve_stream(DecodeEngine, DecodeScheduler, configure, module, layout,
                                     prompts, budgets)
                decode = "pool_paged_decode_attention" if layout else "paged_decode_attention"
                check(A.LAUNCHES["flash_forward"] > 0 and A.LAUNCHES[decode] > 0,
                      f"lm parity {label}: the kernel path launched {A.LAUNCHES}")
                before = dict(A.LAUNCHES)
                with _plain_attention(A):
                    plain = _serve_stream(DecodeEngine, DecodeScheduler, configure, module,
                                          layout, prompts, budgets)
                check(A.LAUNCHES == before,
                      f"lm parity: the plain path launched kernels ({before} -> {A.LAUNCHES})")
                torch.cuda.synchronize()
            total = sum(budgets)
            if dtype == "float32":
                bad = [i for i, (a, b) in enumerate(zip(kern, plain)) if not np.array_equal(a, b)]
                check(not bad, f"lm parity fp32 {label}: kernel and plain tokens differ in "
                               f"streams {bad}")
                # The oracle: full recompute with the dense attention.
                with deterministic(torch), \
                        mock.patch.object(A, "flash_attention", A.attention_reference):
                    for i, (p, b) in enumerate(zip(prompts, budgets)):
                        oracle = greedy_decode(module, torch.from_numpy(p)[None].cuda(), b)
                        check(np.array_equal(oracle[0, p.shape[0]:].cpu().numpy(), kern[i]),
                              f"lm parity fp32 {label}: stream {i} differs from greedy_decode")
                summary[f"fp32 {label}"] = f"{total} of {total} tokens identical (kernel, plain, greedy_decode)"
            else:
                agree = sum(int(np.sum(a == b)) for a, b in zip(kern, plain))
                gaps = []
                for i, (a, b) in enumerate(zip(kern, plain)):
                    diff = np.nonzero(a != b)[0]
                    if diff.size:
                        gaps.append(_plain_gap(torch, A, module, prompts[i], plain[i], int(diff[0])))
                check(all(gap < 0.05 for gap in gaps),
                      f"lm parity bf16 {label}: a disagreement where the plain top-two gap is "
                      f"{max(gaps, default=0.0)} >= 0.05")
                summary[f"bf16 {label}"] = (f"{agree} of {total} tokens agree; first-divergence "
                                            f"top-two gaps {[round(x, 5) for x in gaps]}")
            print(f"lm parity {dtype} {label}: {summary[next(reversed(summary))]}", flush=True)
        del module
        torch.cuda.empty_cache()
    return summary


def _plain_gap(torch, A, module, prompt, plain_tokens, t):
    """Top-two logit gap of the plain path where it emitted token ``t``
    of a stream: the plain decode path's logits, recomputed by feeding
    the stream's own tokens to a fresh plain slot engine."""
    logits = _plain_logits(torch, A, module, prompt, plain_tokens, t)
    top2 = torch.topk(logits, 2)
    check(int(top2.indices[0]) == int(plain_tokens[t]),
          f"lm parity: the recomputed plain logits do not give the plain token {t}")
    return float(top2.values[0] - top2.values[1])


def _plain_logits(torch, A, module, prompt, tokens, t):
    """The plain decode path's fp32 logits for token ``t`` of a stream of
    ``prompt`` whose first ``t`` tokens are ``tokens[:t]``, from a fresh
    plain slot engine."""
    import numpy as np

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving.decode import DecodeEngine

    engine = DecodeEngine()
    configure(engine, {"slots": LM_SLOTS, "seq_buckets": (512, 2048), "page_size": LM_PAGE,
                       "decode_attention": "kernel"}, name="engine")
    engine.bind(module, device="cuda")
    seen = []
    real = module.decode_step

    def spy(*args, **kwargs):
        logits, cache = real(*args, **kwargs)
        seen.append(logits[0].float())
        return logits, cache

    with torch.inference_mode(), _plain_attention(A):
        if t == 0:  # the prefill's logits, at the engine's padded bucket
            dev = engine.device
            padded = np.zeros((1, engine.seq_bucket_for(prompt.shape[0])), np.int32)
            padded[0, : prompt.shape[0]] = prompt
            last, _ = module.prefill(torch.from_numpy(padded).to(dev),
                                     torch.tensor([prompt.shape[0]], device=dev))
            logits = last[0].float()
        else:
            engine.prefill([prompt], [0])
            feed = np.zeros(LM_SLOTS, np.int32)
            lengths = np.zeros(LM_SLOTS, np.int32)
            with mock.patch.object(module, "decode_step", spy):
                for j in range(t):
                    feed[0], lengths[0] = tokens[j], prompt.shape[0] + j
                    engine.decode(feed, lengths)
            logits = seen[-1]
    return logits


#: The LM training slice: the long-context line of examples/lm_experiment.py
#: (TrainLM seq_len=8192 model.d_model=512 model.num_heads=8 batch_size=4
#: model.compute_dtype=bfloat16 loader.dataset.vocab_size=1024), 4 layers.
#: Only the dataset is cut: 8 steps of batch 4 and one validation batch.
LM_TRAIN_CONFIG = {
    "seq_len": 8192, "batch_size": 4,
    "model.num_layers": 4, "model.d_model": 512, "model.num_heads": 8, "model.mlp_ratio": 4,
    "model.compute_dtype": "bfloat16", "loader.dataset.vocab_size": 1024,
    "loader.dataset.num_train_examples": 32, "loader.dataset.num_validation_examples": 4,
    "epochs": 1, "steps_per_epoch": 8, "seed": 0, "device": "cuda", "verbose": False,
}
LM_TRAIN_STEPS = 8
#: The attention shape of every layer of a training step.
LM_TRAIN_SHAPE = (4, 8192, 8, 64)
#: K9 with lse, K10 and K11 checks: (b, s, h, d, dtype name, causal[,
#: "fused qkv"]); the main path's shape first, then the prefill-sized
#: shapes in both dtypes and both masks, an awkward length, the other
#: head_dims and the model's strided operands.
LM_TRAIN_CHECKS = (
    (*LM_TRAIN_SHAPE, "bfloat16", True),
    (1, 2048, 8, 64, "bfloat16", True), (1, 2048, 8, 64, "bfloat16", False),
    (1, 2048, 8, 64, "float32", True), (1, 2048, 8, 64, "float32", False),
    (1, 999, 8, 64, "bfloat16", True), (1, 999, 8, 64, "float32", True),
    (1, 1024, 4, 128, "bfloat16", True), (2, 300, 3, 32, "float32", False),
    # The tensor-core K10/K11's ragged edges: head_dims 40 and 72 (zero-
    # padded to the 64- and 128-dim tiles), head_dim 128 full and at an
    # awkward length.
    (1, 1024, 4, 40, "bfloat16", True), (1, 1024, 4, 72, "bfloat16", True),
    (1, 1024, 4, 128, "bfloat16", False), (1, 999, 4, 128, "bfloat16", True),
    # Past one register tile: head_dims 256 and 320 run in 128-dim chunks.
    (1, 1024, 4, 256, "bfloat16", True), (1, 1024, 4, 256, "float32", True),
    (1, 512, 2, 320, "bfloat16", True), (1, 512, 2, 320, "float32", True),
    # The tensor-core kernels' element-by-element copies: head_dims that
    # are not multiples of 8 elements.
    (1, 999, 4, 20, "bfloat16", True), (1, 1024, 4, 100, "bfloat16", True),
    # q, k and v as the model passes them: strided views of one fused
    # [b, s, 3 h d] product (``TransformerLM``'s ``_heads``).
    (2, 1024, 8, 64, "bfloat16", True, "fused qkv"),
)


def _flash_work(name, b, s, h, d, size, causal):
    """(bytes, ops) of one flash call: each input read once and each
    output written once; 4d (K9: S and P V), 6d (K10: S, dO V^T, dS K) or
    8d (K11: S, dO V^T, P^T dO, dS^T Q) flops per attended pair."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    x, stat = b * s * h * d * size, b * h * s * 4  # one [b, s, h, d]; lse or D
    if name == "flash_forward_lse":
        return 4 * x + stat, 4 * d * pairs
    if name == "flash_backward_dq":
        return 5 * x + 2 * stat, 6 * d * pairs
    return 6 * x + 2 * stat, 8 * d * pairs


def _grad_use(torch, got, want, dtype) -> float:
    """How much of the gradient limit the worst element uses (ok when at
    most 1). fp32: 5e-5 + 5e-5 |want| per element, the JAX package's
    flash-gradient tolerance (fp32 sums in another order). bf16: kernel
    and plain version round P and dS to bf16 at the same places, so they
    differ by the fp32 sum order, the final bf16 rounding (up to 2^-7 of
    the value) and, rarely, one P or dS that rounds to the other side
    (moving the sum by one bf16 step, 2^-7, of that term, which may
    dwarf a value that cancels to near 0). So each element within 2^-6
    |want| + 2^-7 max|want|, and the whole within one bf16 step in norm:
    |got - want|_2 <= 2^-7 |want|_2; the larger use of the two."""
    g, w = got.float(), want.float()
    if dtype == torch.float32:
        return float(((g - w).abs() / (5e-5 + 5e-5 * w.abs())).max())
    elem = ((g - w).abs() / (2.0**-6 * w.abs() + 2.0**-7 * w.abs().max())).max()
    norm = torch.linalg.vector_norm(g - w) / (2.0**-7 * torch.linalg.vector_norm(w))
    return float(torch.maximum(elem, norm))


def _flash_variant_wanted(torch, dtype, d) -> str:
    """The flash kernels (K9, K10/K11) a geometry must take: tensor cores
    for bf16 at head_dim <= 128; fp32 keeps the FMA kernels (exact
    products, as JAX's Precision.HIGHEST), and head_dims above 128 the
    chunked FMA kernels."""
    if d > 128:
        return "fma_wide"
    return "mma" if dtype == torch.bfloat16 else "fma"


def _kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel template instance (its integer
    and bool arguments), or the mangled name if it is not one."""
    import re

    name = mangled
    for m in re.finditer(r"\d+", mangled):
        # The length prefix is a suffix of the digit run (a hash may
        # end in digits just before it); the kernel is the last name.
        for start in range(m.start(), m.end()):
            ident = mangled[m.end():m.end() + int(mangled[start:m.end()])]
            rest = mangled[m.end() + len(ident):]
            if ident[:1].isalpha() and ident.endswith("_kernel") and rest.startswith("I"):
                args = re.findall(r"L[ib](\d+)E", rest[:rest.find("EEv") + 1])
                name = f"{ident}<{', '.join(args)}>"
    return name


def print_kernel_resources(cuda_build, name: str, match: str) -> None:
    """Print ptxas's registers and spills of each kernel of ``name``'s
    library whose mangled name contains ``match``."""
    import re

    kernel = None
    for line in cuda_build.build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = _kernel_name(m.group(1))
            spills = None
            continue
        if kernel is None or match not in kernel:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f"spill stores {m.group(1)} B, spill loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            print(f"ptxas {name}: {kernel}: {m.group(1)} registers, {spills}", flush=True)
            kernel = None


def _plain_flash_training(A):
    """The training kernels' wrappers swapped for their plain versions."""
    return mock.patch.multiple(
        A,
        flash_forward_lse=lambda q, k, v, causal, scale: A.flash_attention_plain(
            q, k, v, causal=causal, scale=scale, want_lse=True),
        flash_backward_dq=A.flash_backward_dq_plain,
        flash_backward_dkv=A.flash_backward_dkv_plain,
    )


def lm_train_kernel_phase(torch, A):
    """Check K9 with lse, K10 and K11 against their plain versions at the
    shapes of ``LM_TRAIN_CHECKS`` (K9's out also against its no-lse out,
    bit for bit), the autograd path against the dense oracle's gradients
    in fp32, and time each kernel beside its plain version, its bound and
    SDPA (K10 and K11 together beside SDPA's backward, read as forward +
    backward minus forward). Returns ({(kernel, label): record},
    {kernel: max abs err})."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    records = {}
    max_err = dict.fromkeys(LM_TRAIN_KERNELS, 0.0)

    for b, s, h, d, dtype_name, causal, *layout in LM_TRAIN_CHECKS:
        dtype = getattr(torch, dtype_name)
        label = f"[{b}, {s}, {h}, {d}] {dtype_name} causal={causal}" + "".join(
            f" {x}" for x in layout)
        if layout == ["fused qkv"]:
            qkv = torch.randn(b, s, 3 * h * d, generator=g, device=dev).to(dtype)
            q, k, v = (x.reshape(b, s, h, d) for x in qkv.split(h * d, dim=-1))
            do = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
            del qkv
        else:
            q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
                           for _ in range(4))
        kw = {"causal": causal}
        wanted = _flash_variant_wanted(torch, dtype, d)
        variant = A.flash_backward_variant(dtype, d)
        fwd_variant = A.flash_forward_variant(dtype, d)
        check(variant == wanted and fwd_variant == wanted,
              f"flash at {label}: K9 variant {fwd_variant}, K10/K11 {variant}, want {wanted}")
        with deterministic(torch):
            out0 = A.flash_attention(q, k, v, **kw)
            out, lse = A.flash_forward_lse(q, k, v, **kw)
            p_out, p_lse = A.flash_attention_plain(q, k, v, want_lse=True, **kw)
            delta = A.flash_backward_delta(out, do)
            ops = (q, k, v, do, lse, delta)
            got = {"flash_backward_dq": (A.flash_backward_dq(*ops, **kw),),
                   "flash_backward_dkv": A.flash_backward_dkv(*ops, **kw)}
            want = {"flash_backward_dq": (A.flash_backward_dq_plain(*ops, **kw),),
                    "flash_backward_dkv": A.flash_backward_dkv_plain(*ops, **kw)}
            again = {"flash_backward_dq": (A.flash_backward_dq(*ops, **kw),),
                     "flash_backward_dkv": A.flash_backward_dkv(*ops, **kw)}
            torch.cuda.synchronize()
        for name in got:
            check(all(_same_bits(torch, x, y) for x, y in zip(got[name], again[name])),
                  f"{name} at {label}: two calls gave different bits")
        check(_same_bits(torch, out, out0),
              f"flash_forward_lse at {label}: out differs from the no-lse K9's")
        notes = [f"K9 variant {fwd_variant}, K10/K11 variant {variant}, the same bits twice"]
        lse_err = _max_abs_err(torch, lse, p_lse)
        # lse: an fp32 log of an fp32 sum on both sides (|lse| < 20 here).
        check(lse_err <= 1e-5, f"flash_forward_lse at {label}: lse err {lse_err} > 1e-5")
        out_err = _max_abs_err(torch, out, p_out)
        if dtype == torch.float32:
            ok, tol = out_err <= 2e-5, "2e-5"
        else:
            use = _bf16_flash_use(torch, out, p_out)
            ok, tol = use <= 1 and out_err <= 3e-2, f"2^-6|want| + 2e-3 (used {use:.3g})"
        check(ok, f"flash_forward_lse at {label}: out err {out_err} (tolerance {tol})")
        max_err["flash_forward_lse"] = max(max_err["flash_forward_lse"], out_err, lse_err)
        notes.append(f"K9-lse out err {out_err:.3g} (tol {tol}, equal to no-lse out), "
                     f"lse err {lse_err:.3g} (tol 1e-5)")
        for name in ("flash_backward_dq", "flash_backward_dkv"):
            for which, a, w in zip(("dq",) if name == "flash_backward_dq" else ("dk", "dv"),
                                   got[name], want[name]):
                err, use = _max_abs_err(torch, a, w), _grad_use(torch, a, w, dtype)
                check(use <= 1, f"{name} at {label}: {which} err {err}, limit used {use:.3g} > 1")
                max_err[name] = max(max_err[name], err)
                notes.append(f"{which} err {err:.3g} (limit used {use:.3g})")
        del got, want, again, out0, p_out, p_lse

        heavy = s >= 8192
        reps, inner = (5, 3) if heavy else (11, 5)
        kernels = {
            "flash_forward_lse": lambda: A.flash_forward_lse(q, k, v, **kw),
            "flash_backward_dq": lambda: A.flash_backward_dq(*ops, **kw),
            "flash_backward_dkv": lambda: A.flash_backward_dkv(*ops, **kw),
        }
        plains = {
            "flash_forward_lse": lambda: A.flash_attention_plain(q, k, v, want_lse=True, **kw),
            "flash_backward_dq": lambda: A.flash_backward_dq_plain(*ops, **kw),
            "flash_backward_dkv": lambda: A.flash_backward_dkv_plain(*ops, **kw),
        }
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        sdpa_fwd = time_ms(torch, sdpa, reps, inner)
        sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot),
                           reps, inner) - sdpa_fwd
        rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
        times = {}
        for name in LM_TRAIN_KERNELS:
            nbytes, n_ops = _flash_work(name, b, s, h, d, q.element_size(), causal)
            b_ms, b_by = bound_ms(name, nbytes, n_ops, rate)
            rec = {"ms": time_ms(torch, kernels[name], reps, inner),
                   "plain_ms": time_ms(torch, plains[name], 3 if heavy else 5, 1 if heavy else 2),
                   "library_ms": sdpa_fwd if name == "flash_forward_lse" else sdpa_bwd,
                   "bound_ms": b_ms, "bound_by": b_by}
            records[(name, label)] = rec
            times[name] = rec
            print(f"kernel {name} {label}: kernel {rec['ms']:.6f} ms, plain "
                  f"{rec['plain_ms']:.6f} ms, bound {b_ms:.6f} ms by {b_by} ({nbytes} B, "
                  f"{n_ops} ops)", flush=True)
        bwd = times["flash_backward_dq"]["ms"] + times["flash_backward_dkv"]["ms"]
        print(f"lm train kernels {label}: {'; '.join(notes)}; SDPA forward {sdpa_fwd:.6f} ms "
              f"(K9-lse {times['flash_forward_lse']['ms']:.6f}), SDPA backward (fwd+bwd - fwd) "
              f"{sdpa_bwd:.6f} ms (K10+K11 {bwd:.6f}, {bwd / sdpa_bwd:.1f}x)", flush=True)
        del q, k, v, do, out, lse, delta, ops, qt, kt, vt, dot

    # The autograd path in fp32 against the dense oracle's gradients.
    b, s, h, d = 1, 2048, 8, 64
    qkv = [torch.randn(b, s, h, d, generator=g, device=dev).requires_grad_(True)
           for _ in range(3)]
    do = torch.randn(b, s, h, d, generator=g, device=dev)
    with deterministic(torch):
        before = dict(A.LAUNCHES)
        got = torch.autograd.grad(A.flash_attention(*qkv, causal=True), qkv, do)
        launched = {name: A.LAUNCHES[name] - before[name] for name in A.LAUNCHES}
        want = torch.autograd.grad(A.attention_reference(*qkv, causal=True), qkv, do)
        torch.cuda.synchronize()
    check(launched == {**dict.fromkeys(A.LAUNCHES, 0), **dict.fromkeys(LM_TRAIN_KERNELS, 1)},
          f"flash_attention under autograd launched {launched}")
    uses = [_grad_use(torch, a, w, torch.float32) for a, w in zip(got, want)]
    check(max(uses) <= 1, f"flash gradients against the dense oracle: limit used {uses}")
    print(f"lm train kernels: fp32 [{b}, {s}, {h}, {d}] causal gradients through "
          f"flash_attention (one K9-lse, K10, K11 launch) against autograd of "
          f"attention_reference: max err "
          f"{[round(_max_abs_err(torch, a, w), 9) for a, w in zip(got, want)]}, "
          f"limit 5e-5 + 5e-5|want| used {[round(u, 4) for u in uses]}", flush=True)
    torch.cuda.empty_cache()
    return records, max_err


def _bf16_step_use(torch, loss_k, loss_p, grads_k, grads_p):
    """How much of the bf16 step limit the worst of loss and gradients
    uses (ok when at most 1). The loss within 2^-7 relative: one bf16
    step; the forward's K9-lse differs from its plain version by the
    order of fp32 sums and the loss is an fp32 mean over every position.
    Each gradient within 2^-6 of its norm, in norm: each layer's K10/K11
    output is within 2^-7 of its plain version's in norm (``_grad_use``'s
    bf16 limit), and the gradients of the bottom layer carry the
    deviations of both layers' attention backward, 2 x 2^-7. Per element
    no limit holds: the products downstream mix the deviations of every
    position, and an element near 0 may move by more than itself.
    Returns (use, name of the worst tensor)."""
    uses = [(abs(loss_k - loss_p) / (2.0**-7 * abs(loss_p)), "loss")]
    for name, g, w in zip(grads_k, grads_k.values(), grads_p.values()):
        diff = torch.linalg.vector_norm((g - w).float())
        uses.append((float(diff / (2.0**-6 * torch.linalg.vector_norm(w.float()))), name))
    return max(uses)


def _step_check(torch, A, experiment, dev, dtype_name):
    """One training step (2 layers, [2, 2048], vocab 1024) through the
    kernels against the same step through their plain versions. fp32:
    the loss within 1e-5 relative and each gradient within 1e-4 of its
    largest magnitude (the CPU tests' step tolerances: the attention sums
    run in another order); bf16: ``_bf16_step_use``."""
    from zookeeper_tpu_torch.training.step import softmax_cross_entropy

    exp = experiment(**{"model.num_layers": 2, "model.compute_dtype": dtype_name,
                        "seq_len": 2048, "batch_size": 2})
    state = exp.build_state(dev)
    batch = next(iter(exp.loader.host_batches("train")))
    tokens, target = (torch.from_numpy(batch[key]).to(dev) for key in ("input", "target"))
    names, params = zip(*state.module.named_parameters())

    def loss_and_grads():
        loss = softmax_cross_entropy(state.module.train()(tokens), target)
        return loss.item(), dict(zip(names, torch.autograd.grad(loss, params)))

    what = f"lm training {dtype_name} check"
    with deterministic(torch):
        A.reset_launches()
        loss_k, grads_k = loss_and_grads()
        launched = dict(A.LAUNCHES)
        with _plain_flash_training(A):
            loss_p, grads_p = loss_and_grads()
        torch.cuda.synchronize()
    check(launched == {**dict.fromkeys(A.LAUNCHES, 0), **dict.fromkeys(LM_TRAIN_KERNELS, 2)},
          f"{what}: the kernel step launched {launched}")
    check(A.LAUNCHES == launched, f"{what}: the plain step launched kernels "
                                  f"({launched} -> {A.LAUNCHES})")
    worst = max((float((g - grads_p[n]).abs().max() / grads_p[n].abs().max().clamp_min(1e-30)), n)
                for n, g in grads_k.items())
    if dtype_name == "float32":
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        check(loss_rel <= 1e-5 and worst[0] <= 1e-4,
              f"{what}: loss {loss_k} vs {loss_p}, worst gradient {worst[1]} at {worst[0]} of "
              f"its largest magnitude")
        tol = (f"loss rel {loss_rel:.3g} (tol 1e-5), worst {worst[1]} at {worst[0]:.3g} of its "
               f"largest magnitude (tol 1e-4)")
    else:
        use, where = _bf16_step_use(torch, loss_k, loss_p, grads_k, grads_p)
        check(use <= 1, f"{what}: loss {loss_k} vs {loss_p}, {where} uses {use:.3g} of its limit")
        tol = (f"limit (loss 2^-7 rel, each gradient 2^-6 of its norm) used {use:.3g} at "
               f"{where}; largest element error {worst[0]:.3g} of its tensor's largest "
               f"magnitude at {worst[1]}")
    print(f"lm training: {dtype_name} step (2 layers, [2, 2048], vocab 1024, K10/K11 "
          f"variant {A.flash_backward_variant(getattr(torch, dtype_name), 64)}) through the "
          f"kernels against their plain versions: loss {loss_k:.7f} vs {loss_p:.7f}, "
          f"{len(names)} gradients, {tol}", flush=True)
    del exp, state, grads_k, grads_p
    torch.cuda.empty_cache()


def lm_training_phase(torch, A, smi):
    """TrainLM: one fp32 and one bf16 step at reduced depth and sequence
    through the kernels against the same step through their plain
    versions; then the full-width run() with its launches per step, its
    losses, the step's time, busy share, peak memory and profile.
    Returns (launches over run(), stats)."""
    from torch.profiler import ProfilerActivity, profile

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.training.lm import TrainLM

    dev = torch.device("cuda")

    def experiment(**overrides):
        exp = TrainLM()
        configure(exp, {**LM_TRAIN_CONFIG, **overrides}, name="experiment")
        return exp

    # (1) 2 layers, seq 2048, batch 2: the kernel step against the plain
    # step, in fp32 (K10/K11 on FMA) and in bf16 (on tensor cores).
    for dtype_name in ("float32", "bfloat16"):
        _step_check(torch, A, experiment, dev, dtype_name)

    # (2) run() at full width; each train step's launches and loss are
    # read around the step, the eval's launches are what is left.
    exp = experiment()
    head_dim = LM_TRAIN_CONFIG["model.d_model"] // LM_TRAIN_CONFIG["model.num_heads"]
    variant = A.flash_backward_variant(torch.bfloat16, head_dim)
    fwd_variant = A.flash_forward_variant(torch.bfloat16, head_dim)
    check(variant == fwd_variant == "mma",
          f"lm training run(): K9-lse takes the {fwd_variant}, K10/K11 the {variant} kernels at "
          f"bf16 head_dim {head_dim}, want the tensor-core ones")
    losses, per_step = [], []
    real_step_fn = TrainLM._train_step_fn

    def step_fn(self):
        step = real_step_fn(self)

        def counted(st, b):
            before = dict(A.LAUNCHES)
            st, metrics = step(st, b)
            per_step.append({name: A.LAUNCHES[name] - before[name] for name in A.LAUNCHES})
            losses.append(metrics["loss"])
            return st, metrics

        return counted

    A.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(TrainLM, "_train_step_fn", step_fn):
        history = exp.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(A.LAUNCHES)
    want_step = {**dict.fromkeys(A.LAUNCHES, 0), **dict.fromkeys(LM_TRAIN_KERNELS, LM_LAYERS)}
    check(len(per_step) == LM_TRAIN_STEPS and all(p == want_step for p in per_step),
          f"lm training run(): launches per step {per_step}, want {want_step} x {LM_TRAIN_STEPS}")
    eval_batches = (LM_TRAIN_CONFIG["loader.dataset.num_validation_examples"]
                    // LM_TRAIN_CONFIG["batch_size"])
    want_run = {**dict.fromkeys(A.LAUNCHES, 0),
                **dict.fromkeys(LM_TRAIN_KERNELS, LM_LAYERS * LM_TRAIN_STEPS),
                "flash_forward": LM_LAYERS * eval_batches}
    check(launches == want_run, f"lm training run(): launches {launches}, want {want_run}")
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"lm training run(): losses {losses}")
    check(losses[-1] < losses[0], f"lm training run(): the loss did not fall: {losses}")
    val = history["validation"][0]
    check(math.isfinite(val["loss"]), f"lm training run(): validation {val}")
    tokens_per_step = LM_TRAIN_CONFIG["batch_size"] * LM_TRAIN_CONFIG["seq_len"]
    run_tokens_per_s = history["train"][0]["examples_per_sec"] * LM_TRAIN_CONFIG["seq_len"]
    print(f"lm training run(): {LM_TRAIN_STEPS} steps, K9-lse and K10/K11 variant {variant}, "
          f"launches "
          f"{launches} (per step "
          f"{per_step[0]}; the eval's {eval_batches} batch ran {launches['flash_forward']} "
          f"no-lse K9), losses {[round(x, 5) for x in losses]}, validation {val}, "
          f"{run_tokens_per_s:.1f} tokens/s through run() (first epoch, first step included), "
          f"run {run_s:.1f} s with build and eval", flush=True)

    # (3) the step in the default settings on a device-resident batch:
    # CUDA events and the host clock over three steps after a warm step.
    state, step = exp.final_state, exp._train_step_fn()
    batches = exp.loader.batches("train", device=dev, epoch=1, max_batches=1)
    batch = next(batches)
    batches.close()
    step(state, batch)
    torch.cuda.synchronize()
    dev_ms, wall_ms = [], []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        step(state, batch)
        end.record()
        end.synchronize()
        wall_ms.append((time.perf_counter() - t1) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    step_ms, step_wall_ms = statistics.median(dev_ms), statistics.median(wall_ms)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(getattr(e, attr) for e in kernels) / 1e3
    acts = sum(e.count for e in kernels)
    print(f"lm training profile: {acts} device activities, {busy_ms:.3f} ms busy, "
          f"{100 * busy_ms / step_ms:.1f}% of the {step_ms:.3f} ms step; top items:", flush=True)
    for e in sorted(kernels, key=lambda e: getattr(e, attr), reverse=True)[:12]:
        t = getattr(e, attr) / 1e3
        print(f"  {t:9.3f} ms {100 * t / busy_ms:5.1f}% x{e.count:<5d} {e.key[:100]}", flush=True)
    gib = 2.0**30
    stats = {
        "step_ms": step_ms, "step_wall_ms": step_wall_ms, "step_ms_all": dev_ms,
        "tokens_per_s_step": tokens_per_step / (step_ms / 1e3),
        "tokens_per_s_run": run_tokens_per_s, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / step_ms, "device_activities_per_step": acts,
        "peak_gib": peak / gib, "step_gib": (peak - base) / gib,
        "loss_first": losses[0], "loss_last": losses[-1],
    }
    print(f"lm training on {smi}: {json.dumps(stats)}", flush=True)
    del exp, state, batch
    torch.cuda.empty_cache()
    return launches, stats


#: TransformerLM at head_dim 256 (d_model 1024, 4 heads), 2 layers, seq_len
#: 2048: the geometry the port's kernels refused before they took every
#: head_dim. Served in both layouts, and one training step.
LM_WIDE = {"model.num_layers": 2, "model.d_model": 1024, "model.num_heads": 4,
           "model.mlp_ratio": 4, "model.compute_dtype": "bfloat16", "seq_len": 2048}


def lm_wide_phase(torch, A, smi):
    """Serve a few requests through LMServingConfig.run() at head_dim 256 in
    the slot and paged layouts (2 K9 per prefill, 2 K12/K13 per decode
    step), then take one training step through the train step (2 K9-lse,
    2 K10, 2 K11). Returns the launches."""
    import numpy as np

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.training.lm import TrainLM

    layers = LM_WIDE["model.num_layers"]
    launches = {}
    for label, overrides in (("slots", {}), ("paged", PAGED)):
        cfg = _lm_config({**LM_WIDE, "requests": 6, "max_prompt": 1500, "new_tokens": 8,
                          **overrides})
        A.reset_launches()
        t0 = time.perf_counter()
        result = cfg.run()
        torch.cuda.synchronize()
        got = dict(A.LAUNCHES)
        kernel = "paged_decode_attention" if label == "slots" else "pool_paged_decode_attention"
        prefills = int(result["prefills_total"]) + 2  # + the warmup of both buckets
        decodes = int(result["decode_steps_total"]) + 1  # + the warmup step
        want = {**dict.fromkeys(A.LAUNCHES, 0), "flash_forward": layers * prefills,
                kernel: layers * decodes}
        check(got == want, f"lm head_dim 256 {label}: launches {got}, want {want}")
        outputs = np.concatenate(cfg.outputs)
        check(result["generated_tokens"] == 6 * 8 and outputs.min() >= 0
              and outputs.max() < LM_CONFIG["vocab_size"],
              f"lm head_dim 256 {label}: {result['generated_tokens']} tokens, range "
              f"[{outputs.min()}, {outputs.max()}]")
        launches[label] = got
        print(f"lm head_dim 256 {label} on {smi}: launches {got} ({prefills} prefills, "
              f"{decodes} decode steps with warmup), tokens/s {result['tokens_per_sec']:.1f}, "
              f"run {time.perf_counter() - t0:.1f} s", flush=True)
        del cfg
        torch.cuda.empty_cache()

    dev = torch.device("cuda")
    exp = TrainLM()
    configure(exp, {**LM_TRAIN_CONFIG, **LM_WIDE, "batch_size": 2}, name="experiment")
    state, step = exp.build_state(dev), exp._train_step_fn()
    batches = exp.loader.batches("train", device=dev, epoch=0, max_batches=1)
    batch = next(batches)
    batches.close()
    A.reset_launches()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    got = dict(A.LAUNCHES)
    want = {**dict.fromkeys(A.LAUNCHES, 0), **dict.fromkeys(LM_TRAIN_KERNELS, layers)}
    check(got == want, f"lm head_dim 256 training step: launches {got}, want {want}")
    check(math.isfinite(loss), f"lm head_dim 256 training step: loss {loss}")
    launches["train"] = got
    print(f"lm head_dim 256 training step on {smi} ([2, 2048], bf16): launches {got}, loss "
          f"{loss:.5f}, first step {step_s * 1e3:.1f} ms with the kernels' first use", flush=True)
    del exp, state, batch
    torch.cuda.empty_cache()
    return launches


#: TrainCifar at its own width (``examples/cifar_experiment.py``: BinaryNet
#: with features (128, 128, 256, 256) and one dense layer of 512, batch
#: 128, pad-and-crop by 4, Adam) on SyntheticCifar10's 1024 training
#: examples: one epoch of 8 steps, the profiler window on steps 5-8.
CIFAR = {"model": "BinaryNet", "model.features": (128, 128, 256, 256),
         "model.dense_units": (512,)}
CIFAR_GEOMETRY = {"height": 32, "width": 32, "channels": 3, "num_classes": 10}
CIFAR_STEPS = 8
CIFAR_WINDOW = 4
#: ConvertPacked of the float export: (label, settings, verify_atol, the
#: kernels its twin launches). BinaryNet folds its dense stage only (its
#: conv BNs follow a maxpool), so the folded twins pack the dense stage;
#: the popcount twin's float side runs the same popcount path on latent
#: kernels (its SAME convs pad with ones, unlike "mxu"'s zeros).
CIFAR_CONVERSIONS = (
    ("xnor", {}, 0.0, {"packed_weight_matmul"}),
    ("xnor_fold", {"fold_bn": True, "deploy_overrides": {
        "packed_weights": False, "dense_packed_weights": True,
        "dense_binary_compute": "xnor"}}, 1e-4, {"packed_weight_matmul"}),
    ("popcount", {"model.binary_compute": "xnor_popcount"}, 0.0,
     {"pack_rows", "conv_gemm_popcount", "xnor_matmul_packed_scaled"}),
    ("popcount_fold", {"fold_bn": True, "deploy_overrides": {
        "packed_weights": False, "dense_packed_weights": True,
        "dense_binary_compute": "xnor_popcount"}}, 1e-4,
     {"pack_rows", "xnor_matmul_packed_scaled"}),
)
CIFAR_LATENCY_BATCHES = (1, 8)


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launched(bc):
    return {k: v for k, v in bc.LAUNCHES.items() if v}


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _state_tensors(torch, state):
    """Every tensor of a train state, by name (parameters, statistics,
    Adam's moments and count)."""
    out = {f"module.{k}": v for k, v in state.module.state_dict().items()}
    for key in ("mu", "nu"):
        out.update({f"{key}.{k}": v for k, v in state.opt_state[key].items()})
    out["count"] = torch.as_tensor(state.opt_state["count"])
    return out


def cifar_phase(torch, bc, smi, device="cuda", model=None):
    """TrainCifar -> export -> ConvertPacked -> LatencyBench / ServingConfig
    on the card (module docstring, phase 17). ``device`` and ``model``
    exist for a rehearsal on the CPU at a small width. Returns ({kernel:
    {path: launches}}, stats)."""
    import tempfile

    import numpy as np

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.data.store import MemmapWriter
    from zookeeper_tpu_torch.serving import InferenceEngine, ServingConfig
    from zookeeper_tpu_torch.serving.latency import LatencyBench
    from zookeeper_tpu_torch.training import EvalExperiment
    from zookeeper_tpu_torch.training.cifar import TrainCifar
    from zookeeper_tpu_torch.training.convert_packed import ConvertPacked, resolve_deploy_conf
    from zookeeper_tpu_torch.training.profiling import format_breakdown, op_time_breakdown

    dev = torch.device(device)
    model = model or CIFAR
    tag = "cifar"
    stats = {}
    entries = {}

    def add_launches(path, launches):
        for name, n in launches.items():
            entries.setdefault(name, {})[path] = n

    with tempfile.TemporaryDirectory(prefix="zk_cifar_") as tmp:
        float_dir = os.path.join(tmp, "float")

        def train(extra):
            exp = TrainCifar()
            configure(exp, {**model, "epochs": 1, "steps_per_epoch": CIFAR_STEPS,
                            "log_every": 1, "seed": 0, "device": device, "verbose": False,
                            **extra}, name="experiment")
            with deterministic(torch):
                bc.reset_launches()
                t0 = time.perf_counter()
                history = exp.run()
                _sync(torch, dev)
            check(not _launched(bc), f"{tag}: TrainCifar on mxu launched {_launched(bc)}")
            return exp, history, time.perf_counter() - t0

        # 1. In memory, with the jsonl writer, the profiler window and the export.
        mem_log, prof_dir = os.path.join(tmp, "mem.jsonl"), os.path.join(tmp, "prof")
        exp, history, wall = train({"writer.jsonl.path": mem_log, "profile_dir": prof_dir,
                                    "export_model_to": float_dir})
        losses = [r["train/loss"] for r in _jsonl(mem_log) if "train/loss" in r]
        check(len(losses) == CIFAR_STEPS and all(math.isfinite(v) for v in losses),
              f"{tag}: per-step losses {losses}")
        epoch_rows = [r for r in _jsonl(mem_log) if "train_epoch/loss" in r]
        want = {"step": CIFAR_STEPS, **{f"train_epoch/{k}": v for k, v in history["train"][0].items()},
                **{f"val/{k}": v for k, v in history["validation"][0].items()}}
        check(epoch_rows == [want], f"{tag}: the jsonl epoch line {epoch_rows} is not run()'s "
                                    f"metrics {want}")
        check(os.path.isfile(os.path.join(float_dir, "model.pt")), f"{tag}: no float export")
        ips_mem = history["train"][0]["examples_per_sec"]
        print(f"{tag}: TrainCifar (BinaryNet {model['model.features']} + "
              f"{model['model.dense_units']}, batch 128, deterministic) {CIFAR_STEPS} steps "
              f"in {wall:.1f} s, losses {[round(v, 4) for v in losses]}, the jsonl epoch line "
              f"equal to run()'s metrics, val {json.dumps(history['validation'][0])}", flush=True)

        # The window's breakdown against one traced step of the same step
        # function (deterministic mode, as in the run).
        check(len(os.listdir(prof_dir)) == 1, f"{tag}: profile_dir holds {os.listdir(prof_dir)}")
        if dev.type == "cuda":
            breakdown = op_time_breakdown(prof_dir, steps=CIFAR_WINDOW)
            print(f"{tag} profiler window ({CIFAR_WINDOW} steps) on {smi}:\n"
                  + format_breakdown(breakdown), flush=True)
            state = exp.build_state(dev)
            step = exp._train_step_fn()
            batches = exp.loader.batches("train", device=dev, epoch=0, max_batches=1)
            batch = next(batches)
            batches.close()
            keys = []
            with deterministic(torch):
                times = []
                for _ in range(7):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    step(state, batch)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                step_ms = statistics.median(times[1:])
                busy_ms, _ = _profile_train_step(torch, lambda: step(state, batch), step_ms,
                                                 f"{tag} step", top=5, keys=keys)
            window_ms = breakdown["total_ms_per_step"]
            top = [row[2] for row in breakdown["top_ops"][:5]]
            rel = abs(window_ms - busy_ms) / busy_ms
            check(rel <= 0.1, f"{tag}: the window's {window_ms:.4f} ms/step differs from the "
                              f"traced step's busy {busy_ms:.4f} ms by {100 * rel:.1f}%")
            check(top[0] in keys[:3] and keys[0] in top[:3]
                  and len(set(top) & set(keys)) >= 3,
                  f"{tag}: the window's top kernels {top} disagree with the step's {keys}")
            stats["train"] = {"step_ms": step_ms, "busy_ms_step": busy_ms,
                              "busy_ms_window": window_ms,
                              "busy_share_step": busy_ms / step_ms,
                              "busy_share_window": window_ms / step_ms,
                              "window_vs_step": rel}
            print(f"{tag} on {smi}: step {step_ms:.4f} ms, busy {busy_ms:.4f} ms "
                  f"({100 * busy_ms / step_ms:.1f}%); the window's {window_ms:.4f} ms/step "
                  f"({100 * window_ms / step_ms:.1f}%), {100 * rel:.2f}% apart, top items "
                  f"shared {len(set(top) & set(keys))}/5", flush=True)
            del state, batch
        mem_state = _state_tensors(torch, exp.final_state)
        mem_lines = _jsonl(mem_log)

        # 2. The same steps from a MemmapDataset store of the same splits.
        store = os.path.join(tmp, "store")
        t0 = time.perf_counter()
        for split, source in (("train", exp.loader.dataset.train()),
                              ("validation", exp.loader.dataset.validation())):
            with MemmapWriter(os.path.join(store, split)) as writer:
                for lo in range(0, len(source), 100):
                    writer.append({k: v[lo:lo + 100] for k, v in source.arrays.items()})
        write_s = time.perf_counter() - t0
        store_bytes = sum(os.path.getsize(os.path.join(root, f))
                          for root, _, files in os.walk(store) for f in files)
        mm_log = os.path.join(tmp, "memmap.jsonl")
        exp_mm, history_mm, wall_mm = train({"loader.dataset": "MemmapDataset",
                                             "loader.dataset.directory": store,
                                             "writer.jsonl.path": mm_log})
        # In memory again, without the profiler window (the first run's
        # host time carried it and the warm-up), for the rate beside the
        # store's.
        exp_again, history_again, _ = train({})
        again = _state_tensors(torch, exp_again.final_state)
        check(all(_same_bits(torch, again[k], mem_state[k]) for k in mem_state),
              f"{tag}: two in-memory runs differ")
        del exp_again
        check(exp_mm.num_classes == 10, f"{tag}: the store's label scan gave {exp_mm.num_classes}")
        mm_state = _state_tensors(torch, exp_mm.final_state)
        differ = [k for k in mem_state if not _same_bits(torch, mem_state[k], mm_state[k])]
        check(not differ and mem_state.keys() == mm_state.keys(),
              f"{tag}: the memmap run's state differs in {differ[:5]}")
        strip = lambda rows: [{k: v for k, v in r.items() if "examples_per_sec" not in k}  # noqa: E731
                              for r in rows]
        check(strip(_jsonl(mm_log)) == strip(mem_lines),
              f"{tag}: the memmap run's metrics differ from the in-memory run's")
        ips_mm = history_mm["train"][0]["examples_per_sec"]
        ips_again = history_again["train"][0]["examples_per_sec"]
        stats["memmap"] = {"store_bytes": store_bytes, "write_s": write_s,
                           "examples_per_sec_memory_profiled": ips_mem,
                           "examples_per_sec_memmap": ips_mm,
                           "examples_per_sec_memory": ips_again}
        print(f"{tag} memmap on {smi}: store {store_bytes} B written in {write_s:.3f} s "
              f"(chunks of 100); the run equal to the in-memory one in all "
              f"{len(mem_state)} tensors and every step's metrics; run() "
              f"{ips_mm:.1f} examples/s from the store, then {ips_again:.1f} in memory "
              f"({ips_mem:.1f} in the first, profiled run; deterministic mode, 8 steps)",
              flush=True)
        del exp_mm

        # 3. ConvertPacked, each twin's probe through its kernels.
        geometry = {**CIFAR_GEOMETRY}
        exports = {}
        for label, settings, atol, kernels in CIFAR_CONVERSIONS:
            out = os.path.join(tmp, f"packed_{label}")
            cp = ConvertPacked()
            configure(cp, {**model, **geometry, **settings, "checkpoint": float_dir,
                           "output": out, "verify_atol": atol, "device": device,
                           "verbose": False}, name="convert")
            with deterministic(torch):
                bc.reset_launches()
                cp.run()
                _sync(torch, dev)
            launched = _launched(bc)
            if dev.type == "cuda":
                check(set(launched) == kernels,
                      f"{tag}: ConvertPacked {label}'s probe launched {launched}, want {kernels}")
            add_launches(f"ConvertPacked {label} probe", launched)
            conf, _ = resolve_deploy_conf(cp.model, cp.fold_bn, cp.deploy_overrides)
            exports[label] = (out, {"model": model["model"],
                                    **{f"model.{k}": v for k, v in conf.items()}}, kernels)
            r = cp.result
            stats[f"convert_{label}"] = r
            print(f"{tag} ConvertPacked {label} on {smi}: max |diff| {r['max_abs_diff']} "
                  f"(verify_atol {atol}), whole model {r['whole_mib'][0]:.4f} -> "
                  f"{r['whole_mib'][1]:.4f} MiB, binary kernels {r['binary_kib'][0]:.1f} -> "
                  f"{r['binary_kib'][1]:.1f} KiB, probe launches {launched}", flush=True)
        # The popcount twin of the "mxu" float model differs by its ones
        # padding: verify_atol=0 must refuse it.
        cp = ConvertPacked()
        configure(cp, {**model, **geometry, "checkpoint": float_dir,
                       "output": os.path.join(tmp, "refused"), "device": device,
                       "deploy_overrides": {"binary_compute": "xnor_popcount"},
                       "verbose": False}, name="convert")
        try:
            cp.run()
            refused = None
        except RuntimeError as e:
            refused = str(e)
        check(refused is not None and "diverges" in refused
              and not os.path.exists(os.path.join(tmp, "refused")),
              f"{tag}: the ones-padded popcount twin of the mxu model was not refused")
        print(f"{tag}: the popcount twin of the mxu float model refused at verify_atol=0 "
              f"({refused.split(':')[1].split('>')[0].strip()})", flush=True)

        # 4. LatencyBench on each export at batch 1 and 8.
        for label, (out, conf, kernels) in exports.items():
            for b in CIFAR_LATENCY_BATCHES:
                lb = LatencyBench()
                configure(lb, {**conf, **geometry, "checkpoint": out, "batch_size": b,
                               "device": device}, name="bench")
                bc.reset_launches()
                result = lb.run()
                _sync(torch, dev)
                launched = _launched(bc)
                if dev.type == "cuda":
                    check(set(launched) == kernels,
                          f"{tag}: LatencyBench {label} batch {b} launched {launched}")
                check(result["ms_per_inference"] > 0 and result["p99_ms"] >= result["p50_ms"],
                      f"{tag}: LatencyBench {label} batch {b}: {result}")
                add_launches(f"LatencyBench {label} batch {b}", launched)
                stats[f"latency_{label}_b{b}"] = result
                print(f"{tag} LatencyBench {label} batch {b} on {smi}: {json.dumps(result)}",
                      flush=True)

        # 5. ServingConfig on the "xnor" export, and its logits against
        # EvalExperiment's forward of the same export.
        out, conf, _ = exports["xnor"]
        cfg = ServingConfig()
        configure(cfg, {**conf, **geometry, "checkpoint": out, "device": device,
                        "engine.batch_buckets": (1, BATCH), "requests": 16,
                        "max_request": BATCH, "seed": 0, "verbose": False}, name="serving")
        buckets = []
        real_infer = InferenceEngine.infer

        def spy(engine, x):
            buckets.append(engine.bucket_for(len(x)))
            return real_infer(engine, x)

        bc.reset_launches()
        with mock.patch.object(InferenceEngine, "infer", spy):
            result = cfg.run()
        _sync(torch, dev)
        launched = _launched(bc)
        add_launches("ServingConfig xnor (16 requests, buckets 1 and 8)", launched)
        x = np.random.default_rng(1).normal(size=(BATCH, 32, 32, 3)).astype(np.float32)
        ev = EvalExperiment()
        configure(ev, {**conf, "checkpoint": out, "device": device, "batch_size": BATCH,
                       "loader.dataset": "SyntheticCifar10",
                       "loader.preprocessing": "ImageClassificationPreprocessing",
                       "loader.preprocessing.height": 32, "loader.preprocessing.width": 32,
                       "loader.preprocessing.channels": 3, "verbose": False}, name="eval")
        module = ev.build_state(dev).module.eval()
        with deterministic(torch):
            bc.reset_launches()
            served = cfg.engine.infer(x)
            _sync(torch, dev)
            per_forward = _launched(bc)
            with torch.inference_mode():
                want = module(torch.from_numpy(x).to(dev))
            _sync(torch, dev)
        check(_same_bits(torch, served, want),
              f"{tag}: served logits differ from EvalExperiment's forward "
              f"(max {_max_abs_err(torch, served, want)})")
        if dev.type == "cuda":
            check(set(per_forward) == {"packed_weight_matmul"},
                  f"{tag}: the xnor export's forward launched {per_forward}")
            # K4 launches per forward of each bucket (a conv whose patch
            # matrix is large runs per tap).
            per_bucket = {}
            for b in sorted(set(buckets)):
                bc.reset_launches()
                cfg.engine.infer(np.zeros((b, 32, 32, 3), np.float32))
                per_bucket[b] = bc.LAUNCHES["packed_weight_matmul"]
            n = sum(per_bucket[b] for b in buckets)
            check(launched == {"packed_weight_matmul": n},
                  f"{tag}: ServingConfig launched {launched} in forwards "
                  f"{ {b: buckets.count(b) for b in per_bucket} } of {per_bucket} K4")
            stats["serving_xnor_k4_per_forward"] = per_bucket
        scores = ev.run()
        stats["serving_xnor"] = {k: result[k] for k in ("latency_p50_ms", "latency_p99_ms",
                                                        "bucket_fill_mean", "qps")}
        stats["eval_xnor"] = scores
        print(f"{tag} ServingConfig xnor on {smi}: {len(buckets)} forwards, launches "
              f"{launched}, {json.dumps(stats['serving_xnor'])}; logits equal to "
              f"EvalExperiment's forward bit for bit; eval {json.dumps(scores)}", flush=True)
        del cfg, ev, module
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return entries, stats


def digits_phase(torch, smi, device="cuda"):
    """TrainDigits -> export -> ServeDigits -> LatencyBench on real
    digits, when scikit-learn imports (it bundles the data); otherwise
    one line saying the leg did not run. SimpleCnn launches none of the
    port's kernels. Returns stats or None."""
    try:
        import sklearn  # noqa: F401
    except ImportError:
        print("digits: the TrainDigits -> ServeDigits -> LatencyBench leg was not run: "
              "scikit-learn is absent on this machine", flush=True)
        return None
    import tempfile

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving.classifier import ServeDigits
    from zookeeper_tpu_torch.serving.latency import LatencyBench
    from zookeeper_tpu_torch.training import EvalExperiment
    from zookeeper_tpu_torch.training.digits import TrainDigits

    with tempfile.TemporaryDirectory(prefix="zk_digits_") as tmp:
        export = os.path.join(tmp, "digits")
        exp = TrainDigits()
        configure(exp, {"device": device, "verbose": False, "export_model_to": export},
                  name="experiment")
        history = exp.run()
        losses = [e["loss"] for e in history["train"]]
        check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
              f"digits: epoch losses {losses}")
        serve = ServeDigits()
        configure(serve, {"checkpoint": export, "device": device, "verbose": False},
                  name="serving")
        served = serve.run()
        ev = EvalExperiment()
        configure(ev, {"checkpoint": export, "device": device, "model": "SimpleCnn",
                       "batch_size": 64, "loader.dataset": "SklearnDigits",
                       "loader.preprocessing": "ImageClassificationPreprocessing",
                       "loader.preprocessing.height": 8, "loader.preprocessing.width": 8,
                       "loader.preprocessing.channels": 1, "verbose": False}, name="eval")
        scores = ev.run()
        check(abs(served["accuracy"] - scores["accuracy"]) <= 5e-5
              and served["examples"] == 359,
              f"digits: served accuracy {served['accuracy']} over {served['examples']} "
              f"examples, eval {scores['accuracy']}")
        bench = {}
        for b in CIFAR_LATENCY_BATCHES:
            lb = LatencyBench()
            configure(lb, {"model": "SimpleCnn", "checkpoint": export, "batch_size": b,
                           "height": 8, "width": 8, "channels": 1, "num_classes": 10,
                           "device": device}, name="bench")
            bench[b] = lb.run()
    stats = {"val_accuracy": history["validation"][-1]["accuracy"],
             "served_accuracy": served["accuracy"], "eval_accuracy": scores["accuracy"],
             "latency": bench}
    print(f"digits on {smi}: {json.dumps(stats)}", flush=True)
    return stats


#: The fused loop (phase 18): ``unroll`` 4 over 14 steps, slabs of 4, 4,
#: 4 and 2 (an eager warm-up slab, two replays of the 4-step graph, one
#: of the 2-step graph).
UNROLL = 4
UNROLL_STEPS = 14
UNROLL_LEGS = {
    "TrainImageNet": ({
        "model": "QuickNetLarge", "model.compute_dtype": "bfloat16",
        "model.binary_compute": "int8", "model.pack_residuals": True,
        "batch_size": TRAIN_BATCH,
    }, {name: n * sum(s[0] for s in SECTIONS) for name, n in RESID_PER_CONV.items()}),
    "DistillImageNet": ({
        **RECIPE, "allow_random_teacher": True, "batch_size": TRAIN_BATCH,
    }, RECIPE_PER_STEP),
    "TrainLM": ({**LM_TRAIN_CONFIG, "model.num_layers": 2},
                {name: 2 for name in LM_TRAIN_KERNELS}),
}
#: The kernels' categories in a profiler trace (``training.profiling``).
CATEGORY_OF = {"pack_rows": "K1 pack_rows", "conv_gemm_popcount": "K3 conv_gemm_popcount",
               "pack_resid": "K6 pack_resid", "unpack_resid_pm1": "K7 unpack_resid_pm1",
               "mask_mul_resid": "K8 mask_mul_resid", "flash_forward_lse": "K9 flash_forward",
               "flash_backward_dq": "K10 flash_backward_dq",
               "flash_backward_dkv": "K11 flash_backward_dkv"}


def _shared_source(exp, cache: dict):
    """Give ``exp``'s loader the split sources of ``cache`` (filled by
    the first loader that reads them): every ImageNet-shaped experiment
    of phase 18 configures the same seeded synthetic dataset, made once."""
    object.__setattr__(exp.loader, "_source_cache", cache)
    return exp


def _launch_counts(bc, A):
    return {k: v for counts in (bc.LAUNCHES, A.LAUNCHES) for k, v in counts.items() if v}


def _reset_all(bc, A):
    bc.reset_launches()
    A.reset_launches()


def _same_state(torch, got, want) -> list:
    """Names whose bits differ between two ``_flat_state`` results; a
    count compares by value (a graph keeps it on the card as int32)."""
    check(set(got) == set(want), f"unroll: state names differ: {sorted(set(got) ^ set(want))[:4]}")
    bad = []
    for k in want:
        a, b = got[k], want[k]
        if a.ndim == 0 and not a.is_floating_point() and not b.is_floating_point():
            a, b = a.long(), b.long()
        if not _same_bits(torch, a, b):
            bad.append(k)
    return bad


def _kernel_counts(torch, prof) -> dict:
    """Device kernels of a profiler window by port kernel name."""
    from zookeeper_tpu_torch.training.profiling import kernel_category

    names = {v: k for k, v in CATEGORY_OF.items()}
    counts = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = names.get(kernel_category(e.name))
        if name is not None:
            counts[name] = counts.get(name, 0) + 1
    return counts


def _busy_ms(torch, prof) -> float:
    """Summed device time of a profiler window's device activities."""
    attr = ("self_device_time_total" if hasattr(prof.key_averages()[0], "self_device_time_total")
            else "self_cuda_time_total")
    return sum(getattr(e, attr) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def _unroll_leg(torch, bc, A, smi, name, tmp, sources):
    """One task's fused loop against its eager loop (module docstring,
    phase 18). Returns the leg's numbers."""
    import importlib

    from torch.profiler import ProfilerActivity, profile

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.training import build_multi_step
    from zookeeper_tpu_torch.training.benchmark import measure_fused_loop_time, time_marginal

    conf, per_step = UNROLL_LEGS[name]
    module = "lm" if name == "TrainLM" else "imagenet"
    cls = getattr(importlib.import_module(f"zookeeper_tpu_torch.training.{module}"), name)
    batch = conf.get("batch_size", 4)
    tag = f"unroll {name}"
    dev = torch.device("cuda")

    # The LM's fused run also keeps the experiment's profiler window (whole
    # slabs), read back by the trace breakdown.
    profile_dir = os.path.join(tmp, "profile") if name == "TrainLM" else None

    def make(unroll, path):
        exp = cls()
        configure(exp, {**conf, "loader.dataset.num_train_examples": UNROLL_STEPS * batch,
                        "epochs": 1, "steps_per_epoch": UNROLL_STEPS, "validate": False,
                        "seed": 0, "device": "cuda", "verbose": False, "unroll": unroll,
                        "log_every": 1, "writer.jsonl.path": path,
                        "profile_dir": profile_dir if unroll > 1 else None},
                  name="experiment")
        return _shared_source(exp, sources)

    runs = {}
    for unroll in (1, UNROLL):
        path = os.path.join(tmp, f"{name}-{unroll}.jsonl")
        exp = make(unroll, path)
        _reset_all(bc, A)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with deterministic(torch):
            history = exp.run()
            torch.cuda.synchronize()
        runs[unroll] = {
            "exp": exp, "history": history, "seconds": time.perf_counter() - t0,
            "rows": [r for r in _jsonl(path) if any(k.startswith("train/") for k in r)],
            "state": _flat_state(torch, exp.final_state), "launches": _launch_counts(bc, A),
            # The run's own peak: over what was allocated before it.
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2.0**30,
        }
    eager, fused = runs[1], runs[UNROLL]
    # Bit identity: every per-step metric, every state tensor.
    check(len(eager["rows"]) == len(fused["rows"]) == UNROLL_STEPS,
          f"{tag}: {len(eager['rows'])} and {len(fused['rows'])} step rows, want {UNROLL_STEPS}")
    bad_rows = [i for i, (a, b) in enumerate(zip(eager["rows"], fused["rows"])) if a != b]
    check(not bad_rows, f"{tag}: the per-step metrics differ at steps {bad_rows}: "
                        f"{eager['rows'][bad_rows[0]] if bad_rows else ''} vs "
                        f"{fused['rows'][bad_rows[0]] if bad_rows else ''}")
    bad = _same_state(torch, fused["state"], eager["state"])
    check(not bad, f"{tag}: the fused run differs from the eager run in {len(bad)} of "
                   f"{len(eager['state'])} state tensors, e.g. {bad[:4]}")
    losses = [r["train/loss"] for r in fused["rows"]]
    check(all(math.isfinite(v) for v in losses), f"{tag}: losses {losses}")
    print(f"{tag}: {UNROLL_STEPS} steps at unroll {UNROLL} equal the eager loop bit for bit "
          f"({len(eager['state'])} state tensors, {len(losses)} steps' metrics; losses "
          f"{losses[0]:.5f} -> {losses[-1]:.5f})", flush=True)

    # Launches: the warm-up slab's own, then captured x replays.
    multi = fused["exp"].multi_step
    graphs = list(multi.graphs.values())
    check(len(graphs) == 2, f"{tag}: {len(graphs)} graphs captured, want 2 (4 and 2 steps)")
    total = {k: n * UNROLL_STEPS for k, n in per_step.items()}
    check(fused["launches"] == total == eager["launches"],
          f"{tag}: launched {fused['launches']} fused, {eager['launches']} eager, want {total}")
    graph_rows = []
    replayed = {k: 0 for k in per_step}
    for g in graphs:
        k = int(next(iter(g.slab.values())).shape[0])
        captured = {n: c for d in g.launches for n, c in d.items()}
        want = {n: c * k for n, c in per_step.items()}
        check({n: captured.get(n, 0) for n in per_step} == want,
              f"{tag}: the {k}-step graph captured {captured}, want {want}")
        for n in per_step:
            replayed[n] += captured[n] * g.replays
        graph_rows.append({"steps": k, "replays": g.replays, "captured": want,
                           "capture_s": g.capture_s})
    check(all(replayed[n] + per_step[n] * UNROLL == total[n] for n in per_step),
          f"{tag}: captured x replays {replayed} + the warm-up slab != {total}")

    profile_window = {}
    if profile_dir is not None:
        # The window opens at the first slab from step 4 and closes after
        # the slab holding step 13: steps 4-13.
        from zookeeper_tpu_torch.training.profiling import op_time_breakdown

        cats = op_time_breakdown(profile_dir, steps=UNROLL_STEPS - UNROLL)["by_category"]
        profile_window = {c: cats[c]["ms_per_step"] for c in cats if c.startswith("K")}
        check(sorted(profile_window) == sorted(CATEGORY_OF[n] for n in per_step)
              and all(v > 0 for v in profile_window.values()),
              f"{tag}: the profile_dir window's port kernels are {profile_window}")
        print(f"{tag}: the profile_dir window over whole slabs finds the replayed kernels, "
              f"ms a step {json.dumps(profile_window)}", flush=True)

    # Timing, default settings, from the fused run's state: the fused
    # loop (a fresh multi-step of the fused run's step: its own warm-up
    # slab and capture) against the same step, eager, from the eager
    # run's state, on the same slab.
    exp_e, exp_f = eager["exp"], fused["exp"]
    slabs = exp_f.loader.batches("train", device=dev, epoch=0, max_batches=UNROLL,
                                 unroll=UNROLL)
    slab = next(slabs)
    slabs.close()
    step_batch = {k: v[0] for k, v in slab.items()}
    step_fn = multi.step_fn
    timing_ms = build_multi_step(step_fn)
    fused_s, state_f = measure_fused_loop_time(timing_ms, exp_f.final_state, slab,
                                               rounds=2, n1=1, n2=3)
    holder = {"state": exp_e.final_state}

    def eager_chain(n):
        st, m = holder["state"], None
        t0 = time.perf_counter()
        for _ in range(n):
            st, m = step_fn(st, step_batch)
        float(m["loss"])
        return time.perf_counter() - t0

    eager_chain(2)
    eager_s = time_marginal(eager_chain, UNROLL, 3 * UNROLL, 2)

    # Two profiler windows over two whole slabs (replays of the timing
    # graph): the kernels they launched, counted in a window whose
    # schedule drops a warm-up replay first (a window's first kernel can
    # be missed), and the busy share against the timed wall per step,
    # from a plain window (a scheduled one's device totals read high).
    # The profiler can lose a few kernel records of a window (once on
    # the card: 253 of 256 K7 and K8 records, K6's all there), so a
    # window that sees fewer than the replays launched is taken again,
    # up to 3 windows; one must see them all, and none may see more.
    want_seen = {n: 2 * UNROLL * c for n, c in per_step.items()}
    windows = []
    while len(windows) < 3 and (not windows or windows[-1] != want_seen):
        torch.cuda.synchronize()
        sched = torch.profiler.schedule(wait=0, warmup=1, active=2, repeat=1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=sched) as prof:
            for _ in range(3):
                state_f, _ = timing_ms(state_f, slab)
                torch.cuda.synchronize()
                prof.step()
        windows.append(_kernel_counts(torch, prof))
        check(set(windows[-1]) == set(want_seen)
              and all(windows[-1][n] <= want_seen[n] for n in want_seen),
              f"{tag}: the profiler saw {windows[-1]} in two replays, want {want_seen}")
    check(windows[-1] == want_seen,
          f"{tag}: the profiler saw {windows} in windows of two replays, want {want_seen}")
    if len(windows) > 1:
        print(f"{tag}: profiler windows {windows}, the last complete", flush=True)
    seen = windows[-1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            state_f, _ = timing_ms(state_f, slab)
        torch.cuda.synchronize()
    fused_busy = _busy_ms(torch, prof) / (2 * UNROLL)
    stats = {
        "bit_identical": True, "steps": UNROLL_STEPS, "unroll": UNROLL,
        "launches": total, "graphs": graph_rows,
        "profiler_per_replay": {n: c // 2 for n, c in seen.items()},
        "eager_step_ms": eager_s * 1e3, "fused_step_ms": fused_s * 1e3,
        "fused_busy_ms": fused_busy, "fused_busy_share": fused_busy / (fused_s * 1e3),
        "timing_capture_s": [g.capture_s for g in timing_ms.graphs.values()],
        "eager_peak_gib": eager["peak_gib"], "fused_peak_gib": fused["peak_gib"],
        "eager_run_s": eager["seconds"], "fused_run_s": fused["seconds"],
        "profile_window_ms": profile_window,
    }
    print(f"{tag} on {smi}: {json.dumps(stats)}", flush=True)
    del runs, eager, fused, exp_e, exp_f, timing_ms, state_f, holder
    torch.cuda.empty_cache()
    return stats


def _native_leg(torch, smi, sources):
    """TrainImageNet's input pipeline: the native assembly is built and
    engaged on this host, its batches equal the per-example path's, and
    ``run()``'s examples/s (the fused loop) with each at prefetch 1 and 2."""
    import numpy as np

    from zookeeper_tpu_torch import native
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.training.imagenet import TrainImageNet

    tag = "unroll native"
    check(native.available(), f"{tag}: the native library does not build or load on this host")
    conf, _ = UNROLL_LEGS["TrainImageNet"]
    steps = 2 * UNROLL

    def make(prefetch, per_example):
        exp = TrainImageNet()
        configure(exp, {**conf, "loader.dataset.num_train_examples": UNROLL_STEPS * TRAIN_BATCH,
                        "epochs": 2, "steps_per_epoch": steps, "validate": False, "seed": 0,
                        "device": "cuda", "verbose": False, "unroll": UNROLL,
                        "loader.prefetch": prefetch}, name="experiment")
        if per_example:
            object.__setattr__(exp.loader.preprocessing, "native_batch_spec", lambda t: None)
        return _shared_source(exp, sources)

    # The same batches either way, bit for bit (the augmenting mode).
    calls = []
    real = native.gather_augment_normalize
    with mock.patch.object(native, "gather_augment_normalize",
                           lambda *a, **k: (calls.append(1), real(*a, **k))[1]):
        fast = list(itertools.islice(make(2, False).loader.host_batches("train", epoch=0), 2))
    check(len(calls) == 2, f"{tag}: the native path did not engage ({len(calls)} calls)")
    slow = list(itertools.islice(make(2, True).loader.host_batches("train", epoch=0), 2))
    check(all(np.array_equal(a[k], b[k]) for a, b in zip(fast, slow) for k in a),
          f"{tag}: native and per-example batches differ")
    stats = {}
    for per_example in (False, True):
        for prefetch in (1, 2):
            calls.clear()
            exp = make(prefetch, per_example)
            with mock.patch.object(native, "gather_augment_normalize",
                                   lambda *a, **k: (calls.append(1), real(*a, **k))[1]):
                history = exp.run()
            check(len(calls) == (0 if per_example else 2 * steps),
                  f"{tag}: {len(calls)} native batches with per_example={per_example}")
            key = f"{'per_example' if per_example else 'native'}_prefetch{prefetch}"
            stats[key] = history["train"][1]["examples_per_sec"]
            del exp
    print(f"{tag} on {smi}: run() examples/s, epoch 2 of 2 ({steps} steps each, unroll "
          f"{UNROLL}: two replays an epoch): {json.dumps(stats)}", flush=True)
    torch.cuda.empty_cache()
    return stats


def _scalar_route_check(torch, smi) -> dict:
    """What the counts on the card must reproduce (``training.optimizer``):
    a division by a host float is a product by its float32 reciprocal
    here, a division by a 0-d tensor is not; and ``1 - torch.pow(decay,
    count)`` here against the host's ``powf`` for counts 1-20000."""
    import numpy as np

    from zookeeper_tpu_torch.training.optimizer import _bias_correction, _foreach_div

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(s, generator=g).to(dev) for s in ((64, 3, 3, 32), (1000,), (7, 9))]
    out = {"float_is_reciprocal_product": True, "float_differs_from_tensor": False}
    for d in (0.1, 0.001, 0.999, 0.19, 3.0):
        f = float(np.float32(d))
        t = torch.tensor(f, dtype=torch.float32, device=dev)
        by_float = torch._foreach_div(xs, f)
        same = lambda a, b: all(torch.equal(p, q) for p, q in zip(a, b))  # noqa: E731
        out["float_is_reciprocal_product"] &= same(by_float, _foreach_div(xs, t))
        out["float_differs_from_tensor"] |= not same(by_float, torch._foreach_div(xs, t))
    check(out["float_is_reciprocal_product"],
          "unroll: a divisor on the card does not give the host float's bits")
    counts = torch.arange(1, 20001, device=dev, dtype=torch.int32)
    for decay in (0.9, 0.95, 0.99, 0.999):
        card = (1 - torch.pow(decay, counts.to(torch.float32))).cpu().numpy()
        host = np.array([_bias_correction(decay, c) for c in range(1, 20001)], np.float32)
        tables = {}
        table = torch.stack([_bias_correction(decay, c, tables)
                             for c in counts[:2000]]).cpu().numpy()
        check(np.array_equal(table.view(np.int32), host[:2000].view(np.int32)),
              f"unroll: the bias-correction table at {decay} differs from the host")
        out[f"pow_differs_{decay}"] = int((card.view(np.int32) != host.view(np.int32)).sum())
    print(f"unroll scalars on {smi}: {json.dumps(out)} (pow: counts 1-20000 where the "
          "card's torch.pow differs from the host's powf)", flush=True)
    return out


def unroll_phase(torch, bc, A, smi):
    """Phase 18, the fused loop (module docstring). Returns {leg: stats}."""
    import tempfile

    out = {"scalars": _scalar_route_check(torch, smi)}
    imagenet, tokens = {}, {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="zk_unroll_") as tmp:
        for name in UNROLL_LEGS:
            out[name] = _unroll_leg(torch, bc, A, smi, name, tmp,
                                    tokens if name == "TrainLM" else imagenet)
            print(f"unroll: {name} leg done at {time.perf_counter() - t0:.1f} s", flush=True)
    out["native"] = _native_leg(torch, smi, imagenet)
    print(f"unroll: phase 18 in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


#: Phase 19: TrainLM at LM_TRAIN_CONFIG's width through run() under each
#: partitioner, cut to 3 steps and no validation.
PARALLEL_STEPS = 3
PARALLEL_CONFIG = {**LM_TRAIN_CONFIG, "steps_per_epoch": PARALLEL_STEPS, "validate": False}
#: The composed ring: sp ranks over LM_TRAIN_SHAPE's sequence.
RING_SP = 4
RING_SHARD = (LM_TRAIN_SHAPE[0], LM_TRAIN_SHAPE[1] // RING_SP, *LM_TRAIN_SHAPE[2:])


def _parallel_run(torch, A, extra):
    """TrainLM at PARALLEL_CONFIG plus ``extra`` through run(), in
    deterministic mode, its kernel counts set to 0 just before it:
    (experiment, flat final state, per-step losses, launches)."""
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.training.lm import TrainLM

    exp = TrainLM()
    configure(exp, {**PARALLEL_CONFIG, **extra}, name="experiment")
    losses = []
    real_step_fn = TrainLM._train_step_fn

    def step_fn(self):
        step = real_step_fn(self)

        def recorded(st, b):
            st, metrics = step(st, b)
            losses.append(metrics["loss"])
            return st, metrics

        return recorded

    A.reset_launches()
    with deterministic(torch), mock.patch.object(TrainLM, "_train_step_fn", step_fn):
        exp.run()
    torch.cuda.synchronize()
    launches = dict(A.LAUNCHES)
    return exp, _flat_state(torch, exp.final_state), [float(x) for x in losses], launches


def _bf16_run_use(torch, got, want, got_losses, want_losses):
    """How much of the LM step's bf16 limits a run uses against another
    (ok when at most 1): each loss within 2^-7 relative, each weight
    within 2^-6 of its norm, in norm."""
    uses = [abs(a - b) / (2.0**-7 * abs(b)) for a, b in zip(got_losses, want_losses)]
    for k, w in want.items():
        if k.startswith("module ") and w.is_floating_point():
            diff = torch.linalg.vector_norm((got[k] - w).float())
            uses.append(float(diff / (2.0**-6 * torch.linalg.vector_norm(w.float()))))
    return max(uses)


def _composed_ring(torch, A, q, k, v):
    """The sp=RING_SP ring of ``ring_flash_attention_local`` composed in one
    process: each rank's queries against the blocks in its ring order
    through ``ring_flash_step`` (the rotations are the only part left
    out). Returns the whole-sequence output."""
    n, sl = RING_SP, q.shape[1] // RING_SP

    def block(x, i):
        return x[:, i * sl:(i + 1) * sl]

    outs = []
    for my in range(n):
        o = lse = None
        for t in range(n):
            src = (my + t) % n
            o, lse = A.ring_flash_step(block(q, my), block(k, src), block(v, src), o, lse,
                                       src=src, my=my, causal=True)
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=1)


def _ring_kernel_rows(torch, A, g):
    """K9-lse, K10 and K11 at the ring's shard shape, causal (the diagonal
    block) and full (a past block): each held to its plain version (K10
    and K11 with ``D' = D - dlse``, a random dlse) and timed beside it,
    its bound and SDPA. Returns {kernel: {"causal": rec, "full": rec}}."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    b, s, h, d = RING_SHARD
    rows = {name: {} for name in LM_TRAIN_KERNELS}
    for causal in (True, False):
        label = "causal" if causal else "full"
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        kw = {"causal": causal}
        with deterministic(torch):
            out, lse = A.flash_forward_lse(q, k, v, **kw)
            p_out, p_lse = A.flash_attention_plain(q, k, v, want_lse=True, **kw)
            dlse = 0.1 * torch.randn(b * h, s, generator=g, device=dev)
            delta = (A.flash_backward_delta(out, do) - dlse).contiguous()
            ops = (q, k, v, do, lse, delta)
            got = {"flash_backward_dq": (A.flash_backward_dq(*ops, **kw),),
                   "flash_backward_dkv": A.flash_backward_dkv(*ops, **kw)}
            want = {"flash_backward_dq": (A.flash_backward_dq_plain(*ops, **kw),),
                    "flash_backward_dkv": A.flash_backward_dkv_plain(*ops, **kw)}
            torch.cuda.synchronize()
        lse_err, out_err = _max_abs_err(torch, lse, p_lse), _max_abs_err(torch, out, p_out)
        use = _bf16_flash_use(torch, out, p_out)
        check(lse_err <= 1e-5 and use <= 1 and out_err <= 3e-2,
              f"ring shard {label}: K9-lse lse err {lse_err}, out err {out_err} (limit used {use})")
        errs = {"flash_forward_lse": max(lse_err, out_err)}
        for name in got:
            errs[name] = 0.0
            for a, w in zip(got[name], want[name]):
                u = _grad_use(torch, a, w, torch.bfloat16)
                check(u <= 1, f"ring shard {label}: {name} with D' = D - dlse uses {u:.3g} of "
                              "its limit")
                errs[name] = max(errs[name], _max_abs_err(torch, a, w))
        kernels = {"flash_forward_lse": lambda: A.flash_forward_lse(q, k, v, **kw),
                   "flash_backward_dq": lambda: A.flash_backward_dq(*ops, **kw),
                   "flash_backward_dkv": lambda: A.flash_backward_dkv(*ops, **kw)}
        plains = {"flash_forward_lse": lambda: A.flash_attention_plain(q, k, v, want_lse=True,
                                                                       **kw),
                  "flash_backward_dq": lambda: A.flash_backward_dq_plain(*ops, **kw),
                  "flash_backward_dkv": lambda: A.flash_backward_dkv_plain(*ops, **kw)}
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        sdpa_fwd = time_ms(torch, sdpa, 11, 5)
        sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot),
                           11, 5) - sdpa_fwd
        for name in LM_TRAIN_KERNELS:
            nbytes, n_ops = _flash_work(name, b, s, h, d, q.element_size(), causal)
            least, by = bound_ms(name, nbytes, n_ops, BF16_OPS_PER_S)
            rows[name][label] = {
                "shape": f"[{b}, {s}, {h}, {d}] bfloat16 causal={causal}",
                "ms": time_ms(torch, kernels[name], 11, 5),
                "plain_ms": time_ms(torch, plains[name], 5, 2),
                "bound_ms": least, "bound_by": by,
                "library_ms": sdpa_fwd if name == "flash_forward_lse" else sdpa_bwd,
                "max_abs_err": errs[name],
            }
            print(f"kernel {name} ring shard {label}: {json.dumps(rows[name][label])}",
                  flush=True)
        del q, k, v, do, out, lse, p_out, p_lse, delta, ops, got, want, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return rows


def parallel_phase(torch, A, smi):
    """Phase 19 (see the module docstring). Returns (launches of the
    sequence-parallel run, launches of the composed ring, the ring's
    kernel rows)."""
    import socket

    import torch.distributed as dist

    from zookeeper_tpu_torch.parallel import distributed as D

    dev = torch.device("cuda")
    want_step = {**dict.fromkeys(A.LAUNCHES, 0),
                 **dict.fromkeys(LM_TRAIN_KERNELS, LM_LAYERS * PARALLEL_STEPS)}

    # (a) No launcher: no group, world size 1.
    check(not D.is_distributed_initialized(), "parallel: a group exists before the phase")
    exp0, state0, losses0, launches0 = _parallel_run(torch, A, {})
    check(type(exp0.partitioner).__name__ == "DataParallelPartitioner"
          and exp0.partitioner.mesh is None and not D.is_distributed_initialized(),
          "parallel: the default run formed a group")
    check(launches0 == want_step, f"parallel: the run with no group launched {launches0}")
    check(all(math.isfinite(x) for x in losses0) and losses0[-1] < losses0[0],
          f"parallel: losses {losses0}")

    # A world-size-1 NCCL group on the card, as torch.distributed.run
    # would describe it.
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    launcher = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "RANK": "0",
                "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    with mock.patch.dict(os.environ, launcher):
        D.initialize_distributed(device="cuda")
        backend = dist.get_backend()
        probe = torch.full((4,), 3.0, device=dev)
        dist.all_reduce(probe)
        torch.cuda.synchronize()
        check(backend == "nccl" and dist.get_world_size() == 1 and bool((probe == 3.0).all()),
              f"parallel: group backend {backend}, world {dist.get_world_size()}, all-reduce "
              f"{probe}")
        print(f"parallel: initialize_distributed formed a {backend} group of "
              f"{dist.get_world_size()} rank on {torch.cuda.get_device_name(0)} (one all-reduce "
              "checked)", flush=True)

        # (b) Under the group: DataParallelPartitioner to the bit, then the
        # sequence-parallel flavors at sp=1.
        exp1, state1, losses1, launches1 = _parallel_run(torch, A, {})
        check(exp1.partitioner.mesh is not None,
              "parallel: the DP run built no mesh under the group")
        bad, spread = _state_spread(torch, state1, state0)
        check(not bad and losses1 == losses0 and launches1 == want_step,
              f"parallel: DataParallelPartitioner under the group differs from the run with no "
              f"group in {bad[:4]} (largest {spread}), losses {losses1} vs {losses0}, launches "
              f"{launches1}")
        print(f"parallel: TrainLM {PARALLEL_STEPS} steps under DataParallelPartitioner on the "
              f"{backend} group: all {len(state0)} state tensors and the losses equal the run "
              f"with no group bit for bit; losses {[round(x, 5) for x in losses0]}", flush=True)
        results = {}
        for label, extra in (
            ("ring_flash", {"partitioner": "SequenceParallelPartitioner",
                            "partitioner.sp": 1}),
            ("ulysses_flash", {"partitioner": "SequenceParallelPartitioner",
                               "partitioner.sp": 1, "partitioner.attention": "ulysses"}),
        ):
            exp, state, losses, launches = _parallel_run(torch, A, extra)
            check(launches == want_step,
                  f"parallel: {label} at sp=1 launched {launches}, want {want_step}")
            use = _bf16_run_use(torch, state, state0, losses, losses0)
            bad, spread = _state_spread(torch, state, state0)
            check(use <= 1,
                  f"parallel: {label} at sp=1 uses {use:.3g} of the bf16 step limits")
            results[label] = {"launches": launches, "limit_used": use,
                              "tensors_with_other_bits": len(bad), "largest_diff": spread,
                              "losses": losses}
            print(f"parallel: TrainLM {PARALLEL_STEPS} steps under "
                  f"SequenceParallelPartitioner sp=1 {label}: {json.dumps(results[label])}",
                  flush=True)
            del exp, state
        del exp0, exp1, state0, state1
        D.shutdown_distributed()
        check(not D.is_distributed_initialized(), "parallel: the group outlived the phase")
        torch.cuda.empty_cache()

    # (c) The sp=4 ring composed in one process.
    g = torch.Generator(device=dev).manual_seed(19)
    b, s, h, d = LM_TRAIN_SHAPE
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    do = torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16)
    with deterministic(torch):
        A.reset_launches()
        out = _composed_ring(torch, A, q, k, v)
        grads = torch.autograd.grad(out, (q, k, v), do)
        torch.cuda.synchronize()
        ring_launches = dict(A.LAUNCHES)
        whole = A.flash_attention(q, k, v, causal=True)
        whole_grads = torch.autograd.grad(whole, (q, k, v), do)
        torch.cuda.synchronize()
    want_ring = {**dict.fromkeys(A.LAUNCHES, 0), **dict.fromkeys(LM_TRAIN_KERNELS, 10)}
    check(ring_launches == want_ring,
          f"parallel: the composed ring launched {ring_launches}, want {want_ring}")
    # Ring and whole round P, dS and the outputs to bf16 at different
    # places (each block's output, P from each block's own lse), so each
    # is held to _grad_use's bf16 limits: within 2^-6 |want| + 2^-7
    # max|want| per element and 2^-7 of the norm as a whole. Dropping the
    # lse cotangent or mis-weighting the merge moves dQ/dK or the output
    # by a few percent of their norm.
    pairs = list(zip(("out", "dq", "dk", "dv"), (out.detach(), *grads),
                     (whole.detach(), *whole_grads)))
    uses = {name: _grad_use(torch, a, w, torch.bfloat16) for name, a, w in pairs}
    errs = {name: _max_abs_err(torch, a, w) for name, a, w in pairs}
    check(max(uses.values()) <= 1,
          f"parallel: the composed ring against whole-sequence flash uses {uses} of its limits "
          f"(max abs errors {errs})")
    # The check must see the lse cotangent: the same ring with each
    # block's lse cut from the graph (K10/K11 then run with D' = D) has
    # to fail it.
    real_lse = A.flash_attention_lse

    def lse_cut(*args, **kwargs):
        o_t, lse_t = real_lse(*args, **kwargs)
        return o_t, lse_t.detach()

    with deterministic(torch), mock.patch.object(A, "flash_attention_lse", lse_cut):
        cut = torch.autograd.grad(_composed_ring(torch, A, q, k, v), (q, k, v), do)
        torch.cuda.synchronize()
    cut_uses = {name: _grad_use(torch, a, w, torch.bfloat16)
                for name, a, w in zip(("dq", "dk", "dv"), cut, whole_grads)}
    check(max(cut_uses.values()) > 1,
          f"parallel: a ring without the lse cotangent passes the ring check ({cut_uses})")
    del cut
    with torch.no_grad():
        ring_fwd_ms = time_ms(torch, lambda: _composed_ring(torch, A, q, k, v), 5, 2)
        whole_fwd_ms = time_ms(torch, lambda: A.flash_attention(q, k, v, causal=True), 5, 2)
    ring_ms = time_ms(torch, lambda: torch.autograd.grad(
        _composed_ring(torch, A, q, k, v), (q, k, v), do), 5, 2)
    whole_ms = time_ms(torch, lambda: torch.autograd.grad(
        A.flash_attention(q, k, v, causal=True), (q, k, v), do), 5, 2)
    ring = {"launches": ring_launches, "limit_used": uses, "max_abs_err": errs,
            "limit_used_without_lse_cotangent": cut_uses,
            "forward_ms": ring_fwd_ms, "whole_forward_ms": whole_fwd_ms,
            "forward_backward_ms": ring_ms, "whole_forward_backward_ms": whole_ms}
    print(f"parallel: sp={RING_SP} ring composed from ring_flash_step on {list(RING_SHARD)} "
          f"bf16 causal shards (all {RING_SP} ranks' blocks in one process) against "
          f"flash_attention over {list(LM_TRAIN_SHAPE)} on {smi}: {json.dumps(ring)}",
          flush=True)
    del q, k, v, do, out, grads, whole, whole_grads, pairs
    torch.cuda.empty_cache()

    # (d) The kernels at the ring's shard shape.
    rows = _ring_kernel_rows(torch, A, g)
    return results["ring_flash"]["launches"], ring_launches, rows


#: Phase 20: sharded parameters. Each partitioner at world size 1 on an
#: NCCL group, TrainLM at PARALLEL_CONFIG (3 steps; 8 at unroll 4 for the
#: graph leg) and TrainImageNet (QuickNet-Large, batch 128, int8, packed
#: residuals, SHARD_IMAGENET_STEPS steps: its host-bound eager step's time
#: spreads, so four are timed); then tp=SHARD_TP composed in one process.
SHARD_TP = 4
SHARD_UNROLL_STEPS = 8
SHARD_IMAGENET_STEPS = 5
SHARD_IMAGENET = {**UNROLL_LEGS["TrainImageNet"][0],
                  "loader.dataset.num_train_examples": SHARD_IMAGENET_STEPS * TRAIN_BATCH,
                  "epochs": 1, "steps_per_epoch": SHARD_IMAGENET_STEPS, "validate": False,
                  "seed": 0, "device": "cuda", "verbose": False}
_FSDP = {"partitioner": "FsdpPartitioner", "partitioner.min_weight_size": 1}
_TP_MESH = {"partitioner": "MeshPartitioner", "partitioner.mesh_shape": (1, 1),
            "partitioner.mesh_axes": ("data", "model")}
#: (label, task, config, rules function of ``parallel.rules`` or None,
#: baseline label).
SHARD_RUNS = (
    ("lm fsdp", "TrainLM", _FSDP, None, "lm"),
    ("lm tp", "TrainLM", _TP_MESH, "transformer_tp_rules", "lm"),
    ("lm sp=1 tp=1", "TrainLM", {"partitioner": "SequenceParallelPartitioner",
                                 "partitioner.sp": 1, "partitioner.tp": 1}, None, "lm"),
    ("imagenet fsdp", "TrainImageNet", _FSDP, None, "imagenet"),
    ("imagenet tp", "TrainImageNet", _TP_MESH, "conv_model_tp_rules", "imagenet"),
    ("lm tp unroll", "TrainLM", {**_TP_MESH, "unroll": UNROLL,
                                 "steps_per_epoch": SHARD_UNROLL_STEPS},
     "transformer_tp_rules", "lm unroll"),
)
SHARD_BASELINES = (("lm", "TrainLM", {}), ("imagenet", "TrainImageNet", {}),
                   ("lm unroll", "TrainLM", {"unroll": UNROLL,
                                             "steps_per_epoch": SHARD_UNROLL_STEPS}))


def _shard_run(torch, bc, A, task, extra, rules, sources, tmp, label):
    """One run through run() in deterministic mode, its kernel counts set to
    0 just before it: the flat final state, the per-step losses (the
    metrics file), the launches, the median step ms over the steps after
    the first (eager runs; CUDA events around each step), the run's peak
    memory over what was allocated before it, and what the plan shards."""
    import importlib

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.parallel import rules as R

    module = "lm" if task == "TrainLM" else "imagenet"
    cls = getattr(importlib.import_module(f"zookeeper_tpu_torch.training.{module}"), task)
    conf = PARALLEL_CONFIG if task == "TrainLM" else SHARD_IMAGENET
    path = os.path.join(tmp, label.replace(" ", "_") + ".jsonl")
    exp = cls()
    configure(exp, {**conf, **extra, "log_every": 1, "writer.jsonl.path": path},
              name="experiment")
    if rules is not None:
        exp.partitioner.with_rules(getattr(R, rules)())
    if task != "TrainLM":
        _shared_source(exp, sources)
    events = []
    real_step_fn = cls._train_step_fn

    def step_fn(self):
        step = real_step_fn(self)
        if self.unroll > 1:
            return step

        def timed(st, b):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(st, b)
            end.record()
            events.append((start, end))
            return out

        return timed

    _reset_all(bc, A)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with deterministic(torch), mock.patch.object(cls, "_train_step_fn", step_fn):
        exp.run()
        torch.cuda.synchronize()
    state = exp.final_state
    plan = state.shards
    out = {
        "exp": exp, "state": _flat_state(torch, state),
        "losses": [r["train/loss"] for r in _jsonl(path) if "train/loss" in r],
        "launches": _launch_counts(bc, A),
        "step_ms": (statistics.median(s.elapsed_time(e) for s, e in events[1:])
                    if len(events) > 1 else None),
        "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2.0**30,
        "sharded": 0 if plan is None else len(plan.layouts),
        "gathered": 0 if plan is None else len(plan.gathered),
        "local_layers": sum(1 for m in state.module.modules()
                            for a in ("_tp", "_tp_attn", "_tp_mlp")
                            if getattr(m, a, None) is not None),
    }
    return out


def _composed_mesh(n, rank):
    """Rank ``rank`` of a ``{"model": n}`` mesh with no process group (a
    ``parallel.shards.MeshGroups`` whose groups are None): what builds each
    rank's shards in one process."""
    from zookeeper_tpu_torch.parallel.shards import MeshGroups

    class Composed(MeshGroups):
        def group(self, axes):
            return None

    return Composed({"model": n}, rank)


def _rank_copies(torch, module, rules):
    """SHARD_TP copies of ``module``, each holding one rank's shards through
    the port's own plan (``plan_state`` + ``ShardPlan.apply``): (modules,
    plans)."""
    import copy
    import types

    from zookeeper_tpu_torch.parallel.shards import plan_state

    copies, plans = [], []
    for r in range(SHARD_TP):
        m = copy.deepcopy(module)
        plan = plan_state(m, rules, _composed_mesh(SHARD_TP, r), ("model",), ())
        plan.apply(types.SimpleNamespace(module=m, opt_state={}, ema_params=None))
        copies.append(m)
        plans.append(plan)
    return copies, plans


def _head_kernel_rows(torch, A, g):
    """K9-lse, K10 and K11 on each rank's heads [b, s, h / SHARD_TP, d] of
    LM_TRAIN_SHAPE: equal bit for bit to the same heads of the whole call,
    and each shard's ms beside the whole call's ms / SHARD_TP."""
    dev = torch.device("cuda")
    b, s, h, d = LM_TRAIN_SHAPE
    hs = h // SHARD_TP
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    kw = {"causal": True}

    def calls(q, k, v, do):
        out, lse = A.flash_forward_lse(q, k, v, **kw)
        delta = A.flash_backward_delta(out, do)
        ops = (q, k, v, do, lse, delta)
        return (out, lse), ops

    with deterministic(torch):
        (out, lse), ops = calls(q, k, v, do)
        dq = A.flash_backward_dq(*ops, **kw)
        dk, dv = A.flash_backward_dkv(*ops, **kw)
        torch.cuda.synchronize()
        heads = lambda x, r: x[:, :, r * hs:(r + 1) * hs].contiguous()  # noqa: E731
        rows_of = lambda x, r: x.view(b, h, s)[:, r * hs:(r + 1) * hs].reshape(b * hs, s)  # noqa
        for r in range(SHARD_TP):
            (o_r, l_r), ops_r = calls(*(heads(x, r) for x in (q, k, v, do)))
            dq_r = A.flash_backward_dq(*ops_r, **kw)
            dk_r, dv_r = A.flash_backward_dkv(*ops_r, **kw)
            torch.cuda.synchronize()
            same = {"out": _same_bits(torch, o_r, heads(out, r)),
                    "lse": _same_bits(torch, l_r, rows_of(lse, r)),
                    "dq": _same_bits(torch, dq_r, heads(dq, r)),
                    "dk": _same_bits(torch, dk_r, heads(dk, r)),
                    "dv": _same_bits(torch, dv_r, heads(dv, r))}
            check(all(same.values()), f"sharded: rank {r}'s heads differ from the whole call's: "
                                      f"{same}")
    import torch.nn.functional as F

    shard = [heads(x, 0) for x in (q, k, v, do)]
    (o0, l0), ops0 = calls(*shard)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in shard[:3])
    dot = shard[3].transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    sdpa_fwd = time_ms(torch, sdpa, 11, 5)
    sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot),
                       11, 5) - sdpa_fwd
    rows = {}
    for name, whole_fn, shard_fn, plain_fn in (
        ("flash_forward_lse", lambda: A.flash_forward_lse(q, k, v, **kw),
         lambda: A.flash_forward_lse(*shard[:3], **kw),
         lambda: A.flash_attention_plain(*shard[:3], want_lse=True, **kw)),
        ("flash_backward_dq", lambda: A.flash_backward_dq(*ops, **kw),
         lambda: A.flash_backward_dq(*ops0, **kw),
         lambda: A.flash_backward_dq_plain(*ops0, **kw)),
        ("flash_backward_dkv", lambda: A.flash_backward_dkv(*ops, **kw),
         lambda: A.flash_backward_dkv(*ops0, **kw),
         lambda: A.flash_backward_dkv_plain(*ops0, **kw)),
    ):
        whole_ms = time_ms(torch, whole_fn, 11, 5)
        shard_ms = time_ms(torch, shard_fn, 11, 5)
        nbytes, n_ops = _flash_work(name, b, s, hs, d, 2, True)
        least, by = bound_ms(name, nbytes, n_ops, BF16_OPS_PER_S)
        rows[name] = {"shape": f"[{b}, {s}, {hs}, {d}] bfloat16 causal=True", "ms": shard_ms,
                      "whole_ms_over_tp": whole_ms / SHARD_TP, "whole_ms": whole_ms,
                      "plain_ms": time_ms(torch, plain_fn, 5, 2),
                      "library_ms": sdpa_fwd if name == "flash_forward_lse" else sdpa_bwd,
                      "bound_ms": least, "bound_by": by, "bit_identical_heads": True}
    del q, k, v, do, out, lse, ops, dq, dk, dv, shard, ops0, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return rows


def _composed_block(torch, A, g):
    """One TrainLM block at PARALLEL_CONFIG's width, tp=SHARD_TP composed in
    one process: each rank's shard built from the whole block's weights by
    the port's plan, its attention and MLP forward and backward, the
    row-parallel partial outputs summed in float32 in rank order and the
    column-parallel inputs' gradients summed in float32 (as the model
    group's all-reduces sum them), the replicated norms run once, against
    the whole block. Returns (launches, limits used)."""
    import copy

    from zookeeper_tpu_torch.models import transformer as T
    from zookeeper_tpu_torch.parallel import transformer_tp_rules

    dev = torch.device("cuda")
    b, s, h, d = LM_TRAIN_SHAPE
    width = h * d
    gen = torch.Generator().manual_seed(20)
    module = T.TransformerLMModule(vocab_size=1024, num_layers=1, d_model=width, num_heads=h,
                                   mlp_ratio=4, max_seq_len=s, dtype=torch.bfloat16)
    for sub in module.modules():
        if isinstance(sub, T._Linear):
            sub.reset_parameters(gen)
    module.to(dev)
    ranks, plans = _rank_copies(torch, module, transformer_tp_rules())
    check(all(m.block0._tp_attn is not None and m.block0._tp_mlp is not None for m in ranks),
          "sharded: a composed rank's block has no model group")
    x = torch.randn(b, s, width, generator=g, device=dev).to(torch.bfloat16).requires_grad_(True)
    do = torch.randn(b, s, width, generator=g, device=dev).to(torch.bfloat16)

    class FanOut(torch.autograd.Function):
        """The members' copies of a replicated activation; the backward sums
        their gradients in float32, as the model group's all-reduce does."""

        @staticmethod
        def forward(ctx, t):
            return tuple(t.view_as(t) for _ in range(SHARD_TP))

        @staticmethod
        def backward(ctx, *grads):
            return sum(gr.float() for gr in grads).to(grads[0].dtype)

    def summed(parts):
        return sum(p.float() for p in parts).to(parts[0].dtype)

    # The replicated norms run once (their copies on the ranks are equal);
    # each rank's column-parallel input is its copy of the norm's output.
    rep = module.block0
    feed = []
    names = [n for n, _ in rep.named_parameters()]
    with deterministic(torch), mock.patch.object(T, "copy_to_model", lambda t, tp: feed.pop(0)):
        A.reset_launches()
        feed[:] = FanOut.apply(rep.RMSNorm_0(x))
        x1 = x + summed([m.block0.attention_partial(x) for m in ranks])
        feed[:] = FanOut.apply(rep.RMSNorm_1(x1))
        out = x1 + summed([m.block0.mlp_partial(x1) for m in ranks])
        sharded = [n for n in names if f"block0.{n}" in plans[0].layouts]
        params = [dict(m.block0.named_parameters())[n] for m in ranks for n in sharded]
        norms = [p for n, p in rep.named_parameters() if n not in sharded]
        grads = torch.autograd.grad(out, [x] + params + norms, do)
        torch.cuda.synchronize()
        launches = dict(A.LAUNCHES)
        xw = x.detach().clone().requires_grad_(True)
        whole = copy.deepcopy(module).block0
        wnamed = dict(whole.named_parameters())
        whole_out = whole(xw)
        wgrads = torch.autograd.grad(whole_out, [xw] + [wnamed[n] for n in names], do)
        torch.cuda.synchronize()
    wgrad = dict(zip(names, wgrads[1:]))
    want = {**dict.fromkeys(A.LAUNCHES, 0), **dict.fromkeys(LM_TRAIN_KERNELS, SHARD_TP)}
    check(launches == want, f"sharded: the composed block launched {launches}, want {want}")
    uses = {"out": _grad_use(torch, out.detach(), whole_out.detach(), torch.bfloat16),
            "dx": _grad_use(torch, grads[0], wgrads[0], torch.bfloat16)}
    for r in range(SHARD_TP):
        for i, name in enumerate(sharded):
            want_r = plans[r].shard(f"block0.{name}", wgrad[name])
            uses[f"{name} rank {r}"] = _grad_use(torch, grads[1 + r * len(sharded) + i], want_r,
                                                 torch.bfloat16)
    rest = [n for n in names if n not in sharded]
    for name, got in zip(rest, grads[1 + SHARD_TP * len(sharded):]):
        uses[name] = _grad_use(torch, got, wgrad[name], torch.bfloat16)
    check(max(uses.values()) <= 1, f"sharded: the composed tp={SHARD_TP} block against the whole "
                                   f"block uses {max(uses.values()):.3g} of the bf16 limits: "
                                   f"{uses}")
    del x, do, x1, out, grads, xw, whole, whole_out, wgrads, ranks, module, feed
    torch.cuda.empty_cache()
    return launches, uses


def _composed_conv(torch, bc, g):
    """One QuickNet-Large binary conv (int8, packed residuals, bf16, batch
    128, the 14x14x256 section) at tp=SHARD_TP composed in one process:
    each rank's output-channel shard, built by the port's plan, forward and
    backward (K6-K8 launched): its output channels equal the whole layer's
    bit for bit, its kernel gradient and the input gradient's tp partial
    sums are within the bf16 limits of the whole layer's. Returns
    (launches, record)."""
    from zookeeper_tpu_torch.ops.layers import QuantConv
    from zookeeper_tpu_torch.parallel import conv_model_tp_rules

    dev = torch.device("cuda")
    _, hw, c = SECTIONS[2]
    holder = torch.nn.Module()
    holder.QuantConv_0 = QuantConv(c, c, (3, 3), dtype=torch.bfloat16, binary_compute="int8",
                                   pack_residuals=True)
    holder.QuantConv_0.reset_parameters(torch.Generator().manual_seed(21))
    holder.to(dev)
    ranks, plans = _rank_copies(torch, holder, conv_model_tp_rules())
    for m in ranks:
        check(m.QuantConv_0._tp is not None, "sharded: a composed conv has no model group")
        m.QuantConv_0._tp = None  # computes its shard; the harness gathers
    x = torch.randn(TRAIN_BATCH, hw, hw, c, generator=g, device=dev).to(torch.bfloat16)
    x.requires_grad_(True)
    do = torch.randn(TRAIN_BATCH, hw, hw, c, generator=g, device=dev).to(torch.bfloat16)
    cs = c // SHARD_TP
    whole = holder.QuantConv_0
    with deterministic(torch):
        y = whole(x)
        dx, dk = torch.autograd.grad(y, (x, whole.latent), do)
        torch.cuda.synchronize()
        bc.reset_launches()
        outs, dxs, dks = [], [], []
        for r, m in enumerate(ranks):
            y_r = m.QuantConv_0(x)
            dx_r, dk_r = torch.autograd.grad(y_r, (x, m.QuantConv_0.latent),
                                             do[..., r * cs:(r + 1) * cs])
            outs.append(y_r)
            dxs.append(dx_r)
            dks.append(dk_r)
        torch.cuda.synchronize()
        launches = {k: v for k, v in bc.LAUNCHES.items() if v}
    same_out = [_same_bits(torch, o, y[..., r * cs:(r + 1) * cs]) for r, o in enumerate(outs)]
    want_dk = [plans[r].shard("QuantConv_0.kernel", dk) for r in range(SHARD_TP)]
    want = {name: SHARD_TP * n for name, n in RESID_PER_CONV.items()}
    check(launches == want, f"sharded: the composed conv launched {launches}, want {want}")
    check(all(same_out), f"sharded: the composed conv's output channels differ from the whole "
                         f"layer's: {same_out}")
    dx_sum = sum(p.float() for p in dxs).to(dx.dtype)
    # The kernel gradient is cuDNN's weight gradient of the +-1 input: its
    # algorithm (and so its sum order) follows the output-channel count,
    # so a shard's need not have the whole layer's bits; it is held to the
    # bf16 limits and its bits are counted.
    rec = {"shape": f"x [{TRAIN_BATCH}, {hw}, {hw}, {c}] bf16, {SHARD_TP} shards of {cs} "
                    "channels", "outputs_bit_identical": True,
           "kernel_grads_bit_identical": [_same_bits(torch, a, w) for a, w in zip(dks, want_dk)],
           "kernel_grad_limit_used": max(_grad_use(torch, a, w, torch.bfloat16)
                                         for a, w in zip(dks, want_dk)),
           "kernel_grad_max_abs_err": max(_max_abs_err(torch, a, w)
                                          for a, w in zip(dks, want_dk)),
           "dx_partial_sum_limit_used": _grad_use(torch, dx_sum, dx, torch.bfloat16),
           "dx_partial_sum_max_abs_err": _max_abs_err(torch, dx_sum, dx)}
    check(rec["dx_partial_sum_limit_used"] <= 1 and rec["kernel_grad_limit_used"] <= 1,
          f"sharded: the conv's gradients against the whole layer's: {rec}")
    del x, do, y, dx, dk, outs, dxs, dks, ranks, holder
    torch.cuda.empty_cache()
    return launches, rec


def sharded_phase(torch, bc, A, smi):
    """Phase 20 (see the module docstring). Returns (the sharded TrainLM
    and TrainImageNet runs' launches, the composed launches, the head
    shard kernel rows)."""
    import socket
    import tempfile

    import torch.distributed as dist

    from zookeeper_tpu_torch.parallel import distributed as D

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="zk-sharded-")
    sources = {}
    check(not D.is_distributed_initialized(), "sharded: a group exists before the phase")
    base = {}
    for label, task, extra in SHARD_BASELINES:
        base[label] = _shard_run(torch, bc, A, task, extra, None, sources, tmp, f"base {label}")
        check(base[label]["exp"].partitioner.mesh is None and base[label]["sharded"] == 0,
              f"sharded: the baseline {label} formed a group or sharded")
        losses = base[label]["losses"]
        check(all(math.isfinite(x) for x in losses), f"sharded: baseline {label} losses {losses}")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    launcher = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "RANK": "0",
                "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    results = {}
    with mock.patch.dict(os.environ, launcher):
        D.initialize_distributed(device="cuda")
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "sharded: no world-size-1 NCCL group")
        for label, task, extra, rules, base_label in SHARD_RUNS:
            run = _shard_run(torch, bc, A, task, extra, rules, sources, tmp, label)
            want = base[base_label]
            bad, spread = _state_spread(torch, run["state"], want["state"])
            check(run["exp"].partitioner.mesh is not None, f"sharded: {label} built no mesh")
            check(run["sharded"] > 0 if "sp=1" not in label else run["sharded"] == 0,
                  f"sharded: {label} sharded {run['sharded']} tensors")
            check(not bad and run["losses"] == want["losses"],
                  f"sharded: {label} differs from the run with no group in {bad[:4]} (largest "
                  f"{spread}), losses {run['losses']} vs {want['losses']}")
            check(run["launches"] == want["launches"],
                  f"sharded: {label} launched {run['launches']}, the run with no group "
                  f"{want['launches']}")
            rec = {"tensors": len(want["state"]), "losses": run["losses"],
                   "launches": run["launches"], "sharded_tensors": run["sharded"],
                   "gathered_params": run["gathered"], "tp_layers": run["local_layers"],
                   "step_ms": run["step_ms"], "no_group_step_ms": want["step_ms"],
                   "peak_gib": run["peak_gib"], "no_group_peak_gib": want["peak_gib"]}
            if run["exp"].unroll > 1:
                graphs = list(run["exp"].multi_step.graphs.values())
                check(graphs and all(gr.replays > 0 for gr in graphs),
                      f"sharded: {label} replayed no CUDA graph")
                rec["graphs"] = [{"launches": gr.launches, "replays": gr.replays}
                                 for gr in graphs]
            results[label] = rec
            print(f"sharded: {label} on the world-size-1 {dist.get_backend()} group equals the "
                  f"run with no group bit for bit on {smi}: {json.dumps(rec)}", flush=True)
            del run
        D.shutdown_distributed()
        check(not D.is_distributed_initialized(), "sharded: the group outlived the phase")
    del base
    gc.collect()
    torch.cuda.empty_cache()

    g = torch.Generator(device=torch.device("cuda")).manual_seed(20)
    head_rows = _head_kernel_rows(torch, A, g)
    for name, row in head_rows.items():
        print(f"kernel {name} head shard tp={SHARD_TP} on {smi}: {json.dumps(row)}", flush=True)
    block_launches, block_uses = _composed_block(torch, A, g)
    print(f"sharded: TrainLM block tp={SHARD_TP} composed (head-aligned qkv, row-parallel sums "
          f"in rank order) against the whole block: launches {json.dumps(block_launches)}, "
          f"largest share of the bf16 limits {max(block_uses.values()):.4g}", flush=True)
    conv_launches, conv = _composed_conv(torch, bc, g)
    print(f"sharded: QuickNet-Large binary conv tp={SHARD_TP} composed: launches "
          f"{json.dumps(conv_launches)} {json.dumps(conv)}", flush=True)
    print(f"sharded: phase 20 in {time.perf_counter() - t0:.1f} s", flush=True)
    return results, {**block_launches, **conv_launches}, head_rows


#: Phase 21: serving under partitioners. The LM stream of each run (phase
#: 10's model, a few dozen tokens), the classifier requests, the composed
#: model-axis size.
SERVE_SHARDED_LM = {"requests": 4, "max_prompt": 512, "new_tokens": 8,
                    "engine.seq_buckets": (512,)}
SERVE_SHARDED_CNN = {"engine.batch_buckets": (1, BATCH), "requests": 4, "max_request": BATCH,
                     "seed": 0, "device": "cuda", "verbose": False}
SERVE_TP = 4
#: (label, partitioner config, rules function of ``parallel.rules``).
SERVE_LM_LEGS = (
    ("fsdp", _FSDP, None),
    ("tp", _TP_MESH, "transformer_tp_rules"),
    ("sp=1 tp=1", {"partitioner": "SequenceParallelPartitioner", "partitioner.sp": 1,
                   "partitioner.tp": 1}, None),
)
#: (label, slice of SLICES, partitioner config, rules).
SERVE_CNN_LEGS = (
    ("dp", "A", {"partitioner": "DataParallelPartitioner"}, None),
    ("tp", "A", _TP_MESH, "conv_model_tp_rules"),
    ("tp xnor", "B", _TP_MESH, "conv_model_tp_rules"),
)


def _served_lm(torch, bc, A, overrides, rules=None):
    """LMServingConfig.run() in deterministic mode, the kernel counts set
    to 0 just before it: (tokens, launches, median decode step ms, the
    config)."""
    from zookeeper_tpu_torch.parallel import rules as R

    cfg = _lm_config({**SERVE_SHARDED_LM, **overrides})
    if rules is not None:
        cfg.partitioner.with_rules(getattr(R, rules)())
    _reset_all(bc, A)
    with deterministic(torch):
        cfg.run()
        torch.cuda.synchronize()
    launches = _launch_counts(bc, A)
    step_ms = statistics.median(r[0] for r in cfg.engine._decode_records) * 1e3
    return [o.copy() for o in cfg.outputs], launches, step_ms, cfg


def _served_cnn(torch, bc, A, label, overrides, rules=None):
    """ServingConfig.run() on slice ``label``'s settings in deterministic
    mode, the counts set to 0 just before it: (launches, logits of one
    fixed batch-8 request, the config)."""
    import numpy as np

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.parallel import rules as R
    from zookeeper_tpu_torch.serving import ServingConfig

    cfg = ServingConfig()
    configure(cfg, {**SLICES[label][0], **SERVE_SHARDED_CNN, **overrides})
    if rules is not None:
        cfg.partitioner.with_rules(getattr(R, rules)())
    _reset_all(bc, A)
    with deterministic(torch):
        cfg.run()
        torch.cuda.synchronize()
        launches = _launch_counts(bc, A)
        x = np.random.default_rng(1).normal(size=(BATCH, *cfg.input_shape)).astype(np.float32)
        logits = cfg.engine.infer(x)
        torch.cuda.synchronize()
    check(bool(torch.isfinite(logits).all()), f"served sharded: slice {label} logits")
    return launches, logits, cfg


def _served_step(torch, engine, label, steps: int = 20):
    """A decode step of every slot at 1000 rows, after the run, in the
    default settings: the median wall ms of ``steps`` steps (each ends in
    the readback of its tokens), and one step's profile (device busy ms,
    activities, top items, printed)."""
    import numpy as np

    n = int(engine.slots)
    tokens, lengths = np.ones(n, np.int32), np.full(n, 1000, np.int32)
    engine.decode(tokens, lengths)
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        engine.decode(tokens, lengths)
        walls.append((time.perf_counter() - t0) * 1e3)
    _, busy_ms, acts, top = _profile_step(torch, engine, tokens, lengths)
    rec = {"wall_ms": statistics.median(walls), "busy_ms": busy_ms, "activities": acts}
    print(f"served sharded: {label} decode step: {json.dumps(rec)}; top items: "
          + "; ".join(f"{t:.4f} ms x{c} {k}" for t, c, k in top[:6]), flush=True)
    return rec


def _decode_shard_rows(torch, A, g):
    """K12 and K13 (bf16 and int8 rows) at phase 10's decode geometry: on
    each of SERVE_TP ranks' head shards [8, 1, 8 / SERVE_TP, 64] and on
    each rank's slot-and-head shard of a dp=2 x tp=2 mesh, each equal to
    the whole call's block bit for bit; the busiest rank's ms (the most
    live rows) beside the whole call's ms / SERVE_TP, its bound and its
    library call."""
    import numpy as np

    dev = torch.device("cuda")
    b, cap, h, d, ps = LM_SLOTS, LM_CAP, LM_HEADS, LM_HEAD_DIM, LM_PAGE
    lengths = torch.tensor(LM_CHECK_LENGTHS, dtype=torch.int32, device=dev)
    q = torch.randn(b, 1, h, d, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(b, cap, h, d, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    pages = b * cap // ps
    table = torch.randperm(pages, device=dev, generator=g).view(b, cap // ps).int()
    kp, vp = (torch.randn(pages, ps, h, d, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    k8, v8 = (torch.randint(-127, 128, (pages, ps, h, d), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(pages, ps, h, generator=g, device=dev) * 0.04 + 0.01
              for _ in range(2))
    live = int((np.clip(np.array(LM_CHECK_LENGTHS), 0, cap - 1) + 1).sum())
    mesh = {"data": 2, "model": 2}
    cases = {
        "paged_decode_attention": (
            lambda q_, k_, v_, l_, **kw: A.sharded_paged_decode_attention(q_, k_, v_, l_, **kw),
            (q, k, v, lengths), ("sh", "sh", "sh", "s"), {}),
        "pool_paged_decode_attention": (
            lambda q_, k_, v_, t_, l_, **kw: A.sharded_pool_paged_decode_attention(
                q_, k_, v_, t_, l_, **kw),
            (q, kp, vp, table, lengths), ("sh", "h", "h", "s", "s"), {}),
        "pool_paged_decode_attention int8": (
            lambda q_, k_, v_, t_, l_, ks_, vs_, **kw: A.sharded_pool_paged_decode_attention(
                q_, k_, v_, t_, l_, k_scale=ks_, v_scale=vs_, **kw),
            (q, k8, v8, table, lengths, ks, vs), ("sh", "h", "h", "s", "s", "h", "h"), {}),
    }

    def block(t, how, slot, head, n_slot, n_head):
        # "s": slots on dim 0; "h": heads on dim 2; "sh": both.
        if "s" in how and n_slot > 1:
            n = t.shape[0] // n_slot
            t = t[slot * n:(slot + 1) * n]
        if "h" in how and n_head > 1:
            n = t.shape[2] // n_head
            t = t[:, :, head * n:(head + 1) * n]
        return t.contiguous()

    rows = {}
    for name, (fn, ops, hows, _) in cases.items():
        kernel = name.split()[0]
        whole_kw = {"mesh": mesh, "replicated": True}
        with deterministic(torch):
            whole = fn(*ops, **whole_kw)
            torch.cuda.synchronize()
        rec = {}
        for layout, (n_slot, n_head) in (("head_shard", (1, SERVE_TP)),
                                         ("slot_head_shard", (2, 2))):
            kw = {"mesh": {"model": n_head} if n_slot == 1 else mesh,
                  "data_axes": () if n_slot == 1 else ("data",), "model_axis": "model"}
            shards = []
            with deterministic(torch):
                for r in range(n_slot * n_head):
                    slot, head = divmod(r, n_head)
                    args = [block(t, how, slot, head, n_slot, n_head) for t, how in zip(ops, hows)]
                    out = fn(*args, **kw)
                    torch.cuda.synchronize()
                    want = block(whole, "sh", slot, head, n_slot, n_head)
                    check(_same_bits(torch, out, want),
                          f"served sharded: {name} {layout} rank {r} differs from the whole "
                          f"call's block")
                    shards.append(args)
            # The busiest rank (the most live rows: the slot blocks differ).
            rank_rows = [int((np.clip(a[3 if kernel == "paged_decode_attention" else 4]
                                      .cpu().numpy(), 0, cap - 1) + 1).sum()) for a in shards]
            busiest = int(np.argmax(rank_rows))
            args0 = shards[busiest]
            shard_ms = time_ms(torch, lambda: fn(*args0, **kw))
            whole_ms = time_ms(torch, lambda: fn(*ops, **whole_kw))
            q0 = args0[0]
            live0 = rank_rows[busiest]
            scales = name.endswith("int8")
            nbytes, n_ops = _decode_work(q0, live0, args0[1].element_size(), scales=scales)
            if kernel == "pool_paged_decode_attention":
                nbytes += args0[3].numel() * 4
            least, by = bound_ms(kernel, nbytes, n_ops)
            library = None
            if kernel == "paged_decode_attention":
                library = time_ms(torch, _sdpa_decode(torch, *args0[:4]))
            plain = (A.cached_attention if kernel == "paged_decode_attention"
                     else A.pool_decode_attention)
            plain_kw = {"k_scale": args0[5], "v_scale": args0[6]} if scales else {}
            rec[layout] = {
                "shape": f"q {list(q0.shape)} of [{b}, 1, {h}, {d}] bf16"
                         + (", int8 rows" if scales else ""),
                "ms": shard_ms, "whole_ms_over_tp": whole_ms / SERVE_TP, "whole_ms": whole_ms,
                "plain_ms": time_ms(torch, lambda: plain(*args0[:5 if kernel.startswith("pool")
                                                               else 4], **plain_kw), 5, 2),
                "bound_ms": least, "bound_by": by, "library_ms": library,
                "bit_identical_blocks": True, "rank": busiest, "rank_live_rows": live0,
                "whole_live_rows": live}
        rows[name] = rec
        print(f"kernel {name} served sharded on its blocks: {json.dumps(rec)}", flush=True)
    del q, k, v, kp, vp, k8, v8, ks, vs, table
    torch.cuda.empty_cache()
    return rows


def _channel_block_rows(torch, bc, g):
    """K3 and K4 on each co / SERVE_TP block of every QuickNet-Large binary
    conv shape (SECTIONS at batch 8; 32 convs a forward): each block
    equal to the whole call's channels bit for bit; per forward, rank 0's
    block ms beside the whole call's ms / SERVE_TP, its bound and its
    library call (cuDNN's bf16 conv of the +-1 operands times the scale;
    ``torch._int_mm``)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    keys = ("ms", "whole_ms", "plain_ms", "library_ms", "bytes", "ops")
    totals = {name: dict.fromkeys(keys, 0.0) for name in ("conv_gemm_popcount",
                                                          "packed_weight_matmul")}
    for count, hw, c in SECTIONS:
        n = c // SERVE_TP
        x = _signs(torch, g, BATCH, hw, hw, c).to(torch.bfloat16).to(dev)
        q = _signs(torch, g, 3, 3, c, c) * (torch.rand(c, generator=g) + 0.1)
        packed, scale = (t.to(dev) for t in bc.pack_conv_kernel(q))
        ciw = packed.shape[2]
        xp, ho, wo = bc._spatial_pad(x, 3, 3, (1, 1), "SAME", 1.0)
        xpc = F.pad(xp, (0, ciw * 32 - c), value=1.0)
        xq = bc.pack_rows_plain(xpc.reshape(-1, ciw * 32).contiguous()).reshape(
            *xpc.shape[:3], ciw)
        k_true = 9 * c
        m = BATCH * ho * wo
        a = _signs(torch, g, m, k_true)
        a[torch.rand(m, k_true, generator=g) < 0.05] = 0.0
        a = a.to(torch.int8).to(dev)
        bp = bc.pack_dense_kernel(_signs(torch, g, k_true, c))[0].to(dev)
        kw = bp.shape[0]
        x_nchw = xp.permute(0, 3, 1, 2)
        w_oihw = (q.sign().permute(3, 2, 0, 1).to(torch.bfloat16).to(dev)
                  .contiguous(memory_format=torch.channels_last))
        calls = {
            "conv_gemm_popcount": (
                lambda p, s_: bc.conv_gemm_popcount(xq, p, s_, (1, 1), k_true),
                lambda p, s_: bc.conv_gemm_popcount_plain(xq, p, s_, (1, 1), k_true),
                lambda r: (packed[..., r * n:(r + 1) * n].contiguous(),
                           scale[r * n:(r + 1) * n].contiguous()),
                (packed, scale),
                lambda: F.conv2d(x_nchw, w_oihw[:n], stride=1) * scale[:n, None, None],
                xq.numel() * 4 + ciw * 9 * n * 4 + n * 4 + m * n * 4, 2 * m * n * k_true),
            "packed_weight_matmul": (
                lambda p, _: bc.packed_weight_matmul(a, p),
                lambda p, _: bc.packed_weight_matmul_plain(a, p),
                lambda r: (bp[:, r * n:(r + 1) * n].contiguous(), None), (bp, None),
                _int_mm_yardstick(torch, m, 32 * kw, n, dev, g)[0],
                m * k_true + kw * n * 4 + m * n * 4, 2 * m * n * k_true),
        }
        for name, (fn, plain, part, whole_args, library, nbytes, n_ops) in calls.items():
            with deterministic(torch):
                whole = fn(*whole_args)
                for r in range(SERVE_TP):
                    out = fn(*part(r))
                    torch.cuda.synchronize()
                    check(_same_bits(torch, out, whole[..., r * n:(r + 1) * n]),
                          f"served sharded: {name} block {r} of {c} channels at {hw}x{hw} "
                          "differs from the whole call's channels")
            args0 = part(0)
            t = totals[name]
            t["ms"] += count * time_ms(torch, lambda: fn(*args0))
            t["whole_ms"] += count * time_ms(torch, lambda: fn(*whole_args))
            t["plain_ms"] += count * time_ms(torch, lambda: plain(*args0), 5, 2)
            t["library_ms"] += count * time_ms(torch, library)
            t["bytes"] += count * nbytes
            t["ops"] += count * n_ops
        del x, xp, xpc, xq, a, bp, packed, scale, x_nchw, w_oihw
    rows = {}
    for name, t in totals.items():
        least, by = bound_ms(name, t["bytes"], t["ops"])
        rows[name] = {"per": f"batch-{BATCH} QuickNet-Large forward, rank 0's co/{SERVE_TP} "
                             "block of each of its 32 binary convs",
                      "ms": t["ms"], "whole_ms_over_tp": t["whole_ms"] / SERVE_TP,
                      "whole_ms": t["whole_ms"], "plain_ms": t["plain_ms"],
                      "library_ms": t["library_ms"], "bound_ms": least, "bound_by": by,
                      "bit_identical_blocks": True}
        print(f"kernel {name} on channel blocks tp={SERVE_TP}: {json.dumps(rows[name])}",
              flush=True)
    torch.cuda.empty_cache()
    return rows


def served_sharded_phase(torch, bc, A, smi):
    """Phase 21 (see the module docstring). Returns (each leg's launches
    beside the no-group run's, the decode shard rows, the channel block
    rows)."""
    import shutil
    import socket
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.parallel import distributed as D
    from zookeeper_tpu_torch.parallel import rules as R
    from zookeeper_tpu_torch.training.lm import TrainLM

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="zk-served-")
    check(not D.is_distributed_initialized(), "served sharded: a group exists before the phase")
    base_lm = {}
    for label, layout in LM_RUNS:
        tokens, launches, step_ms, cfg = _served_lm(torch, bc, A, layout)
        base_lm[label] = (tokens, launches, step_ms)
        if label == "slots":
            base_step = _served_step(torch, cfg.engine, "lm no group slots")
        del cfg
    base_cnn = {}
    for slice_label in ("A", "B"):
        launches, logits, cfg = _served_cnn(torch, bc, A, slice_label, {})
        base_cnn[slice_label] = (launches, logits)
        del cfg
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    launcher = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "RANK": "0",
                "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    results = {}
    with mock.patch.dict(os.environ, launcher):
        D.initialize_distributed(device="cuda")
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "served sharded: no world-size-1 NCCL group")
        for part_label, part, rules in SERVE_LM_LEGS:
            for label, layout in LM_RUNS:
                tokens, launches, step_ms, cfg = _served_lm(torch, bc, A, {**layout, **part},
                                                            rules)
                want_tokens, want_launches, want_ms = base_lm[label]
                shard = cfg.engine.decode_shard
                check(shard is not None and not shard.replicated,
                      f"served sharded: lm {part_label} {label} holds no cache block")
                check(all(np.array_equal(a, b) for a, b in zip(tokens, want_tokens)),
                      f"served sharded: lm {part_label} {label} tokens differ from the run "
                      "with no group")
                check(launches == want_launches,
                      f"served sharded: lm {part_label} {label} launched {launches}, the run "
                      f"with no group {want_launches}")
                tp_blocks = sum(b._tp_attn is not None for b in cfg.engine._module.blocks)
                step = (_served_step(torch, cfg.engine, f"lm {part_label} {label}")
                        if label == "slots" else None)
                rec = {"launches": launches, "decode_step_ms": step_ms,
                       "no_group_decode_step_ms": want_ms, "tp_blocks": tp_blocks,
                       **({"step": step, "no_group_step": base_step} if step else {}),
                       "gathered_params": (0 if cfg.engine._plan is None
                                           else len(cfg.engine._plan.gathered)),
                       "kv_bytes": cfg.engine.kv_cache_nbytes}
                results[f"lm {part_label} {label}"] = rec
                print(f"served sharded: lm {part_label} {label} on the world-size-1 "
                      f"{dist.get_backend()} group equals the run with no group bit for bit "
                      f"on {smi}: {json.dumps(rec)}", flush=True)
                del cfg
        for leg_label, slice_label, part, rules in SERVE_CNN_LEGS:
            launches, logits, cfg = _served_cnn(torch, bc, A, slice_label, part, rules)
            want_launches, want_logits = base_cnn[slice_label]
            check(_same_bits(torch, logits, want_logits),
                  f"served sharded: slice {slice_label} {leg_label} logits differ from the "
                  "run with no group")
            check(launches == want_launches,
                  f"served sharded: slice {slice_label} {leg_label} launched {launches}, the "
                  f"run with no group {want_launches}")
            tp_layers = sum(getattr(m, "_tp", None) is not None
                            for m in cfg.engine._module.modules())
            rec = {"launches": launches, "tp_layers": tp_layers}
            results[f"cnn {leg_label}"] = rec
            print(f"served sharded: slice {slice_label} under {leg_label} equals the run with "
                  f"no group bit for bit: {json.dumps(rec)}", flush=True)
            del cfg
        # Train under TP, save, serve the export under TP.
        export = os.path.join(tmp, "lm_export")
        exp = TrainLM()
        configure(exp, {**PARALLEL_CONFIG, **_TP_MESH, "steps_per_epoch": 2,
                        "export_model_to": export}, name="experiment")
        exp.partitioner.with_rules(R.transformer_tp_rules())
        _reset_all(bc, A)
        with deterministic(torch):
            exp.run()
        check(os.path.exists(os.path.join(export, "model.pt")),
              "served sharded: TrainLM under TP wrote no export")
        ckpt_tokens, ckpt_launches, _, cfg = _served_lm(
            torch, bc, A, {**_TP_MESH, "checkpoint": export}, "transformer_tp_rules")
        del exp, cfg
        D.shutdown_distributed()
        check(not D.is_distributed_initialized(), "served sharded: the group outlived the phase")
    plain_tokens, plain_launches, _, cfg = _served_lm(torch, bc, A, {"checkpoint": export})
    check(all(np.array_equal(a, b) for a, b in zip(ckpt_tokens, plain_tokens))
          and ckpt_launches == plain_launches,
          "served sharded: the TP-trained checkpoint served under TP differs from serving it "
          "with no group")
    results["lm tp checkpoint"] = {"launches": ckpt_launches}
    print(f"served sharded: TrainLM 2 steps under TP -> export -> LMServingConfig under TP "
          f"equals serving the export with no group bit for bit ({sum(map(len, plain_tokens))} "
          f"tokens, launches {json.dumps(ckpt_launches)})", flush=True)
    del cfg
    shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device=torch.device("cuda")).manual_seed(21)
    decode_rows = _decode_shard_rows(torch, A, g)
    channel_rows = _channel_block_rows(torch, bc, torch.Generator().manual_seed(21))
    print(f"served sharded: phase 21 in {time.perf_counter() - t0:.1f} s", flush=True)
    results["no_group"] = {label: base_lm[label][1] for label in base_lm}
    results["no_group"].update({f"slice {k}": v[0] for k, v in base_cnn.items()})
    return results, decode_rows, channel_rows


#: Phase 22: phase 10's model on the paged pool, the kernels on.
FEATURE_ENGINE = {"slots": LM_SLOTS, "seq_buckets": (512, 2048), "page_size": LM_PAGE,
                  "decode_attention": "kernel", "kv_layout": "paged"}
#: (a)'s shared prefixes (the second off a page edge: copies forced), the
#: requests sharing each and their new tokens; suffixes of 1-512 tokens,
#: cut to fit the largest bucket (2048).
FEATURE_PREFIXES = (1536, 1537)
FEATURE_REQUESTS = 32
FEATURE_NEW = 8
FEATURE_CHUNK = 512
SPEC_K = 4
#: (c)'s stream through LMServingConfig.run() (phase 10's, shorter).
SPEC_STREAM = {"requests": 16, "max_prompt": 512, "new_tokens": 32,
               "engine.kv_layout": "paged"}
_LM_WIDTH = {"d_model": 512, "num_heads": 8, "mlp_ratio": 4}
#: A fresh 1-layer draft at the teacher's widths, and the teacher's own
#: geometry (the draft read from its export).
DRAFT_FRESH = {"speculative.draft_model.num_layers": 1, "speculative.draft_model.compute_dtype":
               "bfloat16", **{f"speculative.draft_model.{k}": v for k, v in _LM_WIDTH.items()}}
DRAFT_TEACHER = {**DRAFT_FRESH, "speculative.draft_model.num_layers": LM_LAYERS}
SPEC_ON = {"speculative.enabled": True, "speculative.k": SPEC_K}


def _feature_module(torch, dtype, layers=LM_LAYERS, seed=0):
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.models.transformer import TransformerLM

    model = TransformerLM()
    configure(model, {"num_layers": layers, "compute_dtype": dtype, **_LM_WIDTH}, name="model")
    return model.initialize(model.build((LM_CAP,), 1024), seed=seed).cuda()


def _feature_launches(A, label, launches, engine, spec=None):
    """Hold one run's K9/K12/K13 launches to its dispatches (the warm-ups
    included): K9 once a layer a prefill dispatch, K12 (slots) or K13
    (paged) once a layer a decode step, of the teacher and of the draft;
    the window dispatches launch none. Fails when a kernel of the path
    launched no time. Returns the launches."""
    got = {name: launches.get(name, 0) for name in LM_KERNELS}
    want = dict.fromkeys(LM_KERNELS, 0)
    for eng in (engine,) + ((spec.draft_engine,) if spec is not None else ()):
        layers, d = int(eng._module.num_layers), eng.dispatches
        want["flash_forward"] += layers * d.get("prefill", 0)
        kernel = "pool_paged_decode_attention" if eng.paged else "paged_decode_attention"
        want[kernel] += layers * d.get("decode", 0)
    check(got == want, f"features {label}: launched {got}, the dispatches say {want} "
                       f"(teacher {engine.dispatches}"
                       f"{'' if spec is None else f', draft {spec.draft_engine.dispatches}'})")
    check(all(launches.get(n, 0) == 0 for n in LM_TRAIN_KERNELS),
          f"features {label}: serving launched training kernels {launches}")
    check(got["flash_forward"] > 0 and got["paged_decode_attention"] +
          got["pool_paged_decode_attention"] > 0,
          f"features {label}: a kernel of the path launched no time ({got})")
    return got


def _feature_serve(torch, A, module, prompts, budgets, conf=None, draft=None, sched_conf=None):
    """``prompts`` through a DecodeEngine (FEATURE_ENGINE with ``conf``) and
    a synchronous DecodeScheduler, speculative when ``draft`` is a module;
    the counts set to 0 before the bind (the warm-ups count, as in the
    dispatches) and read after the drain. Returns a record."""
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving.decode import (
        DecodeEngine,
        DecodeMetrics,
        DecodeScheduler,
        SpeculativeDecoding,
    )

    A.reset_launches()
    engine = DecodeEngine()
    configure(engine, {**FEATURE_ENGINE, **(conf or {})}, name="engine")
    engine.bind(module, device="cuda")
    engine.warmup()
    spec = None
    if draft is not None:
        spec = SpeculativeDecoding()
        configure(spec, {"enabled": True, "k": SPEC_K}, name="spec")
        spec.bind(engine, draft)
    metrics = DecodeMetrics()
    configure(metrics, {}, name="metrics")
    sched = DecodeScheduler()
    configure(sched, dict(sched_conf or {}), name="sched")
    sched.bind(engine, metrics=metrics, speculative=spec)
    t0 = time.perf_counter()
    streams = [sched.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    sched.drain()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(A.LAUNCHES)
    tokens = [s.result() for s in streams]
    check(all(t.shape == (b,) for t, b in zip(tokens, budgets)),
          "features: a stream ended short of its budget")
    pool = engine.page_pool
    if pool is not None:
        check(pool.leak_check() == 0, f"features: {pool.leak_check()} pages leaked")
    sched.close()
    return {"tokens": tokens, "metrics": metrics, "engine": engine, "spec": spec,
            "launches": launches, "wall_s": wall_s, "streams": streams}


def _equal_share(a, b) -> float:
    import numpy as np

    return sum(int(np.sum(x == y)) for x, y in zip(a, b)) / sum(len(x) for x in a)


def _shared_prefix_prompts(seed, prefixes, per_prefix, suffix_max, cap):
    import numpy as np

    rng = np.random.default_rng(seed)
    prompts = []
    for n in prefixes:
        prefix = rng.integers(1, 1024, size=n).astype(np.int32)
        for _ in range(per_prefix):
            m = int(rng.integers(1, min(suffix_max, cap - n) + 1))
            prompts.append(np.concatenate([prefix, rng.integers(1, 1024, size=m)
                                           .astype(np.int32)]))
    return prompts


def _itl_run(torch, A, module, chunk):
    """(b): 7 streams of 256-token prompts decode; once each has 8 tokens,
    a 2048-token prompt arrives. The scheduler is stepped by hand; each
    step ends in the tokens' readback. Returns the 7 streams' inter-token
    gaps from the arrival on, the long prompt's TTFT, the tokens and the
    launches."""
    import numpy as np

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving.decode import DecodeEngine, DecodeScheduler

    A.reset_launches()
    engine = DecodeEngine()
    configure(engine, {**FEATURE_ENGINE, "prefix_cache": False, "prefill_chunk_tokens": chunk},
              name="engine")
    engine.bind(module, device="cuda")
    engine.warmup()
    sched = DecodeScheduler()
    configure(sched, {}, name="sched")
    sched.bind(engine)
    rng = np.random.default_rng(23)
    short = [rng.integers(1, 1024, size=256).astype(np.int32) for _ in range(LM_SLOTS - 1)]
    long = rng.integers(1, 1024, size=2048).astype(np.int32)
    streams = [sched.submit(p, max_new_tokens=48) for p in short]
    seen, last, gaps, arrival = [0] * len(streams), [0.0] * len(streams), [], None
    while sched._has_work():
        sched._pump()
        now = time.perf_counter()
        for i, s in enumerate(streams):
            n = len(s._tokens)
            if n > seen[i]:
                if arrival is not None:
                    gaps.append((now - last[i]) * 1e3)
                seen[i], last[i] = n, now
        if arrival is None and min(seen) >= 8:
            arrival = sched.submit(long, max_new_tokens=8)
    torch.cuda.synchronize()
    launches = _feature_launches(A, f"itl chunk={chunk}", dict(A.LAUNCHES), engine)
    tokens = [s.result() for s in streams + [arrival]]
    check(engine.page_pool.leak_check() == 0, "features: itl run leaked pages")
    arr = np.asarray(gaps)
    rec = {"itl_p50_ms": float(np.percentile(arr, 50)), "itl_p99_ms": float(np.percentile(arr, 99)),
           "itl_max_ms": float(arr.max()), "gaps": len(gaps), "long_ttft_ms": arrival.ttft_ms,
           "dispatches": engine.dispatches, "launches": launches}
    sched.close()
    return rec, tokens


def features_phase(torch, bc, A, smi):
    """Phase 22 (see the module docstring). Returns {path: K9/K12/K13
    launches}."""
    import shutil
    import socket
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from zookeeper_tpu_torch.models.transformer import greedy_decode
    from zookeeper_tpu_torch.parallel import distributed as D
    from zookeeper_tpu_torch.parallel import rules as R
    from zookeeper_tpu_torch.training.checkpoint import export_trees, save_model

    t0 = time.perf_counter()
    features = {}

    # Phase 10's stream on the paged layout at its defaults.
    cfg = _lm_config({"engine.kv_layout": "paged"})
    A.reset_launches()
    result = cfg.run()
    torch.cuda.synchronize()
    check(cfg.engine.prefix_cache and result["prefix_cache_hit_rate"] >= 0,
          "features: the paged defaults served without the prefix cache")
    features["paged_defaults"] = _feature_launches(A, "paged defaults", dict(A.LAUNCHES),
                                                   cfg.engine)
    check(cfg.engine.page_pool.leak_check() == 0, "features: paged defaults leaked pages")
    print(f"features: phase 10's stream, paged at the defaults (prefix cache on) on {smi}: "
          f"{json.dumps({k: result[k] for k in ('tokens_per_sec', 'ttft_p50_ms', 'ttft_p99_ms', 'itl_p50_ms', 'itl_p99_ms', 'prefix_cache_hit_rate', 'prefills_total', 'decode_steps_total')})}"
          f" dispatches {cfg.engine.dispatches} launches {features['paged_defaults']}", flush=True)
    del cfg
    gc.collect()
    torch.cuda.empty_cache()

    # (a) Shared prefixes, cold and warm.
    module = _feature_module(torch, "bfloat16")
    prompts = _shared_prefix_prompts(22, FEATURE_PREFIXES, FEATURE_REQUESTS, 512, 2048)
    budgets = [FEATURE_NEW] * len(prompts)
    runs = {}
    for label, conf in (("cold", {"prefix_cache": False}), ("warm", {})):
        run = _feature_serve(torch, A, module, prompts, budgets, conf)
        run["launches"] = _feature_launches(A, f"shared prefix {label}", run["launches"],
                                            run["engine"])
        snap, pool, d = run["metrics"].snapshot(), run["engine"].page_pool, run["engine"].dispatches
        rec = {k: snap[k] for k in ("ttft_p50_ms", "ttft_p99_ms", "prefill_p50_ms",
                                    "prefill_p99_ms", "token_p50_ms")}
        rec.update(wall_s=run["wall_s"], hit_rate=pool.prefix_hit_rate, cow_pages=pool.cow_pages,
                   leaked=pool.leak_check(), dispatches=d, launches=run["launches"])
        runs[label] = (run, rec)
        features[f"shared_prefix_{label}"] = run["launches"]
        print(f"features (a) {label} on {smi}: {json.dumps(rec)}", flush=True)
    warm = runs["warm"][0]
    d = warm["engine"].dispatches
    cold_admissions = sum(s.shared_tokens == 0 for s in warm["streams"])
    check(d["prefill"] == len(FEATURE_ENGINE["seq_buckets"]) + cold_admissions
          and d.get("prefill_warm", 0) == len(FEATURE_ENGINE["seq_buckets"]) + len(prompts)
          - cold_admissions
          and 1 <= cold_admissions <= len(FEATURE_PREFIXES),
          f"features (a): K9 must run for the cold groups only ({cold_admissions} cold "
          f"admissions, dispatches {d})")
    check(warm["engine"].page_pool.cow_pages >= FEATURE_REQUESTS - 1,
          "features (a): the 1537-token prefix forced no copy")
    print(f"features (a): warm tokens equal cold in {_equal_share(warm['tokens'], runs['cold'][0]['tokens']):.4f} "
          "of tokens (bf16: the warm suffix runs the plain fp32 window attention, the cold "
          "prefill K9)", flush=True)
    del runs, warm
    gc.collect()
    torch.cuda.empty_cache()

    # (b) A long prompt arriving under decode, chunked and not.
    itl = {}
    for chunk in (0, FEATURE_CHUNK):
        rec, tokens = _itl_run(torch, A, module, chunk)
        itl[chunk] = (rec, tokens)
        features["chunked" if chunk else "unchunked"] = rec["launches"]
        print(f"features (b) prefill_chunk_tokens={chunk} on {smi}: {json.dumps(rec)}", flush=True)
    print(f"features (b): chunked tokens equal unchunked in "
          f"{_equal_share(itl[FEATURE_CHUNK][1], itl[0][1]):.4f} of tokens (bf16)", flush=True)
    del module
    gc.collect()
    torch.cuda.empty_cache()

    # (c) Speculation through LMServingConfig.run(): plain, a fresh 1-layer
    # draft, the teacher's own export.
    tmp = tempfile.mkdtemp(prefix="zk-features-")
    export = os.path.join(tmp, "teacher")
    save_model(export, *export_trees(_feature_module(torch, "bfloat16").cpu()))
    spec_runs = {}
    for label, extra in (("plain", {}), ("fresh draft", {**SPEC_ON, **DRAFT_FRESH}),
                         ("teacher draft", {**SPEC_ON, **DRAFT_TEACHER,
                                            "speculative.draft_checkpoint": export})):
        cfg = _lm_config({**SPEC_STREAM, **extra})
        A.reset_launches()
        result = cfg.run()
        torch.cuda.synchronize()
        spec = cfg.scheduler._speculative
        check(result["speculative"] == bool(extra),
              f"features (c) {label}: speculative is {result['speculative']}")
        launches = _feature_launches(A, f"speculative {label}", dict(A.LAUNCHES), cfg.engine,
                                     spec)
        features[f"speculative_{label.split()[0]}"] = launches
        rec = {k: result.get(k) for k in ("tokens_per_sec", "spec_acceptance_rate",
                                          "spec_draft_tokens_total", "decode_steps_total",
                                          "token_p50_ms", "itl_p50_ms", "ttft_p50_ms")}
        rec.update(teacher_dispatches=cfg.engine.dispatches, launches=launches,
                   draft_dispatches=None if spec is None else spec.draft_engine.dispatches)
        if spec_runs:
            rec["equal_to_plain"] = _equal_share(cfg.outputs, spec_runs["plain"][1])
            rec["tokens_per_sec_over_plain"] = (result["tokens_per_sec"]
                                                / spec_runs["plain"][0]["tokens_per_sec"])
        spec_runs[label] = (rec, [o.copy() for o in cfg.outputs])
        print(f"features (c) {label} on {smi}: {json.dumps(rec)}", flush=True)
        del cfg
        gc.collect()
        torch.cuda.empty_cache()
    check(spec_runs["teacher draft"][0]["spec_acceptance_rate"] > 0.5,
          "features (c): the teacher's own export as the draft accepts under half its drafts")

    # (d) Deterministic fp32 identities at phase 11's model.
    module = _feature_module(torch, "float32")
    fresh = _feature_module(torch, "float32", layers=1, seed=5)
    prompts = _shared_prefix_prompts(24, (300,), 8, 100, 2048)
    rng = np.random.default_rng(25)
    prompts += [rng.integers(1, 1024, size=int(n)).astype(np.int32) for n in (37, 700)]
    budgets = [int(b) for b in rng.integers(1, 13, size=len(prompts))]
    legs = (("warm", {}, None), ("chunked", {"prefix_cache": False, "prefill_chunk_tokens": 128},
                                 None),
            ("speculative teacher", {"prefix_cache": False}, module),
            ("speculative fresh slots", {"kv_layout": "slots"}, fresh))
    with deterministic(torch):
        cold = _feature_serve(torch, A, module, prompts, budgets, {"prefix_cache": False})
        _feature_launches(A, "fp32 cold", cold["launches"], cold["engine"])
        with mock.patch.object(A, "flash_attention", A.attention_reference):
            for i in range(2):
                oracle = greedy_decode(module, torch.from_numpy(prompts[i])[None].cuda(),
                                       budgets[i])[0, len(prompts[i]):].cpu().numpy()
                check(np.array_equal(oracle, cold["tokens"][i]),
                      f"features (d): cold stream {i} differs from greedy_decode")
        for label, conf, draft in legs:
            run = _feature_serve(torch, A, module, prompts, budgets, conf, draft)
            features[f"fp32_{label.replace(' ', '_')}"] = _feature_launches(
                A, f"fp32 {label}", run["launches"], run["engine"], run["spec"])
            bad = [i for i, (a, b) in enumerate(zip(run["tokens"], cold["tokens"]))
                   if not np.array_equal(a, b)]
            check(not bad, f"features (d) fp32: {label} tokens differ from the cold plain "
                           f"run's in streams {bad}")
            extra = ""
            if label == "warm":
                pool = run["engine"].page_pool
                check(run["engine"].dispatches.get("prefill_warm", 0) > 0 and pool.cow_pages > 0,
                      "features (d): the warm run took no warm admission or copy")
                extra = f", hit rate {pool.prefix_hit_rate:.4f}, {pool.cow_pages} copies"
            if run["spec"] is not None:
                extra = f", acceptance {run['spec'].acceptance_rate:.4f}"
            print(f"features (d) fp32: {label} tokens equal the cold plain run's "
                  f"({sum(budgets)} of {sum(budgets)}{extra})", flush=True)
    del module, fresh, cold, run
    gc.collect()
    torch.cuda.empty_cache()

    # (e) On a world-size-1 NCCL group: warm, chunked and speculative at once.
    prompts = _shared_prefix_prompts(26, (600,), 6, 200, 2048)
    conf = {"engine.kv_layout": "paged", "engine.prefill_chunk_tokens": FEATURE_CHUNK,
            **SPEC_ON, **DRAFT_FRESH}

    def grouped(part, rules=None):
        cfg = _lm_config({**conf, **part})
        if rules is not None:
            cfg.partitioner.with_rules(getattr(R, rules)())
        _reset_all(bc, A)
        with deterministic(torch):
            engine, sched = cfg.build_service()
            # The first prompt's pages are cached before the others arrive.
            streams = [sched.submit(prompts[0], max_new_tokens=FEATURE_NEW)]
            sched.drain()
            streams += [sched.submit(p, max_new_tokens=FEATURE_NEW) for p in prompts[1:]]
            sched.drain()
            torch.cuda.synchronize()
        launches = _feature_launches(A, f"grouped {part.get('partitioner', 'none')}",
                                     _launch_counts(bc, A), engine, sched._speculative)
        tokens = [s.result() for s in streams]
        check(engine.page_pool.cow_pages > 0 and engine.dispatches.get("prefill_chunk", 0) > 0
              and sched._speculative is not None,
              "features (e): the run took no copy, no chunk or no speculation")
        sched.close()
        return tokens, launches

    base_tokens, base_launches = grouped({})
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    launcher = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "RANK": "0",
                "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    with mock.patch.dict(os.environ, launcher):
        D.initialize_distributed(device="cuda")
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "features: no world-size-1 NCCL group")
        for label, part, rules in (("fsdp", _FSDP, None),
                                   ("tp", _TP_MESH, "transformer_tp_rules")):
            tokens, launches = grouped(part, rules)
            check(all(np.array_equal(a, b) for a, b in zip(tokens, base_tokens))
                  and launches == base_launches,
                  f"features (e): {label} tokens or launches ({launches}) differ from the run "
                  f"with no group ({base_launches})")
            features[f"world1_{label}"] = launches
            print(f"features (e): warm + chunked + speculative under {label} on the "
                  "world-size-1 NCCL group equal the run with no group bit for bit "
                  f"({sum(map(len, tokens))} tokens, launches {json.dumps(launches)})", flush=True)
        D.shutdown_distributed()
    check(not D.is_distributed_initialized(), "features: the group outlived the phase")
    features["world1_no_group"] = base_launches
    shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"features: phase 22 in {time.perf_counter() - t0:.1f} s", flush=True)
    return features


#: Phase 23 (``group_phase``): TrainLM at the LM training width, 2
#: layers, GROUP_STEPS steps a run at unroll UNROLL (4 and 4 a slab, then
#: CUDA graph replays); a drain started at step 0 exits at 0 + the margin
#: 4 x unroll.
GROUP_SPE = 8
GROUP_EPOCHS = 3
GROUP_STEPS = GROUP_SPE * GROUP_EPOCHS
GROUP_LAYERS = 2
GROUP_TIMEOUT_S = 2.0
#: (c)'s runs: GROUP_COST_EPOCHS epochs each (the first, with the warm-up
#: and the capture, not sampled), in the order GROUP_COST_ORDER.
GROUP_COST_EPOCHS = 9
GROUP_COST_ORDER = ("none", "wired", "wired", "none", "none", "wired")


class _PeerHost:
    """Host 1 of a 2-host group, on a thread: starts a drain at step 0,
    then answers "recoverable" and "ok" to host 0's verdict rounds."""

    def __init__(self, root):
        import threading

        from zookeeper_tpu_torch.resilience import FileCoordinator

        self.coord = FileCoordinator(root, 1, 2, timeout_s=300.0)
        self.verdicts, self.error = [], None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            self.coord.publish_flag("preempt", {"origin": 1, "step": 0, "signal": None})
            for attempt, outcome in enumerate(("recoverable", "ok")):
                self.coord.generation = attempt
                self.verdicts.append(self.coord.exchange(
                    "supervisor_verdict", {"outcome": outcome, "cause": None, "origin": None}))
        except BaseException as e:  # read by the phase
            self.error = e


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def group_phase(torch, A, smi, device="cuda", conf=None):
    """Phase 23, the per-host sharded checkpoint and group recovery on the
    card (module docstring). Returns (launches of the supervised run,
    stats)."""
    import tempfile
    import threading

    import numpy as np

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.resilience import FaultPlan, FileCoordinator, faults, run_with_recovery
    from zookeeper_tpu_torch.training import Checkpointer
    from zookeeper_tpu_torch.training import checkpoint as ck_mod
    from zookeeper_tpu_torch.training.lm import TrainLM

    tag = "group"
    dev = torch.device(device)
    conf = conf or {**LM_TRAIN_CONFIG, "model.num_layers": GROUP_LAYERS}
    per_step = dict.fromkeys(LM_TRAIN_KERNELS, GROUP_LAYERS)
    stats = {}

    def lm(extra=None, seed=0):
        exp = TrainLM()
        configure(exp, {**conf, "loader.dataset.num_train_examples":
                        GROUP_SPE * conf["batch_size"], "steps_per_epoch": GROUP_SPE,
                        "epochs": GROUP_EPOCHS, "unroll": UNROLL, "validate": False,
                        "seed": seed, "device": device, **(extra or {})}, name="experiment")
        return exp

    with tempfile.TemporaryDirectory(prefix="zk_group_") as tmp:
        # (b) the group drain: host 0 under run_with_recovery, host 1 a stub.
        t0 = time.perf_counter()
        A.reset_launches()
        with deterministic(torch):
            oracle = lm()
            oracle.run()
        _sync(torch, dev)
        want = _flat_state(torch, oracle.final_state)
        oracle_launches = {n: A.LAUNCHES[n] for n in LM_TRAIN_KERNELS}
        total = {n: k * GROUP_STEPS for n, k in per_step.items()}
        check(oracle_launches == total,
              f"{tag}: the uninterrupted run launched {oracle_launches}, want {total}")
        exp = lm({"checkpointer.directory": os.path.join(tmp, "drain"),
                  "checkpointer.save_every_epochs": 0})
        coord_root = os.path.join(tmp, "coord")
        coord = FileCoordinator(coord_root, 0, 2, timeout_s=300.0)
        peer = _PeerHost(coord_root)
        A.reset_launches()
        with deterministic(torch):
            result = run_with_recovery(exp, coordinator=coord, max_restarts=1, backoff_s=0.0,
                                       sleep=lambda s: None)
        _sync(torch, dev)
        launches = {n: A.LAUNCHES[n] for n in LM_TRAIN_KERNELS}
        peer.thread.join(60)
        check(peer.error is None and not peer.thread.is_alive(),
              f"{tag}: the peer host failed: {peer.error}")
        causes = [(type(c).__name__, c.step, c.saved) for c in result.causes]
        stop = 4 * UNROLL
        check(result.restarts == 1 and causes == [("Preempted", stop, True)],
              f"{tag}: {result.restarts} restarts, causes {causes}, want one Preempted at {stop}")
        check([[v["outcome"] for v in r] for r in peer.verdicts]
              == [["recoverable", "recoverable"], ["ok", "ok"]]
              and peer.verdicts[0][0]["origin"] == 1,
              f"{tag}: verdicts {peer.verdicts}")
        run_steps = stop + (GROUP_STEPS - stop)
        check(launches == {n: k * run_steps for n, k in per_step.items()},
              f"{tag}: the supervised run launched {launches}, want {per_step} x {run_steps} "
              "steps")
        bad = _same_state(torch, _flat_state(torch, exp.final_state), want)
        check(not bad, f"{tag}: the drained and resumed run differs from the uninterrupted "
                       f"one in {len(bad)} of {len(want)} tensors, e.g. {bad[:4]}")
        stats["drain"] = {"stopped_at": stop, "restarts": result.restarts,
                          "restore_ms": result.restore_ms, "save_wait_ms": result.save_wait_ms,
                          "launches": launches, "tensors": len(want),
                          "seconds": time.perf_counter() - t0}
        print(f"{tag}: a drain started by host 1 at step 0 stops host 0 at step {stop}, saved; "
              f"one restart; the resumed run equals the uninterrupted one bit for bit "
              f"({len(want)} tensors); launches {launches}", flush=True)
        del exp

        # (a) the two-host save of the trained state, its restore, a torn
        # finalize; beside the bare layout's save and restore.
        state = oracle.final_state
        step = state.step
        hosts = []
        for pid in range(2):
            ck = Checkpointer()
            configure(ck, {"directory": os.path.join(tmp, "hosts"), "sharded_per_host": True,
                           "save_every_epochs": 0, "process_index": pid, "process_count": 2,
                           "host_commit_timeout_s": GROUP_TIMEOUT_S}, name="checkpointer")
            hosts.append(ck)
        commit_ms = []
        real_commit = hosts[0]._commit_sharded_step

        def timed_commit(*a):
            t1 = time.perf_counter()
            try:
                return real_commit(*a)
            finally:
                commit_ms.append((time.perf_counter() - t1) * 1e3)

        object.__setattr__(hosts[0], "_commit_sharded_step", timed_commit)
        write_ms = {}
        for pid in (1, 0):
            _sync(torch, dev)
            t1 = time.perf_counter()
            check(hosts[pid].save(state), f"{tag}: host {pid}'s save of step {step} failed")
            write_ms[pid] = (time.perf_counter() - t1) * 1e3
        step_root = os.path.join(tmp, "hosts", f"{step}.zkhost")
        host_bytes = [_dir_bytes(os.path.join(step_root, f"host_{pid:05d}")) for pid in (0, 1)]
        check(os.path.isfile(os.path.join(step_root, "COMMIT.json")),
              f"{tag}: no commit record for step {step}")

        # The split of each host's restore: reading its boxes from the npz
        # files, the agreement's exchange rounds (waiting on the peer
        # included), loading the tree into the state, and the rest.
        split = {}
        where = threading.local()

        def timed(kind, fn):
            def call(*a, **k):
                t1 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    d = split.get(getattr(where, "pid", None))
                    if d is not None:
                        d[kind] += (time.perf_counter() - t1) * 1e3
                        if kind == "exchange_ms":
                            d["rounds"] += 1
            return call

        def group_restore():
            out, ms = {}, {}

            def run(pid):
                fresh = lm(seed=1).build_state(dev)
                where.pid = pid
                split[pid] = dict.fromkeys(("read_ms", "exchange_ms", "load_ms", "rounds"), 0)
                t1 = time.perf_counter()
                hosts[pid].restore_state(fresh)
                _sync(torch, dev)
                ms[pid] = (time.perf_counter() - t1) * 1e3
                d = split[pid]
                d["other_ms"] = ms[pid] - d["read_ms"] - d["exchange_ms"] - d["load_ms"]
                out[pid] = fresh

            with contextlib.ExitStack() as stack:
                for cls, attr, kind in ((ck_mod._HostFiles, "table", "read_ms"),
                                        (ck_mod._HostFiles, "read", "read_ms")):
                    stack.enter_context(mock.patch.object(
                        cls, attr, timed(kind, getattr(cls, attr))))
                stack.enter_context(mock.patch.object(
                    Checkpointer, "_load_tree",
                    staticmethod(timed("load_ms", Checkpointer._load_tree))))
                for ck in hosts:
                    c = ck._coordinator()
                    stack.enter_context(mock.patch.object(
                        c, "exchange", timed("exchange_ms", c.exchange)))
                t = threading.Thread(target=run, args=(1,))
                t.start()
                run(0)
                t.join()
            return out, ms

        restored, restore_ms = group_restore()
        restore_split = {pid: dict(split[pid]) for pid in (0, 1)}
        # The same reads on one thread alone, and bare exchange rounds with
        # both hosts ready at once.
        t1 = time.perf_counter()
        with np.load(os.path.join(step_root, "host_00000", "data.npz")) as npz:
            solo_bytes = sum(npz[key].nbytes for key in npz.files)
        solo_read_ms = (time.perf_counter() - t1) * 1e3
        round_ms = []
        pair = [FileCoordinator(os.path.join(tmp, "rounds"), pid, 2) for pid in (0, 1)]
        for r in range(20):
            t = threading.Thread(target=pair[1].exchange, args=("round", r))
            t1 = time.perf_counter()
            t.start()
            pair[0].exchange("round", r)
            round_ms.append((time.perf_counter() - t1) * 1e3)
            t.join()
        for pid in (0, 1):
            bad = _same_state(torch, _flat_state(torch, restored[pid]), want)
            check(restored[pid].step == step and not bad,
                  f"{tag}: host {pid} restored step {restored[pid].step}, {len(bad)} tensors "
                  f"differ, e.g. {bad[:4]}")
        del restored
        bare = Checkpointer()
        configure(bare, {"directory": os.path.join(tmp, "bare")}, name="checkpointer")
        _sync(torch, dev)
        t1 = time.perf_counter()
        bare.save(state)
        bare_save_ms = (time.perf_counter() - t1) * 1e3
        fresh = lm(seed=1).build_state(dev)
        t1 = time.perf_counter()
        bare.restore_state(fresh)
        _sync(torch, dev)
        bare_restore_ms = (time.perf_counter() - t1) * 1e3
        del fresh
        # A torn finalize: host 1 dies before its rename; host 0 waits out
        # the commit deadline; every host walks back to the committed step.
        state.step = step + 1
        with faults.injected(FaultPlan(fail_host_finalize=1)):
            torn = [hosts[1].save(state), hosts[0].save(state)]
        state.step = step
        check(torn == [False, False] and [ck.latest_step() for ck in hosts] == [step, step],
              f"{tag}: the torn step saved {torn}, latest {[ck.latest_step() for ck in hosts]}")
        walked, _ = group_restore()
        for pid in (0, 1):
            bad = _same_state(torch, _flat_state(torch, walked[pid]), want)
            check(walked[pid].step == step and not bad,
                  f"{tag}: after the torn step host {pid} restored {walked[pid].step}")
        del walked
        stats["two_host"] = {
            "step": step, "host_bytes": host_bytes, "host_write_ms": [write_ms[0], write_ms[1]],
            "commit_ms": commit_ms[0], "restore_ms": [restore_ms[0], restore_ms[1]],
            "bare_bytes": _dir_bytes(os.path.join(tmp, "bare", str(step))),
            "bare_save_ms": bare_save_ms, "bare_restore_ms": bare_restore_ms,
            "torn_commit_wait_ms": commit_ms[-1], "restore_split": restore_split,
            "solo_read_ms": solo_read_ms, "solo_read_bytes": solo_bytes,
            "exchange_round_ms_median": statistics.median(round_ms),
            "exchange_round_ms_max": max(round_ms),
        }
        print(f"{tag}: two hosts saved step {step} ({host_bytes} B), committed, and restored "
              "it bit for bit into fresh states; a torn finalize on host 1 stays invisible and "
              "both walk back to it", flush=True)

        # (c) a wired coordinator's cost: ms a step at unroll 4, epochs 2 on
        # (graph replays), with a 2-host coordinator and no flag, against
        # none; and the boundary's poll_flags alone.
        per_step_ms = {"none": [], "wired": []}
        for label in GROUP_COST_ORDER:
            exp = lm({"epochs": GROUP_COST_EPOCHS})
            if label == "wired":
                idle = os.path.join(tmp, f"idle{len(per_step_ms['wired'])}")
                exp.group_coordinator = FileCoordinator(idle, 0, 2)
            history = exp.run()
            for epoch in history["train"][1:]:
                per_step_ms[label].append(conf["batch_size"] * 1e3 / epoch["examples_per_sec"])
            del exp
        idle = FileCoordinator(os.path.join(tmp, "idle_poll"), 0, 2)
        poll_us = []
        for _ in range(500):
            t1 = time.perf_counter()
            idle.poll_flags("preempt")
            poll_us.append((time.perf_counter() - t1) * 1e6)

        def spread(xs):
            q1, q2, q3 = statistics.quantiles(xs, n=4)
            return {"median": statistics.median(xs), "q1": q1, "q3": q3,
                    "min": min(xs), "max": max(xs), "n": len(xs)}

        none, wired = spread(per_step_ms["none"]), spread(per_step_ms["wired"])
        stats["coordinator_cost"] = {
            "step_ms_none": none, "step_ms_wired": wired,
            "median_diff_ms": wired["median"] - none["median"],
            # The difference is resolved only when it exceeds both
            # interquartile ranges.
            "resolved": abs(wired["median"] - none["median"]) > max(
                none["q3"] - none["q1"], wired["q3"] - wired["q1"]),
            "poll_flags_us_median": statistics.median(poll_us),
            "samples": per_step_ms,
        }
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"{tag} on {smi}: {json.dumps(stats)}", flush=True)
    return launches, stats


#: Phase 24 (``disagg_phase``): DisaggServingConfig at phase 10's model
#: and stream (bf16 and int8 rows on both roles: the prefill role 4 lanes
#: batched (1, 2, 4) wide with the prefix cache, the decode role 8 slots
#: without), beside LMServingConfig's paged engine on the same stream.
DISAGG = {**LM_CONFIG, "engine.kv_layout": "paged", "engine.prefix_cache": False,
          "prefill_engine.seq_buckets": LM_CONFIG["engine.seq_buckets"],
          "prefill_engine.page_size": LM_PAGE, "prefill_engine.decode_attention": "auto"}
DISAGG_ROWS = (("bf16", {}, {}),
               ("int8", {"engine.kv_quant": "int8", "prefill_engine.kv_quant": "int8"},
                {"engine.kv_quant": "int8"}))
#: The handoff timed alone: one 2048-token prompt (128 pages), this many
#: moves a path after one untimed.
DISAGG_MOVES = 20
#: The roles of the fp32 legs (``_disagg_serve``): FEATURE_ENGINE's
#: geometry, 4 prefill lanes, 8 decode slots.
DISAGG_PREFILL = {**FEATURE_ENGINE, "slots": 4, "prefill_buckets": (1, 2, 4)}
DISAGG_DECODE = {**FEATURE_ENGINE, "prefix_cache": False}
#: (c)'s prompts beside phase 22 (d)'s shared-prefix ones, and (d)'s
#: prompt lengths (4 in flight at the swap, 2 after it).
DISAGG_EXTRA = (37, 700)
DISAGG_SWAP_PROMPTS = (100, 300, 500, 40, 200, 7)
#: The packed classifier the watcher swaps (slice A: K1 + K3 32 each a
#: forward), its checkpoint steps' seeds and the stream around the swap.
WATCH_SLICE = "A"
WATCH_REQUESTS = 8


def _disagg_config(overrides):
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving import DisaggServingConfig

    cfg = DisaggServingConfig()
    configure(cfg, {**DISAGG, **overrides})
    return cfg


def _disagg_serve(torch, A, module, prompts, budgets, *, conf=None, draft=None, plan=None,
                  swap=None):
    """``prompts`` through a prefill and a decode DecodeEngine over
    ``module`` (DISAGG_PREFILL/DISAGG_DECODE with ``conf``), a PageTransfer
    and a synchronous DisaggScheduler, the decode role speculative when
    ``draft`` is a module, under the FaultPlan ``plan``; ``swap`` (export
    trees) is requested after two iterations, and the prompts from the
    fifth on are submitted after it. The counts are set to 0 before the
    binds and read after the drain. Returns a record."""
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.resilience import faults
    from zookeeper_tpu_torch.serving import DisaggScheduler, PageTransfer
    from zookeeper_tpu_torch.serving.decode import (
        DecodeEngine,
        DecodeMetrics,
        SpeculativeDecoding,
    )

    A.reset_launches()
    engines = []
    for role, base, warm in (("prefill", DISAGG_PREFILL, {"decode": False}),
                             ("decode", DISAGG_DECODE, {"prefill": False})):
        engine = DecodeEngine()
        configure(engine, {**base, **(conf or {})}, name=f"{role}_engine")
        engine.bind(module, device="cuda")
        engine.warmup(**warm)
        engine.warmup_transfer()
        engines.append(engine)
    pre, dec = engines
    spec = None
    if draft is not None:
        spec = SpeculativeDecoding()
        configure(spec, {"enabled": True, "k": SPEC_K}, name="spec")
        spec.bind(dec, draft)
    metrics = DecodeMetrics()
    configure(metrics, {}, name="metrics")
    transfer = PageTransfer()
    configure(transfer, {}, name="transfer")
    transfer.bind(pre, dec, metrics=metrics)
    sched = DisaggScheduler()
    configure(sched, {}, name="sched")
    sched.bind(pre, dec, transfer, metrics=metrics, speculative=spec)
    with faults.injected(plan) if plan is not None else contextlib.nullcontext():
        if swap is None:
            streams = [sched.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
        else:
            streams = [sched.submit(p, max_new_tokens=b) for p, b in zip(prompts[:4], budgets)]
            sched._pump()
            sched._pump()
            sched.request_swap(*swap, step=2)
            check(sched.swap_pending, "disagg: the swap applied with streams in flight")
            streams += [sched.submit(p, max_new_tokens=b)
                        for p, b in zip(prompts[4:], budgets[4:])]
        sched.drain()
    torch.cuda.synchronize()
    launches = dict(A.LAUNCHES)
    check(pre.page_pool.leak_check() == 0 and dec.page_pool.leak_check() == 0,
          f"disagg: pages leaked (prefill {pre.page_pool.leak_check()}, decode "
          f"{dec.page_pool.leak_check()})")
    out = [(s.tokens_so_far, None if s.error is None else type(s.error).__name__)
           for s in streams]
    rec = {"out": out, "metrics": metrics, "engines": (pre, dec), "spec": spec,
           "launches": launches, "transfer": transfer.status(), "sched": sched}
    sched.close()
    return rec


def _role_launches(A, label, launches, pre, dec, spec=None):
    """Hold a disaggregated run's launches to its roles' dispatches (the
    warm-ups included): K9 once a layer a prefill dispatch, of the prefill
    role (and of the draft, whose cache prefills at the decode admission),
    none of the decode role; K13 once a layer a decode step of the decode
    role, none of the prefill role; K12 once a layer a draft step. Fails
    when a kernel of the path launched no time. Returns the launches."""
    got = {name: launches.get(name, 0) for name in LM_KERNELS}
    check(dec.dispatches.get("prefill", 0) == 0 and pre.dispatches.get("decode", 0) == 0,
          f"disagg {label}: a role ran the other's dispatch (prefill {pre.dispatches}, "
          f"decode {dec.dispatches})")
    want = {"flash_forward": int(pre._module.num_layers) * pre.dispatches.get("prefill", 0),
            "pool_paged_decode_attention": int(dec._module.num_layers)
            * dec.dispatches.get("decode", 0), "paged_decode_attention": 0}
    if spec is not None:
        d, layers = spec.draft_engine.dispatches, int(spec.draft_engine._module.num_layers)
        want["flash_forward"] += layers * d.get("prefill", 0)
        want["paged_decode_attention"] += layers * d.get("decode", 0)
    check(got == want, f"disagg {label}: launched {got}, the roles' dispatches say {want} "
                       f"(prefill {pre.dispatches}, decode {dec.dispatches})")
    check(got["flash_forward"] > 0 and got["pool_paged_decode_attention"] > 0
          and (spec is None or got["paged_decode_attention"] > 0),
          f"disagg {label}: a kernel of the path launched no time ({got})")
    check(all(launches.get(n, 0) == 0 for n in LM_TRAIN_KERNELS),
          f"disagg {label}: serving launched training kernels {launches}")
    return got


def _first_divergence(a, b):
    """(share of equal tokens, the first (stream, position) where two
    streams' tokens differ, or None)."""
    import numpy as np

    first = None
    for i, (x, y) in enumerate(zip(a, b)):
        diff = np.flatnonzero(np.asarray(x) != np.asarray(y))
        if diff.size and (first is None or diff[0] < first[1]):
            first = (i, int(diff[0]))
    return _equal_share(a, b), first


def _save_packed(torch, directory, settings, step, seed):
    """Save a packed classifier initialized from ``seed`` as training step
    ``step`` of a ``Checkpointer`` directory (built on the CPU)."""
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving import ServingConfig
    from zookeeper_tpu_torch.training import Checkpointer
    from zookeeper_tpu_torch.training.optimizer import Sgd
    from zookeeper_tpu_torch.training.state import TrainState

    cfg = ServingConfig()
    configure(cfg, dict(settings), name="serving")
    module = cfg.model.initialize(cfg.model.build(cfg.input_shape, cfg.num_classes), seed=seed)
    opt = Sgd()
    configure(opt, {}, name="optimizer")
    tx = opt.build(total_steps=1)
    ckpt = Checkpointer()
    configure(ckpt, {"directory": directory}, name="ckpt")
    t0 = time.perf_counter()
    ckpt.save(TrainState(step=step, module=module, tx=tx,
                         opt_state=tx.init(dict(module.named_parameters()))), step=step)
    ckpt.wait()
    ckpt.close()
    return (time.perf_counter() - t0) * 1e3


def disagg_phase(torch, bc, A, smi):
    """Phase 24 (see the module docstring). Returns ({path: K9/K12/K13
    launches}, {path: K1/K3 launches}, stats)."""
    import shutil
    import socket
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.models.transformer import greedy_decode
    from zookeeper_tpu_torch.parallel import distributed as D
    from zookeeper_tpu_torch.parallel import rules as R
    from zookeeper_tpu_torch.resilience import FaultPlan, faults
    from zookeeper_tpu_torch.serving import (
        DisaggPartitioner,
        InferenceEngine,
        MicroBatcher,
        PageTransfer,
        ServingConfig,
        WorkerCrashedError,
    )
    from zookeeper_tpu_torch.serving.decode import DecodeEngine, DecodeScheduler
    from zookeeper_tpu_torch.training.checkpoint import export_trees

    t_phase = time.perf_counter()
    launches, stats = {}, {}

    # The roles' devices: one card here.
    part = DisaggPartitioner()
    configure(part, {"device": "cuda"}, name="partitioner")
    cards = torch.cuda.device_count()
    check(part.disjoint == (cards >= 2), f"disagg: {cards} device(s) but {part.describe()}")
    print(f"disagg: {cards} device(s) in this process: roles {json.dumps(part.describe())}; "
          "disjoint roles need two cards, so this run checks the overlapping roles (both on "
          "device 0) and no cross-card copy", flush=True)

    # (a) Phase 10's stream through DisaggServingConfig.run(), bf16 and int8
    # rows, beside LMServingConfig's paged engine on the same stream;
    # (b) the handoff of one 2048-token prompt timed alone.
    for label, extra, single_extra in DISAGG_ROWS:
        single = _lm_config({**PAGED, **single_extra})
        single_result = single.run()
        torch.cuda.synchronize()
        single_out = [o.copy() for o in single.outputs]
        del single
        cfg = _disagg_config(extra)
        A.reset_launches()
        result = cfg.run()
        torch.cuda.synchronize()
        pre, dec = cfg.prefill_engine, cfg.engine
        launches[f"run_{label}"] = _role_launches(A, f"run {label}", dict(A.LAUNCHES), pre, dec)
        requests = int(cfg.requests)
        check(result["transfer_handoffs"] == requests and result["disjoint_roles"] is False,
              f"disagg {label}: {result['transfer_handoffs']} handoffs for {requests} requests")
        check(pre.page_pool.leak_check() == 0 and dec.page_pool.leak_check() == 0,
              f"disagg {label}: pages leaked")
        share, first = _first_divergence(cfg.outputs, single_out)
        keys = ("tokens_per_sec", "ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms", "itl_p99_ms",
                "token_p50_ms", "prefill_p50_ms")
        rec = {"disagg": {k: result.get(k) for k in keys + ("transfer_p50_ms", "transfer_p99_ms",
                                                           "transfer_bytes", "transfer_pages")},
               "single": {k: single_result.get(k) for k in keys},
               "equal_tokens_share": share, "first_divergence": first,
               "prefill_dispatches": pre.dispatches, "decode_dispatches": dec.dispatches,
               "launches": launches[f"run_{label}"]}
        print(f"disagg (a) {label} on {smi}: {json.dumps(rec)}", flush=True)

        # (b) One 2048-token prompt's pages (128 of 16 tokens) moved alone.
        n = int(max(pre.seq_buckets))
        prompt = np.random.default_rng(40).integers(1, 1024, size=n).astype(np.int32)
        for engine in (pre, dec):
            engine._reset_cache()
        check(pre.admit_slot(0, prompt) is not None, "disagg (b): no pages for the prompt")
        pre.prefill([prompt], [0])
        pages = pre.page_pool.pages_for(n)
        src = [int(p) for p in pre.page_pool.table[0, :pages]]
        dst = dec.page_pool.adopt_slot(0, pages)
        idx = {"src": torch.as_tensor(src, device="cuda"),
               "dst": torch.as_tensor(dst, device="cuda")}
        moves = {}
        for bounce in (False, True):
            transfer = PageTransfer()
            configure(transfer, {"host_bounce": bounce}, name="transfer")
            transfer.bind(pre, dec)
            for layer in dec.cache:
                for buf in layer.values():
                    buf.index_fill_(0, idx["dst"], 0)
            transfer.move(src, dst)  # untimed first move
            torch.cuda.synchronize()
            same = all(torch.equal(d[name].index_select(0, idx["dst"]),
                                   s[name].index_select(0, idx["src"]))
                       for s, d in zip(pre.cache, dec.cache) for name in s)
            check(same, f"disagg (b) {label}: the moved pages differ from the source's "
                        f"(host_bounce={bounce})")
            ms = []
            for _ in range(DISAGG_MOVES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                transfer.move(src, dst)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            st = transfer.status()
            nbytes = st["bytes_total"] // st["handoffs_total"]
            p50, p99 = float(np.percentile(ms, 50)), float(np.percentile(ms, 99))
            check(st["host_bounces"] == (st["handoffs_total"] if bounce else 0),
                  f"disagg (b): {st['host_bounces']} bounces counted (host_bounce={bounce})")
            moves["host_bounce" if bounce else "direct"] = {
                "ms_p50": p50, "ms_p99": p99, "ms_min": min(ms), "bytes": nbytes,
                "pages": pages, "gb_per_s_p50": nbytes / (p50 * 1e-3) / 1e9,
                # The export's gather and the import's scatter each read and
                # write the block on the card: 4 x its bytes of HBM traffic.
                "hbm_bound_ms": 4 * nbytes / HBM_BYTES_PER_S * 1e3}
        pre.page_pool.release_slot(0)
        dec.page_pool.release_slot(0)
        stats[label] = {**rec, "moves": moves}
        print(f"disagg (b) {label}: one {n}-token prompt's handoff on {smi}: "
              f"{json.dumps(moves)}", flush=True)
        del cfg, pre, dec
        gc.collect()
        torch.cuda.empty_cache()

    # (c) Deterministic fp32 at phase 11's model: the disaggregated tokens
    # equal the single paged engine's, plain and speculative (a fresh
    # 1-layer draft with the decode role: K12); both fault legs fail their
    # victims only; a swap mid-stream keeps each stream on one version.
    module = _feature_module(torch, "float32")
    module_b = _feature_module(torch, "float32", seed=1)
    fresh = _feature_module(torch, "float32", layers=1, seed=5)
    params_b = export_trees(module_b)
    prompts = _shared_prefix_prompts(24, (300,), 8, 100, int(max(FEATURE_ENGINE["seq_buckets"])))
    rng = np.random.default_rng(25)
    prompts += [rng.integers(1, 1024, size=int(n)).astype(np.int32) for n in DISAGG_EXTRA]
    budgets = [int(b) for b in rng.integers(2, 13, size=len(prompts))]
    with deterministic(torch):
        cold = _feature_serve(torch, A, module, prompts, budgets, {"prefix_cache": False})
        cold_b = _feature_serve(torch, A, module_b, prompts[4:], budgets[4:],
                                {"prefix_cache": False})
        with mock.patch.object(A, "flash_attention", A.attention_reference):
            oracle = greedy_decode(module_b, torch.from_numpy(prompts[4])[None].cuda(),
                                   budgets[4])[0, len(prompts[4]):].cpu().numpy()
        check(np.array_equal(oracle, cold_b["tokens"][0]),
              "disagg (c): the single engine's new-weights stream differs from greedy_decode")
        want = [t.tolist() for t in cold["tokens"]]
        legs = (("plain", {}), ("speculative", {"draft": fresh}),
                ("fail_page_transfer", {"plan": FaultPlan(fail_page_transfer=1)}),
                ("prefill_role_crash_at", {"plan": FaultPlan(prefill_role_crash_at=2)}),
                ("swap", {"swap": params_b}))
        for label, kw in legs:
            run = _disagg_serve(torch, A, module, prompts, budgets, **kw)
            pre, dec = run["engines"]
            launches[f"fp32_{label}"] = _role_launches(A, f"fp32 {label}", run["launches"], pre,
                                                       dec, run["spec"])
            got = [t.tolist() for t, _ in run["out"]]
            errors = [e for _, e in run["out"]]
            if label == "swap":
                check(got[:4] == want[:4] and got[4:] == [t.tolist() for t in cold_b["tokens"]],
                      "disagg (c): a stream of the swap run is not wholly on one weight version")
                check(run["metrics"].totals["weight_swaps_total"] == 1,
                      "disagg (c): the swap was not applied once")
                note = "4 in-flight streams on the old weights, the rest on the new"
            elif "plan" in kw:
                victims = [i for i, e in enumerate(errors) if e is not None]
                expect = ("PageTransferError" if label == "fail_page_transfer"
                          else "WorkerCrashedError")
                check(victims and all(errors[i] == expect for i in victims)
                      and (label != "fail_page_transfer" or len(victims) == 1),
                      f"disagg (c) {label}: victims {victims} with {errors}")
                check(all(got[i] == want[i] for i in range(len(got)) if errors[i] is None),
                      f"disagg (c) {label}: a survivor's tokens differ from the plain run's")
                check(all(got[i] == want[i][:len(got[i])] and len(got[i]) >= 1
                          for i in victims),
                      f"disagg (c) {label}: a victim's partial tokens are not the plain run's")
                note = f"victims {victims} ({expect}), {len(got) - len(victims)} survivors equal"
            else:
                check(got == want and not any(errors),
                      f"disagg (c) fp32 {label}: tokens differ from the single paged engine's")
                note = "tokens equal the single paged engine's"
                if run["spec"] is not None:
                    note += f", acceptance {run['spec'].acceptance_rate:.4f}"
            print(f"disagg (c) fp32 {label}: {note}; handoffs {run['transfer']['handoffs_total']}, "
                  f"launches {json.dumps(launches[f'fp32_{label}'])}", flush=True)
    del module, module_b, fresh, cold, cold_b, run
    gc.collect()

    # (d) A staged swap under FSDP and the (1, 1) TP mesh on a world-size-1
    # group equals the swap with no group, bf16, deterministic.
    params_b = export_trees(_feature_module(torch, "bfloat16", seed=1))
    swap_prompts = [np.random.default_rng(41 + i).integers(1, 1024, size=int(n))
                    .astype(np.int32) for i, n in enumerate(DISAGG_SWAP_PROMPTS)]

    def swapped(part, rules=None):
        cfg = _lm_config({**PAGED, **part})
        if rules is not None:
            cfg.partitioner.with_rules(getattr(R, rules)())
        _reset_all(bc, A)
        with deterministic(torch):
            engine, sched = cfg.build_service()
            streams = [sched.submit(p, max_new_tokens=16) for p in swap_prompts[:4]]
            sched._pump()
            sched._pump()
            sched.request_swap(*params_b)
            streams += [sched.submit(p, max_new_tokens=16) for p in swap_prompts[4:]]
            sched.drain()
            torch.cuda.synchronize()
        got = _launch_counts(bc, A)
        tokens = [s.result() for s in streams]
        check(cfg.metrics.totals["weight_swaps_total"] == 1, "disagg (d): no swap applied")
        sched.close()
        return tokens, got

    base_tokens, base_launches = swapped({})
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    launcher = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "RANK": "0",
                "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    with mock.patch.dict(os.environ, launcher):
        D.initialize_distributed(device="cuda")
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "disagg: no world-size-1 NCCL group")
        for label, part, rules in (("fsdp", _FSDP, None),
                                   ("tp", _TP_MESH, "transformer_tp_rules")):
            tokens, got = swapped(part, rules)
            check(all(np.array_equal(a, b) for a, b in zip(tokens, base_tokens))
                  and got == base_launches,
                  f"disagg (d): the swap under {label} differs from the swap with no group "
                  f"(launches {got} against {base_launches})")
            print(f"disagg (d): a staged swap under {label} on the world-size-1 group equals "
                  f"the swap with no group bit for bit ({sum(map(len, tokens))} tokens, "
                  f"launches {json.dumps(got)})", flush=True)
        D.shutdown_distributed()
    check(not D.is_distributed_initialized(), "disagg: the group outlived the phase")

    # (e) ServingConfig(watch=True) on packed QuickNet-Large: a step that
    # lands while it serves is swapped in; the answers then equal a cold
    # load of that step bit for bit. (f) The worker crashes on the card.
    settings = {**SLICES[WATCH_SLICE][0], "engine.batch_buckets": (1, BATCH),
                "requests": WATCH_REQUESTS, "max_request": BATCH, "weights": "raw",
                "device": "cuda", "verbose": False}
    per_forward = SLICES[WATCH_SLICE][1]
    tmp = tempfile.mkdtemp(prefix="zk-watch-")
    save_ms = [_save_packed(torch, tmp, settings, 1, seed=0)]
    cfg = ServingConfig()
    configure(cfg, {**settings, "checkpoint": tmp, "watch": True, "watch_poll_s": 3600.0},
              name="serving")
    buckets = []
    real_infer = InferenceEngine.infer

    def spy(engine, x):
        buckets.append(engine.bucket_for(len(x)))
        return real_infer(engine, x)

    x = np.random.default_rng(3).normal(size=(BATCH, *cfg.input_shape)).astype(np.float32)
    requests = list(cfg.request_stream())
    bc.reset_launches()
    with mock.patch.object(InferenceEngine, "infer", spy):
        engine, batcher = cfg.build_service()
        warmed = engine.warmed_buckets
        check(cfg.watcher.current_step == 1 and cfg.metrics.totals["weight_swaps"] == 0,
              "disagg (e): the watcher swapped the step the service loaded")
        handles = [batcher.submit(r) for r in requests[: len(requests) // 2]]
        batcher.flush()
        save_ms.append(_save_packed(torch, tmp, settings, 2, seed=1))
        check(cfg.watcher.poll_once() == 2, "disagg (e): the watcher did not swap step 2 in")
        handles += [batcher.submit(r) for r in requests[len(requests) // 2:]]
        batcher.flush()
        torch.cuda.synchronize()
    watch_launches = _launched(bc)
    for name in ("pack_rows", "conv_gemm_popcount"):
        want_n = sum(per_forward(b).get(name, 0) for b in buckets)
        check(watch_launches.get(name, 0) == want_n > 0,
              f"disagg (e): {name} launched {watch_launches.get(name, 0)}, the forwards say "
              f"{want_n}")
    check(all(h.result().shape[0] >= 1 for h in handles), "disagg (e): an answer is missing")
    swap_snapshot = cfg.metrics.snapshot()
    status = cfg.status()
    check(status["watcher_alive"] is True and status["serving_weights_step"] == 2
          and engine.warmed_buckets == warmed,
          f"disagg (e): status {status}, warmed buckets {engine.warmed_buckets} against {warmed}")
    with deterministic(torch):
        live = engine.infer(x)
        cold = ServingConfig()
        configure(cold, {**settings, "checkpoint": tmp}, name="serving")
        cold_engine, cold_batcher = cold.build_service()
        check(torch.equal(live, cold_engine.infer(x)),
              "disagg (e): the swapped answers differ from a cold load of step 2")
        cold_batcher.close()
    del cold, cold_engine

    # (f) serving_worker_crash on an async batcher over the watched engine.
    crash_batcher = MicroBatcher()
    configure(crash_batcher, {"synchronous": False, "max_delay_ms": 1.0}, name="batcher")
    crash_batcher.bind(engine)
    with faults.injected(FaultPlan(serving_worker_crash=1)):
        doomed = crash_batcher.submit(x[:2])
        try:
            doomed.result(timeout=120)
            fail("disagg (f): serving_worker_crash did not crash the worker")
        except WorkerCrashedError:
            pass
    with deterministic(torch):
        check(torch.equal(torch.as_tensor(crash_batcher.submit(x[:3]).result(timeout=120)),
                          engine.infer(x[:3]).cpu()),
              "disagg (f): the restarted batcher's answer differs")
    crash_batcher.close()
    cfg._teardown_service()
    check(not cfg.watcher.alive, "disagg (e): teardown left the watcher running")
    stats["watch"] = {"swap_ms": swap_snapshot.get("weight_swap_ms_mean"),
                      "save_ms": save_ms, "forwards": len(buckets), "launches": watch_launches,
                      "recompiles_after_warmup": engine.warmed_buckets - warmed}
    print(f"disagg (e) watch on {smi}: {json.dumps(stats['watch'])}", flush=True)
    del cfg, engine, batcher
    shutil.rmtree(tmp, ignore_errors=True)

    # decode_worker_crash on an async DecodeScheduler.
    module = _feature_module(torch, "bfloat16")
    decoded = {}
    for mode in ("sync", "async"):
        engine = DecodeEngine()
        configure(engine, dict(FEATURE_ENGINE), name="engine")
        engine.bind(module, device="cuda")
        sched = DecodeScheduler()
        configure(sched, {"synchronous": mode == "sync"}, name="sched")
        sched.bind(engine)
        if mode == "async":
            with faults.injected(FaultPlan(decode_worker_crash=1)):
                doomed = sched.submit(swap_prompts[0], max_new_tokens=8)
                try:
                    doomed.result(timeout=120)
                    fail("disagg (f): decode_worker_crash did not crash the loop")
                except WorkerCrashedError:
                    pass
        with deterministic(torch):
            decoded[mode] = sched.submit(swap_prompts[1], max_new_tokens=8).result(timeout=120)
        sched.close()
    check(np.array_equal(decoded["sync"], decoded["async"]),
          "disagg (f): the restarted decode loop's tokens differ")
    print("disagg (f): serving_worker_crash and decode_worker_crash failed their requests and "
          "the next submit served on a restarted worker", flush=True)
    del module, engine
    gc.collect()
    torch.cuda.empty_cache()
    print(f"disagg: phase 24 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, {"watch": watch_launches}, stats


#: Phase 25 (c): the LM service's runs with observability off and on, in
#: turns, in default (not deterministic) settings.
OBS_ORDER = ("off", "on", "on", "off", "off", "on")
#: Streams in flight when (d)'s injected crash fires.
OBS_CRASH_STREAMS = 10
#: Series every scrape of the LM service must carry (the JAX package's
#: scrape smoke's, less the overload guard's).
OBS_REQUIRED = (
    "zk_decode_tokens_total", "zk_decode_ttft_ms_bucket", "zk_decode_token_ms_bucket",
    "zk_decode_slot_occupancy", "zk_decode_kv_pages_in_use", "zk_decode_queue_depth",
    "zk_decode_kv_bytes", "zk_decode_mbu", "zk_decode_itl_ms_bucket",
    "zk_spec_draft_tokens_total", "zk_spec_accepted_tokens_total", "zk_spec_acceptance_rate",
    "zk_spec_accept_length_bucket", "zk_kv_pool_free_pages", "zk_prefix_cache_hit_rate",
    "zk_prefill_chunks_total", "zk_prefill_stall_ms_bucket", "zk_transfer_bytes",
    "zk_hbm_bytes_in_use", "zk_hbm_peak_bytes_in_use", "zk_hbm_bytes_limit",
    "zk_serving_recompiles_total", "zk_compiles_total",
)


def _http_get(port, path):
    """GET ``http://127.0.0.1:<port><path>`` as text."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode()


def _exposition(body):
    """{series: value} of a Prometheus exposition, and its invalid lines."""
    import re

    line_re = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [^ ]+$")
    samples = [ln for ln in body.splitlines() if ln and not ln.startswith("#")]
    bad = [ln for ln in samples if not line_re.match(ln)]
    return {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1]) for ln in samples
            if line_re.match(ln)}, bad


def obs_phase(torch, bc, A, smi):
    """Phase 25 (see the module docstring). Returns ({path: K9/K13
    launches}, {path: K1/K3 launches}, stats)."""
    import shutil
    import tempfile
    import threading

    import numpy as np

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.observability import trace
    from zookeeper_tpu_torch.observability.ledger import default_ledger
    from zookeeper_tpu_torch.observability.registry import default_registry
    from zookeeper_tpu_torch.resilience import FaultPlan, faults
    from zookeeper_tpu_torch.serving import InferenceEngine, ServingConfig, WorkerCrashedError

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="obs_phase_")
    launches_lm, launches_cnn, stats = {}, {}, {}
    get, parse = _http_get, _exposition

    def recompiles():
        return sum(i.value for i in default_registry().collect()
                   if i.name == "zk_serving_recompiles_total")

    # The process-wide recompile counter starts this phase at 0.
    for inst in default_registry().collect():
        if inst.name == "zk_serving_recompiles_total":
            inst.reset()

    # (a) Phase 10's LM (paged) through LMServingConfig with everything off,
    # and with the endpoint, the recorder and tracing on.
    services = {}
    for label, extra in (("off", {}), ("on", {"metrics_port": 0,
                                              "flight_recorder_dir": os.path.join(tmp, "lm")})):
        if label == "on":
            default_ledger().clear()  # /statusz then lists this service's programs
        cfg = _lm_config({**PAGED, **extra})
        A.reset_launches()
        t0 = time.perf_counter()
        cfg.build_service()
        torch.cuda.synchronize()
        launches_lm[f"build_{label}"] = dict(A.LAUNCHES)
        services[label] = cfg
        stats[f"build_{label}_s"] = time.perf_counter() - t0
    check(launches_lm["build_off"] == launches_lm["build_on"],
          f"obs: warm-ups launched differently: {launches_lm['build_off']} (off) "
          f"{launches_lm['build_on']} (on)")
    on, off = services["on"], services["off"]
    port = on.obs_server.port
    prompts = off.prompts(min(off.max_prompt, off.engine.max_prompt))

    def serve(label, scrapes=None):
        cfg = services[label]
        trace.install(trace.Tracer() if label == "on" else None)
        cfg.metrics.reset()
        A.reset_launches()
        t0 = time.perf_counter()
        streams = [cfg.scheduler.submit(pr, max_new_tokens=cfg.new_tokens) for pr in prompts]
        cfg.scheduler.drain()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        outs = [st.result() for st in streams]
        snap = cfg.metrics.snapshot()
        tokens = sum(int(o.shape[0]) for o in outs)
        return outs, {"tokens_per_sec": tokens / dt, "itl_p50_ms": snap["itl_p50_ms"],
                      "itl_p99_ms": snap["itl_p99_ms"], "ttft_p50_ms": snap["ttft_p50_ms"],
                      "launches": dict(A.LAUNCHES)}

    # Scrapes over HTTP while the first "on" run serves: a thread GETs
    # /metrics and /statusz until the drain ends.
    scraped, errors, done = [], [], threading.Event()

    def scraper():
        while not done.is_set():
            try:
                scraped.append((get(port, "/metrics"), json.loads(get(port, "/statusz"))))
            except Exception as e:  # reported by the main thread
                errors.append(repr(e))
            done.wait(0.05)

    # (a)'s pair is held to bit equality, in deterministic mode.
    outputs = {}
    for label in ("off", "on"):
        thread = None
        if label == "on":
            thread = threading.Thread(target=scraper, name="obs-scraper", daemon=True)
            thread.start()
        with deterministic(torch):
            outputs[label], rec = serve(label)
        launches_lm[f"serve_{label}"] = rec["launches"]
        if thread is not None:
            done.set()
            thread.join(timeout=30)
            check(not thread.is_alive(), "obs: the scraper thread did not stop")
        if label == "on":
            check(not errors, f"obs: scrapes during the run failed: {errors[:3]}")
            check(len(scraped) >= 1, "obs: no scrape landed while the stream was served")
            for body, status in scraped:
                _, bad = parse(body)
                check(not bad, f"obs: invalid exposition lines mid-run: {bad[:5]}")
                check("decode" in status and "requests" in status and "programs" in status,
                      f"obs: /statusz sections mid-run: {sorted(status)}")
            on.obs_probe.poll_once()
            body = get(port, "/metrics")
            values, bad = parse(body)
            check(not bad, f"obs: invalid exposition lines: {bad[:5]}")
            missing = [n for n in OBS_REQUIRED if n not in body]
            missing += [inst.name for inst in on.metrics.registry.collect()
                        if inst.name not in body]
            check(not missing, f"obs: series missing from /metrics: {missing}")
            status = json.loads(get(port, "/statusz"))
            mbu = values["zk_decode_mbu"]
            in_use = values['zk_hbm_bytes_in_use{device="0"}']
            limit = values['zk_hbm_bytes_limit{device="0"}']
            total = torch.cuda.mem_get_info()[1]
            programs = {row["key"] for row in status["programs"]["programs"]}
            warmed = {rec.key for rec in on.engine.programs.values()}
            stats["a"] = {
                "scrapes_mid_run": len(scraped), "series": len(values), "zk_decode_mbu": mbu,
                "zk_hbm_bytes_in_use": in_use, "zk_hbm_bytes_limit": limit,
                "zk_hbm_peak_bytes_in_use": values['zk_hbm_peak_bytes_in_use{device="0"}'],
                "zk_serving_recompiles_total": values["zk_serving_recompiles_total"],
                "programs": sorted(programs),
                "program_rows": {rec.key: {"compile_ms": rec.compile_ms, "flops": rec.flops,
                                           "bytes": rec.bytes_accessed,
                                           "dispatches": rec.dispatches}
                                 for rec in on.engine.programs.values()},
                "requests_by_outcome": status["requests"]["by_outcome"],
            }
            check(0 < mbu <= 1.05, f"obs: zk_decode_mbu {mbu} outside (0, 1.05]")
            check(0 < in_use <= limit and limit == total,
                  f"obs: zk_hbm_bytes_in_use {in_use}, limit {limit}, card total {total}")
            check(programs == warmed and status["programs"]["count"] == len(warmed),
                  f"obs: /statusz programs {sorted(programs)} against the warmed {sorted(warmed)}")
            check(values["zk_serving_recompiles_total"] == 0
                  and status["decode"]["recompiles_detected"] == 0,
                  f"obs: recompiles after warm-up: {values['zk_serving_recompiles_total']}")
            check(status["requests"]["by_outcome"] == {"ok": len(prompts)},
                  f"obs: RequestLog outcomes {status['requests']['by_outcome']}")
    trace.install(None)
    for label in ("off", "on"):
        check(len(outputs[label]) == len(prompts), f"obs: {label} run lost streams")
    check(all(np.array_equal(a, b) for a, b in zip(outputs["off"], outputs["on"])),
          "obs: tokens differ with observability on")
    for name in ("flash_forward", "pool_paged_decode_attention"):
        check(launches_lm["serve_off"][name] == launches_lm["serve_on"][name] > 0,
              f"obs: {name} launched {launches_lm['serve_off'][name]} (off) and "
              f"{launches_lm['serve_on'][name]} (on) times")
    print(f"obs (a) on {smi}: tokens equal off/on, launches {launches_lm}; "
          f"{json.dumps(stats['a'])}", flush=True)

    # (c) tokens/s and inter-token p50/p99, three runs each, in turns.
    runs = []
    for i, label in enumerate(OBS_ORDER):
        outs, rec = serve(label)
        rec["tokens_equal_a"] = all(np.array_equal(a, b) for a, b in zip(outs, outputs[label]))
        runs.append({"run": i + 1, "obs": label, **rec})
    trace.install(None)
    by = {label: [r for r in runs if r["obs"] == label] for label in ("off", "on")}
    stats["c"] = {label: {key: [r[key] for r in rs] for key in
                          ("tokens_per_sec", "itl_p50_ms", "itl_p99_ms", "ttft_p50_ms")}
                  for label, rs in by.items()}
    stats["c"]["order"] = list(OBS_ORDER)
    stats["c"]["tokens_equal_a"] = [r["tokens_equal_a"] for r in runs]
    print(f"obs (c) overhead on {smi}: {json.dumps(stats['c'])}", flush=True)

    # (d) An injected loop crash with the recorder armed: one bundle, the
    # victims' rids crashed in its RequestLog tail and present in its trace.
    trace.install(trace.Tracer())
    sched = on.scheduler
    streams = [sched.submit(pr, max_new_tokens=on.new_tokens)
               for pr in prompts[:OBS_CRASH_STREAMS]]
    for _ in range(3):
        sched._pump()  # admit and decode a few steps first
    with faults.injected(FaultPlan(decode_worker_crash=1)):
        try:
            sched.drain()
            fail("obs (d): the injected decode crash did not fire")
        except WorkerCrashedError:
            pass
    victims = {st.rid for st in streams if isinstance(st.error, WorkerCrashedError)}
    bundles = on.flight_recorder.bundles()
    check(len(victims) == OBS_CRASH_STREAMS, f"obs (d): {len(victims)} victims")
    check(len(bundles) == 1 and bundles[0].endswith("decode_worker_crash"),
          f"obs (d): bundles {bundles}")
    with open(os.path.join(bundles[0], "requestlog.json")) as f:
        tail = json.load(f)["decode"]["tail"]
    with open(os.path.join(bundles[0], "trace.json")) as f:
        traced = {ev.get("args", {}).get("rid") for ev in json.load(f)["traceEvents"]}
    crashed = {r["rid"] for r in tail if r["outcome"] == "crashed"}
    with open(os.path.join(bundles[0], "manifest.json")) as f:
        manifest = json.load(f)
    stats["d"] = {"victims": len(victims), "bundle": os.path.basename(bundles[0]),
                  "files": manifest["files"], "write_ms": manifest["write_ms"]}
    check(victims == crashed, f"obs (d): crashed rids {sorted(crashed)} against the "
          f"victims {sorted(victims)}")
    check(victims <= traced, f"obs (d): victims missing from the bundle's trace: "
          f"{sorted(victims - traced)}")
    trace.install(None)
    print(f"obs (d): {json.dumps(stats['d'])}", flush=True)
    for cfg in services.values():
        cfg._teardown_service()
    check(on.obs_server is None and on.obs_probe is None and on.flight_recorder is None,
          "obs: the LM service's endpoint, probe or recorder outlived its teardown")
    del services, on, off, sched, streams
    gc.collect()
    torch.cuda.empty_cache()

    # (b) Slice A through ServingConfig with observability off and on; (e)
    # one forward at an unwarmed bucket after a partial warm-up.
    settings, per_forward = SLICES["A"]
    base = {"engine.batch_buckets": (1, BATCH), "requests": 16, "max_request": BATCH,
            "seed": 0, "device": "cuda", "verbose": False, **settings}
    answers = {}
    for label, extra in (("off", {}), ("on", {"metrics_port": 0, "flight_recorder_interval_s": 0.0,
                                              "flight_recorder_dir": os.path.join(tmp, "cnn")})):
        cfg = ServingConfig()
        configure(cfg, {**base, **extra})
        bc.reset_launches()
        engine, batcher = cfg.build_service()
        with deterministic(torch):
            handles = [batcher.submit(x) for x in cfg.request_stream()]
            batcher.flush()
            answers[label] = [h.result() for h in handles]
        torch.cuda.synchronize()
        launches_cnn[label] = dict(bc.LAUNCHES)
        if label == "on":
            cport = cfg.obs_server.port
            values, bad = parse(get(cport, "/metrics"))
            status = json.loads(get(cport, "/statusz"))
            mfu, mfu8 = values["zk_serve_mfu"], values["zk_serve_mfu_int8"]
            stats["b"] = {"zk_serve_mfu": mfu, "zk_serve_mfu_int8": mfu8,
                          "zk_serve_dispatch_ms": values["zk_serve_dispatch_ms"],
                          "zk_serve_dispatch_rows": values["zk_serve_dispatch_rows"],
                          "programs": {rec.key: {"compile_ms": rec.compile_ms,
                                                 "flops": rec.flops,
                                                 "bytes": rec.bytes_accessed}
                                       for rec in engine.programs.values()}}
            check(not bad, f"obs (b): invalid exposition lines {bad[:5]}")
            check(0 < mfu8 <= 1.05 and 0 < mfu <= 1.05,
                  f"obs (b): zk_serve_mfu {mfu}, zk_serve_mfu_int8 {mfu8}")
            check(status["serving"]["packed_deployment"] and
                  status["requests"]["by_outcome"] == {"ok": int(cfg.requests)},
                  f"obs (b): /statusz {status['serving']}, {status['requests']['by_outcome']}")
            # (e) A second engine over the same module, warmed; bucket 8 is
            # then dropped from its cache of run programs (a private seam,
            # as the JAX test reaches a bucket the warm-up never covered),
            # so its next batch-8 forward is the detected stall.
            eng = InferenceEngine()
            configure(eng, {"batch_buckets": (1, BATCH)}, name="engine")
            eng.bind(engine._module, cfg.input_shape, dtype=cfg.model.dtype(), device="cuda")
            eng.warmup()
            eng._warmed.discard((BATCH, eng._mesh_key))
            x = np.random.default_rng(25).normal(size=(BATCH, *cfg.input_shape))
            eng.infer(x.astype(np.float32))
            torch.cuda.synchronize()
            rec_bundles = [b for b in cfg.flight_recorder.bundles()
                           if b.endswith("recompile_detected")]
            values, _ = parse(get(cport, "/metrics"))
            stats["e"] = {"recompiles_detected": eng.recompiles_detected,
                          "first_run_ms": {rec.key: rec.compile_ms
                                           for rec in eng.programs.values()},
                          "zk_serving_recompiles_total": values["zk_serving_recompiles_total"],
                          "bundles": [os.path.basename(b) for b in rec_bundles]}
            check(eng.recompiles_detected == 1 and recompiles() == 1
                  and values["zk_serving_recompiles_total"] == 1,
                  f"obs (e): recompiles {stats['e']}")
            check(len(rec_bundles) == 1, f"obs (e): recompile bundles {rec_bundles}")
            del eng
        cfg._teardown_service()
        del cfg, engine, batcher
        torch.cuda.empty_cache()
    for name in bc.LAUNCHES:
        check(launches_cnn["off"][name] == launches_cnn["on"][name],
              f"obs (b): {name} launched {launches_cnn['off'][name]} (off) and "
              f"{launches_cnn['on'][name]} (on) times")
    check(launches_cnn["on"]["pack_rows"] > 0 and launches_cnn["on"]["conv_gemm_popcount"] > 0,
          f"obs (b): slice A launched {launches_cnn['on']}")
    check(len(answers["off"]) == len(answers["on"]) and all(
        np.array_equal(a, b) for a, b in zip(answers["off"], answers["on"])),
          "obs (b): slice A's answers differ with observability on")
    print(f"obs (b) on {smi}: answers equal off/on, launches {launches_cnn}; "
          f"{json.dumps(stats['b'])}", flush=True)
    print(f"obs (e): {json.dumps(stats['e'])}", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    stats["phase_s"] = time.perf_counter() - t_phase
    print(f"obs phase: {stats['phase_s']:.1f} s", flush=True)
    return launches_lm, launches_cnn, stats


#: Phase 26: the training half of observability. (a) TrainLM at full
#: width (LM_TRAIN_CONFIG: 4 layers, 8 steps) with async saves every 4
#: steps; (c) its step time, off and on in turns; (b) the fused
#: QuickNet-Large leg; (d) a NaN halt under run_with_recovery.
OBS_TRAIN_ORDER = ("off", "on", "on", "off", "off", "on")
OBS_TRAIN_LM = {**LM_TRAIN_CONFIG, "validate": False, "checkpointer.mode": "async",
                "checkpointer.save_every_steps": 4}
#: (b): phase 18's QuickNet-Large leg at unroll 4, 12 steps (a warm-up
#: slab, the 4-step graph captured, one replay).
OBS_TRAIN_CNN_STEPS = 12
#: (d): a 2-layer TrainLM, NaN at step counter 3, saves every 2 steps.
OBS_TRAIN_NAN = {**LM_TRAIN_CONFIG, "model.num_layers": 2, "validate": False,
                 "nan_policy": "halt", "log_every": 1, "checkpointer.save_every_steps": 2}
OBS_TRAIN_NAN_AT = 3
#: Series every scrape of a training run must carry at its end.
OBS_TRAIN_REQUIRED = (
    "zk_train_step_time_ms", "zk_train_mfu", "zk_prefetch_occupancy", "zk_train_steps_total",
    "zk_ckpt_queue_depth", "zk_hbm_bytes_in_use", "zk_hbm_peak_bytes_in_use",
    "zk_hbm_bytes_limit", "zk_compiles_total",
)


def obs_train_phase(torch, bc, A, smi):
    """Phase 26 (see the module docstring). Returns ({leg: launches},
    stats)."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.observability import recorder, trace
    from zookeeper_tpu_torch.observability.ledger import default_ledger
    from zookeeper_tpu_torch.resilience import FaultPlan, faults, run_with_recovery
    from zookeeper_tpu_torch.training.imagenet import TrainImageNet
    from zookeeper_tpu_torch.training.lm import TrainLM

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="obs_train_phase_")
    launches, stats = {}, {}
    counter = itertools.count()
    get, parse = _http_get, _exposition

    def make(cls, conf, on, extra=None):
        """An experiment over a fresh checkpoint directory; ``on`` adds the
        trace export, the endpoint, the flight recorder and log_every=1."""
        run = os.path.join(tmp, f"run{next(counter)}")
        os.makedirs(run)
        obs = ({"trace_export": os.path.join(run, "trace.json"), "metrics_port": 0,
                "flight_recorder_dir": os.path.join(run, "bundles"), "log_every": 1}
               if on else {})
        exp = cls()
        configure(exp, {**conf, "checkpointer.directory": os.path.join(run, "ckpt"), **obs,
                        **(extra or {})}, name="experiment")
        return exp, run

    def scraping(exp, scrapes):
        """Scrape /metrics and /statusz over HTTP at each save."""
        real = exp.checkpointer.save

        def save(*a, **k):
            server = getattr(exp, "obs_server", None)
            if server is not None:
                scrapes.append((get(server.port, "/metrics"),
                                json.loads(get(server.port, "/statusz"))))
            return real(*a, **k)

        object.__setattr__(exp.checkpointer, "save", save)

    # (a) TrainLM at full width, everything off, then on; the pair in
    # deterministic mode, held to bit equality.
    finals, scrapes, runs = {}, [], {}
    for label in ("off", "on"):
        exp, run = make(TrainLM, OBS_TRAIN_LM, label == "on")
        if label == "on":
            default_ledger().clear()  # /statusz then lists this run's program
            scraping(exp, scrapes)
        A.reset_launches()
        t0 = time.perf_counter()
        with deterministic(torch):
            exp.run()
            torch.cuda.synchronize()
        stats[f"a_{label}_run_s"] = time.perf_counter() - t0
        launches[f"lm_{label}"] = dict(A.LAUNCHES)
        finals[label] = _flat_state(torch, exp.final_state)
        runs[label] = (exp, run)
    bad = _same_state(torch, finals["on"], finals["off"])
    check(not bad, f"obs train (a): the final state differs with observability on: {bad[:5]}")
    for name in LM_TRAIN_KERNELS:
        want = LM_LAYERS * LM_TRAIN_STEPS
        check(launches["lm_off"][name] == launches["lm_on"][name] == want,
              f"obs train (a): {name} launched {launches['lm_off'][name]} (off), "
              f"{launches['lm_on'][name]} (on), want {want}")
    exp, run = runs["on"]
    check(len(scrapes) >= 2, f"obs train (a): {len(scrapes)} scrapes at the saves, want 2")
    for body, status in scrapes:
        _, bad_lines = parse(body)
        check(not bad_lines, f"obs train (a): invalid exposition lines {bad_lines[:5]}")
    values, _ = parse(scrapes[-1][0])
    status = scrapes[-1][1]
    missing = [n for n in OBS_TRAIN_REQUIRED if n not in scrapes[-1][0]]
    check(not missing, f"obs train (a): series missing from the last scrape: {missing}")
    mfu, step_ms = values["zk_train_mfu"], values["zk_train_step_time_ms"]
    rows = status["programs"]["programs"]
    anomalies = exp.obs_registry.counter("zk_step_time_anomalies_total",
                                         labels={"stream": "train_step"}).value
    with open(os.path.join(run, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {}
    for ev in events:
        if ev["ph"] in ("X", "i"):
            names[ev["name"]] = names.get(ev["name"], 0) + 1
    saves = 2  # step 4 (the step cadence) and 8 (the epoch's)
    stats["a"] = {
        "zk_train_step_time_ms": step_ms, "zk_train_mfu": mfu,
        "zk_train_steps_total": values["zk_train_steps_total"],
        "zk_ckpt_queue_depth": values["zk_ckpt_queue_depth"],
        "zk_hbm_bytes_in_use": next((v for k, v in values.items()
                                     if k.startswith("zk_hbm_bytes_in_use")), None),
        "scrapes": len(scrapes), "series": len(values),
        "programs": [{k: r.get(k) for k in ("kind", "key", "flops", "compile_ms", "dispatches")}
                     for r in rows],
        "trace_counts": names, "train_step_anomalies": anomalies,
    }
    check(step_ms > 0 and 0 < mfu <= 1.05,
          f"obs train (a): zk_train_step_time_ms {step_ms}, zk_train_mfu {mfu}")
    check(values["zk_train_steps_total"] == LM_TRAIN_STEPS,
          f"obs train (a): zk_train_steps_total {values['zk_train_steps_total']}")
    check([r["kind"] for r in rows] == ["train_step"] and rows[0]["dispatches"] >= LM_TRAIN_STEPS,
          f"obs train (a): /statusz programs {rows}")
    for name, n in (("data_wait", LM_TRAIN_STEPS), ("dispatch", LM_TRAIN_STEPS),
                    ("readback", LM_TRAIN_STEPS), ("checkpoint", saves),
                    ("ckpt_write", saves), ("ckpt_finalized", saves)):
        check(names.get(name, 0) >= n, f"obs train (a): {names.get(name, 0)} {name} records in "
                                       f"the exported trace, want >= {n}")
    check(anomalies == 0, f"obs train (a): {anomalies} train_step anomalies")
    print(f"obs train (a) on {smi}: states equal off/on, launches {launches['lm_off']} (off) "
          f"{launches['lm_on']} (on); {json.dumps(stats['a'])}", flush=True)
    del runs, exp, finals
    gc.collect()

    # (c) Leg (a)'s step time, three runs a side in turns (default
    # settings), both at log_every=1: the median of the steps' clean
    # readback-to-readback times. Three steady iterations (dispatches 3,
    # 5 and 7, the card idle at each edge) are profiled in the first run
    # of each side, by one profiler whose schedule runs a warm-up
    # iteration before each: a window opened cold has lost its first
    # ~40 kernel records on the card. The loader's prefetch thread copies
    # batches to the card whenever its queue has room, so host-to-device
    # copies are left out (and counted apart); an iteration's events are
    # each other event's largest count over the three windows. A readback
    # or a fill that observability added would show here.
    real_step_fn = TrainLM._train_step_fn
    counts = {}
    windows_of = {}

    def step_fn(self):
        step = real_step_fn(self)
        calls = itertools.count()
        window = {}
        label = self._obs_label
        seen = windows_of.setdefault(label, [])

        def ready(prof):
            ev = prof.key_averages()
            seen.append({
                "host_ops": sum(e.count for e in ev
                                if e.device_type == torch.autograd.DeviceType.CPU),
                "device": {e.key: e.count for e in ev
                           if e.device_type == torch.autograd.DeviceType.CUDA}})
            # Copies and fills by name (the host-to-device ones vary).
            seen[-1]["copies"] = {k: n for k, n in seen[-1]["device"].items()
                                  if k.startswith(("Memcpy", "Memset"))}

        def profiled(st, b):
            i = next(calls)
            if label not in counts and 1 <= i <= 7:
                torch.cuda.synchronize()
                if i == 1:
                    window["prof"] = profile(
                        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                         repeat=3),
                        on_trace_ready=ready)
                    window["prof"].__enter__()
                else:
                    window["prof"].step()
                if i == 7:
                    window.pop("prof").__exit__(None, None, None)
                    events = {}
                    for w in seen:
                        for name, n in w["device"].items():
                            if not name.startswith("Memcpy HtoD"):
                                events[name] = max(events.get(name, 0), n)
                    counts[label] = {
                        "host_ops": [w["host_ops"] for w in seen],
                        "device_events": [sum(w["device"].values()) for w in seen],
                        "copies": [w["copies"] for w in seen],
                        "events": sum(events.values()), "by_name": events}
            return step(st, b)

        return profiled

    per_run = []
    with mock.patch.object(TrainLM, "_train_step_fn", step_fn):
        for label in OBS_TRAIN_ORDER:
            exp, _ = make(TrainLM, OBS_TRAIN_LM, label == "on", {"log_every": 1})
            object.__setattr__(exp, "_obs_label", label)
            steps = []
            real_publish = exp._publish_mfu

            def publish(per_step, program, real_publish=real_publish, steps=steps):
                steps.append(per_step * 1e3)
                return real_publish(per_step, program)

            object.__setattr__(exp, "_publish_mfu", publish)
            exp.run()
            per_run.append({"obs": label, "step_ms": statistics.median(steps),
                            "samples": len(steps)})
            del exp
    stats["c"] = {label: [r["step_ms"] for r in per_run if r["obs"] == label]
                  for label in ("off", "on")}
    stats["c"]["order"] = list(OBS_TRAIN_ORDER)
    stats["c"]["one_iteration"] = {label: {k: v for k, v in c.items() if k != "by_name"}
                                   for label, c in counts.items()}
    check(set(counts) == {"off", "on"}, f"obs train (c): profiled {sorted(counts)}")
    names = set(counts["off"]["by_name"]) | set(counts["on"]["by_name"])
    stats["c"]["differ"] = {n: [counts[label]["by_name"].get(n, 0) for label in ("off", "on")]
                            for n in sorted(names)
                            if counts["off"]["by_name"].get(n) != counts["on"]["by_name"].get(n)}
    check(counts["off"]["by_name"] == counts["on"]["by_name"],
          f"obs train (c): a steady iteration's events differ off/on: {stats['c']['differ']} "
          f"({stats['c']['one_iteration']})")
    print(f"obs train (c) step ms on {smi}: {json.dumps(stats['c'])}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) Phase 18's QuickNet-Large leg at unroll 4, off and on.
    conf, _ = UNROLL_LEGS["TrainImageNet"]
    conf = {**conf, "loader.dataset.num_train_examples": OBS_TRAIN_CNN_STEPS * TRAIN_BATCH,
            "epochs": 1, "steps_per_epoch": OBS_TRAIN_CNN_STEPS, "validate": False, "seed": 0,
            "device": "cuda", "verbose": False, "unroll": UNROLL,
            "checkpointer.save_every_epochs": 0}
    sources, finals = {}, {}
    for label in ("off", "on"):
        exp, _ = make(TrainImageNet, conf, label == "on", {"log_every": UNROLL})
        _shared_source(exp, sources)
        if label == "on":
            default_ledger().clear()
        bc.reset_launches()
        with deterministic(torch):
            exp.run()
            torch.cuda.synchronize()
        launches[f"cnn_{label}"] = dict(bc.LAUNCHES)
        finals[label] = _flat_state(torch, exp.final_state)
        if label == "on":
            rows = [r for r in default_ledger().entries() if r.kind == "multi_step"]
            reg = exp.obs_registry
            stats["b"] = {"zk_train_mfu": reg.gauge("zk_train_mfu").value,
                          "zk_train_mfu_int8": reg.gauge("zk_train_mfu_int8").value,
                          "zk_train_step_time_ms": reg.gauge("zk_train_step_time_ms").value,
                          "rows": [{"key": r.key, "steps": r.attrs.get("steps"),
                                    "flops": r.flops, "compile_ms": r.compile_ms,
                                    "dispatches": r.dispatches} for r in rows]}
        del exp
    bad = _same_state(torch, finals["on"], finals["off"])
    check(not bad, f"obs train (b): the final state differs with observability on: {bad[:5]}")
    for name in RESID_KERNELS:
        check(launches["cnn_off"][name] == launches["cnn_on"][name] > 0,
              f"obs train (b): {name} launched {launches['cnn_off'][name]} (off), "
              f"{launches['cnn_on'][name]} (on)")
    b = stats["b"]
    check([r["steps"] for r in b["rows"]] == [UNROLL],
          f"obs train (b): multi_step rows {b['rows']}")
    check(0 < b["zk_train_mfu"] <= 1.05 and 0 < b["zk_train_mfu_int8"] <= 1.05,
          f"obs train (b): zk_train_mfu {b['zk_train_mfu']}, _int8 {b['zk_train_mfu_int8']}")
    print(f"obs train (b) on {smi}: states equal off/on, launches {launches['cnn_off']} (off) "
          f"{launches['cnn_on']} (on); {json.dumps(b)}", flush=True)
    del finals, sources
    gc.collect()
    torch.cuda.empty_cache()

    # (d) A NaN halt under run_with_recovery with the recorder armed and
    # the trace ring on.
    exp, run = make(TrainLM, OBS_TRAIN_NAN, False, {
        "flight_recorder_dir": os.path.join(tmp, "nan_bundles"),
        "flight_recorder_interval_s": 0.0})
    prior = recorder.get_recorder()
    tracer = trace.Tracer()
    trace.install(tracer)
    A.reset_launches()
    try:
        with faults.injected(FaultPlan(nan_at_step=OBS_TRAIN_NAN_AT)):
            result = run_with_recovery(exp, max_restarts=1, backoff_s=0.0, sleep=lambda s: None)
        torch.cuda.synchronize()
        launches["nan_halt"] = dict(A.LAUNCHES)
        kinds = []
        for path in exp.flight_recorder.bundles():
            with open(os.path.join(path, "manifest.json")) as f:
                kinds.append(json.load(f)["trigger"]["kind"])
        ring = tracer.snapshot()
    finally:
        trace.install(None)
        recorder.uninstall()
        if prior is not None:
            recorder.install(prior)
    nan_marks = [r for r in ring if r["name"] == "fault_injected"
                 and (r["attrs"] or {}).get("kind") == "nan_at_step"]
    done = [r for r in ring if r["name"] == "restore_done"]
    stats["d"] = {"restarts": result.restarts, "bundles": kinds,
                  "cause": type(result.causes[0]).__name__ if result.causes else None,
                  "nan_marks": len(nan_marks), "restore_done_steps": [r["step"] for r in done]}
    check(result.restarts == 1 and stats["d"]["cause"] == "NonFiniteLossError",
          f"obs train (d): {stats['d']}")
    check(kinds.count("nan_halt") == 1 and kinds.count("supervisor_restart") == 1,
          f"obs train (d): bundles {kinds}")
    check(nan_marks and done, f"obs train (d): the trace ring's marks {stats['d']}")
    print(f"obs train (d) on {smi}: {json.dumps(stats['d'])}, launches {launches['nan_halt']}",
          flush=True)
    del exp
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    stats["phase_s"] = time.perf_counter() - t_phase
    print(f"obs train phase: {stats['phase_s']:.1f} s", flush=True)
    return launches, stats


#: Phase 27 (a): phase 10's LM (paged, no prefix cache) behind an async
#: scheduler; the guard-off run and the guarded runs replay one
#: ``poisson_burst`` trace of GUARD_REQUESTS requests (prompts 64-2048
#: tokens, 64 new). Its rates and phase lengths are scaled together, so
#: the requests are the same at every offered rate.
GUARD_SEED = 27
GUARD_REQUESTS = 64
GUARD_TRACE = {"base_rate_rps": 25.0, "burst_rate_rps": 40.0, "base_s": 1.0, "burst_s": 0.8,
               "cooldown_s": 1.5, "vocab": 1024, "prompt_len": 64, "max_prompt_len": 2048,
               "new_tokens": 64, "max_new_tokens": 64}
#: The offered rates, as multiples of the rate the guard-off run sustains.
GUARD_LOADS = (0.5, 3.0)
#: The deadline, as a multiple of the guard-off run's median per-request
#: service time (dispatch to completion).
GUARD_DEADLINE_X = 6.0
#: The guard: the brown-out engages after 4 predicted-miss sheds in a row
#: and releases after 16 admits in a row (more than the overloaded run's
#: tail admits, so the drain that ends it applies the brown-out).
GUARD = {"guard.enabled": True, "guard.brownout_after": 4, "guard.brownout_release": 16,
         "guard.brownout_max_new_tokens": 8}
#: Phase 27 (b), (c): the fleet's workers serve phase 10's LM on the paged
#: pool with the radix prefix cache on; a session_mix trace (4 sessions x
#: 3 turns over a 1024-token shared prefix, 128 tokens a turn, 32 new).
FLEET_WORKER = {**LM_CONFIG, "model.max_seq_len": LM_CONFIG["seq_len"],
                "engine.kv_layout": "paged", "engine.prefix_cache": True, "requests": 0,
                "metrics_port": 0}
FLEET_TRACE = {"sessions": 4, "turns": 3, "shared_prefix_len": 1024, "turn_tokens": 128,
               "vocab": 1024, "new_tokens": 32, "max_new_tokens": 32}
FLEET_KILL_AT = 5
#: (c)'s gray leg: w0 of the round-robin fleet stalls its first forward
#: this long; its breaker trips past the threshold and probes after the
#: cooldown.
GRAY_STALL_MS, GRAY_THRESHOLD_MS, GRAY_COOLDOWN_S = 1500, 1000.0, 1.0


def fleet_worker_main(argv) -> None:
    """``python chip_smoke.py --fleet-worker ID READY WORKDIR CONFIG``: one
    fleet worker (``serving.fleet_worker.run_fleet_worker``) that also
    writes its kernel launches and its engine's dispatch counts since the
    service was built (its warm-up left out) to ``WORKDIR/launches_ID.json``
    every 0.2 s and at exit (the counters are process-local)."""
    import threading

    sys.path.insert(0, ROOT)
    from zookeeper_tpu_torch.ops import attention as A
    from zookeeper_tpu_torch.serving.decode import LMServingConfig
    from zookeeper_tpu_torch.serving.fleet_worker import run_fleet_worker

    worker_id, ready, workdir, config_json = argv
    path = os.path.join(workdir, f"launches_{worker_id}.json")
    served = {}
    build = LMServingConfig.build_service

    def build_service(self):
        engine, scheduler = build(self)
        # The counts start here, before the worker answers: the warm-up's
        # launches and dispatches are not the served path's.
        A.reset_launches()
        served.update(engine=engine, baseline=dict(engine.dispatches))
        return engine, scheduler

    def write():
        if "engine" not in served:
            return
        base = served["baseline"]
        doc = {"launches": dict(A.LAUNCHES),
               "dispatches": {k: n - base.get(k, 0)
                              for k, n in served["engine"].dispatches.items()}}
        with open(path + ".tmp", "w") as f:
            json.dump(doc, f)
        os.replace(path + ".tmp", path)

    stop = threading.Event()

    def loop():
        while not stop.wait(0.2):
            write()

    thread = threading.Thread(target=loop, name="launch-writer", daemon=True)
    thread.start()
    try:
        with mock.patch.object(LMServingConfig, "build_service", build_service):
            run_fleet_worker(worker_id, ready, workdir, config_json)
    finally:
        stop.set()
        thread.join(timeout=5)
        write()


def _worker_counts(workdir, worker_id, served):
    """A worker's launches and dispatches since its warm-up, and how many
    of the ``served`` entries it answered."""
    with open(os.path.join(workdir, f"launches_{worker_id}.json")) as f:
        doc = json.load(f)
    return {"flash_forward": doc["launches"]["flash_forward"],
            "pool_paged_decode_attention": doc["launches"]["pool_paged_decode_attention"],
            "prefill": doc["dispatches"].get("prefill", 0),
            "prefill_warm": doc["dispatches"].get("prefill_warm", 0),
            "decode": doc["dispatches"].get("decode", 0),
            "requests": sum(e["worker"] == worker_id for e in served)}


def _counts_match(counts, served=True) -> bool:
    """K9 = layers x prefill dispatches, K13 = layers x decode steps; a
    path that ``served`` requests took at least one decode step, and one
    that served none dispatched and launched nothing."""
    if not served:
        return not any(counts.values())
    return (counts["flash_forward"] == LM_LAYERS * counts["prefill"]
            and counts["pool_paged_decode_attention"] == LM_LAYERS * counts["decode"]
            and counts["decode"] > 0)


def _slo_summary(report):
    import numpy as np

    ok = [o for o in report.results if o.outcome == "ok"]
    pct = lambda xs, q: round(float(np.percentile(xs, q)), 3) if xs else None  # noqa: E731
    ttft = [o.ttft_ms for o in ok if o.ttft_ms is not None]
    lat = [o.latency_ms for o in ok]
    return {"outcomes": dict(report.outcomes), "ok_tokens": report.ok_tokens,
            "goodput_tokens_per_sec": round(report.goodput_tokens_per_sec, 3),
            "wall_s": round(report.wall_s, 3), "ttft_p50_ms": pct(ttft, 50),
            "ttft_p99_ms": pct(ttft, 99), "latency_p50_ms": pct(lat, 50),
            "latency_p99_ms": pct(lat, 99)}


class _StreamTarget:
    """A stream-scheduler replay target that keeps each admitted stream by
    rid (the report keeps only token counts)."""

    def __init__(self, scheduler):
        self.scheduler = scheduler
        self.request_log = scheduler.request_log
        self.streams = {}

    def submit(self, prompt, **kw):
        stream = self.scheduler.submit(prompt, **kw)
        self.streams[stream.rid] = stream
        return stream

    def drain(self):
        self.scheduler.drain()


def _guard_trace(loadgen, rate_rps=None):
    """The guard's trace, its rates scaled so that its mean rate over the
    kept requests is ``rate_rps`` (None: as configured)."""
    base = loadgen.poisson_burst(GUARD_SEED, **GUARD_TRACE)
    check(len(base.requests) >= GUARD_REQUESTS,
          f"guard: the trace has {len(base.requests)} < {GUARD_REQUESTS} requests")
    mean = GUARD_REQUESTS / (base.requests[GUARD_REQUESTS - 1].at_ms / 1e3)
    c = 1.0 if rate_rps is None else rate_rps / mean
    scaled = {**GUARD_TRACE, "base_rate_rps": GUARD_TRACE["base_rate_rps"] * c,
              "burst_rate_rps": GUARD_TRACE["burst_rate_rps"] * c,
              "base_s": GUARD_TRACE["base_s"] / c, "burst_s": GUARD_TRACE["burst_s"] / c,
              "cooldown_s": GUARD_TRACE["cooldown_s"] / c}
    trace = loadgen.poisson_burst(GUARD_SEED, **scaled)
    keep = trace.requests[:GUARD_REQUESTS]
    check(len(keep) == GUARD_REQUESTS
          and [r.prompt for r in keep] == [r.prompt for r in base.requests[:GUARD_REQUESTS]],
          "guard: the scaled trace's requests differ from the base trace's")
    return loadgen.Trace(name=f"{trace.name}@{rate_rps or mean:.2f}rps", seed=GUARD_SEED,
                         requests=keep), mean


def _serve_in_order(svc, entries):
    """``[(prompt, max_new)]`` one at a time through ``svc``'s scheduler,
    as a fleet worker serves them; the tokens as lists."""
    import numpy as np

    out = []
    for prompt, new in entries:
        stream = svc.scheduler.submit(np.asarray(prompt, np.int32), max_new_tokens=new)
        out.append([int(t) for t in stream.result(timeout=300.0)])
    return out


def _oracle_by_replica(svc, served):
    """The in-process oracle of a fleet run: each replica's requests, in
    the order it served them, through ``svc`` with its prefix cache
    emptied first, so every request takes the path (warm or cold) it took
    on its worker. Returns the entries whose tokens differ."""
    by_worker = {}
    for entry in served:
        by_worker.setdefault(entry["worker"], []).append(entry)
    wrong = []
    for worker, entries in by_worker.items():
        svc.engine.invalidate_prefix_cache()
        want = _serve_in_order(svc, [(e["prompt"], e["new"]) for e in entries])
        wrong += [(worker, e["index"]) for e, w in zip(entries, want) if w != e["tokens"]]
    return wrong


class _RouterTarget:
    """A callable replay target over a router, keeping each response."""

    def __init__(self, router, served):
        self.router = router
        self.served = served
        self.by_index = {}

    def __call__(self, req):
        import numpy as np

        resp = self.router.submit(np.asarray(req.prompt, np.int32), session=req.session,
                                  max_new_tokens=req.max_new_tokens)
        entry = {"index": req.index, "phase": req.phase, "worker": resp.worker_id,
                 "prompt": list(req.prompt), "new": req.max_new_tokens,
                 "tokens": [int(t) for t in resp.tokens], "shared": resp.shared_tokens,
                 "affinity_hit": resp.affinity_hit, "rid": resp.rid}
        self.served.append(entry)
        self.by_index[req.index] = entry
        return len(entry["tokens"]), resp.ttft_ms


def _pool_idle(worker):
    """The worker's pool holds no page for a stream: free pages plus the
    prefix cache's equal the pool, none leaked, and the scraped
    ``zk_kv_pool_free_pages`` agrees. Returns (ok, the numbers)."""
    pool = json.loads(_http_get(worker["metrics_port"], "/statusz"))["decode"]["kv_pool"]
    values, _ = _exposition(_http_get(worker["metrics_port"], "/metrics"))
    free = values.get("zk_kv_pool_free_pages")
    nums = {k: pool[k] for k in ("num_pages", "free_pages", "prefix_nodes", "leaked")}
    nums["zk_kv_pool_free_pages"] = free
    return (pool["leaked"] == 0 and pool["free_pages"] + pool["prefix_nodes"]
            == pool["num_pages"] and free == pool["free_pages"]), nums


def guard_fleet_phase(torch, A, smi):
    """Phase 27 (see the module docstring). Returns ({"guard": K9/K13
    launches of (a)'s guarded runs, "fleet": {worker: counts}}, stats)."""
    import shutil
    import tempfile

    import numpy as np

    from zookeeper_tpu_torch import loadgen
    from zookeeper_tpu_torch.resilience import FaultPlan
    from zookeeper_tpu_torch.serving import FleetRouter, ReplicaHandle
    from zookeeper_tpu_torch.serving.fleet import _http_transport
    from zookeeper_tpu_torch.serving.fleet_worker import spawn_fleet_workers, stop_fleet_workers

    t_phase = time.perf_counter()
    stats, launches = {}, {"fleet": {}}

    # (a) The guard. The guard-off run: every request at once (the open
    # loop at time_scale 0), its sustained rate and reference tokens.
    base_trace, _ = _guard_trace(loadgen)
    stats["trace"] = base_trace.stats()
    off = _lm_config({**PAGED, "scheduler.synchronous": False})
    off.build_service()
    target = _StreamTarget(off.scheduler)
    report = loadgen.replay(base_trace, target)
    check(report.outcomes == {"ok": GUARD_REQUESTS}, f"guard: off-run outcomes {report.outcomes}")
    reference = {o.index: [int(t) for t in target.streams[o.rid].result()]
                 for o in report.results}
    sustained = GUARD_REQUESTS / report.wall_s
    service_ms = float(np.median([(r["complete_ns"] - r["dispatch_ns"]) / 1e6
                                  for r in off.scheduler.request_log.tail(GUARD_REQUESTS)]))
    deadline_ms = GUARD_DEADLINE_X * service_ms
    stats["off"] = {**_slo_summary(report), "sustained_rps": round(sustained, 3),
                    "service_p50_ms": round(service_ms, 3), "deadline_ms": round(deadline_ms, 3)}
    off._teardown_service()
    print(f"guard (a) off on {smi}: {json.dumps(stats['off'])}", flush=True)

    on = _lm_config({**PAGED, **GUARD, "scheduler.synchronous": False,
                     "scheduler.default_deadline_ms": deadline_ms})
    on.build_service()
    engine, sched = on.engine, on.scheduler
    before = dict(engine.dispatches)
    A.reset_launches()
    runs = {}
    for load in GUARD_LOADS:
        trace, _ = _guard_trace(loadgen, load * sustained)
        target = _StreamTarget(sched)
        report = loadgen.replay(trace, target, time_scale=1.0)
        runs[load] = report
        st = sched.status()["guardrails"]
        stats[f"x{load}"] = {**_slo_summary(report), "offered_rps": round(load * sustained, 3),
                             "guard": st["guard"], "brownout_active": st["brownout_active"]}
        print(f"guard (a) {load}x on {smi}: {json.dumps(stats[f'x{load}'])}", flush=True)
        check(report.total == GUARD_REQUESTS, f"guard {load}x: {report.total} outcomes")
        for o in report.results:
            check(o.outcome in ("ok", "shed", "deadline_expired"),
                  f"guard {load}x: request {o.index} ended {o.outcome} ({o.error})")
        # Each admitted stream that finished: the guard-off run's tokens, or
        # their first brownout_max_new_tokens where the brown-out capped it.
        cap = int(on.guard.brownout_max_new_tokens)
        for o in report.results:
            if o.outcome != "ok":
                continue
            got, want = [int(t) for t in target.streams[o.rid].result()], reference[o.index]
            capped = got == want[:len(got)] and len(got) == cap and load != GUARD_LOADS[0]
            check(got == want or capped,
                  f"guard {load}x: request {o.index}'s tokens differ from the guard-off run's")
    low, high = (runs[load] for load in GUARD_LOADS)
    check(low.outcomes == {"ok": GUARD_REQUESTS}, f"guard {GUARD_LOADS[0]}x: {low.outcomes}")
    check(high.outcomes.get("shed", 0) > 0, f"guard {GUARD_LOADS[1]}x: nothing shed")
    engaged = sched.status()["guardrails"]["guard"]["brownout"]
    check(engaged["engaged_total"] >= 1, f"guard: the brown-out never engaged: {engaged}")
    # The drain: admissions into the empty queue release the brown-out,
    # the first of them capped while it is still applied.
    release = []
    for r in base_trace.requests[:int(on.guard.brownout_release) + 1]:
        stream = sched.submit(np.asarray(r.prompt, np.int32), max_new_tokens=r.max_new_tokens)
        release.append((r.index, [int(t) for t in stream.result(timeout=300.0)]))
    sched.drain()
    st = sched.status()["guardrails"]
    values, _ = _exposition(_render_registry(on.guard.registry))
    stats["release"] = {"tokens": [len(t) for _, t in release], "guard": st["guard"],
                        "brownout_active": st["brownout_active"],
                        "zk_guard_brownouts_total": values.get("zk_guard_brownouts_total")}
    print(f"guard (a) release on {smi}: {json.dumps(stats['release'])}", flush=True)
    check(not st["brownout_active"] and not on.guard.brownout_engaged,
          f"guard: the brown-out was not released: {st}")
    check(values.get("zk_guard_brownouts_total", 0) >= 1,
          "guard: the brown-out was never applied at a drained boundary")
    for index, got in release:
        want = reference[index]
        check(got == want[:len(got)], f"guard release: request {index}'s tokens")
    check(len(release[0][1]) == int(on.guard.brownout_max_new_tokens)
          and release[-1][1] == reference[release[-1][0]],
          f"guard release: lengths {[len(t) for _, t in release]}")
    delta = {k: engine.dispatches.get(k, 0) - before.get(k, 0)
             for k in ("prefill", "prefill_warm", "decode")}
    launches["guard"] = {"flash_forward": A.LAUNCHES["flash_forward"],
                         "pool_paged_decode_attention": A.LAUNCHES["pool_paged_decode_attention"],
                         **delta}
    check(_counts_match(launches["guard"]), f"guard: launches {launches['guard']}")
    pool = engine.page_pool
    check(pool.free_pages == pool.num_pages and pool.leak_check() == 0,
          f"guard: pages held after the drain: {pool.free_pages} free of {pool.num_pages}")
    on._teardown_service()
    stats["a_s"] = time.perf_counter() - t_phase
    print(f"guard (a) launches on {smi}: {json.dumps(launches['guard'])} "
          f"in {stats['a_s']:.1f} s", flush=True)

    # (b) The fleet: 2 worker processes on this card behind the affinity
    # router, the session trace replayed in arrival order.
    t_b = time.perf_counter()
    fleet_trace = loadgen.session_mix(GUARD_SEED, **FLEET_TRACE)
    entry = [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--fleet-worker"]
    tmp = tempfile.mkdtemp(prefix="guard_fleet_")
    dirs = {"a": os.path.join(tmp, "a"), "b": os.path.join(tmp, "b")}
    for d in dirs.values():
        os.makedirs(d)
    oracle = _lm_config({**FLEET_WORKER, "metrics_port": -1})
    oracle.build_service()
    fleet_a, fleet_b, routers = [], [], []
    try:
        fleet_a = spawn_fleet_workers(dirs["a"], 2, config=FLEET_WORKER, command=entry)
        stats["spawn_a_s"] = time.perf_counter() - t_b
        router = FleetRouter([ReplicaHandle.from_worker(w) for w in fleet_a],
                             page_size=LM_PAGE, policy="affinity")
        routers.append(router)
        served_a = []
        target = _RouterTarget(router, served_a)
        report = loadgen.replay(fleet_trace, target, concurrency=1)
        stats["b"] = {**_slo_summary(report), "affinity_hits": router.affinity_hits_total,
                      "routed": [e["worker"] for e in served_a],
                      "shared": [e["shared"] for e in served_a]}
        print(f"fleet (b) affinity on {smi}: {json.dumps(stats['b'])}", flush=True)
        check(report.outcomes == {"ok": len(fleet_trace.requests)},
              f"fleet (b): outcomes {report.outcomes}")
        check(router.affinity_hits_total >= 8, f"fleet (b): {router.affinity_hits_total} "
              "affinity hits")
        check(all(e["shared"] > 0 for e in served_a if e["phase"] != "turn0"),
              f"fleet (b): a later turn was served cold: {stats['b']['shared']}")
        wrong = _oracle_by_replica(oracle, served_a)
        check(not wrong, f"fleet (b): tokens differ from the in-process oracle at {wrong}")
        time.sleep(0.5)  # the workers idle: their counts settle
        for w in fleet_a:
            counts = _worker_counts(dirs["a"], w["worker_id"], served_a)
            launches["fleet"][f"a_{w['worker_id']}_b"] = counts
            check(_counts_match(counts, counts["requests"] > 0),
                  f"fleet (b): {w['worker_id']}'s launches {counts}")
        router.close()

        # (c) The kill leg on (b)'s fleet: the replica chosen for the 5th
        # routed request is SIGKILLed; retries land on the survivor.
        router = FleetRouter([ReplicaHandle.from_worker(w) for w in fleet_a],
                             page_size=LM_PAGE, policy="affinity", max_retries=2,
                             retry_backoff_s=0.05, breaker_failures=1, breaker_cooldown_s=600.0)
        routers.append(router)
        served_c = []
        target = _RouterTarget(router, served_c)
        report = loadgen.replay(fleet_trace, target,
                                fault_plan=FaultPlan(fleet_replica_kill_at=FLEET_KILL_AT),
                                concurrency=1)
        dead = [r for r in router.replicas if not r.healthy]
        live = [r for r in router.replicas if r.healthy]
        retried = [rid for rid in (e["rid"] for e in served_c)
                   if "retried=" in ((router.request_log.find(rid) or {}).get("detail") or "")]
        stats["c_kill"] = {**_slo_summary(report), "retried": len(retried),
                           "dead": [r.worker_id for r in dead],
                           "breakers": {r.worker_id: r.breaker.status()
                                        for r in router.replicas}}
        check(report.total == len(fleet_trace.requests)
              and sum(report.outcomes.values()) == report.total,
              f"fleet (c): not every request is terminal: {report.outcomes}")
        check(len(dead) == 1 and dead[0].breaker.state == "open" and len(live) == 1
              and live[0].breaker.state == "closed",
              f"fleet (c): replicas after the kill: {stats['c_kill']['breakers']}")
        check(len(retried) >= 1, "fleet (c): no request was retried")
        wrong = _oracle_by_replica(oracle, served_a + served_c)
        check(not wrong, f"fleet (c): tokens differ from the in-process oracle at {wrong}")
        survivor = next(w for w in fleet_a if w["worker_id"] == live[0].worker_id)
        idle, nums = _pool_idle(survivor)
        stats["c_kill"]["survivor_pool"] = nums
        print(f"fleet (c) kill on {smi}: {json.dumps(stats['c_kill'])}", flush=True)
        check(idle, f"fleet (c): the survivor's pool after the leg: {nums}")
        router.close()
        stop_fleet_workers(fleet_a)
        counts = _worker_counts(dirs["a"], survivor["worker_id"], served_a + served_c)
        launches["fleet"][f"a_{survivor['worker_id']}_exit"] = counts
        check(_counts_match(counts, counts["requests"] > 0),
              f"fleet (c): the survivor's launches {counts}")
        fleet_a = []

        # (b) again under round_robin, on a fresh fleet whose w0 stalls its
        # first forward (the gray leg of (c)): the breaker opens, probes,
        # closes; the tokens equal the affinity run's and the oracle's.
        fleet_b = spawn_fleet_workers(dirs["b"], 2, config={
            **FLEET_WORKER, "faults": {"delay_forward_ms": {"w0": GRAY_STALL_MS}}},
            command=entry)
        seen = []

        def transport(replica, payload, timeout_s):
            seen.append((replica.worker_id, replica.breaker.state))
            return _http_transport(replica, payload, timeout_s)

        router = FleetRouter([ReplicaHandle.from_worker(w) for w in fleet_b],
                             page_size=LM_PAGE, policy="round_robin", transport=transport,
                             breaker_latency_ms=GRAY_THRESHOLD_MS, breaker_latency_window=1,
                             breaker_cooldown_s=GRAY_COOLDOWN_S, breaker_jitter_frac=0.0)
        routers.append(router)
        served_b = []
        target = _RouterTarget(router, served_b)
        b0 = router._by_id["w0"].breaker
        healthy, states = [], []
        for req in fleet_trace.requests:
            target(req)
            states.append(b0.state)
            healthy.append(router.check_health()["w0"])
        by_index_b = dict(target.by_index)
        if b0.probes_total == 0:
            # Every session is pinned to the healthy replica by now: once the
            # cooldown ends, a request of no session carries the probe.
            deadline = time.monotonic() + 30.0
            while not b0.routable() and time.monotonic() < deadline:
                time.sleep(0.05)
            first = fleet_trace.requests[0]
            resp = router.submit(np.asarray(first.prompt, np.int32),
                                 max_new_tokens=first.max_new_tokens)
            served_b.append({"index": first.index, "worker": resp.worker_id,
                             "prompt": list(first.prompt), "new": first.max_new_tokens,
                             "tokens": [int(t) for t in resp.tokens]})
            states.append(b0.state)
        w0_states = [s for w, s in seen if w == "w0"]
        stats["c_gray"] = {"w0_states_at_forward": w0_states, "states_after": states,
                           "breaker": b0.status(), "healthy": all(healthy),
                           "routed": [e["worker"] for e in served_b]}
        print(f"fleet (c) gray on {smi}: {json.dumps(stats['c_gray'])}", flush=True)
        check(all(healthy), "fleet (c) gray: the stalled replica failed its health probe")
        check("open" in states and w0_states.count("half_open") == 1
              and b0.state == "closed" and b0.opened_total == 1 and b0.probes_total == 1,
              f"fleet (c) gray: the breaker did not open, probe and close: {stats['c_gray']}")
        # Round-robin against affinity: equal where both served a request
        # by the same path; where one served it warm (the fp32 window over
        # cached pages) and the other cold (K9), bf16 may part them, but
        # only at a near-tie: the plain path's logits of the two tokens
        # where they first differ lie within 0.05 of each other and of the
        # top (phase 10's bf16 rule).
        affinity = {e["index"]: e for e in served_a}
        mismatch = {}
        for i, e in sorted(by_index_b.items()):
            a_tok, b_tok = affinity[i]["tokens"], e["tokens"]
            if a_tok == b_tok:
                continue
            check(affinity[i]["shared"] != e["shared"],
                  f"fleet: request {i} took one path under both policies, and its tokens differ")
            t = next(j for j, (x, y) in enumerate(zip(a_tok, b_tok)) if x != y)
            logits = _plain_logits(torch, A, oracle.engine._module,
                                   np.asarray(fleet_trace.requests[i].prompt, np.int32),
                                   a_tok, t)
            top = float(logits.max())
            gap = abs(float(logits[a_tok[t]] - logits[b_tok[t]]))
            mismatch[i] = {"shared": [affinity[i]["shared"], e["shared"]], "at": t,
                           "gap": gap, "below_top": top - max(float(logits[a_tok[t]]),
                                                               float(logits[b_tok[t]]))}
            check(gap < 0.05 and top - min(float(logits[a_tok[t]]), float(logits[b_tok[t]]))
                  < 0.05, f"fleet: request {i}'s tokens part at {t} where the plain logits "
                          f"are not tied: {mismatch[i]}")
        same = sum(affinity[i]["tokens"] == e["tokens"] for i, e in by_index_b.items())
        stats["round_robin_vs_affinity"] = {"equal": same, "of": len(by_index_b),
                                            "parted": mismatch}
        print(f"fleet round_robin vs affinity on {smi}: "
              f"{json.dumps(stats['round_robin_vs_affinity'])}", flush=True)
        wrong = _oracle_by_replica(oracle, served_b)
        check(not wrong, f"fleet (b) round_robin: tokens differ from the oracle at {wrong}")
        router.close()
        stop_fleet_workers(fleet_b)
        for w in fleet_b:
            counts = _worker_counts(dirs["b"], w["worker_id"], served_b)
            launches["fleet"][f"b_{w['worker_id']}_exit"] = counts
            check(_counts_match(counts, counts["requests"] > 0),
                  f"fleet: {w['worker_id']}'s launches {counts}")
        fleet_b = []
    finally:
        for router in routers:
            router.close()
        stop_fleet_workers(fleet_a + fleet_b)
        oracle._teardown_service(suppress=True)
        shutil.rmtree(tmp, ignore_errors=True)
    stats["phase_s"] = time.perf_counter() - t_phase
    print(f"guard_fleet launches on {smi}: {json.dumps(launches)}; phase "
          f"{stats['phase_s']:.1f} s", flush=True)
    return launches, stats


def _render_registry(registry) -> str:
    from zookeeper_tpu_torch.observability.export import render_prometheus

    return render_prometheus([registry])


def main() -> None:
    if not os.path.isdir(os.path.join(ROOT, "zookeeper_tpu_torch", "csrc")):
        fail("run from a checkout: zookeeper_tpu_torch/ is not beside this script")
    sys.path.insert(0, ROOT)
    started = time.perf_counter()

    def elapsed(label: str) -> None:
        print(f"elapsed {time.perf_counter() - started:.1f} s: {label}", flush=True)

    # cuBLAS reads this when CUDA starts: deterministic workspaces.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA card (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    # Deterministic mode (see ``deterministic``) would also fill every new
    # tensor with NaN, a debugging aid that adds a fill launch per
    # allocation; the results do not depend on it.
    torch.utils.deterministic.fill_uninitialized_memory = False

    from zookeeper_tpu_torch.ops import binary_compute as bc
    from zookeeper_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"build: {sorted(cuda_build.SIGNATURES)} with nvcc "
          f"{' '.join(cuda_build.NVCC_FLAGS)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print_kernel_resources(cuda_build, "flash_forward", "_mma_")
    print_kernel_resources(cuda_build, "flash_backward", "_mma_")
    print_kernel_resources(cuda_build, "packed_weight_matmul", "_kernel")
    print_kernel_resources(cuda_build, "xnor_gemm", "_kernel")
    print_kernel_resources(cuda_build, "conv_gemm_popcount", "_kernel")
    print_kernel_resources(cuda_build, "decode_attention", "split")

    totals = kernel_phase(torch, bc)
    totals.update(resid_kernel_phase(torch, bc))
    totals.update(xnor_kernel_phase(torch, bc, smi))
    int8_exact_phase(torch, bc)
    elapsed("build, kernel phases")
    slices = {label: slice_phase(torch, bc, label, smi) for label in SLICES}
    print(f"slices on {smi}: "
          + " ".join(f"{label} {json.dumps(stats)}" for label, (_, stats) in slices.items()),
          flush=True)
    elapsed("serving slices")
    launches_t, _ = training_phase(torch, bc, smi)
    bireal = bireal_kernel_phase(torch, bc)
    bireal.update(bireal_resid_phase(torch, bc))
    launches_bt, _ = training_phase(torch, bc, smi, model="BiRealNet",
                                    per_step=BIREAL_TRAIN, tag="bireal training")
    resnet = resnet_training_phase(torch, bc, smi)
    mnist = mnist_phase(torch, smi)
    print(f"zoo on {smi}: resnet50 {json.dumps(resnet)} mnist {json.dumps(mnist)}", flush=True)
    elapsed("training phases, zoo")
    dense = dense_kernel_phase(torch, bc)
    xnor_dense_vjp_phase(torch, bc)
    dense_profiles = dense_profile_phase(smi)
    launches_dt, dense_train = xnor_training_phase(torch, bc, smi, "BinaryDenseNet28",
                                                   DENSE_TRAIN, "densenet training")
    launches_at, alex_train = xnor_training_phase(torch, bc, smi, "BinaryAlexNet", ALEXNET_TRAIN,
                                                  "alexnet xnor training", full=False)
    print(f"dense zoo on {smi}: " + " ".join(
        f"{label} {json.dumps({**slices[label][1], **dense_profiles[label]})}"
        for label in DENSE_SLICES)
        + f" densenet_training {json.dumps(dense_train)} alexnet_training "
        f"{json.dumps(alex_train)}", flush=True)

    elapsed("dense zoo")
    from zookeeper_tpu_torch.ops import attention as A

    lm_records, lm_err = lm_kernel_phase(torch, A)
    launches_lm, _, lm_main = lm_serving_phase(torch, A, smi)
    parity = lm_parity_phase(torch, A)
    print(f"lm parity: {json.dumps(parity)}", flush=True)
    lm_train_records, lm_train_err = lm_train_kernel_phase(torch, A)
    launches_lt, _ = lm_training_phase(torch, A, smi)
    lm_wide_phase(torch, A, smi)
    elapsed("LM phases")
    recipe_kernels = recipe_kernel_phase(torch, bc)
    launches_rt, recipe = recipe_phase(torch, bc, smi)
    elapsed("recipe")
    launches_ck, _ = checkpoint_phase(torch, bc, A, smi)
    elapsed("checkpoint")
    cifar_entries, cifar = cifar_phase(torch, bc, smi)
    digits = digits_phase(torch, smi)
    print(f"cifar and digits on {smi}: {json.dumps(cifar)} digits {json.dumps(digits)}",
          flush=True)
    elapsed("cifar, digits")
    unroll = unroll_phase(torch, bc, A, smi)
    elapsed("unroll")
    launches_sp, launches_ring, ring_rows = parallel_phase(torch, A, smi)
    elapsed("parallel")
    sharded, launches_composed, head_rows = sharded_phase(torch, bc, A, smi)
    elapsed("sharded")
    served, decode_shard_rows, channel_rows = served_sharded_phase(torch, bc, A, smi)
    elapsed("served sharded")
    features = features_phase(torch, bc, A, smi)
    elapsed("serving features")
    launches_group, _ = group_phase(torch, A, smi)
    elapsed("group recovery")
    launches_disagg, launches_watch, _ = disagg_phase(torch, bc, A, smi)
    elapsed("disaggregated serving, hot swaps")
    obs_lm, obs_cnn, _ = obs_phase(torch, bc, A, smi)
    elapsed("observability")
    obs_train, _ = obs_train_phase(torch, bc, A, smi)
    elapsed("training observability")
    guard_fleet, _ = guard_fleet_phase(torch, A, smi)
    elapsed("overload guard and fleet")
    served_rows = {}
    for name in ("pack_rows", "conv_gemm_popcount", "packed_weight_matmul", *LM_KERNELS):
        lm = name in LM_KERNELS
        served_rows[name] = {
            "path": ("LMServingConfig (phase 10's model, 4 requests x 8 tokens) under "
                     "FsdpPartitioner, a (1, 1) data x model MeshPartitioner and "
                     "SequenceParallelPartitioner sp=1 tp=1, and a TP-trained export under TP"
                     if lm else "ServingConfig slices A and B (4 requests) under "
                     "DataParallelPartitioner and a (1, 1) MeshPartitioner with "
                     "conv_model_tp_rules")
                    + " on a world-size-1 NCCL group (bit identical to no group); "
                    f"tp={SERVE_TP} composed in one process",
            "launches": {label: r["launches"].get(name, 0) for label, r in served.items()
                         if label != "no_group" and label.startswith("lm" if lm else "cnn")},
            "no_group_launches": {label: n.get(name, 0)
                                  for label, n in served["no_group"].items()},
        }
        if name in channel_rows:
            served_rows[name]["channel_block"] = channel_rows[name]
        for key, rec in decode_shard_rows.items():
            if key.split()[0] == name:
                served_rows[name]["int8" if key.endswith("int8") else "bf16"] = rec
        if lm and name != "flash_forward":
            # Each run's median decode step wall ms beside the no-group
            # run's, and (slot layout) 20 steps at 1000 rows after it.
            served_rows[name]["decode_step_ms"] = {
                label: [r["decode_step_ms"], r["no_group_decode_step_ms"]]
                for label, r in served.items() if label.startswith("lm") and "decode_step_ms" in r}
            served_rows[name]["decode_step_1000_rows"] = {
                label: [r["step"], r["no_group_step"]]
                for label, r in served.items() if "step" in r}
    sharded_rows = {}
    for name in (*RESID_KERNELS, *LM_TRAIN_KERNELS):
        task = "imagenet" if name in RESID_KERNELS else "lm"
        sharded_rows[name] = {
            "path": f"{task} under FsdpPartitioner and a (1, 1) data x model MeshPartitioner "
                    "on a world-size-1 NCCL group (bit identical to no group); "
                    f"tp={SHARD_TP} composed in one process",
            "launches": {label: r["launches"].get(name, 0) for label, r in sharded.items()
                         if label.startswith(task)},
            "composed_launches": launches_composed.get(name, 0),
            "step_ms": {label: [r["step_ms"], r["no_group_step_ms"]]
                        for label, r in sharded.items() if label.startswith(task)},
        }
        if name in head_rows:
            sharded_rows[name]["head_shard"] = head_rows[name]
    unroll_rows = {}
    for leg in UNROLL_LEGS:
        u = unroll[leg]
        for name, n in u["launches"].items():
            unroll_rows[name] = {
                "path": f"{leg} at unroll {UNROLL}, {UNROLL_STEPS} steps (a warm-up slab, "
                        "then CUDA graph replays)",
                "launches": n, "graphs": u["graphs"],
                "profiler_per_replay": u["profiler_per_replay"].get(name, 0),
                "eager_step_ms": u["eager_step_ms"], "fused_step_ms": u["fused_step_ms"],
                "fused_busy_share": u["fused_busy_share"], "bit_identical": u["bit_identical"],
            }
    # Each kernel's launches over the killed-and-resumed runs (both
    # attempts of each).
    checkpoint_rows = {name: {"path": "TrainImageNet QuickNet-Large, 6 steps killed and "
                                      "resumed: sync, async (write killed), async preempted",
                              **{f"launches_{leg}": launches_ck[f"quicknet {leg}"][name]
                                 for leg in ("sync", "async", "async_preempted")}}
                       for name in RESID_KERNELS}
    checkpoint_rows.update({name: {"path": "DistillImageNet student (one block a section), 6 "
                                           "steps killed at 3 and resumed",
                                   "launches": n} for name, n in launches_ck["recipe"].items()})
    checkpoint_rows.update({name: {"path": "TrainLM 2 layers, 6 steps killed at 3 and resumed",
                                   "launches": n} for name, n in launches_ck["lm"].items()})

    # Each kernel's launches on its main path: K1 and K3 serving slice A,
    # K4 slice B, K2 slice C, K5 slice E, K6-K8 the training step.
    main_slice = {"pack_rows": "A", "conv_gemm_popcount": "A", "packed_weight_matmul": "B",
                  "xnor_matmul_packed_scaled": "C", "xnor_matmul_packed": "E"}
    launches = {name: slices[label][0][name] for name, label in main_slice.items()}
    launches.update(launches_t)
    rows = []
    for name, t in totals.items():
        source, replaces = KERNELS[name]
        least_ms, bound_by = bound_ms(name, t["bytes"], t["ops"])
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"zookeeper_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "ok": True,
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "kernel_ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": least_ms,
            "bound_by": bound_by,
            "library_ms": t["library_ms"],
        })
        if name == "pack_rows":
            # Per forward: its 32 launches at the empty-kernel floor.
            rows[-1]["launch_floor_ms"] = t["launch_floor_ms"]
        # Bi-Real-Net-18's path: K1 and K3 per slice-F forward, K4 per
        # slice-G forward, K6 and K7 per training step (its rows' sums).
        if name in bireal:
            b = bireal[name]
            path = {"pack_rows": "F", "conv_gemm_popcount": "F",
                    "packed_weight_matmul": "G"}.get(name, "training step")
            least, by = bound_ms(name, b["bytes"], b["ops"])
            rows[-1]["bireal"] = {
                "path": path, "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": least,
                "bound_by": by, "library_ms": b["library_ms"],
                "launches": slices[path][0][name] if path in slices else launches_bt[name],
            }
        # The dense zoo: K1 and K3 per slice-L (DenseNet) and slice-N
        # (Melius) forward, K4 per slice-M forward (and per forward of
        # Melius on "xnor", which no slice serves), K1 and K3 per DenseNet
        # training step, K2 per BinaryAlexNet training step (M 128).
        entries = {
            "densenet": ("L" if name != "packed_weight_matmul" else "M", None),
            "melius": ("N" if name != "packed_weight_matmul" else "Melius on xnor, not served",
                       None),
            "xnor_train": ("DenseNet28 training step" if name != "xnor_matmul_packed_scaled"
                           else "BinaryAlexNet training step",
                           launches_at if name == "xnor_matmul_packed_scaled" else launches_dt),
        }
        for entry, (path, step_launches) in entries.items():
            if name not in dense[entry]:
                continue
            d = dense[entry][name]
            least, by = bound_ms(name, d["bytes"], d["ops"])
            rows[-1][entry] = {
                "path": path, "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": least,
                "bound_by": by, "library_ms": d["library_ms"], "max_abs_err": d["max_abs_err"],
                "launches": (step_launches.get(name, 0) if step_launches is not None
                             else slices[path][0].get(name, 0) if path in slices else 0),
            }
        # The recipe: K1 and K3 per distillation step (RealToBinaryNet,
        # batch 128), at the step's 16 conv shapes.
        if name in recipe_kernels:
            r = recipe_kernels[name]
            least, by = bound_ms(name, r["bytes"], r["ops"])
            rows[-1]["recipe"] = {
                "path": "DistillImageNet step (RealToBinaryNet, batch 128)", "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": least, "bound_by": by,
                "library_ms": r["library_ms"], "max_abs_err": r["max_abs_err"],
                "launches": launches_rt[name],
                "step_ms": recipe["step_ms"], "step_busy_share": recipe["device_busy_share"],
            }
        if name in checkpoint_rows:
            rows[-1]["checkpoint"] = checkpoint_rows[name]
        if name in cifar_entries:
            # ConvertPacked's probes, LatencyBench and ServingConfig on the
            # TrainCifar export's packed twins.
            rows[-1]["cifar"] = {"launches": cifar_entries[name]}
        if name in unroll_rows:
            rows[-1]["unroll"] = unroll_rows[name]
        if name in sharded_rows:
            rows[-1]["sharded"] = sharded_rows[name]
        if name in served_rows:
            rows[-1]["served_sharded"] = served_rows[name]
        if name in ("pack_rows", "conv_gemm_popcount"):
            rows[-1]["obs"] = {
                "path": "ServingConfig slice A, 16 requests, observability off and on "
                        "(metrics_port=0, flight recorder)",
                "launches": {label: n[name] for label, n in obs_cnn.items()}}
        if name in launches_watch["watch"]:
            rows[-1]["hot_swap"] = {
                "path": f"ServingConfig(watch=True) on slice {WATCH_SLICE}: "
                        f"{WATCH_REQUESTS} requests, a step swapped in between their halves",
                "launches": launches_watch["watch"][name]}
        if name in RESID_KERNELS:
            rows[-1]["obs_train"] = {
                "path": f"TrainImageNet QuickNet-Large at unroll {UNROLL}, "
                        f"{OBS_TRAIN_CNN_STEPS} steps, observability off and on",
                "launches": {label: obs_train[f"cnn_{label}"][name] for label in ("off", "on")}}
        if name in ("mask_mul_resid", "xnor_matmul_packed_scaled"):
            # K8 has no work on Bi-Real's step; K2 runs in XNORNet's dense stage.
            rows[-1]["zoo_launches"] = (launches_bt[name] if name == "mask_mul_resid"
                                        else slices["I"][0][name])
    # LM kernels, per main-path unit: K9 per prefill dispatch (4 layers)
    # over the slots run's bucket mix; K12 and K13 per decode step (4
    # layers) at a mid-run step of the slots / paged run.
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms")
    flash = dict.fromkeys(keys, 0.0)
    for sb, frac in lm_main["buckets"].items():
        rec = lm_records[("flash_forward",
                          f"[1, {sb}, {LM_HEADS}, {LM_HEAD_DIM}] bfloat16 causal=True")]
        for key in keys:
            flash[key] += LM_LAYERS * frac * rec[key]
    flash["bound_by"] = "operations" if flash["ops_ms"] >= flash["bytes_ms"] else "bytes"
    per_unit = {"flash_forward": flash}
    for name in ("paged_decode_attention", "pool_paged_decode_attention"):
        rec = lm_main[name]
        per_unit[name] = {key: (None if rec[key] is None else LM_LAYERS * rec[key])
                          for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        per_unit[name]["bound_by"] = rec["bound_by"]
        per_unit[name]["host_us"] = rec["host_us"]
    int8 = lm_main["pool_paged_decode_attention int8"]
    for name in LM_KERNELS:
        source, replaces = KERNELS[name]
        t = per_unit[name]
        rows.append({
            "name": name, "route": "cuda", "source": f"zookeeper_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches_lm[name], "ok": True,
            "max_abs_err": lm_err[name], "ms": t["ms"], "kernel_ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
        if name != "flash_forward":
            # The wrapper's host time per launch at that step (not per step).
            rows[-1]["host_us"] = t["host_us"]
        if name == "flash_forward":
            rows[-1]["variant"] = A.flash_forward_variant(torch.bfloat16, LM_HEAD_DIM)
        if name != "flash_forward":
            rows[-1]["variant"] = A.decode_variant(torch.bfloat16, LM_HEAD_DIM)
        if name == "pool_paged_decode_attention":
            # The paged-int8 run's mid-run step, per decode step.
            rows[-1]["int8_ms"] = LM_LAYERS * int8["ms"]
            rows[-1]["int8_bound_ms"] = LM_LAYERS * int8["bound_ms"]
        rows[-1]["served_sharded"] = served_rows[name]
        rows[-1]["features"] = {path: n[name] for path, n in features.items()}
        rows[-1]["disagg"] = {path: n[name] for path, n in launches_disagg.items()}
        if name != "paged_decode_attention":
            rows[-1]["guard_fleet"] = {
                "path": f"LMServingConfig paged behind the overload guard: a {GUARD_REQUESTS}-"
                        f"request poisson_burst at {GUARD_LOADS} x the sustained rate "
                        "(guard); a FleetRouter over 2 worker processes, a 4 x 3 session_mix "
                        "under affinity then the kill leg (a_*), and under round_robin with a "
                        "gray worker (b_*): each worker's own counts",
                "launches": {"guard": guard_fleet["guard"][name],
                             **{label: n[name] for label, n in guard_fleet["fleet"].items()}}}
            rows[-1]["obs"] = {
                "path": "LMServingConfig paged (phase 10's model and stream), built and "
                        "served with observability off and on",
                "launches": {path: n[name] for path, n in obs_lm.items()}}
    # LM training kernels, per training step: 4 launches each (one per
    # layer) at the full-width shape.
    label = "[{}, {}, {}, {}] bfloat16 causal=True".format(*LM_TRAIN_SHAPE)
    library_of = {
        "flash_forward_lse": "SDPA forward",
        "flash_backward_dq": "SDPA backward (fwd+bwd - fwd): dQ, dK, dV together, K10+K11's",
        "flash_backward_dkv": "SDPA backward (fwd+bwd - fwd): dQ, dK, dV together, K10+K11's",
    }
    for name in LM_TRAIN_KERNELS:
        source, replaces = KERNELS[name]
        rec = lm_train_records[(name, label)]
        rows.append({
            "name": name, "route": "cuda", "source": f"zookeeper_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches_lt[name], "ok": True,
            "max_abs_err": lm_train_err[name], "ms": LM_LAYERS * rec["ms"],
            "kernel_ms": LM_LAYERS * rec["ms"], "plain_ms": LM_LAYERS * rec["plain_ms"],
            "bound_ms": LM_LAYERS * rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": LM_LAYERS * rec["library_ms"], "library_of": library_of[name],
        })
        variant_of = (A.flash_forward_variant if name == "flash_forward_lse"
                      else A.flash_backward_variant)
        rows[-1]["variant"] = variant_of(torch.bfloat16, LM_TRAIN_SHAPE[3])
        rows[-1]["checkpoint"] = checkpoint_rows[name]
        rows[-1]["unroll"] = unroll_rows[name]
        rows[-1]["parallel"] = {
            "path": f"TrainLM {PARALLEL_STEPS} steps under SequenceParallelPartitioner sp=1 "
                    f"ring_flash on a world-size-1 NCCL group; the sp={RING_SP} ring composed "
                    "in one process, per layer forward and backward",
            "launches": launches_sp[name], "ring_launches_per_layer": launches_ring[name],
            "ring_shard": ring_rows[name],
        }
        rows[-1]["sharded"] = sharded_rows[name]
        rows[-1]["group"] = {
            "path": f"TrainLM {GROUP_LAYERS} layers at unroll {UNROLL} as host 0 of a 2-host "
                    f"group, drained at step {4 * UNROLL}, restarted and resumed to "
                    f"{GROUP_STEPS}",
            "launches": launches_group[name],
        }
        rows[-1]["obs_train"] = {
            "path": f"TrainLM at full width, {LM_TRAIN_STEPS} steps with async saves, "
                    "observability off and on; the 2-layer NaN halt under run_with_recovery",
            "launches": {label: obs_train[key][name] for label, key in
                         (("off", "lm_off"), ("on", "lm_on"), ("nan_halt", "nan_halt"))}}
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fleet-worker"]:
        fleet_worker_main(sys.argv[2:])
    else:
        main()

#!/usr/bin/env python3
"""Drive the PyTorch port (torchmpi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N]

Phases, each of which fails the run (non-zero exit) if it fails:

1. device: requires CUDA; prints the card; turns TF32 off for matmuls and
   convolutions, so f32 means f32.
2. build: builds every kernel source under torchmpi_tpu_torch/ops/csrc with
   nvcc, one compiler for each source, all started together, and prints
   the build time.
3. kernel: the flash-attention forward kernel (B4) against its plain
   PyTorch version at the training and generate paths' shape (B=1, H=32,
   L=2048, D=128, causal) in bf16 (one bf16 product a product) and f32
   (one split launch for q, k, v, then three bf16 products a product),
   f32 in with bf16 out and bf16 in with f32 out (all timed), plus a
   non-causal bf16 case, an Lk != Lq pair (bf16 in, f32 out and bf16 out,
   both timed) and ragged cases (Lq 100, Lk 300: f32, timed, and bf16
   causal and not), each checked call launching B4 once (and the split
   once for f32 inputs); the split alone is timed (back to back, and its
   device time alone by CUDA-graph replay) and held bit for bit against
   its plain version at the main f32 shape; each record names its design,
   and the timed ones their TFLOP/s; then the backward kernels, dq (B5) and
   dk/dv (B6), against theirs in the same cases plus f32 in with bf16 out,
   each checked call one backward as the model's autograd runs it (bf16:
   one bf16 product a product; f32: one split launch for q, k, v and do,
   shared by both passes, then three bf16 products a product; the two Lk
   != Lq ones, bf16 out and the f32-out ring carry, through
   flash_bwd_block with an external lse and delta), launching each pass
   once (and the split once for f32 inputs); the main cases and the Lk !=
   Lq pair timed pass by pass (an f32 pass alone splits its own inputs),
   the f32 main cases also as one whole backward, and the four-operand
   split alone (back to back, and device-only by CUDA-graph replay, held
   bit for bit against its plain version), each record with its design
   and the timed ones their TFLOP/s.  Each max
   error is printed beside its tolerance, with the kernel's, the plain
   version's and a PyTorch library call's time (scaled_dot_product_attention
   forward, and its backward; a yardstick only, the port never calls it)
   beside the card's bound.  Both kernel phases also hold B4, B5 and B6
   at head size 64 (ViT-B/16's) against their plain versions:
   ``VIT_KERNEL_CASES``, BH = 64 x 12 = 768, L = 256 non-causal, the
   ragged L = 196 and L = 256 causal, each in bf16 and in f32 (split),
   every one timed beside its plain version, SDPA and its bound.
4. generate: make_generate_fn at Llama-3-8B width, bf16 weights from a
   seeded torch.Generator, B=1, a 2048-token prompt, 16 new tokens,
   greedy; the prefill must launch the forward kernel once per layer.  The
   prefill logits through the kernel are held against full attention.
5. serve: ServeEngine over a LlamaRunner at the same width, f32 weights,
   4 slots, max_len 2048, four requests of 37, 300, 700 and 1500 prompt
   tokens and 16 new tokens each, single-stepped through iteration() until
   every request is done; the shortest is held against make_generate_fn.
   Then one f32 prefill of a 2048-token prompt through
   ``llama._prefill(attn="auto")`` on the runner's parameters: B4 and the
   split must launch once per layer each (every B4 launch on f32 inputs),
   and its last-row logits are held against the same prefill through full
   attention (F32_PREFILL_RTOL of their norm); both prefills are timed.
5a. frontend: the serve phase's runner (same width, depth and weights, 4
   slots, max_len 2048) behind HTTP on loopback: a ``ServeEngine`` on its
   own scheduler thread with a private metrics ``Registry`` and
   ``HealthState``, an ``ObsHTTPServer`` and a ``ServeFrontend``.  The
   serve phase's four prompts (37, 300, 700, 1500 tokens, 16 new tokens)
   go in as concurrent ``POST /generate`` calls from client threads: every
   call 200 with 16 tokens, the shortest and the longest equal token for
   token to ``make_generate_fn`` on the runner's parameters, no kernel
   launched (the runner prefills with full attention, as JAX's).  ``GET
   /metrics`` must parse and count as many ``outcome="done"`` requests as
   there were 200s; ``/healthz`` answers 200 ``healthy``; a request over a
   full queue (a second engine, not started, ``max_queue`` 1) answers 503
   ``queue_full`` with ``Retry-After``; ``POST /drain`` makes ``/healthz``
   answer 503 ``draining`` and ``{"resume": true}`` brings back 200.  TTFT
   and latency per request (server side, and the client's wall) are
   printed beside the serve phase's direct-engine numbers.
5b. router: two replicas at full width, ROUTER_LAYERS layers each in f32
   (the cut is printed), each with its own runner (the same seed),
   ``Registry``, ``HealthState``, ``ObsHTTPServer`` and ``ServeFrontend``,
   behind one ``ServeRouter`` that probes their ``/healthz``: 16 keyed
   requests through ``dispatch``, each answered by ``route(key)``'s
   replica, both replicas used and one prompt giving the same tokens on
   either; ``POST /drain`` to replica 1 and a probe send every key to
   replica 0, each answered; a resume and a probe bring the first
   assignment back exactly.  The router's overhead (client wall minus the
   replica's own latency) is printed.  Every server and thread is closed
   at the end of the phase, and the card memory that each of 5a and 5b
   leaves allocated may shrink by no more than SERVE_CYCLE_GB in a
   collection of cyclic garbage: a closed replica frees its weights and KV
   when it is dropped.
6. train: make_train_step at Llama-3-8B width, bf16 weights from a seeded
   torch.Generator, B=1, L=2048, attn="flash", remat="dots",
   loss_chunk=512, plain SGD for 4 steps on one repeated batch of the
   synthetic Markov corpus.  Every loss must be finite and the fourth lower
   than the first; each step must launch dq and dk/dv once per layer and
   the forward as often as the remat mode implies (twice per layer under
   "dots": once in the forward, once when the backward recomputes the
   layer), and no split; step 1's loss is held against full attention's.
   train_f32: the same at the same width with f32 weights (TF32 off), at
   no more than TRAIN_F32_LAYERS layers (f32 parameters and gradients of
   32 layers would not fit the card beside the activations; the cut is
   printed): every B4, B5 and B6 launch on f32 inputs, the split three
   times per layer a step (twice for the forward's q, k, v, once for the
   backward's q, k, v, do).  Step 1's loss is held against full
   attention's at F32_TRAIN_LOSS_RTOL, and before the steps the gradients
   of the attention projections (wq, wk, wv of every layer, which take
   dq, dk and dv from B5 and B6) against full attention's at
   F32_TRAIN_GRAD_RTOL of their norm; peak memory is printed.

7. ring_kernels: the ring allreduce (B1), reduce-scatter (B2) and
   allgather (B3) kernels with p = 2, 3 and 4 ranks spawned on the one
   card (``tools/ring_bench.py``; p = 3, the elastic phase's odd ring,
   without the cases at n = 25,557,032): f32 and bf16 (and int32 for B1
   and B3) at n = 25,557,032, 3,000 and 5 (the reduce-scatter's small n a
   multiple of p), the small sizes again with 64 KiB
   sub-chunks and one staging slot, B1 once more at the 43 ring sizes of a
   ResNet-50 compiled training step (f32, mean, the engine's collective
   ids) and at the 4 bucket sizes of an eager_async step (f32, mean, in
   dispatch order), each rank's result held against its plain version bit
   for bit (all three are one-shot: ``_oneshot_*_plain`` sums each
   element in the ring's order, or for B3 lays every rank's vector out in
   rank order), each kernel's record naming its design; kernel, plain and
   library (gloo on the same tensors) times at n = 25,557,032 in f32 at
   p = 2 and p = 4 with their bound, for the 43 rings of a step and for the
   4 buckets; the public collectives driven once through the selector at
   n = 25,557,032 (the ``collectives`` path); the first call of a ring on a
   new collective id while rank 0's stream is busy, bit for bit (its
   staging must be zeroed before a peer signals); three B1 and three B3
   calls back to back on one id each (both staging slots, then the first
   reused; one input an offset view), each bit for bit; for B1 and for B3
   two forced stalls (a rank that never enters, and one that enters after
   its neighbour gave up) that must raise within their deadline without
   lowering the aborted rank's READY word; last, B1's late stall with the
   rank that gave up tearing down locally first (``release_local``, as a
   survivor of a lost peer does), where the late rank must raise
   ``RingTimeout`` and no ring state may be left after the blocks kept
   for it are freed.
8. train_resnet: ResNet-50 at full width (224x224x3, 1000 classes, f32, TF32
   off) trained data-parallel by AllReduceSGDEngine in ``compiled`` mode
   with ``use_pallas_collectives`` on, 2 ranks spawned on the one card, 32
   images per rank, lr 0.1, 5 steps on one repeated batch of synthetic
   images: every step must launch B1 exactly 43 times on each rank and B2/B3
   never, every ring of step 1 must equal the plain schedule over both
   ranks' gradients (gathered over gloo) bit for bit, the loss must be
   finite and fall from step 1 to step 5, and ``check_with_allreduce`` must
   find the replicas' parameters bitwise equal; then one ``eager_sync`` step
   and an inference-mode evaluation.
9. conv_kernel: the 3x3 convolution kernel (B7) against its plain version
   at the bench's two shapes (``benchmarks/pallas_conv_bench.py``'s
   ``SHAPES``: x (128, 7, 7, 512) with w (3, 3, 512, 512), and x (128, 14,
   14, 256) with w (3, 3, 256, 256)) in bf16 and f32, each error beside its
   tolerance, with the kernel's, the plain version's and ``F.conv2d``'s
   forward and forward+backward times (cuDNN, channels_last, TF32 off; a
   yardstick only) beside the bound, its design (bf16: one bf16 product,
   f32: one split launch for x and w, then three bf16 products) and
   TFLOP/s, the f32 split alone timed (as for B4) and held bit for bit
   against its plain version; then two edge cases in both types, checked
   (the f32 ones timed too): x (3, 5, 9, 72) to 40 channels (off the
   kernel's tiles) and x (2, 6, 7, 13) to 20 (C and Cout not multiples of
   8).  Its path is ``conv3x3`` with the bench's blocks (bn=8, bc=256)
   once at each shape in each type: the counts are set to 0 just before
   each of those checked calls and read just after, and they must launch
   the kernel twice in each type and the split twice.
10. train_resnet_async: ResNet-50 as in phase 8, 2 ranks, 3 steps of
   ``eager_async`` with ``use_pallas_collectives`` on and the ``"ready"``
   drain, then the same 3 steps from the same start with the ``"barrier"``
   drain and in ``eager_sync`` mode, with deterministic cuDNN convolutions
   (whose default algorithms differ from call to call in the last bits of
   a gradient): every bucket's ring in step 1 of the first run must equal
   the plain schedule over both ranks' buckets (gathered over gloo) bit for
   bit, the parameters must be bitwise equal
   across the three runs and across the replicas, and every step must
   launch B1 once per bucket of ``nn.bucketing.plan_ready_order`` (every
   bucket lies above the small-message cutoff) and B2/B3 never; step ms and
   the seconds blocked in handle waits are printed.
11. train_mnist: config 1, the MNIST MLP 784-1024-1024-10 at full width
   (f32, TF32 off), trained by ``examples/mnist_allreduce.py``'s ``run``
   (the example's own entry, through ``import torchmpi_tpu_torch as mpi``)
   on 2 ranks spawned on the one card, global batch 128, lr 0.1, 3 epochs
   of synthetic MNIST (8192 training and 8192 held-out examples), in
   ``compiled`` (through its ``DataPipeline``), ``eager_sync`` and
   ``eager_async``: in every mode the epoch loss must fall by at least 0.2
   and the held-out accuracy exceed 95%; every compiled step must launch B1
   3 times (w0, w1, the tail bucket) and step 1's rings equal the plain
   schedule bit for bit on both ranks; eager_async launches B1 once a step
   (its one bucket) and eager_sync never; the eager modes check the
   replicas every 10 steps and at the end.  Then the compiled run again
   with ``data_pipeline="off"``, which must give the same losses and
   parameters bit for bit, saving at step 40 and 80, and a fresh engine
   resumed from the save at step 40, which must give the continuous run's
   losses and step-80 parameters (bit for bit, or within the printed
   tolerance).  Step ms (median), the rings' ms a step (CUDA events),
   images/s per card and the device stage's wait are printed per mode.
   The example follows ``use_pallas_collectives``; this phase sets it on
   outside ``eager_sync`` before each run.
12. train_mnist_options: config 1 (the MLP at full width, f32, 2 ranks on
   the one card, global batch 128) under the engine's options, five
   compiled runs of OPT_STEPS steps from one start on the same batches:
   (i) Adam with the rings, (ii) the same with ``accum_steps=4``, (iii)
   Adam in GSPMD mode (rings off), (iv) Adam with ``zero1``, (v) SGD in
   GSPMD mode.  The ranks' parameters must be bitwise equal after each
   run, (ii) equal (i) and (iv) equal (iii) within JAX's test tolerances,
   each rank's sharded moments hold half of theirs, and B1 launch 3 times
   a step in (i) and (ii) and never in (iii)-(v); step ms per run.
13. train_resnet_gspmd: phase 8's ResNet-50 (224x224, 1000 classes, f32,
   TF32 off, 32 images per rank, 2 ranks on the one card) for
   GSPMD_STEPS compiled steps with the knob off: batch norm's statistics
   averaged over the ranks, the gradients with one gloo allreduce;
   then one ``update_stats`` fold with ``comm``.  Losses finite, the
   ranks' parameters and running statistics bitwise equal, no ring
   launched; step ms and, by CUDA events, the ms a step in batch norm's
   means and in the gradient allreduce.
14. tester: ``utils/tester.sweep`` at p = 2 on the one card for
   allreduce, reduce-scatter and allgather, 2^8..2^23 f32 elements with
   jitter, through the ring kernels (B1, B2, B3) and through gloo, the
   first size of each checked; a line a size with us, bus GB/s by the
   volume models and the bytes bound.
15. profiler: a ``StepWindowProfiler`` window of two steps of run (i) of
   phase 12 on rank 0, read back by ``print_breakdown`` (device time by
   category and the top kernels).  Phases 12-15 share one spawned pair of
   ranks.
16. train_adam: phase 6's Llama-3-8B width in bf16 under
   ``make_train_step(optimizer=optim.adam(1e-4))`` for ADAM_STEPS steps,
   at as many layers as leave ADAM_HEADROOM_GB of the card free by the
   estimate of ``adam_layers`` (the cut is printed): the loss must fall,
   the moments stay bf16, and each step launch B4, B5 and B6 as phase 6
   does; step ms and peak memory.

17. hierarchy: 4 ranks spawned on the one card (gloo).  Device plane, CUDA
   tensors of integer-valued f32 (every order of summation gives the same
   bits) at config 1's gradient size (1,863,690) and at 2^23, each rank's
   result held bit for bit against the plain result over every rank's
   input (regenerated from its seed): over a cartesian 2x2 split
   (``push_communicator(lambda r: r // 2)``), ``allreduce`` (sum, mean,
   max), ``broadcast`` and ``reduce`` through the ``mpi`` surface at the
   intra level, the inter level and the span (0, 2); over a 3+1 split
   under ``use_tree_communicators``, ``allreduce_tree``,
   ``broadcast_tree``, ``reduce_tree`` (roots 0 and 3) and
   ``allgatherv``; at the world level ``alltoall`` and the three scalar
   forms.  Then with ``use_pallas_collectives`` on and the span at (0, 2)
   over the 2x2 split, one world-level allreduce of 25,557,032 f32
   through ``selector.resolve`` must resolve to the world with no groups
   and launch B1 exactly once on each rank (the counts set to 0 just
   before), bit for bit against its plain version.  Host plane: a
   ``HostCommunicator`` over the 4 ranks and a
   ``HierarchicalHostCommunicator`` over ((0, 1), (2, 3)), wired from
   endpoints gathered over the world group, run config 1's vector copied
   from the card into pinned host memory, f32 and bf16: allreduce,
   broadcast, reduce, allgather, sendreceive, barrier and the flat ring's
   async allreduce, on the device plane's integer-valued random inputs,
   each bit for bit against its plain result on the card; the
   selector's host column (a CPU tensor in a world started on the card)
   on the attached ring; and a pair of ranks whose second never enters,
   whose first must raise ``HostcommTimeout`` within its 1 s deadline.
   The f32 allreduce of config 1's size is timed on the host ring, with
   gloo on the same host tensors and with B1 on the card (yardsticks).

18. mesh: BASELINE config 5's dp x tp x sp through Llama's ``mesh=``
   entry points, ranks spawned on the one card (gloo: every tp sum and
   ring shift stages its wire buffer through the host; the model stays on
   the card).  (i) {sp 2, tp 2}, 4 ranks: Llama-3-8B width cut to
   MESH_LAYERS layers, bf16, B=1, L=4096 (each rank's sp chunk 2048, the
   shape of the B4-B6 rows), remat "dots", loss_chunk 512, MESH_STEPS SGD
   steps at TRAIN_LR under ``attn="ring"`` and under ``"ring-zigzag"``,
   each from the same weights: the first loss within MESH_LOSS_RTOL of the
   one-rank ``make_train_step(attn="flash")`` on the same weights and
   tokens (run in this process after the ranks), a corner of every rank's
   shard of the updated leaves held against the one-rank run's, the sp
   replicas' leaves bit for bit, and every rank's B4/B5/B6 launches a step
   as the ring's schedule predicts (``ring_blocks``; two forwards a layer
   under "dots"); then the tp sum (the f32 wire) and the ring shifts timed
   alone at this path's shapes; every training step's ms in each wire (tp
   sums, ring shifts, the gradients' sync, the loss's tp reductions) is
   clocked (``_WireClock``, each call between CUDA synchronizations) and
   the last step's printed.  (ii) {dp 2, tp 2}, the same 4 ranks:
   Adam (lr 1e-4) with ``zero1=True``, flash on each rank's heads, B=2,
   L=2048, MESH_STEPS steps, against the one-rank Adam step (loss, leaves,
   moments bf16 and half of each rank's shard).  (iii) {tp 2}, 2 ranks:
   ``make_generate_fn(mesh=)`` at ``--layers`` layers (32), bf16, a
   2048-token prompt, 16 greedy tokens, prefill ms and decode ms a token,
   the prefill's last-row logits within MESH_LOGITS_RTOL of the one-rank
   run's (B4 once a layer a call); and at MESH_F32_LAYERS f32 layers the
   greedy tokens equal to the one-rank run's.  The flash kernels' plain
   versions must never run in a rank.

19. moe: Mixtral-8x7B width (``llama.mixtral_8x7b()``: d_model 4096, d_ff
   14336, 8 experts, top-2, vocab 32000), random weights, cut in depth
   only.  (a) At MOE_CHECK_LAYERS layers in f32 with capacity factor 8,
   the dropless decode's greedy tokens equal the teacher-forced argmax.
   (b) ``make_generate_fn`` at MOE_GEN_LAYERS bf16 layers (about 24 GB),
   a 2048-token prompt, 16 greedy tokens: B4 once a layer a call, prefill
   ms and decode ms a token.  (c) ``make_train_step`` at MOE_TRAIN_LAYERS
   bf16 layers, B=1, L=2048, flash, remat "dots", loss_chunk 512, SGD, 4
   steps on one batch: the loss falls, the aux loss at init in (0.5, 2),
   B4 4, B5 2, B6 2 launches a step; step ms and peak memory.  (d) 2
   ranks spawned on the card over {ep 2} (4 experts each): the same steps,
   step 1's loss within MOE_EP_LOSS_RTOL of (c)'s, the ep sums clocked;
   then ``parallel/moe.make_moe_layer`` at the same width, f32, 4096
   tokens a rank, within MOE_LAYER_RTOL of the one-rank layer, its
   all-to-alls clocked.  No plain flash version runs, here or in a rank.
20. parameterserver: config 3, the MNIST MLP on the card, synthetic data.
   ``examples/mnist_parameterserver.py`` in this process with 4 shard
   servers, Downpour then EASGD, 4 epochs of 64 steps: the loss falls
   by 0.2 and the held-out accuracy exceeds 30% (the JAX package's bar
   for these examples), every leaf on cuda, no retry, timeout or CRC
   failure, and Downpour's shards equal, bit for bit, a numpy replay of
   the 'add' rule over every vector pushed; push and pull ms and bytes a
   cycle.  Then ``mnist_parameterserver_easgd_dataparallel`` on 3 ranks
   in DP groups of 2 and 1 (two PS clients; the group checks its replicas
   after every integration) and ``mnist_modelparallel`` on 2 ranks (tp
   2), each converging by the same bar.

21. pipeline: BASELINE config 4 and Llama's pipeline steps over the
   mesh's pp axis, 4 ranks spawned on the one card (every hand-off a gloo
   send and receive through the host, tagged by tick and direction).
   Llama-3-8B width cut to PIPE_LAYERS (4) layers, bf16, random weights
   from PIPE_SEED, one batch of PIPE_BATCH sequences of PIPE_L tokens as
   PIPE_M micro-batches, flash, remat "dots", loss_chunk 512, SGD at
   TRAIN_LR.  Every rank first runs one layer and the loss head on its
   shard (``_pipe_warm``), so that no step pays its cold start.  (a)
   GPipe (``make_pp_train_step``) over {pp 2} on ranks 0 and 1,
   PIPE_GPIPE_STEPS steps: step 1's loss within PIPE_LOSS_RTOL of
   the one-rank ``make_train_step`` on the same weights and batch (run
   here after the ranks), the updated embed, norm and head bit-equal on
   both ranks, B4-B6 launches a rank a step as ``pipe_expected`` predicts;
   the hand-offs and the two broadcasts clocked (``_WireClock``), one
   16.8 MB hop timed alone, the hand-offs' wait beyond their transfers
   over the step beside ``pipeline_stats(2, PIPE_M)``, peak GB.  (b) 1F1B
   (``make_1f1b_train_step``, ``stage_tp="manual"``) over {pp 2, tp 2},
   ``"combined"`` then ``"alternating"`` from the same weights,
   PIPE_1F1B_STEPS steps each: step 1's loss within PIPE_LOSS_RTOL of the
   one-rank step's, the stash's high-water mark within the schedule's
   bound, B4-B6 as predicted; the hand-offs, tp sums, the loss's tp
   reductions and the sums over pp clocked, peak GB.  (c) config 4, the
   port's ``mnist_pipeline`` with its defaults for PIPE_MNIST_EPOCHS
   epochs over {pp 4}, f32: the epoch loss down by 0.2 and the held-out
   accuracy above 30% (the JAX package's bar), every stage leaf on cuda,
   the ranks' losses equal; step ms.  No plain flash version runs in a
   rank.
22. vit: ViT-B/16 (``models/vit.py``) at full width (224x224x3, patch
   16, 1000 classes), random weights from VIT_SEED, images whose labels
   carry a signal.  (a) bf16 inference at batch 64 through B4 (12
   launches a forward) with 60 registers (N = 256) and with none (N =
   196), the logits held against ``attn="full"`` at VIT_LOGITS_RTOL of
   their norm, both timed.  (b) ``benchmarks/vit_bench.py``'s step: bf16,
   batch 64, 60 registers, flash, SGD at lr 1e-3, 4 steps on one batch
   under remat "none" (B4, B5, B6 12 a step each) and again under "dots"
   (B4 24): losses finite and falling, step 1's loss and the wqkv
   gradients first held against full attention; step ms and peak GB.
   (c) f32 (TF32 off) data-parallel training through
   ``AllReduceSGDEngine`` in ``compiled`` mode with
   ``use_pallas_collectives`` on, 2 ranks spawned on the card, 32 images a
   rank, flash, remat "dots", VIT_DP_STEPS steps: B1 as many times a step
   as ``engine.sgdengine.ring_plan`` plans rings for ViT-B/16's leaves, B2
   and B3 never, B4 24, B5 12, B6 12 and the split 36 a step on f32
   inputs; the loss falls, step 1's within 1e-4 of full attention's, and
   ``check_with_allreduce`` finds the replicas bitwise equal.  (d) the
   bf16 forward on {tp 2} in the same ranks (wqkv cut by heads), each
   rank's logits within VIT_TP_RTOL of the one-rank forward's, B4 12
   launches a rank.
23. elastic: failure and membership (``tools/elastic_drill.py``): six
   processes spawned on the card run config 1 (the MLP at full width,
   f32, global batch 128, 126 at p = 3, ``compiled``,
   ``use_pallas_collectives`` on, so three B1 rings a step) through four
   legs.  (a) ``mnist_elastic``'s
   flow on 4 ranks, a checkpoint every 10 steps, an injected fault at
   step 20 on every rank, restored and re-formed on 2: resumed at step
   11, the loss finite and falling, the replicas bit-equal and equal to a
   2-rank run started alone from the same checkpoint.  (b) 4 ranks under
   ``run_elastic`` with heartbeat monitors; one non-leader SIGKILLs itself
   mid-training: the survivors' B1 rings give up (``RingTimeout``,
   recoverable) within ``RING_TIMEOUT_S`` plus 5 s, they tear down with no
   barrier on the dead, re-form at p = 3 from the agreed checkpoint (the
   first step's three rings bit-equal to B1's plain version over the
   three ranks' gradients), the loss finite and falling, and end
   bit-equal, each one's card memory within 0.25 GB of before.  (c) a
   2-rank loop under ``ResizeController`` and the engine's step boundary:
   a grow whose ship crosses a blackholing ``ChaosProxy`` aborts (epoch
   unchanged, the old ring training on), a retry grows to 4 (two joiners
   put the shipped parameters on their cards), a drain leaves 3; the
   probe loss of the parameters equal to the bit before and after each
   commit on every member.  (d) a planned ``handoff`` evicts rank 0; the
   new leader grows a rank in, then dies by SIGKILL inside a drain's
   window: the two survivors fail over over ``/healthz`` (one epoch claim,
   one resolved verdict, "aborted") and train on at p = 2; ``POST
   /resize`` to the non-leader answers a 307 naming the new leader.  B1
   runs 3 times a step at p = 4, 3 and 2; ``obs/rca.analyze`` over the
   journals names ``aborted_resize`` and ``leader_failover``.  The kill
   seconds, restart seconds and ``scale.pause_ms`` are printed.
24. mfu (run after vit): ``utils/tester.mfu_sweep`` on Llama-3-8B, all
   MFU_LAYERS (32) layers, bf16, flash, L = 2048, batch 1 and 2 under
   remat "none" and "dots", ``tester.sweep_batch``'s tokens, one warmup
   step (the FLOP probe's) and 3 timed: each cell's ms, TFLOP/s, MFU, peak
   GB and the LM head's share of its FLOPs printed; its B4-B6 launches as
   ``_mfu_expected`` predicts (B4 1 or 2 a layer a step, B5 and B6 1);
   the probe's flash share equal to the closed formula
   (``ops/flash_attention.attention_flops``), its step FLOPs within
   MFU_FLOPS_RTOL of 6 x matmul parameters x tokens plus that formula,
   and its first loss within MFU_LOSS_RTOL of full attention's on the
   same parameters and tokens.  The kernel phases hold B4-B6 at its
   batch-2 shape (``mfu_bf16``: BH = 64, L = 2048, causal).
25. numerics (after elastic): the numerics plane on config 1
   (``tools/numerics_drill.py``): four ranks spawned on the card, the MLP
   at full width, f32, global batch 128, ``compiled`` through B1 with
   ``obs_http`` on and an ``Auditor`` over a host ring.  The same seeds
   with ``numerics_mode`` "off" and "audit" (interval 2): parameters
   bit-equal, B1 launches equal (3 a step); every step's sentinels within
   1e-5 relative (plus 1e-6) of a float64 recomputation from every rank's
   gathered gradients.  One ulp on one element of rank 2's ``w1``: the
   next audit names ``['w1']`` and rank 2 on every rank, rank 2's
   ``/healthz`` answers 503 ``diverged``, ``tmpi_numerics_divergence_total``
   moves, a flight bundle holds the leaf, ``cluster.job_view`` over the
   four endpoints reads ``diverged`` at rank 2 and ``cluster.federate``
   labels every sample with its rank; a clean audit clears it.  A NaN in
   one rank's batch is counted on that step by every rank's sentinels.
   ``tmpi_step_flops`` equals the MLP step's analytic count and
   ``tmpi_mfu_estimate`` is published; the sentinels' cost a step and the
   audit's ms are printed.
26. autotune (after numerics): the measured collective autotuner on 2
   ranks of the card.  The eager pass (``collectives/autotune.run_pass``)
   over the five ops at AUTOTUNE_SIZES (2^14 to 2^23 f32 elements, so
   that ResNet-50's 32 MiB and 8 MiB buckets have exact cells), the ring
   kernels (B1-B3) against gloo where both are candidates: every cell's
   ms per candidate and its winner, the document identical on both ranks,
   B1-B3 launched in the pass, and every candidate of every cell bit-equal
   to the plain result.  ResNet-50 (224x224, 1000 classes, f32, 32 images
   a rank, ``eager_async``) AUTOTUNE_RESNET_STEPS steps under
   ``autotune_mode="off"`` and again under ``"cache"`` from one start: the
   losses and parameters bit-equal, the namespace each bucket rode (the
   ``autotune.decision`` marks), both step times and B1's launches.
   ``bench_section``'s A/B (``default_ms``, ``autotuned_ms``), and a pass
   on the host column (hostcomm, gloo and the ring's plain form over a
   host ring) at config 1's 1,863,690 elements (7.45 MB).
27. retune: ``tools/retune_drill.py`` on 4 ranks of the card: a chaos
   straggler sags config 1's step rate, ``step_rate_sag`` fires, the
   agreeing controllers probe and apply the same flips at one boundary
   (``retune.pause_ms`` printed: the controller's default eager pass,
   the ops with a choice of namespace, under 6 s, the rest of the pause
   under 250 ms; ``retune.ab.ratio``
   printed); a seeded wrong
   winner flips back on ``autotune_mix_drift``; the compiled pass times
   both wire variants of both default programs at Llama-3-8B width cut to
   2 layers (bf16, flash: B4-B6 launched), each variant's first loss
   within 1e-2 of full attention's on the same weights and tokens (the
   kernel phases hold B4-B6 at its shape, ``compiled_bf16``: BH = 32,
   L = 512, causal); ``perf_retune`` is named from the journals alone.  Both phases print the card's name and power limit
   beside their numbers.

Then a ``timing`` line with each phase's seconds (the build included, the
imports before it not) and the card memory each left allocated (before
and after a collection of cyclic garbage), a line with the card's name and power limit, a
``kernels`` JSON line, and last ``{"ok": true, "device": {...}}``.  ``--layers`` cuts the depth of
phases 4-6 to no fewer than 8 layers (never the width), and train_f32 to
no more than that; a cut is printed.
Exits non-zero and prints no result when no GPU is visible.  Every process
the run starts has ended when it exits, multiprocessing's resource tracker
included.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# name -> (source, the TPU kernel it replaces, its function there, the
# PyTorch call timed as library_ms)
SDPA_BWD = "scaled_dot_product_attention backward (dq, dk and dv in one call)"
KERNELS = {
    "flash_attention_fwd": (
        "torchmpi_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "torchmpi_tpu/ops/flash_attention.py:36", "_attn_kernel",
        "scaled_dot_product_attention forward"),
    "flash_attention_bwd_dq": (
        "torchmpi_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "torchmpi_tpu/ops/flash_attention.py:140", "_attn_bwd_dq_kernel",
        SDPA_BWD),
    "flash_attention_bwd_dkv": (
        "torchmpi_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "torchmpi_tpu/ops/flash_attention.py:183", "_attn_bwd_dkv_kernel",
        SDPA_BWD),
}
# B4-B6 at head size 64, ViT-B/16's (d_model 768 over 12 heads), in the
# kernel phases: (base name, BH, Lq, Lk, causal), each in bf16 and in f32
# (split), named f"{base}_{dtype}".  BH = 64 images x 12 heads; L = 196
# patches + 60 registers = 256, the ragged 196 of the 0-register path (one
# block, the kernels' tail masked), and the causal mask at D = 64.
VIT_KERNEL_CASES = [("vit", 768, 256, 256, False),
                    ("vit_ragged", 768, 196, 196, False),
                    ("vit_causal", 768, 256, 256, True)]
VIT_BASES = {case[0] for case in VIT_KERNEL_CASES}
VIT_CASES = tuple(f"{case[0]}_{dt}" for case in VIT_KERNEL_CASES
                  for dt in ("bfloat16", "float32"))
VIT_PATHS = ("vit_inference", "vit_train", "vit_dp", "vit_tp")


def head_dim(case: str) -> int:
    """A kernel-phase case's head size: 64 for the ViT cases, else 128."""
    return 64 if case.startswith("vit") else 128


# The training phases: SGD learning rate, and forward launches per layer and
# step that each remat mode implies (a checkpointed layer runs its forward
# again in the backward).  At 1.0 plain SGD overshoots at this width: at 8
# layers the loss read 12.26, 11.91, 10.81, 12.60, and the JAX reference
# follows the port's trajectory step for step, the overshoot included,
# from the same converted weights (at a narrower MLP, on the CPU).  At 0.25
# it fell at every step at 8, 16, 24 and 32 layers in bf16 and at 8 and
# 16 in f32, and at 8 layers further than at 0.5, where the sharpest
# directions already overshoot.
TRAIN_LR = 0.25
TRAIN_REMAT = "dots"
FWD_PER_LAYER = {"none": 1, "dots": 2, "full": 2}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
# Dense peak rates by input type (H100 SXM data sheet).  A bound is the
# least time the card needs for the work, whatever implements it; the least
# time for f32-accurate products on this card is three bf16 products (A_hi
# B_hi + A_hi B_lo + A_lo B_hi) at the 989 TFLOP/s dense bf16 tensor-core
# rate, so f32 rows are bounded at 989e12 / 3 operations a second (the
# CUDA cores' f32 FMAs reach 67e12), whatever their kernel runs on.
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 989e12 / 3}
BOUND_RATE = {"bfloat16": "989e12 operations/s: dense bf16 tensor cores",
              "float32": "989e12 / 3 operations/s: an f32-accurate product "
                         "as three bf16 products on the tensor cores"}


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


# The ring kernels: name -> (source, the TPU kernel it replaces, its
# function there, the cuda_ring counter, the library call timed beside it).
RING_SRC = "torchmpi_tpu_torch/ops/csrc/ring.cu"
RING_KERNELS = {
    "ring_allreduce": ("torchmpi_tpu/collectives/pallas_ring.py:194",
                       "_ar_kernel", "allreduce",
                       "torch.distributed.all_reduce (gloo)"),
    "ring_reduce_scatter": ("torchmpi_tpu/collectives/pallas_ring.py:165",
                            "_rs_kernel", "reduce_scatter",
                            "torch.distributed.all_reduce (gloo) and a slice"),
    "ring_allgather": ("torchmpi_tpu/collectives/pallas_ring.py:241",
                       "_ag_kernel", "allgather",
                       "torch.distributed.all_gather (gloo, via the host)"),
}
RESNET_STEPS, RESNET_BATCH, RESNET_LR, RESNET_RINGS = 5, 32, 0.1, 43
# Each ring kernel's design on one card (ops/csrc/ring.cu): the ranks'
# contexts are time-sliced, so nothing spins on a peer (tools/ring_probe.py)
# and the orders across processes are stream waits on monotone flag words.
STAGE_WAIT = ("one-shot: a STAGE kernel (this rank's input into its own "
              "cudaIpc slot, then an add to every peer's READY word), one "
              "cuStreamWaitValue64, ")
ONESHOT = STAGE_WAIT + ("a REDUCE kernel (every rank's slot, in the ring's "
                        "order, into the output)")
RING_DESIGN = {
    "ring_allreduce": ONESHOT,
    "ring_reduce_scatter": ONESHOT,
    "ring_allgather": STAGE_WAIT + ("a GATHER kernel (rank r's slot into row "
                                    "r of the output, for every r)"),
}
KIND_KERNEL = {kind: name for name, (_, _, kind, _) in RING_KERNELS.items()}

# The convolution kernel (B7): the bench's two shapes (x NHWC, Cout) and
# blocks, the TPU kernel it replaces and the library call timed beside it.
CONV_SRC = "torchmpi_tpu_torch/ops/csrc/conv3x3.cu"
CONV_REPLACES = ("benchmarks/pallas_conv_bench.py:52", "_conv_kernel")
CONV_SHAPES = [("7x7x512", (128, 7, 7, 512), 512),
               ("14x14x256", (128, 14, 14, 256), 256)]
CONV_BN, CONV_BC = 8, 256
# Edge cases of B7, checked against the plain version and not timed: off
# the bf16 kernel's 128 x 128 tile and 64-channel chunk (N*H*W, C and Cout),
# and a C and Cout that are not multiples of 8 (masked element loads).
# (name, x NHWC, Cout, bn, bc.)
CONV_EDGE_CASES = [("edge_3x5x9x72_to_40", (3, 5, 9, 72), 40, 1, 40),
                   ("edge_c13_to_20", (2, 6, 7, 13), 20, 1, 20)]
CONV_LIBRARY = ("torch.nn.functional.conv2d (cuDNN, channels_last, TF32 "
                "off), forward")
RESNET_ASYNC_STEPS = 3
RESNET_ASYNC_RUNS = (("eager_async-ready", "eager_async", "ready"),
                     ("eager_async-barrier", "eager_async", "barrier"),
                     ("eager_sync", "eager_sync", "ready"))

# The train_mnist phase (config 1): the MNIST MLP 784-1024-1024-10 at full
# width, f32, global batch 128 over 2 ranks, lr 0.1, 3 epochs of synthetic
# MNIST (8192 examples, 8192 held out), as examples/mnist_allreduce.py runs
# it.  B1 launches a step by mode: compiled rings w0 and w1 alone and the
# other four leaves in one tail bucket; eager_async rings its one bucket;
# eager_sync goes through gloo.  The bars are tests/test_examples.py's for
# synthetic data.  Resume: saved at MNIST_SAVE_AT, resumed to
# MNIST_RESUME_TO in a fresh engine.
MNIST_MODES = ("compiled", "eager_sync", "eager_async")
MNIST_EPOCHS, MNIST_BATCH, MNIST_LR = 3, 128, 0.1
MNIST_RINGS = {"compiled": 3, "eager_sync": 0, "eager_async": 1}
MNIST_MIN_LOSS_DROP, MNIST_MIN_ACCURACY = 0.2, 0.95
MNIST_SAVE_AT, MNIST_RESUME_TO = 40, 80
# Relative to a leaf's largest magnitude, if a resumed run is not bitwise
# equal (another cuBLAS algorithm in the fresh engine).
MNIST_RESUME_RTOL = 1e-6

# What each kernel runs on, by input dtype (the sources dispatch on it).
F32_SPLIT = "wgmma, three bf16 products"
DESIGN = {
    "flash_attention_fwd": {"bfloat16": "wgmma bf16→f32",
                            "float32": F32_SPLIT},
    "flash_attention_bwd_dq": {"bfloat16": "wgmma bf16→f32",
                               "float32": F32_SPLIT},
    "flash_attention_bwd_dkv": {"bfloat16": "wgmma bf16→f32",
                                "float32": F32_SPLIT},
    "conv3x3": {"bfloat16": "wgmma bf16→f32", "float32": F32_SPLIT},
}
# The f32 prefill of the serve phase: prompt length, and its last-row
# logits' tolerance against the same prefill through full attention, as a
# share of their norm.  Both sides are f32; B4 with f32 inputs is held at
# 2e-4 abs against its plain version on unit-scale inputs (its three bf16
# products miss an f32 product by ~2^-16 relative), so each layer's
# attention output moves by ~1e-5 of its scale, and 32 residual layers of
# random weights leave the logits well inside 1e-3 of their norm; a kernel
# fault (a wrong tile, a lost lo part) moves them by far more.
F32_PREFILL_LEN = 2048
F32_PREFILL_RTOL = 1e-3
# The f32 train phase: its largest depth (f32 parameters 0.872 GB a layer
# plus 4.2 GB of embedding and head, gradients as much again, and the
# "dots" activations: about 43 GB at 16 layers, 76 GB at 32), and its
# tolerances against full attention.  Both sides are f32; B4's three bf16
# products move each layer's attention output by ~1e-5 of its scale (the
# f32 prefill's logits: 1.6e-5 of their norm at 32 layers), so the mean
# NLL moves by far less than 1e-4 of itself; B5 and B6 hold 5e-4 abs +
# 1e-3 rel against their plain versions on unit-scale inputs (~2^-16
# relative a product), so the projections' gradients stay well inside
# 1e-3 of their norm, where a bf16-level fault (2^-9) would not.
TRAIN_F32_LAYERS = 16
F32_TRAIN_LOSS_RTOL = 1e-4
F32_TRAIN_GRAD_RTOL = 1e-3

COUNTERS = {"flash_attention_fwd": "flash_fwd_launches",
            "flash_attention_bwd_dq": "flash_bwd_dq_launches",
            "flash_attention_bwd_dkv": "flash_bwd_dkv_launches"}


def reset_counts(fa) -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    for attr in COUNTERS.values():
        setattr(fa, attr, 0)


def read_counts(fa) -> dict:
    """Every kernel's launch count, by kernel name."""
    return {name: getattr(fa, attr) for name, attr in COUNTERS.items()}


def cuda_ms(torch, fn, warmup: int = 2, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 10) -> float:
    """Device time of ``fn`` alone: ``iters`` calls captured in one CUDA
    graph, whose replay is timed with CUDA events, so no host dispatch is
    counted (``cuda_ms`` times back-to-back calls, which for a short
    kernel may read the host's pace instead)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def attention_flops(bh, lq, lk, d, causal, part) -> float:
    """The package's closed formula for one attention call's FLOPs over
    the (q, k) pairs the mask keeps (``ops/flash_attention.attention_flops``,
    the one the step FLOP probe credits): ``part`` "fwd", "dq" or "dkv"."""
    from torchmpi_tpu_torch.ops.flash_attention import (
        attention_flops as flops)

    return flops(bh, lq, lk, d, causal, part)


def bound_ms(ops: float, nbytes: float, in_dtype: str):
    """The larger of ops over the input type's peak and bytes over the HBM
    rate, with the one that bounds."""
    t_ops = ops / PEAK_OPS_PER_S[in_dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def attention_bound_ms(bh, lq, lk, d, causal, in_dtype, in_bytes, out_bytes):
    """Least time for the attention forward on this card: the larger of its
    bytes (q, k, v read once, o and lse written once) over HBM rate and its
    multiply-adds (the (q, k) pairs this causal mask keeps) over the peak
    rate of the input type."""
    ops = attention_flops(bh, lq, lk, d, causal, "fwd")   # q.k and p.v
    nbytes = bh * (lq * d * in_bytes + 2 * lk * d * in_bytes
                   + lq * d * out_bytes + lq * 4)
    return bound_ms(ops, nbytes, in_dtype)


def attention_tflops(bh, lq, lk, d, causal, ms):
    """The forward's rate: its multiply-adds over the kept (q, k) pairs
    (q.k and p.v) in TFLOP/s at ``ms`` a call."""
    return attention_flops(bh, lq, lk, d, causal, "fwd") / ms / 1e9


def attention_bwd_bound_ms(kernel, bh, lq, lk, d, causal, in_dtype, in_bytes,
                           out_bytes):
    """Least time for one backward pass: ``"dq"`` does three products over
    the kept pairs (s, dp, dq) and writes dq; ``"dkv"`` four (s, dp, dv,
    dk) and writes dk and dv.  Both read q, k, v, do once and lse and
    delta (f32) once."""
    out_rows = {"dq": lq, "dkv": 2 * lk}[kernel]
    ops = attention_flops(bh, lq, lk, d, causal, kernel)
    nbytes = bh * ((2 * lq + 2 * lk) * d * in_bytes + 2 * lq * 4
                   + out_rows * d * out_bytes)
    return bound_ms(ops, nbytes, in_dtype)


def attention_bwd_tflops(kernel, bh, lq, lk, d, causal, ms):
    """A backward pass's rate: its products over the kept pairs (three for
    ``"dq"``, four for ``"dkv"``) in TFLOP/s at ``ms`` a call."""
    return attention_flops(bh, lq, lk, d, causal, kernel) / ms / 1e9


def conv_bound_ms(n, h, w, c, cout, in_dtype, esize):
    """Least time for the 3x3 convolution on this card: its multiply-adds
    (2 N H W 9 C Cout) over the input type's peak against x and w read once
    and the output written once."""
    ops = 2.0 * n * h * w * 9 * c * cout
    nbytes = (n * h * w * c + 9 * c * cout + n * h * w * cout) * esize
    return bound_ms(ops, nbytes, in_dtype)


def conv_atol(dtype: str, scale: float) -> float:
    """B7's tolerance at an output of largest magnitude ``scale``.  f32:
    the same f32 products (three bf16 products for each, in the kernel)
    summed in another order, 1e-5 of the scale.  bf16: both sides sum in
    f32 and round once, so at most one bf16 ulp at the output's scale."""
    if dtype == "float32":
        return 1e-5 * scale
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def phase_conv_kernel(torch, conv, split):
    """B7 against its plain version at the bench's two shapes in bf16 and
    f32, timed beside F.conv2d, then the edge cases in both types (f32
    timed too), with the counts (B7's and the split's) set to 0 just before
    each checked call and read just after.  Returns the records and the
    path's launches by dtype (the checked calls at the bench's shapes)."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(3)
    recs = {}

    def checked(name, xshape, cout, bn, bc, dtype, extra):
        n, h, w_, c = xshape
        dt = getattr(torch, dtype)
        x = torch.randn(xshape, generator=g, device="cuda").to(dt)
        w = (torch.randn((3, 3, c, cout), generator=g, device="cuda")
             / math.sqrt(9 * c)).to(dt)
        with torch.no_grad():
            conv.conv3x3_launches = split.bf16_split_launches = 0
            got = conv.conv3x3(x, w, bn=bn, bc=bc)
            torch.cuda.synchronize()
            launched = conv.conv3x3_launches
            split_launched = split.bf16_split_launches
            want = conv.conv3x3_plain(x, w)
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        rec = {"case": f"{name}_{dtype}", "x": list(xshape),
               "w": [3, 3, c, cout], "bn": bn, "bc": bc, "dtype": dtype,
               "max_abs_err": err, "atol": conv_atol(dtype, scale),
               "out_scale": scale,
               "finite": bool(torch.isfinite(got.float()).all()),
               "launches": launched, "split_launches": split_launched,
               "design": DESIGN["conv3x3"][dtype],
               **(extra(x, w, want) if extra else {})}
        emit(phase="conv_kernel", **rec)
        if not (err <= rec["atol"] and rec["finite"] and launched == 1
                and split_launched == (dtype == "float32")
                and got.dtype == dt):
            raise AssertionError(f"conv3x3 kernel disagrees with its plain "
                                 f"version: {rec}")
        recs[rec["case"]] = rec

    def timing(xshape, cout, bn, bc):
        n, h, w_, c = xshape

        def extra(x, w, want):
            # F.conv2d on the same memory: x NHWC is NCHW channels_last.
            xc = x.permute(0, 3, 1, 2)
            wc = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            xg = xc.detach().requires_grad_(True)
            wg = wc.detach().requires_grad_(True)
            gout = torch.randn((n, cout, h, w_), generator=g,
                               device="cuda").to(x.dtype).contiguous(
                                   memory_format=torch.channels_last)

            def fwd_bwd():
                out = F.conv2d(xg, wg, padding=1)
                return torch.autograd.grad(out, (xg, wg), gout)

            dtype = str(x.dtype).split(".")[-1]
            with torch.no_grad():
                kernel_ms = cuda_ms(torch, lambda: conv.conv3x3(
                    x, w, bn=bn, bc=bc))
                plain_ms = cuda_ms(torch, lambda: conv.conv3x3_plain(x, w))
                library_ms = cuda_ms(torch, lambda: F.conv2d(xc, wc,
                                                             padding=1))
                lib_err = float((F.conv2d(xc, wc, padding=1).permute(
                    0, 2, 3, 1).float() - want.float()).abs().max())
                more = {}
                if dtype == "float32":
                    more["split_ms"] = cuda_ms(
                        torch, lambda: split.bf16_split("conv3x3", x, w))
                    more["split_device_ms"] = graph_ms(
                        torch, lambda: split.bf16_split("conv3x3", x, w))
                    bufs = split.bf16_split("conv3x3", x, w)
                    more["split_bitwise_equal"] = all(
                        torch.equal(b, split.bf16_split_plain(t))
                        for b, t in zip(bufs, (x, w)))
                    del bufs
            bound, bound_by = conv_bound_ms(n, h, w_, c, cout, dtype,
                                            x.element_size())
            return {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms,
                    "library_fwd_bwd_ms": cuda_ms(torch, fwd_bwd),
                    "library_max_abs_err": lib_err, "bound_ms": bound,
                    "bound_by": bound_by, "bound_rate": BOUND_RATE[dtype],
                    "kernel_tflops": 2.0 * n * h * w_ * 9 * c * cout
                    / kernel_ms / 1e9, **more}
        return extra

    for name, xshape, cout in CONV_SHAPES:
        for dtype in ("bfloat16", "float32"):
            checked(name, xshape, cout, CONV_BN, CONV_BC, dtype,
                    timing(xshape, cout, CONV_BN, CONV_BC))
    # The edge cases, the f32 ones timed as well.
    for name, xshape, cout, bn, bc in CONV_EDGE_CASES:
        for dtype in ("bfloat16", "float32"):
            checked(name, xshape, cout, bn, bc, dtype,
                    timing(xshape, cout, bn, bc) if dtype == "float32"
                    else None)
    bad = [r for r in recs.values() if r.get("split_bitwise_equal") is False]
    if bad:
        raise AssertionError(f"the split kernel disagrees with its plain "
                             f"version: {bad}")
    torch.cuda.empty_cache()
    # The path: the op as the bench calls it (bn=8, bc=256), once at each
    # shape in each type; its launches are those of the checked calls above.
    launches = {dtype: sum(recs[f"{shape}_{dtype}"]["launches"]
                           for shape, _, _ in CONV_SHAPES)
                for dtype in ("bfloat16", "float32")}
    split_launches = sum(recs[f"{shape}_float32"]["split_launches"]
                         for shape, _, _ in CONV_SHAPES)
    emit(phase="conv_kernel", path="conv3x3", launches=launches,
         split_launches=split_launches,
         shapes=[s for s, _, _ in CONV_SHAPES], bn=CONV_BN, bc=CONV_BC)
    if launches != dict.fromkeys(launches, len(CONV_SHAPES)) \
            or split_launches != len(CONV_SHAPES):
        raise AssertionError(f"the conv3x3 path launched the kernel "
                             f"{launches} and the split {split_launches} "
                             f"times, expected {len(CONV_SHAPES)} each")
    return recs, launches


def phase_kernel(torch, fa, split):
    """B4 against its plain version, the counts (B4's and the split's) set
    to 0 just before each checked call and read just after; returns the
    records by case."""
    g = torch.Generator(device="cuda").manual_seed(0)
    # (name, BH, Lq, Lk, causal, in dtype, out dtype, o atol, o rtol).
    # f32: same f32 products, different summation order: 2e-4 abs.
    # bf16 out: both sides compute in f32 and round once to bf16, where a
    # last-place flip is 2^-7 relative: 1e-2 abs + 1e-2 rel.
    # lse is f32 on both sides, log of a sum of <= 2048 terms: 1e-3 abs.
    # bf16 inputs: the bf16 P moves a bf16 o by at most 2^-9 of
    # sum p|v| / l, inside the bf16 tolerance; with an f32 output the
    # kernel forms P V as P_hi V + P_lo V and holds the f32 2e-4.  f32
    # inputs: one split launch for q, k and v, then three bf16 products for
    # each product, which hold the f32 2e-4 (and the bf16 tolerance for a
    # bf16 output).  The main shape in every type pair, the lk_ne_lq pair
    # (f32 out against bf16 out) and ragged_f32 are timed.
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("main_bf16", 32, 2048, 2048, True, bf16, None, 1e-2, 1e-2),
        ("main_f32", 32, 2048, 2048, True, f32, None, 2e-4, 0.0),
        ("main_f32_bf16out", 32, 2048, 2048, True, f32, bf16, 1e-2, 1e-2),
        ("main_bf16_f32out", 32, 2048, 2048, True, bf16, f32, 2e-4, 0.0),
        # The mfu phase's batch-2 shape: 2 x 32 heads.
        ("mfu_bf16", 64, 2048, 2048, True, bf16, None, 1e-2, 1e-2),
        # The retune drill's compiled leg: L 512, 2 x 16 heads a rank over
        # {dp 2, tp 2} (16 over 1F1B's {pp 2, tp 2}, the same kernel).
        ("compiled_bf16", 32, 512, 512, True, bf16, None, 1e-2, 1e-2),
        ("noncausal_bf16", 8, 1024, 1024, False, bf16, None, 1e-2, 1e-2),
        ("lk_ne_lq_f32out", 32, 512, 2048, True, bf16, f32, 2e-4, 0.0),
        ("lk_ne_lq_bf16", 32, 512, 2048, True, bf16, None, 1e-2, 1e-2),
        ("ragged_f32", 4, 100, 300, False, f32, None, 2e-4, 0.0),
        ("ragged_bf16", 4, 100, 300, False, bf16, None, 1e-2, 1e-2),
        ("ragged_bf16_causal", 4, 100, 300, True, bf16, None, 1e-2, 1e-2),
    ] + [(name, bh, lq, lk, causal, dt, None, *tol)
         for name, bh, lq, lk, causal in VIT_KERNEL_CASES
         for dt, tol in ((bf16, (1e-2, 1e-2)), (f32, (2e-4, 0.0)))]
    timed = ("main_bf16", "main_f32", "main_f32_bf16out", "main_bf16_f32out",
             "lk_ne_lq_f32out", "lk_ne_lq_bf16", "ragged_f32", *VIT_CASES)
    with_library = ("main_bf16", "main_f32", "main_f32_bf16out",
                    "ragged_f32", *VIT_CASES)
    records = {}
    for name, bh, lq, lk, causal, dt, odt, atol, rtol in cases:
        if name in VIT_BASES:
            name = f"{name}_{str(dt).split('.')[-1]}"
        d = head_dim(name)
        q = torch.randn((bh, lq, d), generator=g, device="cuda").to(dt)
        k = torch.randn((bh, lk, d), generator=g, device="cuda").to(dt)
        v = torch.randn((bh, lk, d), generator=g, device="cuda").to(dt)
        odt = odt or dt
        bq, bk = fa._resolve_blocks(lq, lk, None, None)
        scale = 1.0 / math.sqrt(d)

        def kern():
            return fa._flash_bh_kernel(q, k, v, causal=causal, scale=scale,
                                       out_dtype=odt)

        def plain():
            return fa._flash_bh_plain(q, k, v, causal=causal, block_q=bq,
                                      block_k=bk, scale=scale, out_dtype=odt)

        fa.flash_fwd_launches = split.bf16_split_launches = 0
        o, lse = kern()
        torch.cuda.synchronize()
        launched = fa.flash_fwd_launches
        split_launched = split.bf16_split_launches
        po, plse = plain()
        diff = (o.float() - po.float()).abs()
        o_err = float(diff.max())
        o_ok = bool((diff <= atol + rtol * po.float().abs()).all())
        lse_err = float((lse - plse).abs().max())
        finite = bool(torch.isfinite(o.float()).all()
                      and torch.isfinite(lse).all())
        dtype = str(dt).split(".")[-1]
        rec = {"case": name, "bh": bh, "lq": lq, "lk": lk, "d": d,
               "causal": causal,
               "dtype": dtype, "out_dtype": str(odt).split(".")[-1],
               "o_max_abs_err": o_err, "o_atol": atol, "o_rtol": rtol,
               "lse_max_abs_err": lse_err, "lse_atol": 1e-3,
               "finite": finite, "launches": launched,
               "split_launches": split_launched,
               "design": DESIGN["flash_attention_fwd"][dtype]
               + (", P V as P_hi V + P_lo V" if (dt, odt) == (bf16, f32)
                  else "")}
        if name in timed:
            rec["kernel_ms"] = cuda_ms(torch, kern)
            rec["kernel_tflops"] = attention_tflops(bh, lq, lk, d, causal,
                                                    rec["kernel_ms"])
            esize = torch.tensor([], dtype=dt).element_size()
            rec["bound_ms"], rec["bound_by"] = attention_bound_ms(
                bh, lq, lk, d, causal, rec["dtype"], esize,
                torch.tensor([], dtype=odt).element_size())
            rec["bound_rate"] = BOUND_RATE[dtype]
        if name in with_library:
            rec["plain_ms"] = cuda_ms(torch, plain, warmup=1, iters=3)
            qs, ks, vs = (x.view(1, bh, -1, d) for x in (q, k, v))
            rec["library_ms"] = cuda_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=causal))
        if name == "main_f32":
            # The split alone at the path's shape, and bit for bit against
            # its plain version.
            rec["split_ms"] = cuda_ms(torch, lambda: split.bf16_split(
                "flash_attention_fwd", q, k, v))
            rec["split_device_ms"] = graph_ms(torch, lambda: split.bf16_split(
                "flash_attention_fwd", q, k, v))
            bufs = split.bf16_split("flash_attention_fwd", q, k, v)
            rec["split_bitwise_equal"] = all(
                torch.equal(b, split.bf16_split_plain(t))
                for b, t in zip(bufs, (q, k, v)))
            del bufs
        emit(phase="kernel", **rec)
        if not (o_ok and lse_err <= 1e-3 and finite and launched == 1
                and split_launched == (dt == f32)
                and rec.get("split_bitwise_equal", True)):
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"in case {name}: {rec}")
        records[name] = rec
        del q, k, v, o, lse, po, plse, diff
    torch.cuda.empty_cache()
    return records


def phase_kernel_bwd(torch, fa, split):
    """The dq (B5) and dk/dv (B6) kernels against their plain versions, the
    counts (B5's, B6's and the split's) set to 0 just before each checked
    call and read just after; returns the records by case, each timed one
    with a ``dq`` and a ``dkv`` part."""
    g = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    # (name, BH, Lq, Lk, causal, in dtype, out dtype, atol, rtol, block op).
    # f32 out: the same f32 products summed in another order; each gradient
    # entry sums up to 2048 terms (ds k, ds q, p do) of size up to ~1 with
    # cancellation, so 5e-4 abs + 1e-3 rel.
    # bf16 out: both sides compute in f32 and round once to bf16, where a
    # last-place flip is 2^-8 relative: 1e-2 abs + 1e-2 rel.
    # bf16 inputs run the tensor-core kernels, whose second-stage products
    # take p and ds as bf16: inside the bf16 tolerance; with an f32 output
    # they take p and ds as bf16 hi + lo parts and hold the f32 one.  f32
    # inputs: one split launch for q, k, v and do, then three bf16 products
    # for each product, which hold the f32 tolerance (and the bf16 one for
    # a bf16 output).
    cases = [
        ("main_bf16", 32, 2048, 2048, True, bf16, None, 1e-2, 1e-2, False),
        ("main_f32", 32, 2048, 2048, True, f32, None, 5e-4, 1e-3, False),
        ("main_f32_bf16out", 32, 2048, 2048, True, f32, bf16, 1e-2, 1e-2,
         False),
        # The mfu phase's batch-2 shape: 2 x 32 heads.
        ("mfu_bf16", 64, 2048, 2048, True, bf16, None, 1e-2, 1e-2, False),
        # The retune drill's compiled leg (as in the forward's cases).
        ("compiled_bf16", 32, 512, 512, True, bf16, None, 1e-2, 1e-2,
         False),
        ("noncausal_bf16", 8, 1024, 1024, False, bf16, None, 1e-2, 1e-2,
         False),
        ("block_lk_ne_lq_f32out", 32, 512, 2048, True, bf16, f32, 5e-4,
         1e-3, True),
        ("lk_ne_lq_bf16", 32, 512, 2048, True, bf16, None, 1e-2, 1e-2,
         True),
        ("ragged_f32", 4, 100, 300, True, f32, None, 5e-4, 1e-3, False),
        ("ragged_bf16", 4, 100, 300, False, bf16, None, 1e-2, 1e-2, False),
        ("ragged_bf16_causal", 4, 100, 300, True, bf16, None, 1e-2, 1e-2,
         False),
    ] + [(name, bh, lq, lk, causal, dt, None, *tol, False)
         for name, bh, lq, lk, causal in VIT_KERNEL_CASES
         for dt, tol in ((bf16, (1e-2, 1e-2)), (f32, (5e-4, 1e-3)))]
    timed = ("main_bf16", "main_f32", "main_f32_bf16out",
             "block_lk_ne_lq_f32out", "lk_ne_lq_bf16", *VIT_CASES)
    records = {}
    for name, bh, lq, lk, causal, dt, odt, atol, rtol, block in cases:
        if name in VIT_BASES:
            name = f"{name}_{str(dt).split('.')[-1]}"
        d = head_dim(name)
        q, do = (torch.randn((bh, lq, d), generator=g, device="cuda").to(dt)
                 for _ in range(2))
        k, v = (torch.randn((bh, lk, d), generator=g, device="cuda").to(dt)
                for _ in range(2))
        odt = odt or dt
        scale = 1.0 / math.sqrt(d)
        o, lse = fa._flash_bh_kernel(q, k, v, causal=causal, scale=scale,
                                     out_dtype=dt)
        if block:
            # As a ring caller hands them in: the lse of a combination with
            # a second chunk of equal mass, and some other output's delta.
            lse = lse + math.log(2.0)
            delta = torch.randn((bh, lq, 1), generator=g, device="cuda")
        else:
            delta = torch.sum(do.float() * o.float(), dim=-1, keepdim=True)
        bq, bk = fa._resolve_blocks(lq, lk, None, None)
        args = (q, k, v, do, lse, delta)
        kw = dict(causal=causal, scale=scale, out_dtype=odt)
        pkw = dict(kw, block_q=bq, block_k=bk)
        fns = {
            "dq": (lambda: fa._flash_bh_bwd_dq_kernel(*args, **kw),
                   lambda: fa._flash_bh_bwd_dq_plain(*args, **pkw)),
            "dkv": (lambda: fa._flash_bh_bwd_dkv_kernel(*args, **kw),
                    lambda: fa._flash_bh_bwd_dkv_plain(*args, **pkw)),
        }

        def backward():
            # One backward as the model's autograd (or a ring caller) runs
            # it: for f32 inputs one split, read by both passes.
            if block:
                return fa.flash_bwd_block(*args, causal=causal, out_dtype=odt)
            return fa._flash_bh_bwd(*args, **pkw)

        reset_counts(fa)
        split.bf16_split_launches = 0
        got = backward()
        torch.cuda.synchronize()
        launched = read_counts(fa)
        split_launched = split.bf16_split_launches
        ref = (fns["dq"][1](), *fns["dkv"][1]())
        errs, ok = {}, True
        for gname, a, b in zip(("dq", "dk", "dv"), got, ref):
            diff = (a.float() - b.float()).abs()
            errs[gname] = float(diff.max())
            ok = ok and bool((diff <= atol + rtol * b.float().abs()).all()) \
                and bool(torch.isfinite(a.float()).all()) and a.dtype == odt
        dtype = str(dt).split(".")[-1]
        rec = {"case": name, "bh": bh, "lq": lq, "lk": lk, "d": d,
               "causal": causal,
               "dtype": dtype, "out_dtype": str(odt).split(".")[-1],
               "block_op": block,
               **{f"{k}_max_abs_err": e for k, e in errs.items()},
               "atol": atol, "rtol": rtol,
               "launches": {"dq": launched["flash_attention_bwd_dq"],
                            "dkv": launched["flash_attention_bwd_dkv"]},
               "split_launches": split_launched,
               # dq and dk/dv share their design in each type.
               "design": DESIGN["flash_attention_bwd_dq"][dtype]
               + (", P and dS as hi + lo bf16" if (dt, odt) == (bf16, f32)
                  else "")}
        if name in timed:
            esize = q.element_size()
            osize = torch.tensor([], dtype=odt).element_size()
            for part, (kern, _) in fns.items():
                b_ms, b_by = attention_bwd_bound_ms(
                    part, bh, lq, lk, d, causal, dtype, esize, osize)
                ms = cuda_ms(torch, kern)
                rec[part] = {"kernel_ms": ms,
                             "kernel_tflops": attention_bwd_tflops(
                                 part, bh, lq, lk, d, causal, ms),
                             "bound_ms": b_ms, "bound_by": b_by,
                             "bound_rate": BOUND_RATE[dtype],
                             "design": rec["design"]}
        if dt == f32 and name in timed:
            # An f32 pass timed alone splits its own inputs; the path splits
            # once for both: the whole backward, and the split alone at the
            # path's shape, bit for bit against its plain version.
            rec["bwd_ms"] = cuda_ms(torch, backward)
            rec["split_ms"] = cuda_ms(torch, lambda: split.bf16_split(
                "flash_attention_bwd", q, k, v, do))
            rec["split_device_ms"] = graph_ms(torch, lambda: split.bf16_split(
                "flash_attention_bwd", q, k, v, do))
            bufs = split.bf16_split("flash_attention_bwd", q, k, v, do)
            rec["split_bitwise_equal"] = all(
                torch.equal(b, split.bf16_split_plain(t))
                for b, t in zip(bufs, (q, k, v, do)))
            del bufs
            for part in fns:
                rec[part].update({k: rec[k] for k in (
                    "bwd_ms", "split_ms", "split_device_ms")})
        if name.startswith("main") or name in VIT_CASES:
            # The library yardstick: scaled_dot_product_attention's
            # backward, which computes dq, dk and dv in one call.
            qs, ks, vs = (x.view(1, bh, -1, d).detach().requires_grad_()
                          for x in (q, k, v))
            out = torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal)
            dos = do.view(1, bh, lq, d)
            lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
                out, (qs, ks, vs), dos, retain_graph=True))
            for part, (_, plain) in fns.items():
                rec[part].update(plain_ms=cuda_ms(torch, plain, warmup=1,
                                                  iters=3),
                                 library_ms=lib_ms)
            del qs, ks, vs, out
        emit(phase="kernel_bwd", **rec)
        if not (ok and rec["launches"] == {"dq": 1, "dkv": 1}
                and launched["flash_attention_fwd"] == 0
                and split_launched == (dt == f32)
                and rec.get("split_bitwise_equal", True)):
            raise AssertionError(f"backward kernels disagree with their "
                                 f"plain versions in case {name}: {rec}")
        records[name] = rec
        del q, k, v, do, o, lse, delta, got, ref, args, fns
    torch.cuda.empty_cache()
    return records


def _attention_grad_error(torch, llama, cfg, params, batch, chunk):
    """The gradients of every layer's wq, wk and wv (the leaves whose
    gradients take dq, dk and dv from the backward kernels) through flash
    attention, against full attention's, as the largest error over the
    three stacked leaves relative to its norm."""
    leaves = [params["layers"][k] for k in ("wq", "wk", "wv")]

    def grads(attn):
        for p in leaves:
            p.requires_grad_(True)
        loss = llama.make_loss_fn(cfg, attn=attn, remat=TRAIN_REMAT,
                                  loss_chunk=chunk)(params, batch)
        out = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        return out

    full = grads("full")
    flash = grads("flash")
    return max(float((a - b).norm() / b.norm())
               for a, b in zip(flash, full))


def phase_train(torch, llama, fa, split, train_mod, layers: int,
                lr: float = TRAIN_LR, remat: str = TRAIN_REMAT,
                dtype: str = "bfloat16"):
    """Four SGD steps at Llama-3-8B width through the three kernels, on
    weights of ``dtype``."""
    cfg = llama.llama3_8b()
    if layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    f32 = dtype == "float32"
    L, chunk = 2048, 512
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(4)
    t0 = time.perf_counter()
    params = llama.init(g, cfg, dtype=getattr(torch, dtype))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data, _ = train_mod.synthetic_tokens(cfg, n_seq=1, seq_len=L)
    batch = torch.from_numpy(data).to("cuda", torch.long)
    tokens, targets = batch[:, :-1], batch[:, 1:]
    # Reference: step 1's loss through plain full attention.
    with torch.no_grad():
        ref_loss = float(llama.make_loss_fn(cfg, attn="full",
                                            loss_chunk=chunk)(
            params, (tokens, targets)))
    grad_rel = (_attention_grad_error(torch, llama, cfg, params,
                                      (tokens, targets), chunk)
                if f32 else None)
    step = llama.make_train_step(cfg, lr=lr, attn="flash", remat=remat,
                                 loss_chunk=chunk)
    expected = {"flash_attention_fwd": FWD_PER_LAYER[remat] * cfg.n_layers,
                "flash_attention_bwd_dq": cfg.n_layers,
                "flash_attention_bwd_dkv": cfg.n_layers,
                # f32: one split for each forward call (q, k, v) and one for
                # each backward call (q, k, v, do).
                "bf16_split": (FWD_PER_LAYER[remat] + 1) * cfg.n_layers
                if f32 else 0}

    def counts():
        return {**read_counts(fa), "bf16_split": split.bf16_split_launches}

    losses, step_ms, per_step = [], [], []
    reset_counts(fa)
    split.bf16_split_launches = 0
    for _ in range(4):
        before = counts()
        t0 = time.perf_counter()
        params, _, loss = step(params, None, tokens, targets)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        after = counts()
        per_step.append({k: after[k] - before[k] for k in after})
    total = counts()
    steady_ms = sorted(step_ms[1:])[1]          # median of steps 2-4
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    loss_rtol = F32_TRAIN_LOSS_RTOL if f32 else 1e-2
    rec = {"phase": "train_f32" if f32 else "train", "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "batch": 1, "seq": L, "dtype": dtype,
           "attn": "flash", "remat": remat, "loss_chunk": chunk, "lr": lr,
           "init_s": init_s, "losses": losses,
           "step1_loss_full_attention": ref_loss,
           "step1_loss_rel_err_vs_full": rel, "loss_rtol": loss_rtol,
           "step_ms": step_ms, "steady_step_ms": steady_ms,
           "tokens_per_s": L / (steady_ms / 1e3),
           "launches": {k: v for k, v in total.items() if k in COUNTERS},
           "split_launches": total["bf16_split"],
           "launches_per_step": per_step,
           "expected_launches_per_step": expected,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if f32:
        rec.update(attention_grad_rel_err_vs_full=grad_rel,
                   grad_rtol=F32_TRAIN_GRAD_RTOL)
    print(json.dumps(rec), flush=True)
    del params, step
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall at lr {lr}: {losses}")
    if any(s != expected for s in per_step):
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{expected} (remat={remat!r}, {dtype})")
    if not rel < loss_rtol:
        raise AssertionError(f"step 1's loss {losses[0]} is {rel:.3g} "
                             f"relative from full attention's {ref_loss}")
    if f32 and not grad_rel < F32_TRAIN_GRAD_RTOL:
        raise AssertionError(f"the attention projections' gradients are "
                             f"{grad_rel:.3g} of their norm from full "
                             f"attention's")
    return rec


def phase_generate(torch, llama, fa, layers: int):
    cfg = llama.llama3_8b()
    if layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    g = torch.Generator(device="cuda").manual_seed(1)
    t0 = time.perf_counter()
    params = llama.init(g, cfg, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = torch.randint(0, cfg.vocab, (1, 2048), generator=g,
                           device="cuda")
    first = llama.make_generate_fn(cfg, 2048, 1)
    fn = llama.make_generate_fn(cfg, 2048, 16)
    fn(params, prompt)            # warm-up: kernels' first loads, cuBLAS
    torch.cuda.synchronize()

    reset_counts(fa)
    t0 = time.perf_counter()
    toks = fn(params, prompt)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts(fa)
    launches = counts["flash_attention_fwd"]
    if counts != {**counts, "flash_attention_fwd": cfg.n_layers,
                  "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}:
        raise AssertionError(f"generate launched {counts}, expected the "
                             f"forward {cfg.n_layers} times and no backward")

    t0 = time.perf_counter()
    first(params, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    # Reference: the same prefill with plain full attention.
    logits_full, _ = llama._prefill(
        cfg, params, llama.init_kv_cache(cfg, 1, 2048, torch.bfloat16),
        prompt, attn="full")
    logits_flash, _ = llama._prefill(
        cfg, params, llama.init_kv_cache(cfg, 1, 2048, torch.bfloat16),
        prompt, attn="flash")
    rel = float((logits_flash - logits_full).norm() / logits_full.norm())
    toks_l = toks.cpu().tolist()[0]
    ok = (tuple(toks.shape) == (1, 16)
          and all(0 <= t < cfg.vocab for t in toks_l)
          and bool(torch.isfinite(logits_flash).all()) and rel < 5e-2)
    rec = {"phase": "generate", "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "prompt_len": 2048, "max_new": 16,
           "dtype": "bfloat16", "init_s": init_s,
           "flash_fwd_launches": launches, "launches": counts,
           "total_ms": total_s * 1e3,
           "prefill_ms": prefill_s * 1e3,
           "decode_ms_per_token": (total_s - prefill_s) * 1e3 / 15,
           "prefill_logits_rel_err_vs_full": rel,
           "greedy_first_token_flash_vs_full":
               [int(logits_flash.argmax()), int(logits_full.argmax())],
           "tokens": toks_l,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(rec), flush=True)
    if not ok:
        raise AssertionError(f"generate phase output wrong: {rec}")
    return rec, cfg


def f32_prefill(torch, llama, fa, split, cfg, params):
    """B4 in f32 on its path: one prefill of a F32_PREFILL_LEN-token prompt
    through ``llama._prefill(attn="auto")`` on f32 parameters (flash from
    1024 tokens on), with the counts set to 0 just before it and read just
    after: B4 once per layer, each launch after one split of its f32 q, k
    and v.  Its last-row logits are held against the same prefill through
    full attention on the same parameters; both are timed."""
    g = torch.Generator(device="cuda").manual_seed(6)
    prompt = torch.randint(0, cfg.vocab, (1, F32_PREFILL_LEN), generator=g,
                           device="cuda")

    def prefill(attn):
        cache = llama.init_kv_cache(cfg, 1, F32_PREFILL_LEN, torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = llama._prefill(cfg, params, cache, prompt, attn=attn)
        torch.cuda.synchronize()
        return logits, (time.perf_counter() - t0) * 1e3

    prefill("auto")                 # warm-up: the f32 kernels' first loads
    reset_counts(fa)
    split.bf16_split_launches = 0
    logits_flash, flash_ms = prefill("auto")
    counts = read_counts(fa)
    split_launches = split.bf16_split_launches
    logits_full, full_ms = prefill("full")
    rel = float((logits_flash - logits_full).norm() / logits_full.norm())
    rec = {"phase": "serve_f32_prefill", "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "prompt_len": F32_PREFILL_LEN,
           "dtype": str(params["embed"].dtype).split(".")[-1],
           "attn": "auto", "launches": counts,
           "split_launches": split_launches,
           "prefill_ms_flash": flash_ms, "prefill_ms_full": full_ms,
           "logits_rel_err_vs_full": rel, "rtol": F32_PREFILL_RTOL,
           "greedy_first_token_flash_vs_full":
               [int(logits_flash.argmax()), int(logits_full.argmax())],
           "finite": bool(torch.isfinite(logits_flash).all())}
    print(json.dumps(rec), flush=True)
    want = {**dict.fromkeys(counts, 0), "flash_attention_fwd": cfg.n_layers}
    if rec["dtype"] != "float32" or counts != want \
            or split_launches != cfg.n_layers:
        raise AssertionError(f"the f32 prefill launched {counts} and the "
                             f"split {split_launches} times, expected the "
                             f"forward and the split {cfg.n_layers} times "
                             f"each on f32 parameters: {rec}")
    if not (rec["finite"] and rel < F32_PREFILL_RTOL):
        raise AssertionError(f"the f32 prefill through B4 is {rel:.3g} from "
                             f"full attention's logits (rtol "
                             f"{F32_PREFILL_RTOL}): {rec}")
    return rec


def phase_serve(torch, llama, fa, split, engine_mod, serving, cfg):
    """The engine's requests (full-attention prefills, as the JAX runner),
    then the f32 prefill through B4 on the runner's parameters.  Returns
    the requests' launch counts and the prefill's record."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = engine_mod.LlamaRunner(4, cfg=cfg, rng_seed=2, max_len=2048)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ecfg = serving.serve_config()
    ecfg["max_batch"] = 4
    eng = engine_mod.ServeEngine(runner=runner, cfg=ecfg)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in (37, 300, 700, 1500)]
    # Warm-up request: first loads of the f32 kernels stay out of the TTFTs.
    warm = eng.submit(prompts[0][:8], max_new=2, deadline_ms=120000)
    while not warm.done.is_set():
        eng.iteration()
    torch.cuda.synchronize()
    reset_counts(fa)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=16, deadline_ms=120000) for p in prompts]
    iters = 0
    while not all(r.done.is_set() for r in reqs):
        eng.iteration()
        iters += 1
        if iters > 200:
            raise AssertionError("requests did not settle in 200 iterations")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts(fa)
    launches = counts["flash_attention_fwd"]
    bad = [(r.id, r.state, r.shed_reason, len(r.tokens)) for r in reqs
           if r.state != "done" or len(r.tokens) != 16]
    # Reference: the shortest request through make_generate_fn on the
    # runner's own parameters.
    ref = llama.make_generate_fn(cfg, len(prompts[0]), 16)(
        runner.params, [prompts[0]])[0].tolist()
    rec = {"phase": "serve", "n_layers": cfg.n_layers, "dtype": "float32",
           "slots": 4, "max_len": 2048, "init_s": init_s,
           "iterations": iters, "wall_ms": wall_s * 1e3,
           "tokens_per_s": sum(len(r.tokens) for r in reqs) / wall_s,
           "flash_fwd_launches": launches, "launches": counts,
           "requests": [{"prompt": len(r.prompt), "state": r.state,
                         "ttft_ms": r.ttft_s * 1e3,
                         "latency_ms": r.latency_ms(),
                         "tokens": r.tokens} for r in reqs],
           "shortest_matches_generate": reqs[0].tokens == ref,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(rec), flush=True)
    if bad:
        raise AssertionError(f"requests not done with 16 tokens: {bad}")
    if reqs[0].tokens != ref:
        raise AssertionError(f"serve tokens {reqs[0].tokens} differ from "
                             f"make_generate_fn's {ref}")
    if counts["flash_attention_bwd_dq"] or counts["flash_attention_bwd_dkv"]:
        raise AssertionError(f"serving launched a backward kernel: {counts}")
    torch.cuda.empty_cache()
    return counts, f32_prefill(torch, llama, fa, split, cfg, runner.params), \
        runner, rec


def _http(method: str, url: str, body=None, timeout: float = 120.0):
    """(status, JSON body or text, headers) of one request."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, text, headers = r.status, r.read().decode(), r.headers
    except urllib.error.HTTPError as e:
        status, text, headers = e.code, e.read().decode(), e.headers
    try:
        return status, json.loads(text), headers
    except ValueError:
        return status, text, headers


def parse_prometheus(text: str) -> dict:
    """``name{labels}`` -> value of every sample line of a Prometheus text
    exposition; raises on a line that does not parse."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        if not key or " " in key.split("{")[0]:
            raise ValueError(f"bad exposition line {line!r}")
        out[key] = float(value)
    return out


def phase_frontend(torch, llama, fa, engine_mod, serving, cfg, runner,
                   serve_rec):
    """The serve phase's runner behind HTTP: concurrent POST /generate,
    the shortest and longest held against make_generate_fn, /metrics,
    /healthz, a queue_full 503, drain and resume."""
    import threading

    from torchmpi_tpu_torch.obs import metrics as obs_metrics
    from torchmpi_tpu_torch.obs import serve as obs_serve
    from torchmpi_tpu_torch.serving import ServeFrontend

    g = torch.Generator().manual_seed(3)     # the serve phase's prompts
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in (37, 300, 700, 1500)]
    reg = obs_metrics.Registry()
    health = obs_serve.HealthState()
    ecfg = serving.serve_config()
    ecfg["max_batch"] = 4
    eng = engine_mod.ServeEngine(runner=runner, registry=reg, cfg=ecfg)
    obs = front = full = None
    fails, oks = [], 0
    try:
        eng.start()
        obs = obs_serve.ObsHTTPServer(registry=reg, health=health)
        front = ServeFrontend(eng, health=health, replica="frontend")
        code, doc, _ = _http("POST", front.url + "/generate",
                             {"prompt": prompts[0][:8], "max_new": 2,
                              "deadline_ms": 120000})
        oks += code == 200
        if code != 200:
            fails.append(f"warm-up request answered {code}: {doc}")
        torch.cuda.synchronize()
        reset_counts(fa)
        results = [None] * len(prompts)

        def client(i):
            t = time.perf_counter()
            try:
                res = _http("POST", front.url + "/generate",
                            {"prompt": prompts[i], "max_new": 16,
                             "deadline_ms": 120000})
            except Exception as e:  # noqa: BLE001 - reported as a failure
                res = (None, {"error": repr(e)})
            results[i] = (*res[:2], (time.perf_counter() - t) * 1e3)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = read_counts(fa)
        if any(t.is_alive() for t in threads):
            raise AssertionError("an HTTP client did not return in 300 s")
        for i, (code, doc, _) in enumerate(results):
            oks += code == 200
            if code != 200 or len(doc.get("tokens", ())) != 16:
                fails.append(f"request {i} ({len(prompts[i])} tokens) "
                             f"answered {code}: {doc}")
        refs = {}
        for i in (0, len(prompts) - 1):
            refs[i] = llama.make_generate_fn(cfg, len(prompts[i]), 16)(
                runner.params, [prompts[i]])[0].tolist()
            got = results[i][1].get("tokens") if results[i][0] == 200 \
                else None
            if got != refs[i]:
                fails.append(f"request {i} tokens {got} differ from "
                             f"make_generate_fn's {refs[i]}")
        if any(counts.values()):
            fails.append(f"the HTTP path launched kernels: {counts}")
        code, text, _ = _http("GET", obs.url + "/metrics")
        samples = parse_prometheus(text)
        done = samples.get('tmpi_serve_requests_total{outcome="done"}')
        if code != 200 or done != oks:
            fails.append(f"/metrics: {code}, outcome=done {done} against "
                         f"{oks} answers of 200")
        hz = _http("GET", obs.url + "/healthz")
        if (hz[0], hz[1].get("state")) != (200, "healthy"):
            fails.append(f"/healthz answered {hz[0]} {hz[1].get('state')}")
        # A full queue: a second engine over the same runner, never
        # started, its one queue place taken.
        qcfg = dict(ecfg, max_queue=1)
        full_eng = engine_mod.ServeEngine(runner=runner, cfg=qcfg)
        full_eng.submit(prompts[0][:4], max_new=1)
        full = ServeFrontend(full_eng, health=obs_serve.HealthState(),
                             replica="full")
        qf = _http("POST", full.url + "/generate",
                   {"prompt": prompts[0][:4], "max_new": 1})
        if (qf[0], qf[1].get("reason")) != (503, "queue_full") or \
                not qf[2].get("Retry-After"):
            fails.append(f"over a full queue: {qf[0]} {qf[1]}")
        drain = [_http("POST", front.url + "/drain", {})[0],
                 _http("GET", obs.url + "/healthz")]
        resume = [_http("POST", front.url + "/drain", {"resume": True})[0],
                  _http("GET", obs.url + "/healthz")]
        if (drain[0], drain[1][0], drain[1][1].get("state")) != \
                (200, 503, "draining"):
            fails.append(f"drain: {drain[0]}, /healthz {drain[1][0]} "
                         f"{drain[1][1].get('state')}")
        if (resume[0], resume[1][0], resume[1][1].get("state")) != \
                (200, 200, "healthy"):
            fails.append(f"resume: {resume[0]}, /healthz {resume[1][0]} "
                         f"{resume[1][1].get('state')}")
    finally:
        for srv in (full, front, obs):
            if srv is not None:
                srv.close()
        eng.stop()
    direct = {r["prompt"]: r for r in serve_rec["requests"]}
    rec = {"phase": "frontend", "n_layers": cfg.n_layers, "dtype": "float32",
           "slots": 4, "max_len": 2048, "wall_ms": wall_s * 1e3,
           "tokens_per_s": 16 * len(prompts) / wall_s,
           "serve_wall_ms": serve_rec["wall_ms"], "launches": counts,
           "requests": [
               {"prompt": len(p), "status": results[i][0],
                "ttft_ms": results[i][1].get("ttft_ms"),
                "latency_ms": results[i][1].get("latency_ms"),
                "client_ms": results[i][2],
                "serve_ttft_ms": direct[len(p)]["ttft_ms"],
                "serve_latency_ms": direct[len(p)]["latency_ms"]}
               for i, p in enumerate(prompts)],
           "shortest_matches_generate": results[0][1].get("tokens")
           == refs[0],
           "longest_matches_generate": results[-1][1].get("tokens")
           == refs[len(prompts) - 1],
           "metrics_done": done, "answers_200": oks,
           "queue_full": [qf[0], qf[1].get("reason"),
                          qf[2].get("Retry-After")],
           "drain_healthz": [drain[1][0], drain[1][1].get("state")],
           "resume_healthz": [resume[1][0], resume[1][1].get("state")]}
    print(json.dumps(rec), flush=True)
    if fails:
        raise AssertionError("frontend: " + "; ".join(fails))
    return counts


ROUTER_LAYERS = 8
ROUTER_KEYS = 16
# Card memory (GB) that a serving phase may leave to the cyclic collector:
# a closed replica frees its weights and KV when it is dropped.
SERVE_CYCLE_GB = 0.25


def phase_router(torch, llama, fa, engine_mod, serving):
    """Two replicas behind ServeRouter: keyed dispatch, drain cutover,
    resume."""
    from torchmpi_tpu_torch.obs import metrics as obs_metrics
    from torchmpi_tpu_torch.obs import serve as obs_serve
    from torchmpi_tpu_torch.serving import ServeFrontend, ServeRouter

    cfg = dataclasses.replace(llama.llama3_8b(), n_layers=ROUTER_LAYERS)
    emit(phase="cut", path="router", n_layers=ROUTER_LAYERS, of=32,
         replicas=2, why="two f32 replicas side by side, each with its own "
                         "weights, in one phase of the run")
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (37,), generator=g).tolist()
    reg = obs_metrics.Registry()
    reps, fails = [], []
    t0 = time.perf_counter()
    try:
        for r in range(2):
            runner = engine_mod.LlamaRunner(4, cfg=cfg, rng_seed=2,
                                            max_len=2048)
            rreg, health = obs_metrics.Registry(), obs_serve.HealthState()
            ecfg = serving.serve_config()
            ecfg["max_batch"] = 4
            eng = engine_mod.ServeEngine(runner=runner, registry=rreg,
                                         cfg=ecfg).start()
            reps.append([eng, None, None])
            reps[-1][1] = obs_serve.ObsHTTPServer(registry=rreg,
                                                  health=health, rank=r)
            reps[-1][2] = ServeFrontend(eng, health=health,
                                        replica=f"r{r}")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        router = ServeRouter({r: rep[2].url for r, rep in enumerate(reps)},
                             probe_urls={r: rep[1].url
                                         for r, rep in enumerate(reps)},
                             registry=reg, timeout=120.0)
        body = {"prompt": prompt, "max_new": 8, "deadline_ms": 120000}
        for rep in reps:                     # warm each replica once
            _http("POST", rep[2].url + "/generate", body)
        reset_counts(fa)
        keys = [f"user-{i}" for i in range(ROUTER_KEYS)]
        first = {k: router.route(k) for k in keys}
        answers, overhead, latency = {}, [], []
        for k in keys:
            t = time.perf_counter()
            code, doc = router.dispatch(k, body)
            client_ms = (time.perf_counter() - t) * 1e3
            if code != 200 or doc.get("replica") != f"r{first[k]}":
                fails.append(f"key {k}: {code} from {doc.get('replica')}, "
                             f"routed to r{first[k]}")
                continue
            answers.setdefault(doc["replica"], []).append(doc["tokens"])
            overhead.append(client_ms - doc["latency_ms"])
            latency.append(doc["latency_ms"])
        if set(answers) != {"r0", "r1"}:
            fails.append(f"replicas used: {sorted(answers)}")
        distinct = {json.dumps(t) for ts in answers.values() for t in ts}
        if len(distinct) != 1:
            fails.append(f"one prompt gave {len(distinct)} token lists")
        d = _http("POST", reps[1][2].url + "/drain", {})[0]
        drained = router.probe()
        moved = []
        for k in keys:
            code, doc = router.dispatch(k, dict(body, max_new=2))
            moved.append((code, doc.get("replica")))
        if d != 200 or drained != {0: "healthy", 1: "draining"} or \
                any(m != (200, "r0") for m in moved):
            fails.append(f"drain: {d}, probe {drained}, answers "
                         f"{sorted(set(moved))}")
        _http("POST", reps[1][2].url + "/drain", {"resume": True})
        resumed = router.probe()
        back = {k: router.route(k) for k in keys}
        if resumed != {0: "healthy", 1: "healthy"} or back != first:
            fails.append(f"resume: probe {resumed}, assignment back "
                         f"{back == first}")
        counts = read_counts(fa)
        if any(counts.values()):
            fails.append(f"the HTTP path launched kernels: {counts}")
        samples = parse_prometheus(reg.to_prometheus())
    finally:
        for eng, obs, front in reps:
            for srv in (front, obs):
                if srv is not None:
                    srv.close()
            eng.stop()
    overhead.sort()
    latency.sort()
    rec = {"phase": "router", "n_layers": ROUTER_LAYERS, "dtype": "float32",
           "replicas": 2, "keys": ROUTER_KEYS, "init_s": init_s,
           "assignment": {str(s): sum(1 for v in first.values() if v == s)
                          for s in (0, 1)},
           "router_overhead_ms": {
               "median": overhead[len(overhead) // 2] if overhead else None,
               "max": overhead[-1] if overhead else None},
           "replica_latency_ms": {
               "median": latency[len(latency) // 2] if latency else None,
               "max": latency[-1] if latency else None},
           "probe_drained": {str(k): v for k, v in drained.items()},
           "probe_resumed": {str(k): v for k, v in resumed.items()},
           "assignment_restored": back == first,
           "dispatched": {k: v for k, v in samples.items()
                          if k.startswith("tmpi_serve_router")},
           "launches": counts}
    print(json.dumps(rec), flush=True)
    if fails:
        raise AssertionError("router: " + "; ".join(fails))
    return counts


def phase_ring_kernels():
    """B1-B3 against their plain versions at p = 2, 3 and 4 on the one
    card (p = 3, which the elastic phase re-forms to, without the cases
    at n = 25,557,032); returns the results of rank 0 by p."""
    from torchmpi_tpu_torch.tools import ring_bench

    out = {}
    for p in (2, 3, 4):
        t0 = time.perf_counter()
        results = ring_bench.run(p, quick=p == 3)
        bad = [r for res in results for r in res["records"]
               if not r["bitwise_equal"]]
        r0 = results[0]
        for rec in r0["records"]:
            if "kernel_ms" in rec:
                rec["bound_ms"] = ring_bench.bound_ms(rec["kind"], rec["n"], p,
                                                      4)
                emit(phase="ring_kernels",
                     design=RING_DESIGN[KIND_KERNEL[rec["kind"]]], **rec)
        rings = r0["resnet_rings"]
        rings["bound_ms"] = sum(ring_bench.bound_ms("allreduce", n, p, 4)
                                for n in rings["sizes"])
        emit(phase="ring_kernels", design=RING_DESIGN["ring_allreduce"],
             resnet_step_rings={
            k: v for k, v in rings.items() if k != "sizes"})
        buckets = r0["bucket_rings"]
        buckets["bound_ms"] = sum(ring_bench.bound_ms("allreduce", n, p, 4)
                                  for n in buckets["sizes"])
        emit(phase="ring_kernels", design=RING_DESIGN["ring_allreduce"],
             resnet_async_bucket_rings=buckets)
        bad += [r[key] for r in results
                for key in ("resnet_rings", "bucket_rings")
                if not r[key]["bitwise_equal"]]
        bad += [r["fresh_state"] for r in results
                if not r["fresh_state"]["bitwise_equal"]]
        bad += [c for r in results for calls in r["back_to_back"].values()
                for c in calls if not c["bitwise_equal"]]
        emit(phase="ring_kernels", p=p,
             fresh_state=[r["fresh_state"] for r in results],
             back_to_back=r0["back_to_back"])
        emit(phase="ring_kernels", p=p, cases=len(r0["records"]),
             all_bitwise_equal=not bad,
             collectives_launches=r0["collectives_launches"],
             collectives_ok=all(r["collectives_ok"] for r in results),
             stalls=r0["stalls"], teardown=r0["teardown"],
             seconds=time.perf_counter() - t0)
        if bad:
            raise AssertionError(f"ring kernels disagree with the plain "
                                 f"schedule at p={p}: {bad[:3]}")
        if not all(r["collectives_ok"] for r in results):
            raise AssertionError(f"collectives path wrong at p={p}")
        if r0["collectives_launches"] != dict.fromkeys(RING_KERNELS, 1):
            raise AssertionError(f"collectives path launched "
                                 f"{r0['collectives_launches']}")
        if not ring_bench.stalls_ok(r0["stalls"]):
            raise AssertionError(f"a stalled ring did not raise in time or "
                                 f"lost its aborted flag words: "
                                 f"{r0['stalls']}")
        if not ring_bench.teardown_ok(r0["teardown"]):
            raise AssertionError(f"a late ring after its peer's local "
                                 f"teardown: {r0['teardown']}")
        out[p] = r0
    return out


def _ring_timer(torch, cuda_ring, box, check):
    """Wrap inner_ring_allreduce to add each call's device time (CUDA events
    on the rank's stream, from the moment the stream reaches the ring) to
    box[0], in ms.  While check["on"] holds, each ring's result is also held
    against B1's plain version over every rank's input (gathered over the
    process group through the host), bit for bit; check counts the rings
    held, the unequal ones and the largest error."""
    import torch.distributed as dist

    ring = cuda_ring.inner_ring_allreduce

    def timed(x, p, **kwargs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        try:
            out = ring(x, p, **kwargs)
        finally:
            b.record()
            b.synchronize()
            box[0] += a.elapsed_time(b)
        if check["on"]:
            xs = [torch.empty_like(x, device="cpu") for _ in range(p)]
            dist.all_gather(xs, x.cpu(), group=kwargs["comm"].group)
            want = cuda_ring._oneshot_allreduce_plain(
                [t.to(x.device) for t in xs],
                mean=kwargs.get("mean", False))[kwargs["comm"].rank]
            same = bool(torch.equal(out.view(torch.int32),
                                    want.view(torch.int32)))
            check["rings"] += 1
            check["unequal"] += not same
            check["max_abs_err"] = max(check["max_abs_err"], float(
                (out.double() - want.double()).abs().max()))
        return out

    cuda_ring.inner_ring_allreduce = timed


def resnet_rank_main(steps: int, batch: int, lr: float) -> dict:
    """One rank of the train_resnet phase (spawned)."""
    import hashlib

    import torch
    import torch.distributed as dist

    from torchmpi_tpu_torch import nn as mpinn
    from torchmpi_tpu_torch.collectives import cuda_ring
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import resnet
    from torchmpi_tpu_torch.runtime import config, lifecycle
    from torchmpi_tpu_torch.utils import tree
    from torchmpi_tpu_torch.utils.data import synthetic_mnist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config.set("use_pallas_collectives", True)
    device = lifecycle.start()
    try:
        p, rank = lifecycle.size(), lifecycle.rank()
        cfg = resnet.config(depth=50, n_classes=1000, width_multiplier=1.0)
        params, bn_state = resnet.init(7, cfg, device=device)
        ds = synthetic_mnist(n=p * batch, n_classes=1000, seed=1,
                             image_shape=(224, 224, 3))
        one = (ds.x.reshape(p, batch, 224, 224, 3), ds.y.reshape(p, batch))
        ring_s = [0.0]
        check = {"on": False, "rings": 0, "unequal": 0, "max_abs_err": 0.0}
        _ring_timer(torch, cuda_ring, ring_s, check)
        losses, step_ms, launches, ring_ms = [], [], [], []
        marks = {}

        def counts():
            return {"ring_allreduce": cuda_ring.ring_allreduce_launches,
                    "ring_reduce_scatter": cuda_ring.ring_reduce_scatter_launches,
                    "ring_allgather": cuda_ring.ring_allgather_launches}

        def on_sample(state):
            torch.cuda.synchronize()
            check["on"] = not step_ms          # the rings of step 1
            marks["t0"], marks["c0"], ring_s[0] = (time.perf_counter(),
                                                   counts(), 0.0)

        def on_update(state):
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - marks["t0"]) * 1e3)
            ring_ms.append(ring_s[0])
            losses.append(float(state["loss"]))
            c = counts()
            launches.append({k: c[k] - marks["c0"][k] for k in c})

        engine = AllReduceSGDEngine(
            resnet.make_loss_fn(cfg), lr=lr, mode="compiled",
            hooks={"on_sample": on_sample, "on_update": on_update})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_ring.ring_allreduce_launches = 0
        cuda_ring.ring_reduce_scatter_launches = 0
        cuda_ring.ring_allgather_launches = 0
        state = engine.train(params, [one] * steps, epochs=1)
        check["on"] = False
        total = counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        params = state["params"]
        mpinn.check_with_allreduce(params, tol=0.0)
        digest = hashlib.sha256()
        for leaf in tree.leaves(params):
            digest.update(leaf.detach().cpu().numpy().tobytes())
        digests = [None] * p
        dist.all_gather_object(digests, digest.hexdigest())

        # One eager_sync step, then the inference-mode evaluation.
        cuda_ring.ring_allreduce_launches = 0
        eager = AllReduceSGDEngine(resnet.make_loss_fn(cfg), lr=lr,
                                   mode="eager_sync",
                                   sync_parameters_on_start=False)
        est = eager.train(params, [one], epochs=1)
        eager_launches = cuda_ring.ring_allreduce_launches
        x = torch.as_tensor(one[0][rank]).to(device)
        bn_state = resnet.make_update_stats_fn(cfg)(est["params"], bn_state, x)
        acc = engine.test(est["params"], [one],
                          resnet.make_accuracy_fn(cfg, bn_state))
        return {"rank": rank, "p": p, "losses": losses, "step_ms": step_ms,
                "ring_ms": ring_ms, "launches_per_step": launches,
                "launches": total, "peak_gb": peak_gb,
                "step1_rings_vs_plain": {k: v for k, v in check.items()
                                         if k != "on"},
                "replicas_bitwise_equal": len(set(digests)) == 1,
                "eager_sync_loss": float(est["loss"]),
                "eager_sync_ring_launches": eager_launches,
                "eval_accuracy": acc}
    finally:
        lifecycle.stop()


def phase_train_resnet(torch, rings):
    """ResNet-50 at full width on 2 ranks of the one card through B1.  The
    ring's share of a step is read two ways: the rings' device time inside
    the steps (CUDA events), and the ring_kernels phase's time for the 43
    rings of a step at their own sizes at p = 2, over the step."""
    from torchmpi_tpu_torch.runtime import launch

    t0 = time.perf_counter()
    res = launch.spawn(2, resnet_rank_main,
                       (RESNET_STEPS, RESNET_BATCH, RESNET_LR), timeout_s=900)
    r0 = res[0]
    steady = sorted(r0["step_ms"][1:])
    steady_ms = (steady[1] + steady[2]) / 2          # median of steps 2-5
    ring_steady = sorted(r0["ring_ms"][1:])
    ring_ms = (ring_steady[1] + ring_steady[2]) / 2
    bench_ms = rings[2]["resnet_rings"]["kernel_ms"]
    expected = {"ring_allreduce": RESNET_RINGS, "ring_reduce_scatter": 0,
                "ring_allgather": 0}
    rec = {"phase": "train_resnet", "model": "resnet50", "width": 1.0,
           "image": 224, "classes": 1000, "dtype": "float32", "ranks": 2,
           "batch_per_rank": RESNET_BATCH, "lr": RESNET_LR,
           "losses": [r["losses"] for r in res],
           "step_ms": r0["step_ms"], "steady_step_ms": steady_ms,
           "images_per_s_per_card": 2 * RESNET_BATCH / (steady_ms / 1e3),
           "ring_ms_per_step": r0["ring_ms"], "steady_ring_ms": ring_ms,
           "ring_share_of_step": ring_ms / steady_ms,
           "bench_step_rings_ms": bench_ms,
           "bench_ring_share_of_step": bench_ms / steady_ms,
           "launches": r0["launches"],
           "launches_per_step": [r["launches_per_step"] for r in res],
           "step1_rings_vs_plain": [r["step1_rings_vs_plain"] for r in res],
           "expected_launches_per_step": expected,
           "peak_memory_gb_per_rank": [r["peak_gb"] for r in res],
           "replicas_bitwise_equal": r0["replicas_bitwise_equal"],
           "eager_sync_loss": r0["eager_sync_loss"],
           "eager_sync_ring_launches": r0["eager_sync_ring_launches"],
           "eval_accuracy": r0["eval_accuracy"],
           "seconds": time.perf_counter() - t0}
    print(json.dumps(rec), flush=True)
    for r in res:
        if any(s != expected for s in r["launches_per_step"]):
            raise AssertionError(f"rank {r['rank']} launched "
                                 f"{r['launches_per_step']}, expected "
                                 f"{expected} a step")
        held = r["step1_rings_vs_plain"]
        if held["rings"] != RESNET_RINGS or held["unequal"]:
            raise AssertionError(f"rank {r['rank']}: step 1's rings against "
                                 f"the plain schedule: {held}")
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"non-finite loss {r['losses']}")
        if not r["losses"][-1] < r["losses"][0]:
            raise AssertionError(f"loss did not fall: {r['losses']}")
    if not r0["replicas_bitwise_equal"]:
        raise AssertionError("replicas' parameters differ after the steps")
    if not (math.isfinite(r0["eager_sync_loss"])
            and 0.0 <= r0["eval_accuracy"] <= 1.0):
        raise AssertionError(f"eager_sync step or evaluation wrong: {rec}")
    return rec


def resnet_async_rank_main(steps: int, batch: int, lr: float) -> dict:
    """One rank of the train_resnet_async phase (spawned): the same steps
    from the same start in each of RESNET_ASYNC_RUNS."""
    import hashlib

    import torch
    import torch.distributed as dist

    from torchmpi_tpu_torch import nn as mpinn
    from torchmpi_tpu_torch.collectives import cuda_ring
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import resnet
    from torchmpi_tpu_torch.nn import bucketing
    from torchmpi_tpu_torch.runtime import config, lifecycle
    from torchmpi_tpu_torch.utils import tree
    from torchmpi_tpu_torch.utils.data import synthetic_mnist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's default backward algorithms may sum in another order on every
    # call, so two runs of the same step differ in the last bits of their
    # gradients; the runs are held to bitwise equality only with
    # deterministic convolutions.
    torch.backends.cudnn.deterministic = True
    config.set("use_pallas_collectives", True)
    device = lifecycle.start()
    try:
        p, rank = lifecycle.size(), lifecycle.rank()
        cfg = resnet.config(depth=50, n_classes=1000, width_multiplier=1.0)
        init, _ = resnet.init(7, cfg, device=device)
        ds = synthetic_mnist(n=p * batch, n_classes=1000, seed=1,
                             image_shape=(224, 224, 3))
        one = (ds.x.reshape(p, batch, 224, 224, 3), ds.y.reshape(p, batch))
        plan = bucketing.plan_ready_order(init)
        cutoff = int(config.get("small_allreduce_size_gpu"))
        buckets = len(plan.plan.specs)
        above = sum(spec.total > cutoff for spec in plan.plan.specs)

        def counts():
            return {"ring_allreduce": cuda_ring.ring_allreduce_launches,
                    "ring_reduce_scatter": cuda_ring.ring_reduce_scatter_launches,
                    "ring_allgather": cuda_ring.ring_allgather_launches}

        ring_s = [0.0]
        check = {"on": False, "rings": 0, "unequal": 0, "max_abs_err": 0.0}
        _ring_timer(torch, cuda_ring, ring_s, check)
        runs, first = {}, None
        for label, mode, drain in RESNET_ASYNC_RUNS:
            config.set("engine_async_drain", drain)
            step_ms, launches, blocked, losses, ring_ms = [], [], [], [], []
            marks = {}

            def on_sample(state):
                torch.cuda.synchronize()
                # The buckets of the first run's step 1.
                check["on"] = first is None and not step_ms
                marks["t0"], marks["c0"], ring_s[0] = (time.perf_counter(),
                                                       counts(), 0.0)

            def on_update(state):
                torch.cuda.synchronize()
                check["on"] = False
                step_ms.append((time.perf_counter() - marks["t0"]) * 1e3)
                ring_ms.append(ring_s[0])
                losses.append(float(state["loss"]))
                blocked.append(state.get("blocked_s"))
                c = counts()
                launches.append({k: c[k] - marks["c0"][k] for k in c})

            engine = AllReduceSGDEngine(
                resnet.make_loss_fn(cfg), lr=lr, mode=mode,
                hooks={"on_sample": on_sample, "on_update": on_update})
            params = tree.tree_map(lambda t: t.clone(), init)
            torch.cuda.synchronize()
            cuda_ring.ring_allreduce_launches = 0
            cuda_ring.ring_reduce_scatter_launches = 0
            cuda_ring.ring_allgather_launches = 0
            state = engine.train(params, [one] * steps, epochs=1)
            torch.cuda.synchronize()
            total = counts()
            out = state["params"]
            mpinn.check_with_allreduce(out, tol=0.0)
            digest = hashlib.sha256()
            for leaf in tree.leaves(out):
                digest.update(leaf.detach().cpu().numpy().tobytes())
            digests = [None] * p
            dist.all_gather_object(digests, digest.hexdigest())
            if first is None:
                first = out
            runs[label] = {
                "mode": mode, "drain": drain, "losses": losses,
                "step_ms": step_ms, "blocked_s": blocked, "ring_ms": ring_ms,
                "launches_per_step": launches, "launches": total,
                "replicas_bitwise_equal": len(set(digests)) == 1,
                "equal_to_first_run": all(
                    torch.equal(a, b) for a, b in zip(tree.leaves(first),
                                                      tree.leaves(out)))}
        return {"rank": rank, "p": p, "buckets": buckets,
                "buckets_above_cutoff": above,
                "bucket_elements": [spec.total for spec in plan.plan.specs],
                "order": list(plan.order), "runs": runs,
                "step1_rings_vs_plain": {k: v for k, v in check.items()
                                         if k != "on"}}
    finally:
        lifecycle.stop()


def phase_train_resnet_async():
    """eager_async (both drains) and eager_sync from one start on 2 ranks of
    the one card; B1 once per bucket a step, parameters bitwise equal."""
    from torchmpi_tpu_torch.runtime import launch

    t0 = time.perf_counter()
    res = launch.spawn(2, resnet_async_rank_main,
                       (RESNET_ASYNC_STEPS, RESNET_BATCH, RESNET_LR),
                       timeout_s=900)
    r0 = res[0]
    expected = {"ring_allreduce": r0["buckets"], "ring_reduce_scatter": 0,
                "ring_allgather": 0}
    summary = {}
    for label, run in r0["runs"].items():
        steady = sorted(run["step_ms"][1:])
        summary[label] = {
            "steady_step_ms": sum(steady) / len(steady),
            "step_ms": run["step_ms"], "blocked_s": run["blocked_s"],
            "ring_ms_per_step": run["ring_ms"],
            "losses": [r["runs"][label]["losses"] for r in res],
            "launches_per_step": run["launches_per_step"],
            "equal_to_first_run": [r["runs"][label]["equal_to_first_run"]
                                   for r in res],
            "replicas_bitwise_equal": run["replicas_bitwise_equal"]}
    rec = {"phase": "train_resnet_async", "model": "resnet50", "width": 1.0,
           "image": 224, "classes": 1000, "dtype": "float32", "ranks": 2,
           "batch_per_rank": RESNET_BATCH, "lr": RESNET_LR,
           "steps": RESNET_ASYNC_STEPS, "buckets": r0["buckets"],
           "buckets_above_cutoff": r0["buckets_above_cutoff"],
           "bucket_elements": r0["bucket_elements"],
           "ready_order": r0["order"],
           "expected_launches_per_step": expected, "runs": summary,
           "step1_rings_vs_plain": [r["step1_rings_vs_plain"] for r in res],
           "seconds": time.perf_counter() - t0}
    print(json.dumps(rec), flush=True)
    if r0["buckets_above_cutoff"] != r0["buckets"]:
        raise AssertionError(f"a bucket lies at or below the small-message "
                             f"cutoff: {r0['bucket_elements']}")
    for r in res:
        held = r["step1_rings_vs_plain"]
        if held["rings"] != r0["buckets"] or held["unequal"]:
            raise AssertionError(f"rank {r['rank']}: step 1's bucket rings "
                                 f"against the plain schedule: {held}")
        for label, run in r["runs"].items():
            if any(s != expected for s in run["launches_per_step"]):
                raise AssertionError(
                    f"rank {r['rank']} {label} launched "
                    f"{run['launches_per_step']}, expected {expected} a step")
            if not run["equal_to_first_run"]:
                raise AssertionError(f"rank {r['rank']}: {label}'s parameters "
                                     f"differ from eager_async-ready's")
            if not run["replicas_bitwise_equal"]:
                raise AssertionError(f"{label}: replicas' parameters differ")
            if not all(math.isfinite(x) for x in run["losses"]):
                raise AssertionError(f"{label}: non-finite loss "
                                     f"{run['losses']}")
            if run["mode"] == "eager_async" and not all(
                    b is not None and b >= 0 for b in run["blocked_s"]):
                raise AssertionError(f"{label}: blocked_s {run['blocked_s']}")
        if r["runs"]["eager_sync"]["losses"] != r["runs"][
                "eager_async-ready"]["losses"]:
            raise AssertionError(f"rank {r['rank']}: eager_sync's losses "
                                 f"differ from eager_async's")
    return rec, {label: run["launches"]["ring_allreduce"]
                 for label, run in r0["runs"].items()}


def mnist_rank_main(ckpt_dir: str) -> dict:
    """One rank of the train_mnist phase (spawned): the example in each
    mode, then the compiled run again with the data pipeline off, saving at
    MNIST_SAVE_AT, and a fresh engine resumed from that save."""
    import torch
    import torch.distributed as dist

    from torchmpi_tpu_torch.collectives import cuda_ring
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.examples import mnist_allreduce
    from torchmpi_tpu_torch.models import mlp
    from torchmpi_tpu_torch.runtime import config, lifecycle
    from torchmpi_tpu_torch.utils import checkpoint as ckpt
    from torchmpi_tpu_torch.utils.data import ShardedIterator, load_mnist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The group outlives each run (lifecycle.start adopts it), so the runs
    # of this rank share one process group.
    rank, p = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                       % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    dist.init_process_group(lifecycle.choose_backend(dev, p),
                            init_method="env://", rank=rank, world_size=p)
    try:
        def counts():
            return {"ring_allreduce": cuda_ring.ring_allreduce_launches,
                    "ring_reduce_scatter": cuda_ring.ring_reduce_scatter_launches,
                    "ring_allgather": cuda_ring.ring_allgather_launches}

        ring_s = [0.0]
        check = {"on": False, "rings": 0, "unequal": 0, "max_abs_err": 0.0}
        _ring_timer(torch, cuda_ring, ring_s, check)

        def measured(box, check_first=False):
            """Hooks that time each step (host clock around synchronised
            steps), its rings (CUDA events) and its launches."""
            def on_sample(state):
                torch.cuda.synchronize()
                check["on"] = check_first and not box["step_ms"]
                box["t0"], box["c0"], ring_s[0] = (time.perf_counter(),
                                                   counts(), 0.0)

            def on_update(state):
                torch.cuda.synchronize()
                check["on"] = False
                box["step_ms"].append((time.perf_counter() - box["t0"]) * 1e3)
                box["ring_ms"].append(ring_s[0])
                c = counts()
                box["launches"].append({k: c[k] - box["c0"][k] for k in c})
                box["checks"] += (state["t"] % mnist_allreduce.CHECK_FREQUENCY
                                  == 0 and state["engine"].mode != "compiled")

            return {"on_sample": on_sample, "on_update": on_update}

        def new_box():
            return {"step_ms": [], "ring_ms": [], "launches": [], "checks": 0}

        # The main path: the example, through its entry point, per mode.
        runs, params = {}, {}
        for k in RING_KERNELS:
            setattr(cuda_ring, f"{k}_launches", 0)
        for mode in MNIST_MODES:
            # The example follows the knob (the JAX example's default is
            # off): the rings on outside eager_sync, as this phase drives
            # them.
            config.set("use_pallas_collectives", mode != "eager_sync")
            args = mnist_allreduce.parse_args(
                ["--mode", mode, "--data", "synthetic", "--epochs",
                 str(MNIST_EPOCHS), "--batch", str(MNIST_BATCH), "--lr",
                 str(MNIST_LR)])
            box = new_box()
            out = mnist_allreduce.run(args, hooks=measured(
                box, check_first=mode == "compiled"))
            params[mode] = out.pop("params")
            runs[mode] = {**out, **box}
        main_launches = counts()

        # The compiled run again with the pipeline off (each step stages its
        # own batch), saving at MNIST_SAVE_AT and MNIST_RESUME_TO.
        config.set("use_pallas_collectives", True)
        config.set("data_pipeline", "off")
        device = lifecycle.start()
        try:
            ds, _ = load_mnist("train", prefer="synthetic")

            def batches():
                return ShardedIterator(ds, global_batch=MNIST_BATCH,
                                       num_shards=p)

            box, losses = new_box(), []
            hooks = measured(box)
            mgr = ckpt.CheckpointManager(ckpt_dir,
                                         save_interval=MNIST_SAVE_AT,
                                         keep=1000)
            saver = ckpt.checkpoint_hooks(mgr)

            def on_update(state):
                hooks["on_update"](state)
                losses.append(float(state["loss"]))
                saver["on_update"](state)

            engine = AllReduceSGDEngine(
                mlp.loss_fn, lr=MNIST_LR, mode="compiled",
                hooks={**hooks, "on_update": on_update})
            state = engine.train(mlp.init(0, device=device), batches(),
                                 epochs=MNIST_EPOCHS)
            off_params = {k: v.cpu() for k, v in state["params"].items()}
            dist.barrier()                  # rank 0 has written the saves

            # A fresh engine from the save at MNIST_SAVE_AT, on the batches
            # of steps MNIST_SAVE_AT + 1 to MNIST_RESUME_TO.
            config.set("data_pipeline", "auto")
            template = {"params": mlp.init(1, device=device)}
            start, _ = ckpt.restore(ckpt_dir, template, step=MNIST_SAVE_AT,
                                    strict=False)
            want, _ = ckpt.restore(ckpt_dir, template, step=MNIST_RESUME_TO,
                                   strict=False)
            it = batches()
            seen = [b for _ in range(-(-MNIST_RESUME_TO // len(it)))
                    for b in it][MNIST_SAVE_AT:MNIST_RESUME_TO]
            resumed_losses = []
            fresh = AllReduceSGDEngine(
                mlp.loss_fn, lr=MNIST_LR, mode="compiled", hooks={
                    "on_update": lambda s: resumed_losses.append(
                        float(s["loss"]))})
            rstate = fresh.train(start["params"], seen, epochs=1,
                                 start_step=MNIST_SAVE_AT)
            cont = losses[MNIST_SAVE_AT:MNIST_RESUME_TO]
            resume = {
                "saved_at": MNIST_SAVE_AT, "to": MNIST_RESUME_TO,
                "t": rstate["t"], "rtol": MNIST_RESUME_RTOL,
                "bitwise_equal": resumed_losses == cont and all(
                    torch.equal(rstate["params"][k], v)
                    for k, v in want["params"].items()),
                "loss_max_rel_diff": max(abs(a - b) / abs(b) for a, b in
                                         zip(resumed_losses, cont)),
                "param_max_rel_diff": max(
                    float((rstate["params"][k] - v).abs().max())
                    / float(v.abs().max())
                    for k, v in want["params"].items())}
        finally:
            lifecycle.stop()
        return {
            "rank": rank, "p": p, "runs": runs,
            "main_launches": main_launches,
            "step1_rings_vs_plain": {k: v for k, v in check.items()
                                     if k != "on"},
            "pipeline_off": {"losses": losses, "step_ms": box["step_ms"],
                             "launches": box["launches"]},
            "pipeline_on_equals_off": (
                runs["compiled"]["losses"] == losses
                and all(torch.equal(params["compiled"][k], off_params[k])
                        for k in off_params)),
            "resume": resume}
    finally:
        dist.destroy_process_group()


def phase_train_mnist():
    """Config 1 on 2 ranks of the one card: the MNIST MLP at full width
    through the example in each mode (B1 3 times a compiled step, step 1's
    rings bit for bit against the plain schedule), pipeline on = off bit
    for bit, and a resumed run equal to the continuous one."""
    import tempfile

    from torchmpi_tpu_torch.engine.sgdengine import ring_plan
    from torchmpi_tpu_torch.models import mlp
    from torchmpi_tpu_torch.runtime import config, launch
    from torchmpi_tpu_torch.tools import ring_bench
    from torchmpi_tpu_torch.utils import tree

    # The compiled step's rings (leaf sizes in tree order, the engine's
    # plan at the default cutoff) and their bytes bound at p = 2.
    leaves = tree.leaves(mlp.init(0, device="cpu"))
    sizes = [sum(leaves[i].numel() for i in ring) for ring in ring_plan(
        leaves, int(config.get("small_allreduce_size_gpu")))]
    bound = sum(ring_bench.bound_ms("allreduce", n, 2, 4) for n in sizes)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".mnist_ckpt_") as d:
        res = launch.spawn(2, mnist_rank_main, (d,), timeout_s=600)
    r0 = res[0]
    summary = {}
    for mode in MNIST_MODES:
        run = r0["runs"][mode]
        per_epoch = len(run["losses"]) // MNIST_EPOCHS
        epoch_loss = [sum(run["losses"][e * per_epoch:(e + 1) * per_epoch])
                      / per_epoch for e in range(MNIST_EPOCHS)]
        steady = sorted(run["step_ms"][1:])
        step_ms = steady[len(steady) // 2]
        ring_ms = sorted(run["ring_ms"][1:])[len(steady) // 2]
        summary[mode] = {
            "steps": run["steps"], "epoch_loss": epoch_loss,
            "accuracy": [r["runs"][mode]["accuracy"] for r in res],
            "median_step_ms": step_ms, "median_ring_ms": ring_ms,
            "images_per_s_per_card": MNIST_BATCH / (step_ms / 1e3),
            "replica_checks": run["checks"],
            "launches_per_step": run["launches"][1],
            "data_wait_s": run["stage"]["wait_s"] if run["stage"] else None,
            "staged": run["stage"]}
    off = sorted(r0["pipeline_off"]["step_ms"][1:])
    rec = {"phase": "train_mnist", "model": "mlp 784-1024-1024-10",
           "dtype": "float32", "ranks": 2, "global_batch": MNIST_BATCH,
           "lr": MNIST_LR, "epochs": MNIST_EPOCHS, "data": "synthetic",
           "modes": summary, "compiled_ring_sizes": sizes,
           "compiled_ring_bound_ms_per_step": bound,
           "pipeline_off_median_step_ms": off[len(off) // 2],
           "pipeline_on_equals_off": [r["pipeline_on_equals_off"]
                                      for r in res],
           "resume": [r["resume"] for r in res],
           "step1_rings_vs_plain": [r["step1_rings_vs_plain"] for r in res],
           "launches": r0["main_launches"],
           "seconds": time.perf_counter() - t0}
    print(json.dumps(rec), flush=True)
    for r in res:
        for mode in MNIST_MODES:
            run = r["runs"][mode]
            want = {"ring_allreduce": MNIST_RINGS[mode],
                    "ring_reduce_scatter": 0, "ring_allgather": 0}
            if any(s != want for s in run["launches"]):
                raise AssertionError(f"rank {r['rank']} {mode}: launches "
                                     f"{run['launches'][:3]}..., expected "
                                     f"{want} a step")
            if run["accuracy"] <= MNIST_MIN_ACCURACY:
                raise AssertionError(f"{mode}: held-out accuracy "
                                     f"{run['accuracy']}")
            if not all(math.isfinite(x) for x in run["losses"]):
                raise AssertionError(f"{mode}: non-finite loss")
            if mode != "compiled" and run["checks"] < 1:
                raise AssertionError(f"{mode}: no replica check ran")
        held = r["step1_rings_vs_plain"]
        if held["rings"] != MNIST_RINGS["compiled"] or held["unequal"]:
            raise AssertionError(f"rank {r['rank']}: step 1's rings against "
                                 f"the plain schedule: {held}")
        if not r["pipeline_on_equals_off"]:
            raise AssertionError(f"rank {r['rank']}: compiled with the data "
                                 f"pipeline differs from without it")
        res_ = r["resume"]
        close = max(res_["loss_max_rel_diff"],
                    res_["param_max_rel_diff"]) <= MNIST_RESUME_RTOL
        if res_["t"] != MNIST_RESUME_TO or not (res_["bitwise_equal"]
                                                or close):
            raise AssertionError(f"rank {r['rank']}: resumed run differs "
                                 f"from the continuous one: {res_}")
    for mode, s in summary.items():
        if not s["epoch_loss"][0] - s["epoch_loss"][-1] >= MNIST_MIN_LOSS_DROP:
            raise AssertionError(f"{mode}: epoch loss {s['epoch_loss']} fell "
                                 f"by less than {MNIST_MIN_LOSS_DROP}")
    return rec


# The train_adam phase: Llama-3-8B width in bf16 under Adam (optax's
# defaults), lr 1e-4.  Its depth is the most layers whose estimated peak
# leaves ADAM_HEADROOM_GB of the card free: 8 bytes a parameter (the bf16
# parameters, gradients and both moments; the norms' f32 vectors are few)
# beside ADAM_EXTRA_GB_PER_LAYER for the "dots" activations at L = 2048
# and the transients (the stacking of a leaf's per-layer gradients, the
# optimizer's in-place slices of 256 MB).  Measured on an H100 80GB HBM3:
# a peak of 65.25 GB at 31 layers, 62.5 GB of it the 8 bytes a parameter,
# so 2.75 GB beyond them, 0.09 GB a layer: 0.15 leaves room to spare.
ADAM_LR, ADAM_STEPS = 1e-4, 4
ADAM_HEADROOM_GB = 10.0
ADAM_EXTRA_GB_PER_LAYER = 0.15


def adam_layers(cfg, total_bytes: int) -> tuple:
    """The train_adam depth for a card of ``total_bytes``, and the
    estimated peak in GB at that depth."""
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.head_dim
    per_layer = (d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
                 + 3 * d * ff + 2 * d)
    fixed = 2 * v * d + d

    def est(n):
        return 8 * (per_layer * n + fixed) / 1e9 + ADAM_EXTRA_GB_PER_LAYER * n

    n = cfg.n_layers
    while n > 1 and est(n) > total_bytes / 1e9 - ADAM_HEADROOM_GB:
        n -= 1
    return n, est(n)


def phase_train_adam(torch, llama, fa, split, train_mod, max_layers: int):
    """Adam steps at Llama-3-8B width in bf16 through the three flash
    kernels: make_train_step(optimizer=optim.adam(...)), its moments in
    bf16 beside the parameters, updated in place."""
    from torchmpi_tpu_torch import optim
    from torchmpi_tpu_torch.utils.tree import leaves as tree_leaves

    cfg = llama.llama3_8b()
    total = torch.cuda.get_device_properties(0).total_memory
    layers, est_gb = adam_layers(cfg, total)
    fit = layers
    layers = min(layers, max_layers)
    emit(phase="cut" if layers != cfg.n_layers else "depth",
         path="train_adam", n_layers=layers, of=cfg.n_layers,
         estimated_peak_gb=est_gb, card_gb=total / 1e9,
         why=(f"--layers {max_layers}" if layers < fit else
              "bf16 parameters, gradients, two Adam moments and the "
              "activations of the layers leave "
              f"{ADAM_HEADROOM_GB} GB of the card free by the estimate "
              "(adam_layers)"))
    if layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    L, chunk = 2048, 512
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(4)
    params = llama.init(g, cfg, dtype=torch.bfloat16)
    opt = optim.adam(ADAM_LR)
    opt_state = opt.init(params)
    data, _ = train_mod.synthetic_tokens(cfg, n_seq=1, seq_len=L)
    batch = torch.from_numpy(data).to("cuda", torch.long)
    tokens, targets = batch[:, :-1], batch[:, 1:]
    step = llama.make_train_step(cfg, attn="flash", remat=TRAIN_REMAT,
                                 loss_chunk=chunk, optimizer=opt)
    expected = {"flash_attention_fwd": FWD_PER_LAYER[TRAIN_REMAT] * layers,
                "flash_attention_bwd_dq": layers,
                "flash_attention_bwd_dkv": layers, "bf16_split": 0}

    def counts():
        return {**read_counts(fa), "bf16_split": split.bf16_split_launches}

    losses, step_ms, per_step = [], [], []
    torch.cuda.synchronize()
    reset_counts(fa)
    split.bf16_split_launches = 0
    for _ in range(ADAM_STEPS):
        before = counts()
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, tokens, targets)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        after = counts()
        per_step.append({k: after[k] - before[k] for k in after})
    total_counts = counts()
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    # optax keeps the moments in the parameters' dtypes: bf16 beside the
    # bf16 weights, f32 beside the f32 norms.
    moments_ok = all(
        m.dtype == p.dtype for tree in (opt_state[0].mu, opt_state[0].nu)
        for m, p in zip(tree_leaves(tree), tree_leaves(params)))
    rec = {"phase": "train_adam", "n_layers": layers, "d_model": cfg.d_model,
           "batch": 1, "seq": L, "dtype": "bfloat16", "attn": "flash",
           "remat": TRAIN_REMAT, "loss_chunk": chunk,
           "optimizer": f"adam(lr={ADAM_LR}, b1=0.9, b2=0.999, eps=1e-8)",
           "losses": losses, "step_ms": step_ms, "steady_step_ms": steady,
           "tokens_per_s": L / (steady / 1e3),
           "count": int(opt_state[0].count),
           "moments_in_param_dtypes": moments_ok,
           "launches": {k: v for k, v in total_counts.items()
                        if k in COUNTERS},
           "launches_per_step": per_step,
           "expected_launches_per_step": expected,
           "estimated_peak_gb": est_gb,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(rec), flush=True)
    del params, opt_state, step
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite Adam training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"Adam loss did not fall: {losses}")
    if any(s != expected for s in per_step):
        raise AssertionError(f"train_adam launches per step {per_step}, "
                             f"expected {expected}")
    if rec["count"] != ADAM_STEPS or not moments_ok:
        raise AssertionError(f"Adam state wrong: count {rec['count']}, "
                             f"moments in the parameters' dtypes "
                             f"{moments_ok}")
    return rec


# The options phases, one spawned pair of ranks on the one card:
# train_mnist_options (config 1 under five compiled runs of the engine's
# options, from one start, on the same batches), train_resnet_gspmd
# (ResNet-50 in GSPMD mode with cross-rank batch norm) and the tester's
# sweep.  Tolerances of the equalities are JAX's own tests'
# (tests/test_nn_engine.py: accumulation 2e-4 / 2e-5, zero1 2e-5 / 2e-6).
OPT_STEPS, OPT_LR, OPT_SGD_LR = 10, 1e-3, 0.1
OPT_RUNS = (("adam_rings", True, dict(accum_steps=1)),
            ("adam_rings_accum4", True, dict(accum_steps=4)),
            ("adam_gspmd", False, dict()),
            ("adam_zero1", False, dict(zero1=True)),
            ("sgd_gspmd", False, dict()))
OPT_RINGS = {"adam_rings": 3, "adam_rings_accum4": 3, "adam_gspmd": 0,
             "adam_zero1": 0, "sgd_gspmd": 0}
ACCUM_RTOL, ACCUM_ATOL = 2e-4, 2e-5
ZERO1_RTOL, ZERO1_ATOL = 2e-5, 2e-6
PROFILE_WINDOW = (4, 6)                 # steps [4, 6) of run (i)
GSPMD_STEPS = 3
TESTER_MIN_POW, TESTER_MAX_POW = 8, 23
TESTER_WARMUP, TESTER_ITERS = 1, 3


def _digest(tensors) -> str:
    """One hash of the tensors' bytes: equal on two ranks only if every
    tensor is equal bit for bit."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _ring_counts():
    from torchmpi_tpu_torch.collectives import cuda_ring

    return {k: getattr(cuda_ring, f"{k}_launches") for k in RING_KERNELS}


def _reset_ring_counts():
    from torchmpi_tpu_torch.collectives import cuda_ring

    for k in RING_KERNELS:
        setattr(cuda_ring, f"{k}_launches", 0)


def _all_equal(dist, value) -> bool:
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, value)
    return len(set(seen)) == 1


def options_rank_main(trace_dir: str) -> dict:
    """One rank of the options phases (spawned)."""
    import itertools

    import torch
    import torch.distributed as dist

    from torchmpi_tpu_torch import optim
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import mlp
    from torchmpi_tpu_torch.runtime import config, lifecycle
    from torchmpi_tpu_torch.runtime.communicator import stack
    from torchmpi_tpu_torch.utils import profiler, tester
    from torchmpi_tpu_torch.utils import tree
    from torchmpi_tpu_torch.utils.data import ShardedIterator, load_mnist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = lifecycle.start()
    try:
        p, rank = lifecycle.size(), lifecycle.rank()
        out = {"rank": rank, "p": p, "seconds": {}}
        t_sub = time.perf_counter()

        # ---- train_mnist_options: five compiled runs from one start.
        ds, _ = load_mnist("train", prefer="synthetic")
        batches = list(itertools.islice(
            ShardedIterator(ds, global_batch=MNIST_BATCH, num_shards=p,
                            shuffle=False), OPT_STEPS))
        start = mlp.init(0, device=device)
        if rank == 0:
            # The profiler's first start loads CUPTI: done here, outside
            # the runs, so the window's own start is quick.
            with profiler.trace(os.path.join(trace_dir, "warm")):
                torch.ones(1, device=device).add_(1)
        dist.barrier()
        runs, finals = {}, {}
        for name, rings, kw in OPT_RUNS:
            config.set("use_pallas_collectives", rings)
            box = {"step_ms": [], "launches": [], "losses": []}

            def on_sample(state, box=box):
                torch.cuda.synchronize()
                box["t0"], box["c0"] = time.perf_counter(), _ring_counts()

            def on_update(state, box=box):
                torch.cuda.synchronize()
                box["step_ms"].append((time.perf_counter() - box["t0"]) * 1e3)
                c = _ring_counts()
                box["launches"].append({k: c[k] - box["c0"][k] for k in c})
                box["losses"].append(float(state["loss"]))

            hooks = {"on_sample": on_sample, "on_update": on_update}
            prof = None
            if name == "adam_rings":
                prof = profiler.StepWindowProfiler(
                    logdir=trace_dir, start_step=PROFILE_WINDOW[0],
                    end_step=PROFILE_WINDOW[1], enabled=rank == 0)

                def fence(state):
                    # Rank 0 starts and stops the profiler at the window's
                    # edges, which can take longer than a peer waits in a
                    # ring (RING_TIMEOUT_S): every rank meets there first.
                    if state["t"] in PROFILE_WINDOW:
                        dist.barrier()

                hooks = profiler.compose_hooks(
                    hooks, profiler.profiler_hooks(prof),
                    {"on_update": fence})
            opt = (optim.sgd(OPT_SGD_LR) if name == "sgd_gspmd"
                   else optim.adam(OPT_LR))
            eng = AllReduceSGDEngine(mlp.loss_fn, lr=OPT_SGD_LR,
                                     optimizer=opt, mode="compiled",
                                     hooks=hooks, **kw)
            _reset_ring_counts()
            st = eng.train({k: v.clone() for k, v in start.items()},
                           batches)
            launches = _ring_counts()
            leaves = tree.leaves(st["params"])
            state_leaves = tree.leaves(st["opt_state"])
            full = tree.leaves(eng.full_opt_state(st["opt_state"],
                                                  st["params"]))
            finals[name] = [t.detach().cpu() for t in leaves]
            sharded = [t for t, f in zip(state_leaves, full)
                       if t.shape != f.shape]
            runs[name] = {
                **{k: box[k] for k in ("step_ms", "launches", "losses")},
                "rings_on": rings, "launches_total": launches,
                "replicas_equal": _all_equal(dist, _digest(leaves)),
                "state_elements": sum(t.numel() for t in state_leaves),
                "full_state_elements": sum(t.numel() for t in full),
                "sharded_elements": sum(t.numel() for t in sharded),
                "sharded_full_elements": sum(
                    f.numel() for t, f in zip(state_leaves, full)
                    if t.shape != f.shape),
                "trace": prof.trace_path if prof is not None else None}
        config.set("use_pallas_collectives", False)

        def max_violation(a, b, rtol, atol):
            return max(float(((x - y).abs() - (atol + rtol * y.abs()))
                             .max()) for x, y in zip(finals[a], finals[b]))

        out["mnist_options"] = {
            "runs": runs,
            "accum4_vs_adam_rings": max_violation(
                "adam_rings_accum4", "adam_rings", ACCUM_RTOL, ACCUM_ATOL),
            "zero1_vs_adam_gspmd": max_violation(
                "adam_zero1", "adam_gspmd", ZERO1_RTOL, ZERO1_ATOL),
            "max_abs_diff": {
                "accum4_vs_adam_rings": max(
                    float((x - y).abs().max()) for x, y in
                    zip(finals["adam_rings_accum4"], finals["adam_rings"])),
                "zero1_vs_adam_gspmd": max(
                    float((x - y).abs().max()) for x, y in
                    zip(finals["adam_zero1"], finals["adam_gspmd"]))}}

        out["seconds"]["train_mnist_options"] = time.perf_counter() - t_sub

        # ---- train_resnet_gspmd: ResNet-50 with cross-rank batch norm.
        t_sub = time.perf_counter()
        out["resnet_gspmd"] = resnet_gspmd_run(torch, dist, device, p, rank)
        out["seconds"]["train_resnet_gspmd"] = time.perf_counter() - t_sub

        # ---- tester: the sweep through the rings and through gloo.
        t_sub = time.perf_counter()
        comm = stack.current()
        sweeps = {}
        for impl in ("ring", "eager"):
            _reset_ring_counts()
            res = tester.sweep(comm, collectives=("allreduce",
                                                  "reduce_scatter",
                                                  "allgather"),
                               min_pow=TESTER_MIN_POW,
                               max_pow=TESTER_MAX_POW,
                               warmup=TESTER_WARMUP, iters=TESTER_ITERS,
                               report=None, impl=impl)
            sweeps[impl] = {"results": [vars(r) for r in res],
                            "launches": _ring_counts()}
        out["tester"] = sweeps
        out["seconds"]["tester"] = time.perf_counter() - t_sub
        return out
    finally:
        lifecycle.stop()


def resnet_gspmd_run(torch, dist, device, p, rank) -> dict:
    """ResNet-50 compiled steps in GSPMD mode, the BN means and the
    gradient allreduces timed with CUDA events, then one update_stats fold
    over the global batch."""
    from torchmpi_tpu_torch.collectives import eager
    from torchmpi_tpu_torch.collectives import gspmd
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import resnet
    from torchmpi_tpu_torch.runtime.communicator import stack
    from torchmpi_tpu_torch.utils import tree
    from torchmpi_tpu_torch.utils.data import synthetic_mnist

    cfg = resnet.config(depth=50, n_classes=1000, width_multiplier=1.0)
    params, bn_state = resnet.init(7, cfg, device=device)
    ds = synthetic_mnist(n=p * RESNET_BATCH, n_classes=1000, seed=1,
                         image_shape=(224, 224, 3))
    one = (ds.x.reshape(p, RESNET_BATCH, 224, 224, 3),
           ds.y.reshape(p, RESNET_BATCH))
    # Every allreduce of a step, timed on the stream and filed by kind: the
    # loss (one element), the gradients (inside sync_grads) and the rest,
    # batch norm's means (forward and backward).
    kind, events = {"now": "bn"}, []
    allreduce, sync_grads = eager.allreduce, gspmd.sync_grads

    def timed_allreduce(comm, x, *args, **kwargs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        y = allreduce(comm, x, *args, **kwargs)
        b.record()
        events.append(("loss" if x.numel() == 1 else kind["now"], a, b))
        return y

    def timed_sync(grads, comm):
        kind["now"] = "grads"
        try:
            return sync_grads(grads, comm)
        finally:
            kind["now"] = "bn"

    losses, step_ms, per_step, launches = [], [], [], []

    def on_sample(state):
        torch.cuda.synchronize()
        events.clear()
        per_step.append({})
        state["_t0"], state["_c0"] = time.perf_counter(), _ring_counts()

    def on_update(state):
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - state["_t0"]) * 1e3)
        losses.append(float(state["loss"]))
        c = _ring_counts()
        launches.append({k: c[k] - state["_c0"][k] for k in c})
        for what, a, b in events:
            per_step[-1][what] = per_step[-1].get(what, 0.0) + \
                a.elapsed_time(b)
        per_step[-1]["calls"] = len(events)

    eager.allreduce, gspmd.sync_grads = timed_allreduce, timed_sync
    try:
        eng = AllReduceSGDEngine(resnet.make_loss_fn(cfg), lr=RESNET_LR,
                                 mode="compiled",
                                 hooks={"on_sample": on_sample,
                                        "on_update": on_update})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_ring_counts()
        st = eng.train(params, [one] * GSPMD_STEPS, epochs=1)
    finally:
        eager.allreduce, gspmd.sync_grads = allreduce, sync_grads
    total = _ring_counts()
    x = torch.as_tensor(one[0][rank]).to(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = resnet.make_update_stats_fn(cfg, comm=stack.current())(
        st["params"], bn_state, x)
    torch.cuda.synchronize()
    fold_ms = (time.perf_counter() - t0) * 1e3
    own = resnet.make_update_stats_fn(cfg)(st["params"], bn_state, x)
    return {"losses": losses, "step_ms": step_ms, "collective_ms": per_step,
            "launches_per_step": launches, "launches": total,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "replicas_equal": _all_equal(dist, _digest(
                tree.leaves(st["params"]))),
            "stats_equal": _all_equal(dist, _digest(tree.leaves(stats))),
            "own_stats_equal": _all_equal(dist, _digest(tree.leaves(own))),
            "stats_fold_ms": fold_ms}


def phase_options():
    """train_mnist_options, train_resnet_gspmd, tester and profiler: one
    spawned pair of ranks on the one card; each phase's record and
    checks."""
    import tempfile

    from torchmpi_tpu_torch.runtime import launch
    from torchmpi_tpu_torch.tools import ring_bench
    from torchmpi_tpu_torch.utils import profiler

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".trace_") as d:
        res = launch.spawn(2, options_rank_main, (d,), timeout_s=900)
        r0 = res[0]
        trace = r0["mnist_options"]["runs"]["adam_rings"]["trace"]
        breakdown = profiler.op_breakdown(trace, top=12)
        lines = profiler.print_breakdown(trace, top=12)
    seconds = time.perf_counter() - t0
    emit(phase="options_timing", seconds=seconds,
         rank0_seconds=r0["seconds"])

    # train_mnist_options.
    mo = r0["mnist_options"]
    summary = {}
    for name, run in mo["runs"].items():
        steady = sorted(run["step_ms"][1:])
        summary[name] = {
            "median_step_ms": steady[len(steady) // 2],
            "step_ms": run["step_ms"], "losses": run["losses"],
            "rings_on": run["rings_on"],
            "launches_per_step": run["launches"][1],
            "launches_total": run["launches_total"],
            "replicas_equal": [r["mnist_options"]["runs"][name]
                               ["replicas_equal"] for r in res],
            "state_elements": [r["mnist_options"]["runs"][name]
                               ["state_elements"] for r in res],
            "full_state_elements": run["full_state_elements"],
            "sharded_elements": [r["mnist_options"]["runs"][name]
                                 ["sharded_elements"] for r in res],
            "sharded_full_elements": run["sharded_full_elements"]}
    rec = {"phase": "train_mnist_options", "model": "mlp 784-1024-1024-10",
           "dtype": "float32", "ranks": 2, "global_batch": MNIST_BATCH,
           "steps": OPT_STEPS, "adam_lr": OPT_LR, "sgd_lr": OPT_SGD_LR,
           "runs": summary,
           "accum4_vs_adam_rings": {"rtol": ACCUM_RTOL, "atol": ACCUM_ATOL,
                                    "worst_excess": [
                                        r["mnist_options"]
                                        ["accum4_vs_adam_rings"]
                                        for r in res]},
           "zero1_vs_adam_gspmd": {"rtol": ZERO1_RTOL, "atol": ZERO1_ATOL,
                                   "worst_excess": [
                                       r["mnist_options"]
                                       ["zero1_vs_adam_gspmd"]
                                       for r in res]},
           "max_abs_diff": mo["max_abs_diff"]}
    print(json.dumps(rec), flush=True)
    for name, s in summary.items():
        want = {"ring_allreduce": OPT_RINGS[name], "ring_reduce_scatter": 0,
                "ring_allgather": 0}
        for r in res:
            run = r["mnist_options"]["runs"][name]
            if any(x != want for x in run["launches"]):
                raise AssertionError(f"{name}: ring launches "
                                     f"{run['launches'][:3]}..., expected "
                                     f"{want} a step")
            if not all(math.isfinite(x) for x in run["losses"]):
                raise AssertionError(f"{name}: non-finite loss")
        if not all(s["replicas_equal"]):
            raise AssertionError(f"{name}: the ranks' parameters differ")
    for r in res:
        if r["mnist_options"]["accum4_vs_adam_rings"] > 0:
            raise AssertionError("accum_steps=4 differs from one step a "
                                 "batch beyond the tolerance")
        if r["mnist_options"]["zero1_vs_adam_gspmd"] > 0:
            raise AssertionError("zero1 differs from replicated Adam beyond "
                                 "the tolerance")
    z = summary["adam_zero1"]
    if not (z["sharded_full_elements"] > 0 and all(
            2 * e == z["sharded_full_elements"]
            for e in z["sharded_elements"])):
        raise AssertionError(f"zero1's sharded moments are not 1/p of "
                             f"theirs: {z}")

    # train_resnet_gspmd.
    rg = r0["resnet_gspmd"]
    steady = sorted(rg["step_ms"][1:])
    steady_ms = steady[len(steady) // 2]
    per = rg["collective_ms"][1:]
    mid = sorted(per, key=lambda c: sum(v for k, v in c.items()
                                        if k != "calls"))[len(per) // 2]
    grec = {"phase": "train_resnet_gspmd", "model": "resnet50",
            "width": 1.0, "image": 224, "classes": 1000,
            "dtype": "float32", "ranks": 2, "batch_per_rank": RESNET_BATCH,
            "lr": RESNET_LR, "steps": GSPMD_STEPS,
            "losses": [r["resnet_gspmd"]["losses"] for r in res],
            "step_ms": rg["step_ms"], "steady_step_ms": steady_ms,
            "images_per_s_per_card": 2 * RESNET_BATCH / (steady_ms / 1e3),
            "collective_ms_per_step": rg["collective_ms"],
            "median_step_collectives_ms": mid,
            "launches": rg["launches"],
            "launches_per_step": rg["launches_per_step"],
            "peak_memory_gb_per_rank": [r["resnet_gspmd"]["peak_gb"]
                                        for r in res],
            "replicas_equal": rg["replicas_equal"],
            "running_stats_equal": rg["stats_equal"],
            "running_stats_equal_without_comm": rg["own_stats_equal"],
            "stats_fold_ms": rg["stats_fold_ms"]}
    print(json.dumps(grec), flush=True)
    for r in res:
        g = r["resnet_gspmd"]
        if not all(math.isfinite(x) for x in g["losses"]):
            raise AssertionError(f"GSPMD ResNet-50 loss {g['losses']}")
        if any(c["ring_allreduce"] or c["ring_reduce_scatter"]
               or c["ring_allgather"] for c in g["launches_per_step"]):
            raise AssertionError("the GSPMD path launched a ring kernel")
    if not (rg["replicas_equal"] and rg["stats_equal"]):
        raise AssertionError("the GSPMD ResNet-50's ranks differ: params "
                             f"{rg['replicas_equal']}, running statistics "
                             f"{rg['stats_equal']}")

    # tester.
    trec = {"phase": "tester", "ranks": 2, "dtype": "float32",
            "sizes": f"2^{TESTER_MIN_POW}..2^{TESTER_MAX_POW} with jitter",
            "warmup": TESTER_WARMUP, "iters": TESTER_ITERS, "fence": "sync"}
    for impl, sw in r0["tester"].items():
        for r in sw["results"]:
            n = r["elements"]
            bound = ring_bench.bound_ms(r["collective"], n, 2, 4)
            print(f"tester {impl:>5} {r['collective']:>14} n={n:>8} "
                  f"t={r['mean_seconds'] * 1e6:10.1f} us "
                  f"bus={r['bus_gbs']:8.3f} GB/s "
                  f"bound={bound * 1e3:9.1f} us"
                  f"{' checked' if r['checked'] else ''}", flush=True)
        trec[impl] = {"launches": sw["launches"],
                      "checked": sum(r["checked"] for r in sw["results"]),
                      "us": {r["collective"]: [x["mean_seconds"] * 1e6
                                               for x in sw["results"]
                                               if x["collective"]
                                               == r["collective"]]
                             for r in sw["results"]}}
    print(json.dumps(trec), flush=True)
    n_sizes = TESTER_MAX_POW - TESTER_MIN_POW + 1
    for impl, sw in r0["tester"].items():
        if sum(r["checked"] for r in sw["results"]) != 3:
            raise AssertionError(f"tester {impl}: not one check per "
                                 f"collective")
        if len(sw["results"]) != 3 * n_sizes:
            raise AssertionError(f"tester {impl}: {len(sw['results'])} "
                                 f"configs")
    ring_l = r0["tester"]["ring"]["launches"]
    per_coll = n_sizes * (TESTER_WARMUP + TESTER_ITERS) + 1
    if ring_l != {k: per_coll for k in RING_KERNELS}:
        raise AssertionError(f"tester ring launches {ring_l}, expected "
                             f"{per_coll} each")
    if any(r0["tester"]["eager"]["launches"].values()):
        raise AssertionError("the eager sweep launched a ring kernel")

    prec = {"phase": "profiler", "window": list(PROFILE_WINDOW),
            "run": "train_mnist_options adam_rings, rank 0",
            "steps": breakdown["steps"],
            "device_ms_per_step": breakdown["total_ms_per_step"],
            "categories": breakdown["categories"][:8],
            "top_ops": breakdown["top_ops"][:8], "lines": len(lines)}
    print(json.dumps(prec), flush=True)
    if breakdown["steps"] != PROFILE_WINDOW[1] - PROFILE_WINDOW[0] or not (
            breakdown["total_ms_per_step"] > 0):
        raise AssertionError(f"profiler breakdown wrong: {prec}")
    return {"mnist_options": rec, "resnet_gspmd": grec, "tester": trec,
            "profiler": prec, "seconds": seconds}


# The hierarchy phase: 4 ranks on the one card, config 1's gradient size
# (the MLP 784-1024-1024-10's 1,863,690 f32) and 2^23; B1 once at the
# collectives path's size under the span over both levels of a 2x2 split;
# host rings with a stalled peer's deadline.
HIER_RANKS = 4
HIER_SIZES = (784 * 1024 + 1024 + 1024 * 1024 + 1024 + 1024 * 10 + 10, 1 << 23)
HIER_RING_N = 25_557_032
HIER_DEADLINE_MS = 30_000          # every host ring wait: a hang fails
HIER_STALL_MS = 1_000              # the forced stall's deadline
HIER_TIMED_CALLS = 5


def _hier_inputs(torch, n, p, device):
    """Every rank's integer-valued f32 vector (in [-8, 8], from a seed a
    rank): any order of summation gives the same bits."""
    return [torch.randint(-8, 9, (n,), dtype=torch.float32, device=device,
                          generator=torch.Generator(device=device)
                          .manual_seed(7919 + r)) for r in range(p)]


def _hier_plain(torch, what, groups, me, xs, root=0):
    """The plain result of a grouped collective for rank ``me``: the group
    (a group of its own for a rank in none) reduced, broadcast or reduced
    to a root from every member's input."""
    full = list(groups or [tuple(range(len(xs)))])
    full += [(r,) for r in range(len(xs)) if not any(r in g for g in full)]
    g = next(g for g in full if me in g)
    rows = torch.stack([xs[r] for r in g])
    if what == "broadcast":
        return xs[g[root]].clone()
    red = rows.max(0).values if what == "max" else rows.sum(0)
    if what == "mean":
        red = red * (1.0 / len(g))          # exact: groups of 1, 2 and 4
    if what.startswith("reduce"):
        return red if me == g[root] else xs[me].clone()
    return red


def hierarchy_rank_main() -> dict:
    """One rank of the hierarchy phase (spawned, 4 ranks on the card)."""
    import torch
    import torch.distributed as dist

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch.collectives import (cuda_ring, eager,
                                                hierarchical, hostcomm,
                                                selector)
    from torchmpi_tpu_torch.runtime import config
    from torchmpi_tpu_torch.runtime.failure import HostcommTimeout

    t_start = time.perf_counter()
    dev = mpi.start()
    world = mpi.stack.world()
    me, p = world.rank, world.size
    bad, done = [], []

    def check(name, got, want):
        done.append(name)
        same = (got.dtype == want.dtype and got.shape == want.shape
                and torch.equal(got.contiguous().view(torch.uint8),
                                want.contiguous().view(torch.uint8)))
        if not same:
            bad.append(name)

    def fact(name, ok):
        done.append(name)
        if not ok:
            bad.append(name)

    try:
        # --- device plane: CUDA tensors through the mpi surface ---------
        t0 = time.perf_counter()
        intra, inter = ((0, 1), (2, 3)), ((0, 2), (1, 3))
        for n in HIER_SIZES:
            xs = _hier_inputs(torch, n, p, dev)
            x = xs[me]
            config.reset()
            mpi.stack.reset(world)
            mpi.push_communicator(lambda r: r // 2)
            fact("2x2 is cartesian", mpi.stack.current().cartesian)
            for label, move, want_groups in (
                    ("intra", lambda: mpi.set_communicator(1), intra),
                    ("inter", lambda: mpi.set_communicator(
                        1, mpi.CommunicatorType.INTER), inter),
                    ("span(0,2)", lambda: mpi.set_collective_span(0, 2),
                     None)):
                move()
                _, groups = hierarchical.groups_for_cursor(mpi.stack)
                fact(f"2x2 {label} groups", groups == want_groups)
                tag = f"2x2 {label} n={n}"
                for op in ("sum", "mean", "max"):
                    check(f"{tag} allreduce {op}", mpi.allreduce(x, op=op),
                          _hier_plain(torch, op, groups, me, xs))
                check(f"{tag} broadcast", mpi.broadcast(x, root=1),
                      _hier_plain(torch, "broadcast", groups, me, xs, 1))
                check(f"{tag} reduce", mpi.reduce(x, root=0),
                      _hier_plain(torch, "reduce", groups, me, xs))
            # The tree: 3 + 1 under use_tree_communicators.
            config.reset(use_tree_communicators=True,
                         use_cartesian_communicators=False)
            mpi.stack.reset(world)
            mpi.push_communicator(lambda r: int(r == 3))
            lv = mpi.stack.current()
            fact("3+1 is a tree", not lv.cartesian
                 and lv.group_ranks == ((0, 1, 2), (3,)))
            tag = f"tree 3+1 n={n}"
            check(f"{tag} allreduce_tree sum",
                  hierarchical.allreduce_tree(lv, x),
                  _hier_plain(torch, "sum", None, me, xs))
            check(f"{tag} allreduce_tree mean",
                  hierarchical.allreduce_tree(lv, x, op="mean"),
                  _hier_plain(torch, "mean", None, me, xs))
            for root in (0, 3):
                check(f"{tag} broadcast_tree root {root}",
                      hierarchical.broadcast_tree(lv, x, root=root),
                      xs[root])
                check(f"{tag} reduce_tree root {root}",
                      hierarchical.reduce_tree(lv, x, root=root),
                      _hier_plain(torch, "reduce", None, me, xs, root))
            out, counts = eager.allgatherv(world, x, groups=lv.group_ranks)
            g = lv.group_ranks[lv.group_of_rank(me)]
            want = torch.zeros((3, n), device=dev)
            want[:len(g)] = torch.stack([xs[r] for r in g])
            check(f"{tag} allgatherv", out, want)
            fact(f"{tag} allgatherv counts", list(counts) == [3, 3, 3, 1])
            # The world level: alltoall and the scalar forms.
            config.reset()
            mpi.stack.reset(world)
            m = n - n % p
            check(f"world alltoall n={m}", mpi.alltoall(x[:m]), torch.cat(
                [xs[r][:m].view(p, m // p)[me] for r in range(p)]))
            v = me + 0.5
            fact(f"world scalars n={n}",
                 mpi.broadcast_scalar(v, root=2) == 2.5
                 and mpi.reduce_scalar(v, root=1) == (8.0 if me == 1 else v)
                 and mpi.sendreceive_scalar(v, src=0, dst=3)
                 == (0.5 if me == 3 else v))
            del xs, x
        device_s = time.perf_counter() - t0

        # --- B1 under the span over both levels of the 2x2 split ---------
        config.reset(use_pallas_collectives=True)
        mpi.stack.reset(world)
        mpi.push_communicator(lambda r: r // 2)
        mpi.set_collective_span(0, 2)
        comm, groups = hierarchical.groups_for_cursor(mpi.stack)
        xs = _hier_inputs(torch, HIER_RING_N, p, dev)
        torch.cuda.synchronize()
        _reset_ring_counts()
        out = selector.resolve("allreduce")(comm, xs[me], groups=groups)
        torch.cuda.synchronize()
        launches = _ring_counts()
        fact("span (0,2) resolves to the world with no groups",
             comm is world and groups is None)
        fact("B1 once", launches == {"ring_allreduce": 1,
                                     "ring_reduce_scatter": 0,
                                     "ring_allgather": 0})
        want = cuda_ring._oneshot_allreduce_plain(xs)[me]
        check("B1 under span (0,2) vs plain", out, want)
        ring_err = float((out.double() - want.double()).abs().max())
        del xs, out, want
        config.reset()
        mpi.stack.reset(world)
        torch.cuda.empty_cache()

        # --- host plane: rings wired from endpoints gathered over gloo ---
        t1 = time.perf_counter()
        groups2 = [[0, 1], [2, 3]]
        ports = [None] * p
        dist.all_gather_object(ports, hostcomm.free_ports(3))
        lo = lambda i: [("127.0.0.1", q[i]) for q in ports]  # noqa: E731
        ring_kw = dict(timeout_ms=60_000, io_deadline_ms=HIER_DEADLINE_MS)
        flat = hostcomm.HostCommunicator(me, p, lo(0), **ring_kw)
        hier = hostcomm.HierarchicalHostCommunicator(
            me, groups2, lo(1), [lo(2)[g[0]] for g in groups2], **ring_kw)
        n = HIER_SIZES[0]
        # The device plane's integer-valued inputs: every partial sum of
        # four of them is an integer of at most 32, exact in bf16 too, so
        # a piece at the wrong offset or reduced twice changes the bits.
        xs = _hier_inputs(torch, n, p, dev)
        for dtype in (torch.float32, torch.bfloat16):
            on_card = xs[me].to(dtype)

            def pinned():
                buf = torch.empty(n, dtype=dtype, pin_memory=True)
                return buf.copy_(on_card)

            def plain(what, root=0):
                return _hier_plain(torch, what, None, me, xs, root).to(
                    dtype).cpu()

            dt = str(dtype).replace("torch.", "")
            for name, ring in (("flat", flat), ("hierarchical", hier)):
                tag = f"host {name} {dt}"
                check(f"{tag} allreduce", ring.allreduce(pinned()),
                      plain("sum"))
                check(f"{tag} broadcast", ring.broadcast(pinned(), root=2),
                      plain("broadcast", 2))
                check(f"{tag} reduce", ring.reduce(pinned(), root=1),
                      plain("reduce", 1))
                check(f"{tag} allgather", ring.allgather(pinned()),
                      torch.cat(xs).to(dtype).cpu())
                check(f"{tag} sendreceive",
                      ring.sendreceive(pinned(), src=1, dst=3),
                      (xs[1] if me == 3 else xs[me]).to(dtype).cpu())
                ring.barrier()
            check(f"host flat {dt} allreduce_async",
                  flat.allreduce_async(pinned()).wait(), plain("sum"))
            # The selector's host column: a CPU tensor in a world started
            # on the card, the ring attached to the world.
            world.host_ring = flat
            try:
                buf = pinned()
                fact(f"host column {dt} selected",
                     selector.select(payload=buf) == "hostcomm")
                check(f"host column {dt} allreduce mean",
                      selector.resolve("allreduce", payload=buf)(
                          world, buf, op="mean"), plain("mean"))
            finally:
                world.host_ring = None
        del xs
        host_s = time.perf_counter() - t1

        # --- yardsticks: the f32 allreduce of config 1's size -------------
        def timed(fn, sync=False):
            ms = []
            for i in range(HIER_TIMED_CALLS + 1):
                dist.barrier()
                a = time.perf_counter()
                fn()
                if sync:
                    torch.cuda.synchronize()
                if i:
                    ms.append((time.perf_counter() - a) * 1e3)
            return sorted(ms)[len(ms) // 2], ms

        host_buf = torch.empty(n, pin_memory=True).copy_(
            torch.full((n,), float(me), device=dev))
        card_x = torch.full((n,), float(me), device=dev)
        yard = {
            "host_ring": timed(lambda: flat.allreduce(host_buf)),
            "gloo_host": timed(lambda: dist.all_reduce(host_buf)),
            "b1_card": timed(lambda: cuda_ring.ring_allreduce(world, card_x),
                             sync=True)}

        # --- a stalled peer: rank 1 never enters -------------------------
        sp = [None] * p
        dist.all_gather_object(sp, hostcomm.free_ports(1)[0])
        stall = None
        pair = None
        if me < 2:
            pair = hostcomm.HostCommunicator(
                me, 2, [("127.0.0.1", sp[0]), ("127.0.0.1", sp[1])],
                timeout_ms=60_000, io_deadline_ms=HIER_STALL_MS,
                io_timeout_ms=60_000)
        if me == 0:
            a = time.perf_counter()
            try:
                pair.allreduce(torch.ones(1 << 16))
                stall = {"raised": None}
            except HostcommTimeout as e:
                stall = {"raised": "HostcommTimeout", "message": str(e)}
            stall["seconds"] = time.perf_counter() - a
            stall["deadline_ms"] = HIER_STALL_MS
            fact("a stalled peer raises HostcommTimeout in time",
                 stall["raised"] == "HostcommTimeout"
                 and stall["seconds"] < HIER_STALL_MS / 1e3 + 4.0)
        dist.barrier()
        if pair is not None:
            pair.close()
        flat.close()
        hier.close()
        return {"rank": me, "checks": len(done), "bad": bad,
                "launches": launches, "ring_max_abs_err": ring_err,
                "yardsticks_ms": yard, "stall": stall,
                "device_plane_s": device_s, "host_plane_s": host_s,
                "seconds": time.perf_counter() - t_start}
    finally:
        mpi.stop()


def phase_hierarchy():
    """The hierarchical communicators and the host plane on 4 ranks of the
    one card; returns rank 0's record."""
    from torchmpi_tpu_torch.collectives import hostcomm
    from torchmpi_tpu_torch.runtime import launch

    t0 = time.perf_counter()
    hostcomm.lib()              # build the host plane once, before the ranks
    build_s = time.perf_counter() - t0
    res = launch.spawn(HIER_RANKS, hierarchy_rank_main, (), timeout_s=600)
    r0 = res[0]
    bad = {r["rank"]: r["bad"] for r in res if r["bad"]}
    yard = {k: {"median_ms": v[0], "ms": v[1]}
            for k, v in r0["yardsticks_ms"].items()}
    emit(phase="hierarchy", ranks=HIER_RANKS, sizes=list(HIER_SIZES),
         checks=[r["checks"] for r in res], failed=bad,
         launches=[r["launches"] for r in res],
         ring_n=HIER_RING_N, ring_max_abs_err=r0["ring_max_abs_err"],
         stall=r0["stall"], host_build_s=build_s,
         device_plane_s=r0["device_plane_s"],
         host_plane_s=r0["host_plane_s"], rank0_s=r0["seconds"],
         seconds=time.perf_counter() - t0)
    emit(phase="hierarchy_yardsticks", n=HIER_SIZES[0], dtype="float32",
         ranks=HIER_RANKS, where="host ring and gloo: the card's host CPU "
         "over loopback; B1: the card, ranks time-sliced", **yard)
    if bad:
        raise AssertionError(f"hierarchy phase checks failed: {bad}")
    return r0


# The mesh phase (BASELINE config 5's dp x tp x sp): ranks spawned on the
# one card (gloo; every tp sum and ring shift stages its wire buffer
# through the host).  Llama-3-8B width, depth cut to MESH_LAYERS for the
# training runs; the generate run at MESH_GEN_LAYERS (the --layers depth).
MESH_LAYERS = 2
MESH_L, MESH_CHUNK, MESH_STEPS = 4096, 512, 2
MESH_ADAM_L, MESH_ADAM_LR = 2048, 1e-4
MESH_GEN_PROMPT, MESH_GEN_NEW = 2048, 16
MESH_F32_LAYERS, MESH_F32_PROMPT, MESH_F32_NEW = 2, 256, 8
MESH_SEED = 15
MESH_WIRE_CALLS = 5
# The updated leaves held against the one-rank step: a corner of this
# rank's shard of each (both layers; up to 64 rows and 128 columns), and
# the embedding rows of the batch's first 32 tokens.
MESH_SAMPLE = (("layers", "wq"), ("layers", "wk"), ("layers", "wv"),
               ("layers", "wo"), ("layers", "w_gate"), ("layers", "w_up"),
               ("layers", "w_down"), ("layers", "attn_norm"),
               ("layers", "mlp_norm"), ("norm",), ("head",))
PLAIN_FNS = ("_flash_bh_plain", "_flash_bh_bwd_dq_plain",
             "_flash_bh_bwd_dkv_plain")
# Every block the mesh phase's rings hand B4-B6 ({sp 2, tp 2}, L = 4096:
# 16 local heads, a 2048-row sp chunk, zigzag's 1024-row halves), bf16 in
# and f32 out: (name, Lq, Lk, causal).  ring: the diagonal, then sp rank
# 1's past chunk; zigzag: its pair's three blocks, then (2Lc x Lc) where
# the chunk pair came from an earlier rank and (Lc x 2Lc) from a later one.
MESH_BLOCK_BH = 16
MESH_BLOCKS = (("ring_diag", 2048, 2048, True),
               ("ring_past", 2048, 2048, False),
               ("zigzag_diag", 1024, 1024, True),
               ("zigzag_late_on_early", 1024, 1024, False),
               ("zigzag_pair_on_early", 2048, 1024, False),
               ("zigzag_late_on_pair", 1024, 2048, False))


def ring_blocks(attn: str, p: int, me: int) -> int:
    """Flash blocks of one ring attention call on sp rank ``me`` of ``p``
    (forward launches; the backward launches dq and dk/dv once a block):
    the causal contiguous ring attends its own diagonal and the me past
    chunks; the zigzag ring three blocks of its own pair, then one a
    step."""
    return me + 1 if attn == "ring" else 3 + (p - 1)


def _count_plain(fa) -> dict:
    """Wrap the flash plain versions with call counters (the card's mesh
    path must never reach them)."""
    calls = {name: 0 for name in PLAIN_FNS}
    for name in PLAIN_FNS:
        fn = getattr(fa, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        setattr(fa, name, wrapped)
    return calls


class _WireClock:
    """Host wall time a mesh step spends in each wire, by name: the tp
    sums (``tp._tp_sum``), the ring shifts (``innerjit.shift_raw``), the
    gradients' sync (``eager.allreduce_``: the dp x sp mean and zero1's
    reduce; ``eager.allgather``: zero1's gather) and the loss's tp
    reductions (``innerjit.allreduce`` outside a tp sum).  Each call is
    bracketed by CUDA synchronizations, so the card's queued work is not
    counted as the wire's; a call inside another clocked call counts only
    in the outer one."""

    def __init__(self, torch, tp_mod=None, innerjit=None, eager=None,
                 wires=None):
        self.torch = torch
        self.ms, self.calls = {}, {}
        self._depth = 0
        self._undo = []
        if wires is None:
            wires = ((tp_mod, "_tp_sum", "tp_sum"),
                     (innerjit, "shift_raw", "ring_shift"),
                     (innerjit, "allreduce", "loss"),
                     (eager, "allreduce_", "grad_sync"),
                     (eager, "allgather", "grad_sync"))
        for mod, fn, name in wires:
            orig = getattr(mod, fn)
            setattr(mod, fn, self._timed(orig, name))
            self._undo.append((mod, fn, orig))

    def _timed(self, fn, name):
        def wrapped(*a, **kw):
            if self._depth:
                return fn(*a, **kw)
            self._depth += 1
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.torch.cuda.synchronize()
                self._depth -= 1
                self.ms[name] = self.ms.get(name, 0.0) + (
                    time.perf_counter() - t0) * 1e3
                self.calls[name] = self.calls.get(name, 0) + 1
        return wrapped

    def read(self) -> dict:
        """The ms and calls by wire since the last read."""
        out = {"ms": self.ms, "calls": self.calls}
        self.ms, self.calls = {}, {}
        return out

    def close(self) -> None:
        for mod, fn, orig in reversed(self._undo):
            setattr(mod, fn, orig)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _shard_sample(llama, mesh, cfg, params, path):
    """(global start of each dim, a corner of this rank's shard of leaf
    ``path`` as f32 numpy)."""
    from torchmpi_tpu_torch.models._common import mesh_spec

    leaf = _get(params, path)
    spec = mesh_spec(_get(llama.param_specs(cfg), path), mesh,
                     _get(llama.param_shapes(cfg), path))
    starts, index = [], []
    for dim, n in enumerate(leaf.shape):
        take = n if (path[0] == "layers" and dim == 0) else min(
            n, 128 if dim == leaf.dim() - 1 else 64)
        ax = spec[dim] if dim < len(spec) else None
        starts.append(mesh.coords[ax] * n if ax is not None else 0)
        index.append(slice(0, take))
    arr = leaf.detach()[tuple(index)].float().cpu().numpy()
    return starts, arr


def _samples(llama, mesh, cfg, params, tokens):
    out = {".".join(p): _shard_sample(llama, mesh, cfg, params, p)
           for p in MESH_SAMPLE}
    rows = tokens[0, :32].long()
    out["embed"] = (None, params["embed"].detach()[rows, :128]
                    .float().cpu().numpy())
    return out


def _ref_region(leaf, key, starts, like, tokens):
    """The region of a whole leaf that a rank's sample holds (the
    embedding: the batch's first 32 token rows), as f32 numpy."""
    if key == "embed":
        rows = tokens[0, :32].long()
        return leaf.detach()[rows, :128].float().cpu().numpy()
    index = tuple(slice(s0, s0 + n) for s0, n in zip(starts, like.shape))
    return leaf.detach()[index].float().cpu().numpy()


def _mesh_tokens(torch, train_mod, cfg, n_seq, L, seed):
    data, _ = train_mod.synthetic_tokens(cfg, n_seq=n_seq, seq_len=L,
                                         seed=seed)
    batch = torch.from_numpy(data).to("cuda", torch.long)
    return batch[:, :-1], batch[:, 1:]


def _mesh_train_runs(torch, llama, fa, train_mod, mesh_mod, optim):
    """(i) {sp 2, tp 2}: MESH_STEPS SGD steps under ring and ring-zigzag;
    the wire timings; (ii) {dp 2, tp 2}: Adam with zero1."""
    from torchmpi_tpu_torch.collectives import eager, innerjit
    from torchmpi_tpu_torch.parallel import tp as tp_mod
    from torchmpi_tpu_torch.utils import tree

    cfg = dataclasses.replace(llama.llama3_8b(), n_layers=MESH_LAYERS)
    clock = _WireClock(torch, tp_mod, innerjit, eager)
    try:
        return _mesh_train_body(torch, llama, fa, train_mod, mesh_mod,
                                optim, cfg, clock, tp_mod, innerjit, tree)
    finally:
        clock.close()


def _mesh_train_body(torch, llama, fa, train_mod, mesh_mod, optim, cfg,
                     clock, tp_mod, innerjit, tree):
    """:func:`_mesh_train_runs` with its wire clock installed."""
    out = {"runs": {}}
    mesh = mesh_mod.make_mesh({"sp": 2, "tp": 2})
    out["coords_sp_tp"] = mesh.coords
    g = torch.Generator(device="cuda").manual_seed(MESH_SEED)
    shard0 = llama.shard_params(llama.init(g, cfg, dtype=torch.bfloat16),
                                mesh, cfg)
    torch.cuda.empty_cache()
    tokens, targets = _mesh_tokens(torch, train_mod, cfg, 1, MESH_L, 0)
    sp_i = mesh.coords["sp"]
    for attn in ("ring", "ring-zigzag"):
        params = tree.tree_map(lambda t: t.clone(), shard0)
        step = llama.make_train_step(cfg, mesh, lr=TRAIN_LR, attn=attn,
                                     remat=TRAIN_REMAT,
                                     loss_chunk=MESH_CHUNK)
        blocks = ring_blocks(attn, 2, sp_i)
        expected = {"flash_attention_fwd": FWD_PER_LAYER[TRAIN_REMAT]
                    * cfg.n_layers * blocks,
                    "flash_attention_bwd_dq": cfg.n_layers * blocks,
                    "flash_attention_bwd_dkv": cfg.n_layers * blocks}
        losses, step_ms, per_step, sample, wires = [], [], [], None, []
        reset_counts(fa)
        for i in range(MESH_STEPS):
            before = read_counts(fa)
            torch.cuda.synchronize()
            clock.read()
            t0 = time.perf_counter()
            params, _, loss = step(params, None, tokens, targets)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            wires.append(clock.read())
            losses.append(float(loss))
            after = read_counts(fa)
            per_step.append({k: after[k] - before[k] for k in after})
            if i == 0:
                sample = _samples(llama, mesh, cfg, params, tokens)
        out["runs"][attn] = {"losses": losses, "step_ms": step_ms,
                             "wires": wires[-1],
                             "launches": read_counts(fa),
                             "launches_per_step": per_step,
                             "expected_per_step": expected,
                             "sample": sample}
        del params, step
        torch.cuda.empty_cache()
    # The wires, timed alone on this path's shapes: a tp sum of one
    # layer's (1, 2048, 4096) activations on the f32 wire, and the ring
    # shift of this rank's K/V chunk (4 KV heads, 2048 x 128, bf16) and of
    # a backward step's dk/dv (f32) with the next K/V.
    x = torch.randn((1, MESH_L // 2, cfg.d_model), device="cuda",
                    dtype=torch.bfloat16)
    kv = [torch.randn((4, MESH_L // 2, 128), device="cuda",
                      dtype=torch.bfloat16) for _ in range(2)]
    dkv = [t.float() for t in kv]
    sp_comm = mesh.comm("sp")

    def wire_ms(fn):
        ms = []
        for _ in range(MESH_WIRE_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return sorted(ms)[len(ms) // 2]

    with torch.no_grad():
        out["tp_sum_ms"] = wire_ms(lambda: tp_mod.block_output(
            x, "tp", mesh=mesh))
        out["ring_shift_kv_ms"] = wire_ms(
            lambda: innerjit.shift_raw(kv, sp_comm))
        out["ring_shift_bwd_ms"] = wire_ms(
            lambda: innerjit.shift_raw(dkv + kv, sp_comm))
    out["grad_bytes"] = sum(t.numel() * t.element_size()
                            for t in tree.leaves(shard0))
    del shard0, x, kv, dkv
    torch.cuda.empty_cache()

    # (ii) {dp 2, tp 2}: Adam with zero1, flash on this rank's heads.
    mesh2 = mesh_mod.make_mesh({"dp": 2, "tp": 2})
    out["coords_dp_tp"] = mesh2.coords
    g = torch.Generator(device="cuda").manual_seed(MESH_SEED)
    params = llama.shard_params(llama.init(g, cfg, dtype=torch.bfloat16),
                                mesh2, cfg)
    torch.cuda.empty_cache()
    tokens, targets = _mesh_tokens(torch, train_mod, cfg, 2, MESH_ADAM_L, 1)
    opt = optim.adam(MESH_ADAM_LR)
    st = opt.init(llama.zero1_param_blocks(params, mesh2, cfg))
    step = llama.make_train_step(cfg, mesh2, attn="flash", remat=TRAIN_REMAT,
                                 loss_chunk=MESH_CHUNK, optimizer=opt,
                                 zero1=True, opt_state_example=st)
    expected = {"flash_attention_fwd": FWD_PER_LAYER[TRAIN_REMAT]
                * cfg.n_layers, "flash_attention_bwd_dq": cfg.n_layers,
                "flash_attention_bwd_dkv": cfg.n_layers}
    losses, step_ms, per_step, sample, wires = [], [], [], None, []
    reset_counts(fa)
    for i in range(MESH_STEPS):
        before = read_counts(fa)
        torch.cuda.synchronize()
        clock.read()
        t0 = time.perf_counter()
        params, st, loss = step(params, st, tokens, targets)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        wires.append(clock.read())
        losses.append(float(loss))
        after = read_counts(fa)
        per_step.append({k: after[k] - before[k] for k in after})
        if i == 0:
            sample = _samples(llama, mesh2, cfg, params, tokens)
    mu, p_leaves = tree.leaves(st[0].mu), tree.leaves(params)
    out["adam"] = {"losses": losses, "step_ms": step_ms,
                   "wires": wires[-1],
                   "launches": read_counts(fa), "launches_per_step": per_step,
                   "expected_per_step": expected, "sample": sample,
                   "moment_share": sum(m.numel() for m in mu)
                   / sum(p.numel() for p in p_leaves),
                   "moments_own_dtype": all(m.dtype == p.dtype for m, p
                                            in zip(mu, p_leaves))}
    del params, st, step, mu, p_leaves
    torch.cuda.empty_cache()
    return out


def _mesh_generate_runs(torch, llama, fa, mesh_mod, gen_layers):
    """(iii) {tp 2}: make_generate_fn(mesh=) at gen_layers bf16 and at
    MESH_F32_LAYERS f32."""
    out = {}
    mesh = mesh_mod.make_mesh({"tp": 2})
    for name, layers, dtype, plen, new in (
            ("bf16", gen_layers, torch.bfloat16, MESH_GEN_PROMPT,
             MESH_GEN_NEW),
            ("f32", MESH_F32_LAYERS, torch.float32, MESH_F32_PROMPT,
             MESH_F32_NEW)):
        cfg = dataclasses.replace(llama.llama3_8b(), n_layers=layers)
        g = torch.Generator(device="cuda").manual_seed(MESH_SEED)
        params = llama.shard_params(llama.init(g, cfg, dtype=dtype), mesh,
                                    cfg)
        torch.cuda.empty_cache()
        prompt = torch.randint(0, cfg.vocab, (1, plen), generator=g,
                               device="cuda")
        fn = llama.make_generate_fn(cfg, plen, new, mesh=mesh)
        # Warm-up on a short prompt (cuBLAS's first calls, the decode's
        # shapes); the counts are set to 0 after it.
        llama.make_generate_fn(cfg, 128, 2, mesh=mesh)(params,
                                                       prompt[:, :128])
        torch.cuda.synchronize()
        reset_counts(fa)
        t0 = time.perf_counter()
        toks = fn(params, prompt)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = read_counts(fa)
        # The prefill alone (as fn runs it: this rank's KV heads in the
        # cache), timed, and its last-row logits.
        plan = llama._MeshPlan(cfg, mesh)
        kv = params["layers"]["wk"].shape[-1] // cfg.head_dim
        shape = (cfg.n_layers, 1, plen + new, kv, cfg.head_dim)
        cache = {"k": torch.zeros(shape, dtype=dtype, device="cuda"),
                 "v": torch.zeros(shape, dtype=dtype, device="cuda")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = llama._prefill(cfg, params, cache, prompt, tp=plan)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out[name] = {"n_layers": layers, "prompt_len": plen, "max_new": new,
                     "tokens": toks.cpu().tolist()[0], "launches": launches,
                     "total_ms": total_s * 1e3, "prefill_ms": prefill_s * 1e3,
                     "decode_ms_per_token": (total_s - prefill_s) * 1e3
                     / (new - 1),
                     "last_logits": logits.float().cpu().numpy()}
        del params, cache, logits
        torch.cuda.empty_cache()
    return out


def mesh_rank_main(part: str, gen_layers: int = 32) -> dict:
    """One rank of the mesh phase (spawned on the one card)."""
    import importlib

    import torch

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import optim
    from torchmpi_tpu_torch.examples import train_llama as train_mod
    from torchmpi_tpu_torch.models import llama
    from torchmpi_tpu_torch.parallel import mesh as mesh_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    # Four ranks share the card: let freed blocks serve other sizes (read
    # at the rank's first allocation on the card).
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    fa = importlib.import_module("torchmpi_tpu_torch.ops.flash_attention")
    plain = _count_plain(fa)
    t0 = time.perf_counter()
    mpi.start()
    try:
        if part == "train":
            out = _mesh_train_runs(torch, llama, fa, train_mod, mesh_mod,
                                   optim)
        else:
            out = _mesh_generate_runs(torch, llama, fa, mesh_mod, gen_layers)
        out.update(rank=mpi.rank(), plain_calls=dict(plain),
                   seconds=time.perf_counter() - t0,
                   max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        return out
    except BaseException:
        # Every rank's own traceback (the phase raises the first one's).
        import traceback

        print(f"mesh rank {mpi.rank()}: {traceback.format_exc()}",
              file=sys.stderr, flush=True)
        raise
    finally:
        mpi.stop()


# Step 1's loss against the one-rank step's: the same bf16 forward with
# its sums in other orders (the tp sums on the f32 wire, the ring's lse
# combination).  The last step's: the updates of step 1 differ in the last
# place of some elements too, and it is the loss that sees a wrong
# gradient.  On an NVIDIA H100 80GB HBM3 at 700 W (tools/mesh_faults.py)
# sound runs read up to 2.1e-5 and 2.2e-4; every ring block's dq halved
# reads 1.7e-2 at the last step, the ring's past block left out 0.24 (and
# only 2.9e-5 at step 1: at random init the loss hardly sees attention).
MESH_LOSS_RTOL = 1e-4
MESH_LAST_LOSS_RTOL = 1e-3
MESH_LOGITS_RTOL = 5e-2
# The updated leaves against the one-rank step.  SGD, bf16 leaves: both
# are bf16 roundings of p - lr g with g summed in other orders (the tp
# sums on the f32 wire, the sp ring, the gradients' mean), so most
# elements that either update moves round alike: at least
# MESH_MOVED_EQUAL of them bit for bit (a wrong gradient, a factor 2 or a
# missing share, changes the rounding of most of them; near-zero elements
# differ by many of their own ulps with no fault, so no per-element ulp
# bound).  f32 leaves (the norms): the difference within MESH_F32_REL of
# the one-rank update's norm.  Adam (step 1 is -lr g/(|g| + eps), about
# lr a moved element): the bf16 bound of tests/test_torch_llama_train.py
# for one step, 2 lr + 2^-8 max|p| per element and lr / 4 on the mean
# difference.  On an NVIDIA H100 80GB HBM3 at 700 W (tools/mesh_faults.py)
# the bf16 shares of sound runs read 0.89-0.97; with every ring block's dq
# halved wq reads 0.17, with the ring's past block left out every leaf
# 0.22 or less.
MESH_MOVED_EQUAL = 0.8
MESH_F32_REL = 5e-2


def _leaf_stats(np, sample, after, before, tokens, adam_lr=None):
    """Per sampled leaf, a rank's updated values against the one-rank
    run's (see MESH_MOVED_EQUAL): the mean difference, the shares of
    elements equal bit for bit (of all, and of those either update
    moved), the share the one-rank update moved, the difference's norm
    over the one-rank update's; for Adam the largest difference and its
    bound."""
    out = {}
    for key, (starts, arr) in sample.items():
        want = _ref_region(after[key], key, starts, arr, tokens)
        p0 = _ref_region(before[key], key, starts, arr, tokens)
        diff = np.abs(arr - want)
        moved = (want != p0) | (arr != p0)
        rec = {"mean_abs_diff": float(diff.mean()),
               "equal_share": float((arr == want).mean()),
               "moved_share_ref": float((want != p0).mean()),
               "moved_equal_share": float((arr == want)[moved].mean())
               if moved.any() else 1.0,
               "diff_over_update": float(np.linalg.norm(diff)
                                         / max(np.linalg.norm(want - p0),
                                               1e-30))}
        if adam_lr is not None:
            rec["max_abs_diff"] = float(diff.max())
            rec["bound"] = 2 * adam_lr + 2.0 ** -8 * float(np.abs(want).max())
            rec["ok"] = (rec["max_abs_diff"] <= rec["bound"]
                         and rec["mean_abs_diff"] <= adam_lr / 4)
        elif str(after[key].dtype) == "torch.bfloat16":
            rec["ok"] = rec["moved_equal_share"] >= MESH_MOVED_EQUAL
        else:
            rec["ok"] = rec["diff_over_update"] <= MESH_F32_REL
        out[key] = rec
    return out


def _merge_leaves(per_rank: list) -> dict:
    """Each leaf's statistics over the ranks: the worst of each."""
    out = {}
    for key in per_rank[0]:
        rows = [r[key] for r in per_rank]
        out[key] = {k: (min(r[k] for r in rows) if k in (
            "equal_share", "moved_share_ref", "moved_equal_share", "ok")
            else max(r[k] for r in rows)) for k in rows[0]}
    return out


def mesh_blocks(torch, fa):
    """B4, B5 and B6 as the rings call them (``flash_fwd_block`` and
    ``flash_bwd_block``, bf16 in, f32 out) at every block of MESH_BLOCKS,
    each against its plain version on the same inputs, the counts set to 0
    just before each kernel call and read just after.  The backward takes
    the carry's lse and delta, not the block's own: the block combined
    with a second K/V chunk's (plain versions, ``_lse_combine``), as a
    ring step hands them in.  Tolerances: phase_kernel's and
    phase_kernel_bwd's for bf16 in, f32 out (o 2e-4, lse 1e-3; dq, dk, dv
    5e-4 + 1e-3 relative).  Returns the records by block; raises on a
    disagreement."""
    from torchmpi_tpu_torch.parallel.sequence import _lse_combine

    g = torch.Generator(device="cuda").manual_seed(MESH_SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    scale = 1.0 / math.sqrt(128)
    bh = MESH_BLOCK_BH
    zero = dict.fromkeys(COUNTERS, 0)
    records = {}
    for name, lq, lk, causal in MESH_BLOCKS:
        q, do = (torch.randn((bh, lq, 128), generator=g,
                             device="cuda").to(bf16) for _ in range(2))
        k, v, k2, v2 = (torch.randn((bh, lk, 128), generator=g,
                                    device="cuda").to(bf16)
                        for _ in range(4))
        bq, bk = fa._resolve_blocks(lq, lk, None, None)
        kw = dict(scale=scale, out_dtype=f32)
        pkw = dict(kw, block_q=bq, block_k=bk)

        def fwd():
            return fa.flash_fwd_block(q, k, v, causal=causal, **kw)

        reset_counts(fa)
        o, lse = fwd()
        torch.cuda.synchronize()
        fwd_launches = read_counts(fa)
        po, plse = fa._flash_bh_plain(q, k, v, causal=causal, **pkw)
        o_c, lse_c = _lse_combine(po, plse, *fa._flash_bh_plain(
            q, k2, v2, causal=False, **pkw))
        delta = torch.sum(do.float() * o_c.to(bf16).float(), dim=-1,
                          keepdim=True)
        args = (q, k, v, do, lse_c, delta)

        def bwd():
            return fa.flash_bwd_block(*args, causal=causal, **kw)

        reset_counts(fa)
        got = bwd()
        torch.cuda.synchronize()
        bwd_launches = read_counts(fa)
        ref = (fa._flash_bh_bwd_dq_plain(*args, causal=causal, **pkw),
               *fa._flash_bh_bwd_dkv_plain(*args, causal=causal, **pkw))
        ok = (fwd_launches == dict(zero, flash_attention_fwd=1)
              and bwd_launches == dict(zero, flash_attention_bwd_dq=1,
                                       flash_attention_bwd_dkv=1)
              and bool(((o - po).abs() <= 2e-4).all())
              and float((lse - plse).abs().max()) <= 1e-3
              and o.dtype == f32 and bool(torch.isfinite(o).all()))
        errs = {}
        for gname, a, b in zip(("dq", "dk", "dv"), got, ref):
            diff = (a - b).abs()
            errs[gname] = float(diff.max())
            ok = ok and a.dtype == f32 and bool(torch.isfinite(a).all()) \
                and bool((diff <= 5e-4 + 1e-3 * b.abs()).all())
        rec = {"block": name, "bh": bh, "lq": lq, "lk": lk,
               "causal": causal, "dtype": "bfloat16", "out_dtype": "float32",
               "o_max_abs_err": float((o - po).abs().max()),
               "lse_max_abs_err": float((lse - plse).abs().max()),
               **{f"{k}_max_abs_err": e for k, e in errs.items()},
               "launches": {"fwd": fwd_launches, "bwd": bwd_launches},
               "fwd_ms": cuda_ms(torch, fwd), "bwd_ms": cuda_ms(torch, bwd),
               "ok": ok}
        emit(phase="mesh_blocks", **rec)
        if not ok:
            raise AssertionError(f"a ring block disagrees with its plain "
                                 f"version: {rec}")
        records[name] = rec
        del q, do, k, v, k2, v2, o, lse, po, plse, o_c, lse_c, delta, got, \
            ref, args
    torch.cuda.empty_cache()
    return records


def phase_mesh(torch, llama, fa, train_mod, gen_layers: int):
    """BASELINE config 5 on the one card: the ring's blocks against their
    plain versions (:func:`mesh_blocks`), then (i) {sp 2, tp 2} ring and
    ring-zigzag SGD, (ii) {dp 2, tp 2} Adam with zero1, (iii) {tp 2}
    generate; each against the one-rank run of the same entry point on
    the same parameters and tokens (run here, after the ranks)."""
    import numpy as np

    from torchmpi_tpu_torch import optim
    from torchmpi_tpu_torch.runtime import launch

    t_start = time.perf_counter()
    blocks = mesh_blocks(torch, fa)
    blocks_s = time.perf_counter() - t_start
    bad = []

    def fact(name, ok, **detail):
        if not ok:
            bad.append({"check": name, **detail})

    res = launch.spawn(4, mesh_rank_main, ("train",), timeout_s=900)
    res.sort(key=lambda r: r["rank"])
    train_s = time.perf_counter() - t_start
    cfg = dataclasses.replace(llama.llama3_8b(), n_layers=MESH_LAYERS)
    keys = [".".join(k) for k in MESH_SAMPLE] + ["embed"]

    def one_rank(L, n_seq, seed, opt, lr):
        """The one-rank run of MESH_STEPS steps: its losses, the sampled
        leaves before and after step 1 (whole), the tokens, step 1's ms."""
        g = torch.Generator(device="cuda").manual_seed(MESH_SEED)
        params = llama.init(g, cfg, dtype=torch.bfloat16)
        tokens, targets = _mesh_tokens(torch, train_mod, cfg, n_seq, L, seed)
        leaf = {k: (params["embed"] if k == "embed"
                    else _get(params, tuple(k.split(".")))) for k in keys}
        before = {k: t.detach().clone() for k, t in leaf.items()}
        st = opt.init(params) if opt is not None else None
        step = llama.make_train_step(cfg, lr=lr, attn="flash",
                                     remat=TRAIN_REMAT,
                                     loss_chunk=MESH_CHUNK, optimizer=opt)
        losses = []
        for i in range(MESH_STEPS):
            t0 = time.perf_counter()
            params, st, loss = step(params, st, tokens, targets)
            losses.append(float(loss))
            if i == 0:
                ms = (time.perf_counter() - t0) * 1e3
                # The step updates the leaves in place.
                after = {k: t.detach().clone() for k, t in leaf.items()}
        del st, step, params, leaf
        return losses, before, after, tokens, ms

    def launches_ok(name, run, r):
        fact(f"{name}: launches per step", all(
            s == run["expected_per_step"] for s in run["launches_per_step"]),
            rank=r["rank"], got=run["launches_per_step"],
            expected=run["expected_per_step"])

    def check_runs(name, runs, loss_ref, stats):
        rels, rels_last = ([abs(run["losses"][i] - loss_ref[i])
                            / abs(loss_ref[i]) for run in runs]
                           for i in (0, -1))
        for r, run, rel, rel_last, st in zip(res, runs, rels, rels_last,
                                             stats):
            fact(f"{name}: step 1 loss", rel < MESH_LOSS_RTOL,
                 rank=r["rank"], rel=rel)
            fact(f"{name}: step {MESH_STEPS} loss",
                 rel_last < MESH_LAST_LOSS_RTOL, rank=r["rank"],
                 rel=rel_last)
            fact(f"{name}: losses finite and falling",
                 all(math.isfinite(x) for x in run["losses"])
                 and run["losses"][-1] < run["losses"][0], rank=r["rank"],
                 losses=run["losses"])
            launches_ok(name, run, r)
            for key, leaf in st.items():
                fact(f"{name}: updated leaf {key}", leaf["ok"],
                     rank=r["rank"], **{k: leaf[k] for k in (
                         "moved_equal_share", "diff_over_update")})
        return {"losses": [run["losses"] for run in runs],
                "one_rank_losses": loss_ref,
                "step1_loss_rel_err": max(rels),
                "last_loss_rel_err": max(rels_last),
                "step_ms": [run["step_ms"] for run in runs],
                "wires": [run["wires"] for run in runs],
                "launches_per_step": [run["launches_per_step"][-1]
                                      for run in runs],
                "leaves": _merge_leaves(stats)}

    records = {}
    loss_ref, before, after, tokens, ref_ms = one_rank(
        MESH_L, 1, 0, None, TRAIN_LR)
    for attn in ("ring", "ring-zigzag"):
        runs = [r["runs"][attn] for r in res]
        stats = [_leaf_stats(np, run["sample"], after, before, tokens)
                 for run in runs]
        records[attn] = check_runs(attn, runs, loss_ref, stats)
        # sp replicas (same tp coordinate) hold the same parameters.
        for a in res:
            for b in res:
                if a["rank"] < b["rank"] and a["coords_sp_tp"]["tp"] == \
                        b["coords_sp_tp"]["tp"]:
                    same = all(np.array_equal(
                        a["runs"][attn]["sample"][k][1],
                        b["runs"][attn]["sample"][k][1]) for k in keys)
                    fact(f"{attn}: sp replicas equal", same,
                         ranks=[a["rank"], b["rank"]])
    del before, after
    torch.cuda.empty_cache()
    adam_loss, before, after, tokens, adam_ref_ms = one_rank(
        MESH_ADAM_L, 2, 1, optim.adam(MESH_ADAM_LR), None)
    runs = [r["adam"] for r in res]
    stats = [_leaf_stats(np, run["sample"], after, before, tokens,
                         adam_lr=MESH_ADAM_LR) for run in runs]
    adam = check_runs("adam zero1", runs, adam_loss, stats)
    adam["moment_share"] = [run["moment_share"] for run in runs]
    for r, run in zip(res, runs):
        fact("adam zero1: moments in the parameters' dtypes, half of the "
             "shard's", run["moments_own_dtype"]
             and abs(run["moment_share"] - 0.5) < 0.01, rank=r["rank"],
             share=run["moment_share"])
    del before, after
    torch.cuda.empty_cache()

    t_gen = time.perf_counter()
    gres = launch.spawn(2, mesh_rank_main, ("generate", gen_layers),
                        timeout_s=900)
    gres.sort(key=lambda r: r["rank"])
    gen_s = time.perf_counter() - t_gen
    gen = {}
    for name, layers, dtype, plen, new in (
            ("bf16", gen_layers, torch.bfloat16, MESH_GEN_PROMPT,
             MESH_GEN_NEW),
            ("f32", MESH_F32_LAYERS, torch.float32, MESH_F32_PROMPT,
             MESH_F32_NEW)):
        gcfg = dataclasses.replace(llama.llama3_8b(), n_layers=layers)
        g = torch.Generator(device="cuda").manual_seed(MESH_SEED)
        params = llama.init(g, gcfg, dtype=dtype)
        prompt = torch.randint(0, gcfg.vocab, (1, plen), generator=g,
                               device="cuda")
        # Warm-up as the ranks do, then the one-rank run timed as theirs.
        llama.make_generate_fn(gcfg, 128, 2)(params, prompt[:, :128])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = llama.make_generate_fn(gcfg, plen, new)(params, prompt)
        torch.cuda.synchronize()
        one_total_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        logits, _ = llama._prefill(gcfg, params, llama.init_kv_cache(
            gcfg, 1, plen, dtype), prompt)
        torch.cuda.synchronize()
        one_prefill_ms = (time.perf_counter() - t0) * 1e3
        logits = logits.float().cpu().numpy()
        del params
        torch.cuda.empty_cache()
        want = want.cpu().tolist()[0]
        rels = []
        for r in gres:
            run = r[name]
            rel = float(np.linalg.norm(run["last_logits"] - logits)
                        / np.linalg.norm(logits))
            rels.append(rel)
            fact(f"generate {name}: prefill logits", rel < MESH_LOGITS_RTOL,
                 rank=r["rank"], rel=rel)
            fact(f"generate {name}: launches",
                 run["launches"] == {"flash_attention_fwd": layers
                                     if plen >= 1024 else 0,
                                     "flash_attention_bwd_dq": 0,
                                     "flash_attention_bwd_dkv": 0},
                 rank=r["rank"], got=run["launches"])
            fact(f"generate {name}: tokens equal on every rank",
                 run["tokens"] == gres[0][name]["tokens"], rank=r["rank"])
            fact(f"generate {name}: greedy tokens equal the one-rank "
                 f"run's", run["tokens"] == want, rank=r["rank"],
                 got=run["tokens"], want=want)
        gen[name] = {"n_layers": layers, "prompt_len": plen, "max_new": new,
                     "tokens": gres[0][name]["tokens"],
                     "one_rank_tokens": want,
                     "launches": [r[name]["launches"] for r in gres],
                     "prefill_ms": [r[name]["prefill_ms"] for r in gres],
                     "decode_ms_per_token": [r[name]["decode_ms_per_token"]
                                             for r in gres],
                     "one_rank_prefill_ms": one_prefill_ms,
                     "one_rank_decode_ms_per_token":
                         (one_total_ms - one_prefill_ms) / (new - 1),
                     "prefill_logits_rel_err": max(rels)}
    plain = [r["plain_calls"] for r in res + gres]
    fact("no plain version on the card",
         all(v == 0 for d in plain for v in d.values()), plain=plain)
    rec = {"phase": "mesh", "n_layers": MESH_LAYERS, "seq": MESH_L,
           "loss_chunk": MESH_CHUNK, "lr": TRAIN_LR, "remat": TRAIN_REMAT,
           "one_rank_losses": loss_ref, "one_rank_step_ms": ref_ms,
           "sgd": records,
           "adam_zero1": {"one_rank_losses": adam_loss, "lr": MESH_ADAM_LR,
                          "seq": MESH_ADAM_L, "batch": 2,
                          "one_rank_step_ms": adam_ref_ms, **adam},
           "generate": gen,
           "tp_sum_ms": [r["tp_sum_ms"] for r in res],
           "ring_shift_kv_ms": [r["ring_shift_kv_ms"] for r in res],
           "ring_shift_bwd_ms": [r["ring_shift_bwd_ms"] for r in res],
           "grad_bytes": res[0]["grad_bytes"],
           "wire_shapes": {"tp_sum": "(1, 2048, 4096) bf16 on the f32 wire",
                           "ring_shift_kv": "k and v (4, 2048, 128) bf16",
                           "ring_shift_bwd": "dk, dv f32 and k, v bf16, "
                                             "(4, 2048, 128) each",
                           "wires": "the last step's ms and calls in each "
                                    "wire (_WireClock), rank by rank; the "
                                    "step_ms include the clock's CUDA "
                                    "synchronizations around each wire "
                                    "call"},
           "plain_calls": plain,
           "max_memory_gb": {"train": [r["max_memory_gb"] for r in res],
                             "generate": [r["max_memory_gb"] for r in gres]},
           "blocks_s": blocks_s, "train_spawn_s": train_s,
           "generate_spawn_s": gen_s,
           "seconds": time.perf_counter() - t_start, "failed": bad}
    print(json.dumps(rec), flush=True)
    if bad:
        raise AssertionError(f"mesh phase checks failed: {bad}")
    launches = {}
    for path, runs in (("mesh_sp2_tp2_ring", [r["runs"]["ring"] for r in res]),
                       ("mesh_sp2_tp2_zigzag",
                        [r["runs"]["ring-zigzag"] for r in res]),
                       ("mesh_dp2_tp2_adam_zero1", [r["adam"] for r in res]),
                       ("mesh_tp2_generate",
                        [r[n] for r in gres for n in ("bf16", "f32")])):
        launches[path] = {k: sum(run["launches"][k] for run in runs)
                          for k in COUNTERS}
    return {"launches": launches, "record": rec, "blocks": blocks}


# ---------------------------------------------------------------------- moe
# Mixtral-8x7B width (d_model 4096, d_ff 14336, 8 experts, top-2, vocab
# 32000), random weights from seeded generators, cut in depth only: all 32
# layers in bf16 are 93 GB, more than the card holds.
MOE_GEN_LAYERS = 8           # about 24 GB of bf16 weights
MOE_TRAIN_LAYERS = 2
MOE_CHECK_LAYERS = 2         # the f32 dropless-decode check
MOE_CHECK_PROMPT, MOE_CHECK_NEW = 64, 8
MOE_SEED = 16
MOE_L, MOE_CHUNK, MOE_STEPS, MOE_EP_STEPS = 2048, 512, 4, 2
# {ep 2}'s step 1 against the one-rank step's, the bound PR 15's mesh phase
# set for bf16.  Each (token, choice) unit is combined alone and a token's
# units meet in one rounded sum on either path, so on an NVIDIA H100 80GB
# HBM3 at 700 W the two read equal.
MOE_EP_LOSS_RTOL = 1e-3
# make_moe_layer on {ep 2} against the one-rank layer, f32 with TF32 off,
# both dropless (capacity = a rank's tokens, and all tokens for the one
# rank): the same products, cuBLAS tiles of another size.  The largest
# difference over the largest magnitude of the one-rank output.
MOE_LAYER_TOKENS = 4096
MOE_LAYER_RTOL = 1e-4


def _mixtral(llama, layers: int, **kw):
    return dataclasses.replace(llama.mixtral_8x7b(), n_layers=layers, **kw)


class _PlainCalls:
    """Count calls of the flash kernels' plain versions while it is open
    (a path on the card must never reach them)."""

    def __init__(self, fa):
        self.fa = fa
        self.saved = {name: getattr(fa, name) for name in PLAIN_FNS}
        self.calls = _count_plain(fa)

    def close(self) -> None:
        for name, fn in self.saved.items():
            setattr(self.fa, name, fn)


def moe_rank_main() -> dict:
    """One rank of the moe phase's {ep 2} part (spawned on the one card):
    MOE_EP_STEPS SGD steps of Mixtral width at MOE_TRAIN_LAYERS layers over
    a mesh {ep 2} (each rank 4 experts), then ``parallel/moe``'s layer."""
    import importlib

    import numpy as np
    import torch

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch.collectives import innerjit
    from torchmpi_tpu_torch.examples import train_llama as train_mod
    from torchmpi_tpu_torch.models import llama
    from torchmpi_tpu_torch.parallel import mesh as mesh_mod
    from torchmpi_tpu_torch.parallel import moe
    from torchmpi_tpu_torch.parallel import tp as tp_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    fa = importlib.import_module("torchmpi_tpu_torch.ops.flash_attention")
    plain = _count_plain(fa)
    mpi.start()
    try:
        me = mpi.rank()
        mesh = mesh_mod.make_mesh({"ep": 2})
        cfg = _mixtral(llama, MOE_TRAIN_LAYERS)
        g = torch.Generator(device="cuda").manual_seed(MOE_SEED + 1)
        params = llama.shard_params(llama.init(g, cfg, dtype=torch.bfloat16),
                                    mesh, cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tokens, targets = _mesh_tokens(torch, train_mod, cfg, 1, MOE_L, 0)
        step = llama.make_train_step(cfg, mesh, lr=TRAIN_LR, attn="flash",
                                     remat=TRAIN_REMAT, loss_chunk=MOE_CHUNK)
        clock = _WireClock(torch, wires=((tp_mod, "_tp_sum", "ep_sum"),))
        losses, step_ms, wires, per_step = [], [], [], []
        for _ in range(MOE_EP_STEPS):
            reset_counts(fa)
            t0 = time.perf_counter()
            params, _, loss = step(params, None, tokens, targets)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            per_step.append(read_counts(fa))
            wires.append(clock.read())
        clock.close()
        train_peak = torch.cuda.max_memory_allocated() / 1e9
        expert_shape = list(params["layers"]["w_gate"].shape)
        del params, step
        torch.cuda.empty_cache()

        # parallel/moe's layer: every rank draws the whole layer and all
        # 2 x MOE_LAYER_TOKENS tokens, keeps its experts and its tokens.
        E, D, F_, T = 8, 4096, 14336, MOE_LAYER_TOKENS
        g = torch.Generator(device="cuda").manual_seed(MOE_SEED + 2)
        whole = moe.init_experts(g, E, D, F_)
        x = torch.randn((2 * T, D), generator=g, device="cuda")
        mine = moe.shard_experts(whole, mesh)
        fn = moe.make_moe_layer(mesh, E, capacity=T, k=2)
        clock = _WireClock(torch, wires=((innerjit, "_alltoall",
                                          "alltoall"),))
        with torch.no_grad():
            y = fn(mine, x[me * T:(me + 1) * T])
            torch.cuda.synchronize()
            clock.read()
            t0 = time.perf_counter()
            y = fn(mine, x[me * T:(me + 1) * T])
            torch.cuda.synchronize()
            layer_ms = (time.perf_counter() - t0) * 1e3
            layer_wire = clock.read()
            clock.close()
            one = mesh_mod.Mesh(np.array([me]), ("ep",), me)
            ref = moe.make_moe_layer(one, E, capacity=2 * T, k=2)(whole, x)
            ref = ref[me * T:(me + 1) * T]
            err = float((y - ref).abs().max() / ref.abs().max())
            moved = float((y - x[me * T:(me + 1) * T]).abs().max())
            finite = bool(torch.isfinite(y).all())
        return {"rank": me, "losses": losses, "step_ms": step_ms,
                "wires": wires, "launches_per_step": per_step,
                "expert_shape": expert_shape, "train_peak_gb": train_peak,
                "layer_ms": layer_ms, "layer_wire": layer_wire,
                "layer_rel_err": err, "layer_moved": moved,
                "layer_finite": finite, "plain_calls": dict(plain),
                "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    except BaseException:
        import traceback

        print(f"moe rank {mpi.rank()}: {traceback.format_exc()}",
              file=sys.stderr, flush=True)
        raise
    finally:
        mpi.stop()


def phase_moe(torch, llama, fa, train_mod):
    """Mixtral-8x7B width through Llama's MoE paths on the one card: the
    dropless decode against teacher forcing (f32, MOE_CHECK_LAYERS), greedy
    generation (bf16, MOE_GEN_LAYERS), SGD training (bf16,
    MOE_TRAIN_LAYERS), and {ep 2} on 2 spawned ranks (moe_rank_main)."""
    from torchmpi_tpu_torch.runtime import launch

    plain = _PlainCalls(fa)
    bad = []
    # Peaks are read above what this process held when the phase began.
    held0 = torch.cuda.memory_allocated() / 1e9

    def fact(name, ok, **detail):
        if not ok:
            bad.append({"check": name, **detail})

    try:
        # (a) The dropless decode's greedy tokens equal the teacher-forced
        # argmax (JAX's test_generate_matches_teacher_forced; capacity
        # factor 8 makes the teacher-forced forward dropless too).
        cfg = _mixtral(llama, MOE_CHECK_LAYERS, capacity_factor=8.0)
        g = torch.Generator(device="cuda").manual_seed(MOE_SEED)
        params = llama.init(g, cfg, dtype=torch.float32)
        prompt = torch.randint(0, cfg.vocab, (1, MOE_CHECK_PROMPT),
                               generator=g, device="cuda")
        toks = llama.make_generate_fn(cfg, MOE_CHECK_PROMPT, MOE_CHECK_NEW)(
            params, prompt)
        seq, forced = prompt, []
        with torch.no_grad():
            for i in range(MOE_CHECK_NEW):
                nxt = llama.apply(cfg, params, seq)[:, -1].argmax(-1)
                forced.append(int(nxt[0]))
                seq = torch.cat([seq, nxt[:, None]], dim=1)
        check = {"n_layers": cfg.n_layers, "dtype": "float32",
                 "tokens": toks[0].tolist(), "teacher_forced": forced}
        fact("f32 dropless decode = teacher-forced argmax",
             toks[0].tolist() == forced, **check)
        del params
        torch.cuda.empty_cache()

        # (b) Generation, bf16, MOE_GEN_LAYERS layers.
        cfg = _mixtral(llama, MOE_GEN_LAYERS)
        g = torch.Generator(device="cuda").manual_seed(MOE_SEED)
        params = llama.init(g, cfg, dtype=torch.bfloat16)
        prompt = torch.randint(0, cfg.vocab, (1, 2048), generator=g,
                               device="cuda")
        fn = llama.make_generate_fn(cfg, 2048, 16)
        first = llama.make_generate_fn(cfg, 2048, 1)
        fn(params, prompt)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa)
        t0 = time.perf_counter()
        toks = fn(params, prompt)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        gen_launches = read_counts(fa)
        t0 = time.perf_counter()
        first(params, prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        gen = {"n_layers": cfg.n_layers, "prompt_len": 2048, "max_new": 16,
               "dtype": "bfloat16", "launches": gen_launches,
               "prefill_ms": prefill_s * 1e3,
               "decode_ms_per_token": (total_s - prefill_s) * 1e3 / 15,
               "total_ms": total_s * 1e3, "tokens": toks[0].tolist(),
               "weights_gb": sum(t.numel() * t.element_size()
                                 for t in llama._leaves(params)) / 1e9,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9 - held0}
        fact("generate: B4 once a layer, no backward",
             gen_launches == {"flash_attention_fwd": cfg.n_layers,
                              "flash_attention_bwd_dq": 0,
                              "flash_attention_bwd_dkv": 0},
             got=gen_launches)
        fact("generate: tokens in the vocab",
             all(0 <= t < cfg.vocab for t in gen["tokens"]))
        del params, fn, first
        torch.cuda.empty_cache()

        # (c) Training, bf16, MOE_TRAIN_LAYERS layers, one batch.
        cfg = _mixtral(llama, MOE_TRAIN_LAYERS)
        g = torch.Generator(device="cuda").manual_seed(MOE_SEED + 1)
        params = llama.init(g, cfg, dtype=torch.bfloat16)
        tokens, targets = _mesh_tokens(torch, train_mod, cfg, 1, MOE_L, 0)
        with torch.no_grad():
            _, aux0 = llama.apply(cfg, params, tokens, attn="flash",
                                  return_aux=True)
        aux0 = float(aux0)
        torch.cuda.reset_peak_memory_stats()
        step = llama.make_train_step(cfg, lr=TRAIN_LR, attn="flash",
                                     remat=TRAIN_REMAT, loss_chunk=MOE_CHUNK)
        expected = {"flash_attention_fwd": FWD_PER_LAYER[TRAIN_REMAT]
                    * cfg.n_layers,
                    "flash_attention_bwd_dq": cfg.n_layers,
                    "flash_attention_bwd_dkv": cfg.n_layers}
        losses, step_ms, per_step = [], [], []
        for _ in range(MOE_STEPS):
            reset_counts(fa)
            t0 = time.perf_counter()
            params, _, loss = step(params, None, tokens, targets)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            per_step.append(read_counts(fa))
        train = {"n_layers": cfg.n_layers, "batch": 1, "seq": MOE_L,
                 "dtype": "bfloat16", "attn": "flash", "remat": TRAIN_REMAT,
                 "loss_chunk": MOE_CHUNK, "lr": TRAIN_LR,
                 "aux_at_init": aux0, "losses": losses, "step_ms": step_ms,
                 "steady_step_ms": sorted(step_ms[1:])[len(step_ms[1:]) // 2],
                 "launches_per_step": per_step,
                 "expected_launches_per_step": expected,
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9 - held0}
        fact("train: losses finite and falling",
             all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
             losses=losses)
        fact("train: aux at init in (0.5, 2)", 0.5 < aux0 < 2.0, aux=aux0)
        fact("train: launches per step", all(s == expected for s in per_step),
             got=per_step, expected=expected)
        del params, step
        torch.cuda.empty_cache()

        # (d) {ep 2}: 2 ranks on the card.
        t0 = time.perf_counter()
        res = launch.spawn(2, moe_rank_main, (), timeout_s=600)
        ep_s = time.perf_counter() - t0
        res.sort(key=lambda r: r["rank"])
        ep_expected = expected
        for r in res:
            rel = abs(r["losses"][0] - losses[0]) / abs(losses[0])
            r["step1_loss_rel_err_vs_one_rank"] = rel
            fact("ep2: step 1 loss", rel < MOE_EP_LOSS_RTOL, rank=r["rank"],
                 rel=rel)
            fact("ep2: launches per step", all(
                s == ep_expected for s in r["launches_per_step"]),
                rank=r["rank"], got=r["launches_per_step"])
            fact("ep2: experts sharded",
                 r["expert_shape"] == [MOE_TRAIN_LAYERS, 4, 4096, 14336],
                 got=r["expert_shape"])
            fact("ep2: make_moe_layer = one rank's",
                 r["layer_finite"] and r["layer_rel_err"] < MOE_LAYER_RTOL
                 and r["layer_moved"] > 0, rank=r["rank"],
                 rel=r["layer_rel_err"])
            fact("ep2: no plain flash version", not any(
                r["plain_calls"].values()), rank=r["rank"],
                 calls=r["plain_calls"])
        fact("no plain flash version in this process",
             not any(plain.calls.values()), calls=dict(plain.calls))
    finally:
        plain.close()
    ep = {"ranks": 2, "seconds": ep_s, "per_rank": res,
          "loss_rtol": MOE_EP_LOSS_RTOL, "layer_rtol": MOE_LAYER_RTOL,
          "layer": {"d_model": 4096, "d_ff": 14336, "n_experts": 8, "k": 2,
                    "tokens_per_rank": MOE_LAYER_TOKENS, "dtype": "float32"}}
    rec = {"phase": "moe", "config": "mixtral_8x7b",
           "d_model": 4096, "d_ff": 14336, "n_experts": 8, "top_k": 2,
           "vocab": 32000, "held_at_start_gb": held0, "check": check,
           "generate": gen, "train": train, "ep2": ep, "failed": bad}
    print(json.dumps(rec), flush=True)
    if bad:
        raise AssertionError(f"moe phase checks failed: {bad}")
    launches = {"moe_generate": gen_launches,
                "moe_train": _sum_counts(per_step),
                "moe_ep2": _sum_counts([s for r in res
                                        for s in r["launches_per_step"]])}
    return rec, launches


def _sum_counts(dicts) -> dict:
    out = {name: 0 for name in COUNTERS}
    for d in dicts:
        for k in out:
            out[k] += d[k]
    return out


# ----------------------------------------------------------- parameterserver
# BASELINE config 3 ("MNIST async-SGD via parameter-server shard") and
# mnist_modelparallel: the MNIST MLP 784-1024-1024-10 in f32 on the card,
# synthetic data, the JAX examples' defaults (4 shard servers, update
# frequency 4, batch 128, lr 0.1).
# The one-worker runs: 4 epochs of the 8192 synthetic examples, 64 steps an
# epoch; the spawned examples 2 epochs.
PS_LIMIT, PS_EPOCHS, PS_SPAWNED_EPOCHS = 8192, 4, 2
# The JAX package's bar for these examples (tests/test_examples.py
# _assert_converged): accuracy above 30%, the loss down by 0.2.
PS_MIN_ACC, PS_MIN_DROP = 0.30, 0.2


def _ps_summary(out) -> dict:
    st = out["stats"]
    cycles = max(1, st["cycles"])
    steps = sorted(out["step_s"][1:])
    return {"steps": len(out["step_s"]),
            "median_step_ms": steps[len(steps) // 2] * 1e3,
            "cycles": st["cycles"],
            "push_ms_per_cycle": st["push_s"] * 1e3 / cycles,
            "pull_ms_per_cycle": st["pull_s"] * 1e3 / cycles,
            "bytes_pushed_per_cycle": st["bytes_pushed"] / cycles,
            "bytes_pulled_per_cycle": st["bytes_pulled"] / cycles}


def phase_parameterserver(torch, fa):
    """Config 3 through ``examples/mnist_parameterserver.py`` (one worker
    in this process, 4 in-process shard servers, Downpour then EASGD),
    ``mnist_parameterserver_easgd_dataparallel`` (3 ranks on the card in DP
    groups of 2 and 1: two PS clients, one DP plane) and
    ``mnist_modelparallel`` (2 ranks, tp 2)."""
    import numpy as np

    from torchmpi_tpu_torch.examples import mnist_modelparallel as mp_ex
    from torchmpi_tpu_torch.examples import mnist_parameterserver as ps_ex
    from torchmpi_tpu_torch.examples import \
        mnist_parameterserver_easgd_dataparallel as dp_ex
    from torchmpi_tpu_torch.runtime import launch

    bad = []

    def fact(name, ok, **detail):
        if not ok:
            bad.append({"check": name, **detail})

    def converged(name, losses, acc):
        fact(f"{name}: loss falls by {PS_MIN_DROP}",
             losses[-1] < losses[0] - PS_MIN_DROP, losses=losses)
        fact(f"{name}: accuracy above {PS_MIN_ACC}", acc > PS_MIN_ACC,
             accuracy=acc)

    def on_cuda(name, devices):
        fact(f"{name}: every leaf on cuda",
             bool(devices) and all(d.startswith("cuda") for d in devices),
             devices=devices)

    rec = {"phase": "parameterserver", "model": "mlp 784-1024-1024-10",
           "dtype": "float32", "data": "synthetic", "limit": PS_LIMIT,
           "epochs": PS_EPOCHS, "spawned_epochs": PS_SPAWNED_EPOCHS}
    reset_counts(fa)
    for rule in ("downpour", "easgd"):
        record = []
        t0 = time.perf_counter()
        out = ps_ex.run(ps_ex.parse_args([
            "--rule", rule, "--data", "synthetic", "--limit", str(PS_LIMIT),
            "--epochs", str(PS_EPOCHS)]), record)
        seconds = time.perf_counter() - t0
        converged(rule, out["epoch_losses"], out["accuracy"])
        on_cuda(rule, out["devices"])
        # The shards against a numpy replay of the 'add' rule over every
        # vector pushed, from the registered values, bit for bit.
        replay = [t.numpy().copy() for t in record[0][1]]
        pushes = [d for kind, d in record[1:] if kind == "add"]
        for deltas in pushes:
            for v, d in zip(replay, deltas):
                v += d.numpy()
        center = [out["center"][k].numpy() for k in sorted(out["center"])]
        equal = all(v.tobytes() == c.tobytes()
                    for v, c in zip(replay, center))
        if rule == "downpour":
            fact("downpour: shards = numpy replay bit for bit", equal,
                 pushes=len(pushes))
        counters = {k: out["counters"][k]
                    for k in ("retry", "timeout", "crc_failure")}
        rec[rule] = {"seconds": seconds, **_ps_summary(out),
                     "epoch_losses": out["epoch_losses"],
                     "accuracy": out["accuracy"], "pushes": len(pushes),
                     "replay_bit_equal": equal, "counters": counters,
                     "client_counters": out["client_counters"]}
        fact(f"{rule}: no retry, timeout or CRC failure",
             not any(counters.values()), counters=counters)

    t0 = time.perf_counter()
    res = dp_ex.launch(dp_ex.parse_args([
        "--nproc", "3", "--div", "2", "--epochs", str(PS_SPAWNED_EPOCHS),
        "--limit", str(PS_LIMIT)]))
    dp_s = time.perf_counter() - t0
    for r in res:
        converged(f"easgd_dataparallel rank {r['rank']}", r["epoch_losses"],
                  r["accuracy"])
        on_cuda(f"easgd_dataparallel rank {r['rank']}", r["devices"])
    fact("easgd_dataparallel: the DP group checked its replicas",
         res[0]["replica_checks"] == res[1]["replica_checks"] >= 2,
         checks=[r["replica_checks"] for r in res])
    steps = sorted(res[0]["step_s"][1:])
    rec["easgd_dataparallel"] = {
        "ranks": 3, "div": 2, "seconds": dp_s,
        "clients": [r["client"] for r in res],
        "replica_checks": [r["replica_checks"] for r in res],
        "accuracy": res[0]["accuracy"], "epoch_losses": res[0]["epoch_losses"],
        "median_step_ms": steps[len(steps) // 2] * 1e3,
        "root_cycles": [r["stats"]["cycles"] for r in res]}

    t0 = time.perf_counter()
    res = launch.spawn(2, mp_ex.run, (mp_ex.parse_args([
        "--epochs", str(PS_SPAWNED_EPOCHS), "--limit", str(PS_LIMIT)]),),
        timeout_s=300)
    mp_s = time.perf_counter() - t0
    for r in res:
        converged(f"modelparallel rank {r['rank']}", r["epoch_losses"],
                  r["accuracy"])
        on_cuda(f"modelparallel rank {r['rank']}", r["devices"])
    fact("modelparallel: the ranks' losses equal",
         res[0]["epoch_losses"] == res[1]["epoch_losses"])
    steps = sorted(res[0]["step_s"][1:])
    rec["modelparallel"] = {"ranks": 2, "seconds": mp_s,
                            "epoch_losses": res[0]["epoch_losses"],
                            "accuracy": res[0]["accuracy"],
                            "median_step_ms": steps[len(steps) // 2] * 1e3}
    launches = read_counts(fa)
    fact("no flash kernel on these paths", not any(launches.values()),
         launches=launches)
    rec["failed"] = bad
    print(json.dumps(rec), flush=True)
    if bad:
        raise AssertionError(f"parameterserver phase checks failed: {bad}")
    return rec


# ----------------------------------------------------------------- pipeline
# BASELINE config 4 and Llama's pipeline steps over the mesh's pp axis, on
# ranks spawned on the one card (every hand-off a gloo send and receive
# staged through the host).  Llama-3-8B width cut to PIPE_LAYERS layers
# (V = 2 a stage over pp 2), bf16, the global batch PIPE_BATCH sequences of
# PIPE_L tokens as PIPE_M micro-batches of one sequence.
PIPE_LAYERS = 4
PIPE_L, PIPE_BATCH, PIPE_M, PIPE_CHUNK = 2048, 4, 4, 512
PIPE_GPIPE_STEPS = 3
PIPE_1F1B_STEPS = 1     # each schedule; the phase stays under 90 s
PIPE_SEED = 17
PIPE_HOP_CALLS = 5
PIPE_MNIST_EPOCHS = 2
# Step 1's loss against the one-rank step's (the bf16 bound of the mesh
# phase's last step: the same forward, its sums in other orders).
PIPE_LOSS_RTOL = 1e-3
# Config 4's bar: the JAX package's for its examples
# (tests/test_examples.py _assert_converged: accuracy above 30%, the epoch
# loss down by 0.2).
PIPE_MNIST_ACC, PIPE_MNIST_DROP = 0.30, 0.2


def pipe_expected(kind: str, V: int, M: int) -> dict:
    """B4-B6 launches a rank a step.  GPipe runs each of its V layers once a
    micro-batch forward, and remat "dots" runs the forward again in the
    backward; 1F1B's forward op runs the layer without a graph, and its
    backward op re-forms the forward (then remat runs it once more)."""
    fwd = FWD_PER_LAYER[TRAIN_REMAT] + (1 if kind == "1f1b" else 0)
    return {"flash_attention_fwd": fwd * V * M,
            "flash_attention_bwd_dq": V * M,
            "flash_attention_bwd_dkv": V * M}


def _peak_gb(torch, reset: bool = False) -> float:
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated() / 1e9


def _pipe_cfg(llama):
    return dataclasses.replace(llama.llama3_8b(), n_layers=PIPE_LAYERS)


def _pipe_inputs(torch, llama, train_mod, dev):
    """The whole model from PIPE_SEED (bf16) and the batch, the same on
    every rank and in the one-rank run."""
    cfg = _pipe_cfg(llama)
    g = torch.Generator(device=dev).manual_seed(PIPE_SEED)
    whole = llama.init(g, cfg, dtype=torch.bfloat16, device=dev)
    data, _ = train_mod.synthetic_tokens(cfg, n_seq=PIPE_BATCH,
                                         seq_len=PIPE_L, seed=0)
    batch = torch.from_numpy(data).to(dev, torch.long)
    return cfg, whole, batch[:, :-1], batch[:, 1:]


def _pipe_steps(torch, fa, step, params, tokens, targets, steps, clock):
    """``steps`` calls of a pipeline step ``(params, tokens, targets) ->
    (params, loss)``: losses, ms, B4-B6 launches and wire ms a step."""
    losses, step_ms, per_step, wires = [], [], [], []
    for _ in range(steps):
        reset_counts(fa)
        torch.cuda.synchronize()
        clock.read()
        t0 = time.perf_counter()
        params, loss = step(params, tokens, targets)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        per_step.append(read_counts(fa))
        wires.append(clock.read())
    return params, {"losses": losses, "step_ms": step_ms,
                    "launches_per_step": per_step, "wires": wires}


def _pipe_gpipe(torch, llama, fa, mesh, cfg, params, tokens, targets, dev):
    """(a): make_pp_train_step over {pp 2} on this rank's shard, then one
    hand-off timed alone."""
    from torchmpi_tpu_torch.collectives import eager, innerjit

    step, V = llama.make_pp_train_step(
        cfg, mesh, PIPE_M, lr=TRAIN_LR, attn="flash", remat=TRAIN_REMAT,
        loss_chunk=PIPE_CHUNK)
    clock = _WireClock(torch, wires=((innerjit, "handoff", "handoff"),
                                     (eager, "broadcast", "broadcast")))
    _peak_gb(torch, reset=True)
    try:
        params, rec = _pipe_steps(torch, fa, step, params, tokens, targets,
                                  PIPE_GPIPE_STEPS, clock)
    finally:
        clock.close()
    rec.update(V=V, peak_gb=_peak_gb(torch),
               expected_per_step=pipe_expected("gpipe", V, PIPE_M),
               replicated={k: _digest([params[k]])
                           for k in ("embed", "norm", "head")})
    del params, step
    # One hop alone: a (1, PIPE_L, d_model) bf16 activation from stage 0
    # to stage 1 (ticks far past the schedule's, so no tag repeats).
    comm = mesh.comm("pp")
    x = torch.randn((1, PIPE_L, cfg.d_model), dtype=torch.bfloat16,
                    device=dev)
    hop = []
    for i in range(PIPE_HOP_CALLS):
        sends = [(1, x)] if comm.rank == 0 else []
        recvs = [(0, x)] if comm.rank == 1 else []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        innerjit.handoff(sends, recvs, comm, 1_000_000 + i)
        torch.cuda.synchronize()
        hop.append((time.perf_counter() - t0) * 1e3)
    rec["hop_ms"] = sorted(hop)[len(hop) // 2]
    rec["hop_bytes"] = x.numel() * x.element_size()
    return rec


def _pipe_warm(torch, llama, cfg, shard, dev) -> float:
    """One decoder layer's forward and backward and the chunked loss head's
    on this rank's shard (its shapes, PIPE_L tokens), with no collective:
    the card loads the GEMM and flash kernels the steps run, on all ranks
    at once (this cold start took 9.8-11.3 s on an H100 80GB HBM3 at 700
    W).  Returns its seconds."""
    t0 = time.perf_counter()
    lp = {k: v[0].detach().requires_grad_(True)
          for k, v in shard["layers"].items()}
    head = shard["head"].detach().requires_grad_(True)
    h = torch.randn((1, PIPE_L, cfg.d_model), dtype=torch.bfloat16,
                    device=dev, requires_grad=True)
    attn = llama._make_attn_impl(cfg, "flash", None,
                                 1.0 / math.sqrt(cfg.head_dim))
    out, _ = llama._decoder_layer(cfg, lp, h,
                                  torch.arange(PIPE_L, device=dev), attn)
    tgt = torch.zeros((1, PIPE_L), dtype=torch.long, device=dev)
    loss = llama._nll_from_hidden(head, out, tgt, PIPE_CHUNK)
    loss.backward()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _pipe_1f1b(torch, llama, fa, mesh, cfg, shard0, tokens, targets):
    """(b): make_1f1b_train_step over {pp 2, tp 2}, stage_tp="manual",
    each schedule from the same weights."""
    from torchmpi_tpu_torch.collectives import eager, innerjit
    from torchmpi_tpu_torch.parallel import tp as tp_mod
    from torchmpi_tpu_torch.utils import tree

    out = {}
    for sched in ("combined", "alternating"):
        params = tree.tree_map(lambda t: t.clone(), shard0)
        step, V = llama.make_1f1b_train_step(
            cfg, mesh, PIPE_M, lr=TRAIN_LR, attn="flash", remat=TRAIN_REMAT,
            loss_chunk=PIPE_CHUNK, stage_tp="manual", manual_schedule=sched)
        clock = _WireClock(torch, wires=(
            (tp_mod, "_tp_sum", "tp_sum"), (innerjit, "handoff", "handoff"),
            (innerjit, "allreduce", "loss"), (eager, "allreduce_", "pp_sum")))
        _peak_gb(torch, reset=True)
        highs = []

        def counted(p, t, tg, _step=step):
            res = _step(p, t, tg)
            highs.append(_step.pipe.stash_high_water)
            return res

        try:
            params, rec = _pipe_steps(torch, fa, counted, params, tokens,
                                      targets, PIPE_1F1B_STEPS, clock)
        finally:
            clock.close()
        rec.update(V=V, peak_gb=_peak_gb(torch), stash_high_water=highs,
                   stash_bound=step.pipe.stash_bound,
                   expected_per_step=pipe_expected("1f1b", V, PIPE_M),
                   replicated={k: _digest([params[k]])
                               for k in ("embed", "norm", "head")})
        out[sched] = rec
        del params, step
    return out


def pipeline_rank_main() -> dict:
    """One of the pipeline phase's 4 ranks (spawned on the one card): a
    warm-up (``_pipe_warm``), (a) GPipe on {pp 2} (ranks 0 and 1; ranks 2
    and 3 make the mesh's groups with them, then wait), (b) 1F1B on {pp 2,
    tp 2}, (c) config 4's example on {pp 4}.  The process group is this function's, so that the
    example may start and stop the runtime on it."""
    import contextlib
    import importlib
    import io

    import torch
    import torch.distributed as dist

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch.examples import mnist_pipeline
    from torchmpi_tpu_torch.examples import train_llama as train_mod
    from torchmpi_tpu_torch.models import llama
    from torchmpi_tpu_torch.parallel import mesh as mesh_mod
    from torchmpi_tpu_torch.runtime.communicator import Communicator

    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    fa = importlib.import_module("torchmpi_tpu_torch.ops.flash_attention")
    plain = _count_plain(fa)
    dist.init_process_group("gloo", init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    out = {"rank": dist.get_rank()}
    try:
        t0 = time.perf_counter()
        dev = mpi.start()
        try:
            me = mpi.rank()
            cfg, whole, tokens, targets = _pipe_inputs(torch, llama,
                                                       train_mod, dev)
            pp2 = mesh_mod.make_mesh({"pp": 2},
                                     comm=Communicator(range(2), my_rank=me))
            pp2_tp2 = mesh_mod.make_mesh({"pp": 2, "tp": 2})
            out["coords"] = pp2_tp2.coords
            # Both layouts cut from the whole model, which then goes.
            gpipe0 = (llama.shard_params_pp(whole, pp2, cfg) if me < 2
                      else None)
            shard0 = llama.shard_params_pp(whole, pp2_tp2, cfg)
            del whole
            out["warm_s"] = _pipe_warm(torch, llama, cfg,
                                       gpipe0 if me < 2 else shard0, dev)
            torch.cuda.empty_cache()
            if me < 2:
                out["gpipe"] = _pipe_gpipe(torch, llama, fa, pp2, cfg,
                                           gpipe0, tokens, targets, dev)
            del gpipe0
            dist.barrier()
            out["gpipe_s"] = time.perf_counter() - t0
            out["1f1b"] = _pipe_1f1b(torch, llama, fa, pp2_tp2, cfg, shard0,
                                     tokens, targets)
            del shard0
            out["1f1b_s"] = time.perf_counter() - t0 - out["gpipe_s"]
        finally:
            mpi.stop()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            res = mnist_pipeline.run(mnist_pipeline.parse_args(
                ["--epochs", str(PIPE_MNIST_EPOCHS)]))
        out["mnist"] = {**res, "text": text.getvalue(),
                        "seconds": time.perf_counter() - t1}
        out["plain_calls"] = dict(plain)
        out["max_memory_gb"] = _peak_gb(torch)
        return out
    except BaseException:
        import traceback

        print(f"pipeline rank {out['rank']}: {traceback.format_exc()}",
              file=sys.stderr, flush=True)
        raise
    finally:
        dist.destroy_process_group()


def _pipe_one_rank(torch, llama, train_mod, dev) -> dict:
    """The one-rank ``make_train_step`` on the same weights and batch:
    step 1's loss, and the ms of steps 1 and 2."""
    cfg, whole, tokens, targets = _pipe_inputs(torch, llama, train_mod, dev)
    step = llama.make_train_step(cfg, lr=TRAIN_LR, attn="flash",
                                 remat=TRAIN_REMAT, loss_chunk=PIPE_CHUNK)
    losses, ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, loss = step(whole, None, tokens, targets)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return {"loss": losses[0], "losses": losses, "step_ms": ms}


def _pipe_checks(res, ref, stats) -> tuple:
    """The phase's checks over the ranks' results (``res``, by rank) and
    the one-rank run (``ref``); returns (failed checks, record)."""
    bad = []

    def fact(name, ok, **detail):
        if not ok:
            bad.append({"check": name, **detail})

    def run_checks(name, runs):
        for r, run in runs:
            rel = abs(run["losses"][0] - ref["loss"]) / abs(ref["loss"])
            run["step1_loss_rel_err"] = rel
            fact(f"{name}: step 1 loss", rel < PIPE_LOSS_RTOL, rank=r,
                 rel=rel)
            fact(f"{name}: losses finite",
                 all(math.isfinite(x) for x in run["losses"]), rank=r,
                 losses=run["losses"])
            fact(f"{name}: launches per step", all(
                s == run["expected_per_step"]
                for s in run["launches_per_step"]), rank=r,
                got=run["launches_per_step"],
                expected=run["expected_per_step"])

    gpipe = [(r["rank"], r["gpipe"]) for r in res if "gpipe" in r]
    run_checks("gpipe", gpipe)
    fact("gpipe: embed, norm and head bit-equal on both pp ranks",
         gpipe[0][1]["replicated"] == gpipe[1][1]["replicated"],
         digests=[run["replicated"] for _, run in gpipe])
    for sched in ("combined", "alternating"):
        runs = [(r["rank"], r["1f1b"][sched]) for r in res]
        run_checks(f"1f1b {sched}", runs)
        for r, run in runs:
            fact(f"1f1b {sched}: stash within the schedule's bound",
                 max(run["stash_high_water"]) <= run["stash_bound"], rank=r,
                 high=run["stash_high_water"], bound=run["stash_bound"])
    for r in res:
        m = r["mnist"]
        losses = m["epoch_losses"]
        fact("config 4: converged", losses[-1] < losses[0] - PIPE_MNIST_DROP
             and m["accuracy"] > PIPE_MNIST_ACC, rank=r["rank"],
             losses=losses, accuracy=m["accuracy"])
        fact("config 4: every stage leaf on cuda",
             all(d.startswith("cuda") for d in m["devices"]),
             rank=r["rank"], devices=m["devices"])
        fact("config 4: the ranks agree", losses == res[0]["mnist"][
            "epoch_losses"], rank=r["rank"])
    plain = [r["plain_calls"] for r in res]
    fact("no plain flash version on the card",
         all(v == 0 for d in plain for v in d.values()), plain=plain)

    def steady(ms):
        return ms[1:] or ms

    def wire_ms(run, name):
        return run["wires"][-1]["ms"].get(name, 0.0)

    g_rec = {}
    for r, run in gpipe:
        ms = steady(run["step_ms"])[-1]
        hops = run["wires"][-1]["calls"].get("handoff", 0)
        handoff = wire_ms(run, "handoff")
        g_rec[r] = {
            "losses": run["losses"], "step_ms": run["step_ms"],
            "step1_loss_rel_err": run["step1_loss_rel_err"],
            "launches_per_step": run["launches_per_step"][-1],
            "wires": run["wires"][-1], "hop_ms": run["hop_ms"],
            "hop_bytes": run["hop_bytes"], "peak_gb": run["peak_gb"],
            # The hand-offs' wait beyond their transfers, over the step.
            "idle_share": (handoff - hops * run["hop_ms"]) / ms,
            "wire_share": (handoff + wire_ms(run, "broadcast")) / ms}
    b_rec = {}
    for sched in ("combined", "alternating"):
        b_rec[sched] = {
            r["rank"]: {k: r["1f1b"][sched][k] for k in (
                "losses", "step_ms", "step1_loss_rel_err", "stash_high_water",
                "stash_bound", "peak_gb", "replicated")}
            | {"wires": r["1f1b"][sched]["wires"][-1],
               "launches_per_step": r["1f1b"][sched][
                   "launches_per_step"][-1]}
            for r in res}
    m_rec = {r["rank"]: {"epoch_losses": r["mnist"]["epoch_losses"],
                         "accuracy": r["mnist"]["accuracy"],
                         "step_ms_median": 1e3 * sorted(
                             r["mnist"]["step_s"])[len(r["mnist"]["step_s"])
                                                   // 2],
                         "steps": len(r["mnist"]["step_s"]),
                         "seconds": r["mnist"]["seconds"],
                         "devices": r["mnist"]["devices"]} for r in res}
    rec = {"gpipe": g_rec, "1f1b": b_rec, "config4": m_rec,
           "one_rank": ref, "pipeline_stats": stats, "plain_calls": plain,
           "max_memory_gb": [r["max_memory_gb"] for r in res],
           "part_s": [{k: r[k] for k in ("warm_s", "gpipe_s", "1f1b_s")}
                      for r in res]}
    return bad, rec


def phase_pipeline(torch, llama, fa, train_mod):
    """BASELINE config 4 and Llama's pipeline steps on the one card: 4
    ranks spawned (pipeline_rank_main), then the one-rank step on the same
    weights and batch here, and the checks (_pipe_checks)."""
    from torchmpi_tpu_torch.parallel import pipeline as pl
    from torchmpi_tpu_torch.runtime import launch

    t_start = time.perf_counter()
    res = launch.spawn(4, pipeline_rank_main, (), timeout_s=600)
    res.sort(key=lambda r: r["rank"])
    spawn_s = time.perf_counter() - t_start
    ref = _pipe_one_rank(torch, llama, train_mod, torch.device("cuda"))
    torch.cuda.empty_cache()
    stats = {mode: pl.pipeline_stats(2, PIPE_M, mode)
             for mode in ("gpipe", "1f1b", "1f1b-combined")}
    bad, rec = _pipe_checks(res, ref, stats)
    rec.update(phase="pipeline", n_layers=PIPE_LAYERS, seq=PIPE_L,
               batch=PIPE_BATCH, microbatches=PIPE_M, remat=TRAIN_REMAT,
               loss_chunk=PIPE_CHUNK, lr=TRAIN_LR, spawn_s=spawn_s,
               seconds=time.perf_counter() - t_start, failed=bad)
    print(json.dumps(rec), flush=True)
    if bad:
        raise AssertionError(f"pipeline phase checks failed: {bad}")
    launches = {
        "pipeline_gpipe_pp2": {k: sum(
            sum(s[k] for s in r["gpipe"]["launches_per_step"])
            for r in res if "gpipe" in r) for k in COUNTERS}}
    for sched in ("combined", "alternating"):
        launches[f"pipeline_1f1b_pp2_tp2_{sched}"] = {k: sum(
            sum(s[k] for s in r["1f1b"][sched]["launches_per_step"])
            for r in res) for k in COUNTERS}
    return {"launches": launches, "record": rec}


# ------------------------------------------------------------------- vit
# ViT-B/16 (models/vit.py: 224x224x3, patch 16, d_model 768, 12 layers of
# 12 heads of 64, d_ff 3072, 1000 classes) at full width, random weights
# from VIT_SEED; benchmarks/vit_bench.py's run: bf16, batch 64, flash with
# 60 registers (196 + 60 = 256 tokens), an SGD step at lr 1e-3.
VIT_SEED = 18
VIT_BATCH = 64
VIT_REGISTERS = 60
VIT_LR = 1e-3
VIT_STEPS = 4
# (c) data-parallel: f32, 32 images a rank on 2 ranks, 5 steps at lr 5e-3
# (at 1e-2 the loss read 7.18, 3.32, 2.19, 1.95, 2.55 on an H100: the
# fifth step overshot).
VIT_DP_RANKS, VIT_DP_BATCH, VIT_DP_STEPS, VIT_DP_LR = 2, 32, 5, 5e-3
VIT_DP_REMAT = "dots"
# Tolerances, each as a share of the reference's norm.  Flash against full
# attention in bf16: both sides round q, k, v, o and every activation to
# bf16 (2^-8 relative), in other places (the kernel's P is bf16, full
# attention's softmax stays f32), and 12 residual layers carry each
# layer's difference on: the logits within 5e-2 of their norm; step 1's
# loss (a mean over 64 images) within 1e-2 of itself, as the Llama train
# phase holds it; the wqkv gradients within 5e-2 of their norm.  {tp 2}
# against one rank in bf16: the two ranks' bf16 partial sums meet in f32,
# one rank rounds the whole sum once, the same 2^-8 a layer: 5e-2, as the
# mesh phase holds Llama's logits.  f32 flash against f32 full attention
# (the dp run's step-1 check) differs by the three bf16 products' 2^-16:
# the loss within 1e-4.
VIT_LOGITS_RTOL = 5e-2
VIT_LOSS_RTOL = 1e-2
VIT_GRAD_RTOL = 5e-2
VIT_TP_RTOL = 5e-2
VIT_F32_LOSS_RTOL = 1e-4
VIT_SPLIT = "bf16_split"


def _vit_batch(torch, cfg, n: int, seed: int, device):
    """n images whose labels carry a signal: N(0, 1) pixels plus 0.25
    times the label (of 10 classes), labels 0..9 in turn."""
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.arange(n, device=device) % 10
    x = torch.randn((n, cfg.image, cfg.image, cfg.in_channels), generator=g,
                    device=device)
    return x + 0.25 * y[:, None, None, None].float(), y


def _vit_counts(fa, split) -> dict:
    return {**read_counts(fa), VIT_SPLIT: split.bf16_split_launches}


def _vit_reset(fa, split) -> None:
    reset_counts(fa)
    split.bf16_split_launches = 0


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _vit_inference(torch, vit, fa, split, params, x) -> dict:
    """(a) The bf16 forward through B4 at 60 registers (N = 256) and at 0
    (N = 196, the kernels' ragged tail), each held against full attention
    and timed beside it."""
    out = {}
    for regs in (VIT_REGISTERS, 0):
        cfg = vit.vit_b16(regs)
        p = params if regs else {k: v for k, v in params.items()
                                 if k != "registers"}
        with torch.no_grad():
            _vit_reset(fa, split)
            flash = vit.apply(cfg, p, x, attn="flash")
            torch.cuda.synchronize()
            launches = _vit_counts(fa, split)
            full = vit.apply(cfg, p, x, attn="full")
            rel = _rel(flash, full)
            rec = {"n_registers": regs, "seq": cfg.seq_len,
                   "logits_shape": list(flash.shape),
                   "finite": bool(torch.isfinite(flash).all()),
                   "logits_rel_err_vs_full": rel,
                   "rtol": VIT_LOGITS_RTOL, "launches": launches,
                   "flash_ms": cuda_ms(torch, lambda: vit.apply(
                       cfg, p, x, attn="flash"), warmup=1, iters=5),
                   "full_ms": cuda_ms(torch, lambda: vit.apply(
                       cfg, p, x, attn="full"), warmup=1, iters=5)}
        rec["images_per_s"] = x.shape[0] / (rec["flash_ms"] / 1e3)
        emit(phase="vit", part="inference", batch=x.shape[0],
             dtype="bfloat16", **rec)
        want = {"flash_attention_fwd": cfg.n_layers,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                VIT_SPLIT: 0}
        if not (rec["finite"] and rel < VIT_LOGITS_RTOL
                and launches == want
                and rec["logits_shape"] == [x.shape[0], cfg.n_classes]):
            raise AssertionError(f"ViT-B/16 inference at {regs} registers: "
                                 f"{rec}, expected launches {want}")
        out[f"regs{regs}"] = rec
    return out


def _vit_train(torch, vit, llama, fa, split, params0, x, y) -> dict:
    """(b) vit_bench.py's step: 4 SGD steps on one batch, under remat
    "none" and then "dots", each from the same weights; step 1's loss and
    the wqkv gradients first held against full attention."""
    from torchmpi_tpu_torch.utils import tree

    cfg = vit.vit_b16(VIT_REGISTERS)
    batch = (x, y)

    def loss_and_wqkv_grad(attn):
        w = params0["layers"]["wqkv"].requires_grad_(True)
        loss = vit.make_loss_fn(cfg, attn=attn)(params0, batch)
        g, = torch.autograd.grad(loss, [w])
        w.requires_grad_(False)
        return float(loss.detach()), g

    flash_loss, flash_g = loss_and_wqkv_grad("flash")
    full_loss, full_g = loss_and_wqkv_grad("full")
    check = {"step1_loss_flash": flash_loss, "step1_loss_full": full_loss,
             "loss_rel_err": abs(flash_loss - full_loss) / abs(full_loss),
             "loss_rtol": VIT_LOSS_RTOL,
             "wqkv_grad_rel_err": _rel(flash_g, full_g),
             "grad_rtol": VIT_GRAD_RTOL}
    del flash_g, full_g
    emit(phase="vit", part="train_check", **check)
    if not (check["loss_rel_err"] < VIT_LOSS_RTOL
            and check["wqkv_grad_rel_err"] < VIT_GRAD_RTOL):
        raise AssertionError(f"ViT-B/16 flash step 1 against full "
                             f"attention: {check}")
    out = {"check": check}
    for remat in ("none", "dots"):
        params = tree.tree_map(lambda t: t.clone(), params0)
        leaves = [t.requires_grad_(True) for t in tree.leaves(params)]
        loss_fn = vit.make_loss_fn(cfg, attn="flash", remat=remat)
        losses, step_ms, per_step = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(VIT_STEPS):
            _vit_reset(fa, split)
            t0 = time.perf_counter()
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
            for p_, g_ in zip(leaves, grads):
                llama._sgd_update_(p_.data, g_, VIT_LR)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss.detach()))
            per_step.append(_vit_counts(fa, split))
            del grads, loss
        want = {"flash_attention_fwd": FWD_PER_LAYER[remat] * cfg.n_layers,
                "flash_attention_bwd_dq": cfg.n_layers,
                "flash_attention_bwd_dkv": cfg.n_layers, VIT_SPLIT: 0}
        steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
        rec = {"remat": remat, "batch": x.shape[0], "dtype": "bfloat16",
               "lr": VIT_LR, "losses": losses, "step_ms": step_ms,
               "steady_step_ms": steady,
               "images_per_s": x.shape[0] / (steady / 1e3),
               "launches_per_step": per_step,
               "expected_launches_per_step": want,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        emit(phase="vit", part="train", **rec)
        del params, leaves
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite ViT loss: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"ViT loss did not fall under remat "
                                 f"{remat!r}: {losses}")
        if any(c != want for c in per_step):
            raise AssertionError(f"ViT launches per step {per_step}, "
                                 f"expected {want} (remat {remat!r})")
        out[remat] = rec
    return out


def vit_rank_main() -> dict:
    """One rank of the vit phase's (c) and (d) (spawned)."""
    import hashlib
    import importlib

    import torch
    import torch.distributed as dist

    from torchmpi_tpu_torch import nn as mpinn
    from torchmpi_tpu_torch.collectives import cuda_ring
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine, sgdengine
    from torchmpi_tpu_torch.models import vit
    from torchmpi_tpu_torch.parallel import mesh as mesh_mod
    from torchmpi_tpu_torch.runtime import config, lifecycle
    from torchmpi_tpu_torch.utils import tree

    fa = importlib.import_module("torchmpi_tpu_torch.ops.flash_attention")
    split = importlib.import_module("torchmpi_tpu_torch.ops.bf16_split")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config.set("use_pallas_collectives", True)
    device = lifecycle.start()
    try:
        p, rank = lifecycle.size(), lifecycle.rank()
        cfg = vit.vit_b16(VIT_REGISTERS)
        # (c) f32 data-parallel through the engine's B1 rings.
        params = vit.init(VIT_SEED, cfg, device=device)
        x, y = _vit_batch(torch, cfg, p * VIT_DP_BATCH, VIT_SEED + 1, device)
        with torch.no_grad():
            full_loss = float(vit.make_loss_fn(cfg)(
                params, (x[rank::p], y[rank::p])))
        one = (x.view(VIT_DP_BATCH, p, *x.shape[1:]).transpose(0, 1)
               .cpu().numpy(),
               y.view(VIT_DP_BATCH, p).t().cpu().numpy())
        del x, y
        # The rings of a step, as the engine plans them over the gradient
        # leaves (the parameters' shapes and dtypes).
        leaves = tree.leaves(params)
        plan = sgdengine.ring_plan(leaves,
                                   int(config.get("small_allreduce_size_gpu")))
        ring_sizes = [sum(leaves[i].numel() for i in idxs) for idxs in plan]
        ring_s = [0.0]
        _ring_timer(torch, cuda_ring, ring_s,
                    {"on": False, "rings": 0, "unequal": 0,
                     "max_abs_err": 0.0})
        losses, step_ms, launches, ring_ms, marks = [], [], [], [], {}

        def counts():
            return {**_vit_counts(fa, split),
                    "ring_allreduce": cuda_ring.ring_allreduce_launches,
                    "ring_reduce_scatter":
                        cuda_ring.ring_reduce_scatter_launches,
                    "ring_allgather": cuda_ring.ring_allgather_launches}

        def on_sample(state):
            torch.cuda.synchronize()
            marks["t0"], marks["c0"], ring_s[0] = (time.perf_counter(),
                                                   counts(), 0.0)

        def on_update(state):
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - marks["t0"]) * 1e3)
            ring_ms.append(ring_s[0])
            losses.append(float(state["loss"]))
            c = counts()
            launches.append({k: c[k] - marks["c0"][k] for k in c})

        engine = AllReduceSGDEngine(
            vit.make_loss_fn(cfg, attn="flash", remat=VIT_DP_REMAT),
            lr=VIT_DP_LR, mode="compiled",
            hooks={"on_sample": on_sample, "on_update": on_update})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = engine.train(params, [one] * VIT_DP_STEPS, epochs=1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        params = state["params"]
        mpinn.check_with_allreduce(params, tol=0.0)
        digest = hashlib.sha256()
        for leaf in tree.leaves(params):
            digest.update(leaf.detach().cpu().numpy().tobytes())
        digests = [None] * p
        dist.all_gather_object(digests, digest.hexdigest())
        first_full = [None] * p
        dist.all_gather_object(first_full, full_loss)
        del params, state, engine
        dp = {"losses": losses, "step_ms": step_ms, "ring_ms": ring_ms,
              "launches_per_step": launches, "rings_planned": len(plan),
              "ring_sizes": ring_sizes,
              "step1_loss_full_attention": sum(first_full) / p,
              "peak_gb": peak_gb,
              "replicas_bitwise_equal": len(set(digests)) == 1}

        # (d) the bf16 forward on {tp 2}, against the one-rank forward.
        cfg_t = vit.vit_b16(VIT_REGISTERS)
        mesh = mesh_mod.make_mesh({"tp": p})
        whole = vit.init(VIT_SEED, cfg_t, dtype=torch.bfloat16,
                         device=device)
        shard = vit.shard_params(whole, mesh, cfg_t)
        xb, _ = _vit_batch(torch, cfg_t, VIT_BATCH, VIT_SEED + 2, device)
        with torch.no_grad():
            want = vit.apply(cfg_t, whole, xb, attn="flash")
            del whole
            _vit_reset(fa, split)
            got = vit.apply(cfg_t, shard, xb, attn="flash", mesh=mesh)
            torch.cuda.synchronize()
            tp_launches = _vit_counts(fa, split)
            rel = _rel(got, want)
            ms = []
            for _ in range(3):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vit.apply(cfg_t, shard, xb, attn="flash", mesh=mesh)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        tp = {"logits_rel_err_vs_one_rank": rel, "launches": tp_launches,
              "forward_ms": ms, "shape": list(got.shape),
              "finite": bool(torch.isfinite(got).all()),
              "wqkv_shard": list(shard["layers"]["wqkv"].shape)}
        return {"rank": rank, "p": p, "dp": dp, "tp": tp}
    finally:
        lifecycle.stop()


def phase_vit(torch, vit, llama, fa, split):
    """ViT-B/16 at full width: (a) bf16 inference and (b) the bf16 train
    step in this process, then (c) f32 data-parallel training through the
    engine's B1 rings and (d) the bf16 {tp 2} forward in VIT_DP_RANKS
    spawned ranks.  Returns the records and each path's launches (summed
    over the ranks)."""
    from torchmpi_tpu_torch.runtime import launch

    cfg = vit.vit_b16(VIT_REGISTERS)
    g = torch.Generator(device="cuda").manual_seed(VIT_SEED)
    params = vit.init(g, cfg, dtype=torch.bfloat16)
    x, y = _vit_batch(torch, cfg, VIT_BATCH, VIT_SEED + 3, "cuda")
    inference = _vit_inference(torch, vit, fa, split, params, x)
    train = _vit_train(torch, vit, llama, fa, split, params, x, y)
    del params, x, y
    torch.cuda.empty_cache()
    res = launch.spawn(VIT_DP_RANKS, vit_rank_main, (), timeout_s=600)
    layers = cfg.n_layers
    want_dp = {"flash_attention_fwd": FWD_PER_LAYER[VIT_DP_REMAT] * layers,
               "flash_attention_bwd_dq": layers,
               "flash_attention_bwd_dkv": layers,
               VIT_SPLIT: (FWD_PER_LAYER[VIT_DP_REMAT] + 1) * layers,
               "ring_allreduce": res[0]["dp"]["rings_planned"],
               "ring_reduce_scatter": 0, "ring_allgather": 0}
    want_tp = {"flash_attention_fwd": layers, "flash_attention_bwd_dq": 0,
               "flash_attention_bwd_dkv": 0, VIT_SPLIT: 0}
    for r in res:
        dp, tp = r["dp"], r["tp"]
        steady = sorted(dp["step_ms"][1:])
        emit(phase="vit", part="data_parallel", rank=r["rank"],
             ranks=r["p"], batch_per_rank=VIT_DP_BATCH, dtype="float32",
             lr=VIT_DP_LR, remat=VIT_DP_REMAT,
             steady_step_ms=steady[len(steady) // 2],
             expected_launches_per_step=want_dp, **dp)
        emit(phase="vit", part="tp", rank=r["rank"], mesh={"tp": r["p"]},
             batch=VIT_BATCH, dtype="bfloat16", rtol=VIT_TP_RTOL,
             expected_launches=want_tp, **tp)
        losses = dp["losses"]
        rel = (abs(losses[0] - dp["step1_loss_full_attention"])
               / abs(dp["step1_loss_full_attention"]))
        if any(c != want_dp for c in dp["launches_per_step"]):
            raise AssertionError(f"rank {r['rank']}: ViT data-parallel "
                                 f"launches {dp['launches_per_step']}, "
                                 f"expected {want_dp} a step")
        if not (all(math.isfinite(v) for v in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"ViT data-parallel loss did not fall: "
                                 f"{losses}")
        if not rel < VIT_F32_LOSS_RTOL:
            raise AssertionError(f"ViT data-parallel step 1 loss "
                                 f"{losses[0]} is {rel:.3g} from full "
                                 f"attention's")
        if not dp["replicas_bitwise_equal"]:
            raise AssertionError("ViT replicas differ after the steps")
        if not (tp["finite"] and tp["shape"] == [VIT_BATCH, cfg.n_classes]
                and tp["logits_rel_err_vs_one_rank"] < VIT_TP_RTOL
                and tp["launches"] == want_tp):
            raise AssertionError(f"ViT {{tp {r['p']}}} forward on rank "
                                 f"{r['rank']}: {tp}, expected launches "
                                 f"{want_tp}")
    launches = {
        "vit_inference": _sum_counts(rec["launches"]
                                     for rec in inference.values()),
        "vit_train": _sum_counts(c for remat in ("none", "dots")
                                 for c in train[remat]["launches_per_step"]),
        "vit_dp": _sum_counts(c for r in res
                              for c in r["dp"]["launches_per_step"]),
        "vit_tp": _sum_counts(r["tp"]["launches"] for r in res)}
    rings = sum(c["ring_allreduce"] for r in res
                for c in r["dp"]["launches_per_step"])
    emit(phase="vit", part="launches", by_path=launches,
         ring_allreduce=rings)
    return {"inference": inference, "train": train, "ranks": res,
            "launches": launches, "ring_allreduce": rings}


def phase_elastic():
    """Failure and membership on the card (``tools/elastic_drill.py``):
    every check of the drill must hold.  Its ranks' B1 counts start at 0
    in each spawned process and are read from their step records."""
    import tempfile

    from torchmpi_tpu_torch.tools import elastic_drill

    with tempfile.TemporaryDirectory(dir=HERE, prefix=".elastic_") as d:
        out = elastic_drill.run("cuda", d)
    summary = elastic_drill.summary(out)
    failed = elastic_drill.checks(out)
    emit(phase="elastic", **summary, failed=failed)
    if failed:
        raise AssertionError(f"elastic: {failed}")
    return summary


# The mfu phase: tester.mfu_sweep over Llama-3-8B in bf16 with flash
# attention at L = 2048, all MFU_LAYERS layers.  step_flops must lie within
# MFU_FLOPS_RTOL of 6 x (matmul parameters) x tokens plus the attention
# formula: the probe counts every matrix product (2 m n k, the forward, and
# the weight and input gradients) and each flash operator by the formula,
# so the two agree to rounding.  Each cell's first loss (the probed step's, from fresh parameters) must
# lie within MFU_LOSS_RTOL of full attention's on the same parameters and
# tokens: the train phase's bf16 tolerance.
MFU_LAYERS = 32
MFU_BATCHES = (1, 2)
MFU_REMATS = ("none", "dots")
MFU_L = 2048
MFU_WARMUP, MFU_ITERS = 1, 3
MFU_FLOPS_RTOL = 1e-3
MFU_LOSS_RTOL = 1e-2


def _mfu_expected(llama, fa, cfg, batch: int, remat: str) -> dict:
    """What the code predicts for one mfu cell: the three kernels' launches
    over its warmup and timed steps, the probe's flash share, its whole
    step's FLOPs and the LM head's share of them."""
    steps = MFU_WARMUP + MFU_ITERS
    L, D, H = MFU_L, cfg.head_dim, cfg.n_heads
    fwd = FWD_PER_LAYER[remat] * cfg.n_layers
    flash = (fwd * fa.attention_flops(batch * H, L, L, D, True, "fwd")
             + cfg.n_layers * fa.attention_flops(batch * H, L, L, D, True,
                                                 "bwd"))
    kv = cfg.n_kv_heads * D
    per_layer = (2 * cfg.d_model * cfg.d_model + 2 * cfg.d_model * kv
                 + 3 * cfg.d_model * cfg.d_ff)
    head = 6.0 * cfg.d_model * cfg.vocab * batch * L
    step = 6.0 * cfg.n_layers * per_layer * batch * L + head + flash
    return {"launches": {"flash_attention_fwd": steps * fwd,
                         "flash_attention_bwd_dq": steps * cfg.n_layers,
                         "flash_attention_bwd_dkv": steps * cfg.n_layers},
            "flash_flops": flash, "step_flops": step,
            "head_share": head / step}


def _mfu_reference_losses(torch, llama, tester, cfg) -> dict:
    """Full attention's loss by batch size on the sweep's fresh parameters
    (``llama.init(0)``, as ``mfu_sweep`` draws them) and tokens."""
    loss_fn = llama.make_loss_fn(cfg, attn="full")
    ref = {}
    for b in MFU_BATCHES:
        params = llama.init(0, cfg, dtype=torch.bfloat16, device="cuda")
        batch = tester.sweep_batch(b, MFU_L, cfg.vocab, "cuda")
        with torch.no_grad():
            ref[b] = float(loss_fn(params, batch))
        del params, batch
    return ref


def phase_mfu(torch, llama, fa) -> dict:
    """``tester.mfu_sweep`` on Llama-3-8B (bf16, flash, L = 2048, batch 1
    and 2, remat "none" and "dots"): each cell's ms, TFLOP/s, MFU, peak GB
    and the LM head's share of its FLOPs; its B4-B6 launches as predicted,
    the probe's flash share equal to the closed formula, its FLOPs within
    MFU_FLOPS_RTOL of 6 N T plus that formula and its first loss within
    MFU_LOSS_RTOL of full attention's."""
    from torchmpi_tpu_torch.utils import tester

    cfg = dataclasses.replace(llama.llama3_8b(), n_layers=MFU_LAYERS)
    ref = _mfu_reference_losses(torch, llama, tester, cfg)
    cells = []

    def report(line):
        # mfu_sweep reports each cell as it ends: its launches are the
        # counts since the last report.
        cells.append({"line": line, "launches": read_counts(fa)})
        reset_counts(fa)

    reset_counts(fa)
    res = tester.mfu_sweep(MFU_BATCHES, MFU_REMATS, seq_len=MFU_L,
                           warmup=MFU_WARMUP, iters=MFU_ITERS, cfg=cfg,
                           report=report, attn="flash",
                           dtype=torch.bfloat16)
    failed, recs, total = [], [], {k: 0 for k in COUNTERS}
    for r, cell in zip(res, cells):
        want = _mfu_expected(llama, fa, cfg, r.batch, r.remat)
        rel = abs(r.step_flops - want["step_flops"]) / want["step_flops"]
        loss_rel = abs(r.first_loss - ref[r.batch]) / abs(ref[r.batch])
        rec = {"batch": r.batch, "seq": r.seq_len, "remat": r.remat,
               "n_layers": cfg.n_layers,
               "ms": r.mean_seconds * 1e3, "min_ms": r.min_seconds * 1e3,
               "tflops": r.flops_per_s / 1e12, "mfu": r.mfu_estimate,
               "peak_gb": (None if r.peak_hbm_bytes is None
                           else r.peak_hbm_bytes / 1e9),
               "step_flops": r.step_flops,
               "expected_step_flops": want["step_flops"],
               "step_flops_rel_err": rel, "flash_flops": r.flash_flops,
               "expected_flash_flops": want["flash_flops"],
               "head_flops_share": want["head_share"],
               "first_loss": r.first_loss,
               "first_loss_full_attention": ref[r.batch],
               "first_loss_rel_err": loss_rel,
               "launches": cell["launches"],
               "expected_launches": want["launches"],
               "line": cell["line"]}
        emit(phase="mfu_cell", **rec)
        recs.append(rec)
        for k, v in cell["launches"].items():
            total[k] += v
        tag = f"b={r.batch} remat={r.remat}"
        if cell["launches"] != want["launches"]:
            failed.append(f"{tag}: launches {cell['launches']}")
        if r.flash_flops != want["flash_flops"]:
            failed.append(f"{tag}: flash share {r.flash_flops} != "
                          f"{want['flash_flops']}")
        if not rel <= MFU_FLOPS_RTOL:
            failed.append(f"{tag}: step_flops {r.step_flops} is {rel:.3g} "
                          f"from {want['step_flops']}")
        if not (math.isfinite(r.first_loss) and loss_rel < MFU_LOSS_RTOL):
            failed.append(f"{tag}: first loss {r.first_loss} is "
                          f"{loss_rel:.3g} from full attention's "
                          f"{ref[r.batch]}")
        if not (r.mfu_estimate and 0 < r.mfu_estimate < 1):
            failed.append(f"{tag}: mfu {r.mfu_estimate}")
    if len(recs) != len(MFU_BATCHES) * len(MFU_REMATS):
        failed.append(f"{len(recs)} cells")
    emit(phase="mfu", n_layers=MFU_LAYERS, cells=len(recs),
         flops_rtol=MFU_FLOPS_RTOL, loss_rtol=MFU_LOSS_RTOL,
         launches=total, failed=failed)
    if failed:
        raise AssertionError(f"mfu: {failed}")
    return {"cells": recs, "launches": total}


def phase_numerics():
    """The numerics plane on config 1 at p = 4 on the card
    (``tools/numerics_drill.py``): every check of the drill must hold.
    Its ranks' B1 counts start at 0 in each spawned process and are read
    from their records."""
    import tempfile

    from torchmpi_tpu_torch.tools import numerics_drill

    with tempfile.TemporaryDirectory(dir=HERE, prefix=".numerics_") as d:
        out = numerics_drill.run("cuda", d)
    summary = numerics_drill.summary(out)
    failed = numerics_drill.checks(out)
    emit(phase="numerics", **summary, failed=failed)
    if failed:
        raise AssertionError(f"numerics: {failed}")
    return summary


# The autotune phase: the eager pass over the five ops at AUTOTUNE_SIZES
# (f32 elements; ResNet-50's buckets are 32 MiB and 8 MiB), best of
# AUTOTUNE_TRIALS interleaved trials; ResNet-50 at config 2's shape for
# AUTOTUNE_RESNET_STEPS steps a mode; the host-column pass at config 1's
# parameter count.
AUTOTUNE_SIZES = (1 << 14, 1 << 17, 1 << 19, 1 << 21, 1 << 23)
AUTOTUNE_TRIALS = 2
AUTOTUNE_RESNET_STEPS = 3
AUTOTUNE_BENCH_SIZES = (1 << 14, 1 << 18, 1 << 21)
AUTOTUNE_CPU_ELEMENTS = 1863690     # 784-1024-1024-10's parameters
AUTOTUNE_HC_DEADLINE_MS = 60000


def _pass_plain(torch, op, rows, me):
    """What a pass cell's collective must give on rank ``me``: the rows'
    sum, rank 0's row, the stacked rows or this rank's chunk of the sum."""
    total = torch.stack(rows).sum(0)
    return {"allreduce": total, "broadcast": rows[0],
            "reduce": total if me == 0 else rows[me],
            "allgather": torch.stack(rows),
            "reduce_scatter": total.view(len(rows), -1)[me]}[op]


def _host_ring(dist, hostcomm, comm):
    box = [[("127.0.0.1", q) for q in hostcomm.free_ports(comm.size)]]
    dist.broadcast_object_list(box, src=0)
    return hostcomm.HostCommunicator(comm.rank, comm.size, box[0],
                                     timeout_ms=60000,
                                     io_deadline_ms=AUTOTUNE_HC_DEADLINE_MS)


def autotune_rank_main() -> dict:
    """One rank of the autotune phase (spawned): the pass, its checks,
    ResNet-50 off and cache, the A/B and the host-column pass."""
    import hashlib

    import torch
    import torch.distributed as dist

    from torchmpi_tpu_torch.collectives import autotune, hostcomm, selector
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import resnet
    from torchmpi_tpu_torch.nn import bucketing
    from torchmpi_tpu_torch.obs import tracer
    from torchmpi_tpu_torch.runtime import communicator, config, lifecycle
    from torchmpi_tpu_torch.utils import tree
    from torchmpi_tpu_torch.utils.data import synthetic_mnist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    config.set("use_pallas_collectives", True)
    device = lifecycle.start()
    out = {}
    try:
        comm = communicator.stack.world()
        p, me = comm.size, comm.rank
        out["rank"] = me
        _reset_ring_counts()
        t0 = time.perf_counter()
        doc = autotune.run_pass(comm=comm, sizes=AUTOTUNE_SIZES,
                                trials=AUTOTUNE_TRIALS)
        out["pass_s"] = time.perf_counter() - t0
        out["pass_launches"] = _ring_counts()
        out["doc"] = {k: doc[k] for k in ("digest", "fingerprint", "cells")}
        held = []
        for key, c in doc["cells"].items():
            n = c["bytes"] // 4
            rows = [autotune.rank_row(r, n, "float32", device)
                    for r in range(p)]
            want = _pass_plain(torch, c["op"], rows, me)
            for impl in c["ms"]:
                fn = selector.resolve(c["op"], "tpu", c["scope"], prefer=impl)
                got = fn(comm, rows[me], **autotune._OP_KWARGS[c["op"]])
                got = got.reshape(want.shape)
                torch.cuda.synchronize()
                held.append({"cell": key, "impl": impl,
                             "equal": bool(torch.equal(got, want)),
                             "max_abs_err": float((got.double()
                                                   - want.double()).abs()
                                                  .max())})
            del rows, want
        out["held"] = held
        # ResNet-50 eager_async, off then cache, from one start.
        cfg = resnet.config(depth=50, n_classes=1000, width_multiplier=1.0)
        init, _ = resnet.init(7, cfg, device=device)
        ds = synthetic_mnist(n=p * RESNET_BATCH, n_classes=1000, seed=1,
                             image_shape=(224, 224, 3))
        one = (ds.x.reshape(p, RESNET_BATCH, 224, 224, 3),
               ds.y.reshape(p, RESNET_BATCH))
        out["bucket_elements"] = [
            s.total for s in bucketing.plan_ready_order(init).plan.specs]
        runs = {}
        for mode in ("off", "cache"):
            config.set("autotune_mode", mode)
            config.set("obs_trace", mode == "cache")
            tracer.drain()
            step_ms, losses, marks = [], [], {}

            def on_sample(state):
                torch.cuda.synchronize()
                marks["t0"] = time.perf_counter()

            def on_update(state):
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - marks["t0"]) * 1e3)
                losses.append(float(state["loss"]))

            engine = AllReduceSGDEngine(
                resnet.make_loss_fn(cfg), lr=RESNET_LR, mode="eager_async",
                hooks={"on_sample": on_sample, "on_update": on_update})
            params = tree.tree_map(lambda t: t.clone(), init)
            torch.cuda.synchronize()
            _reset_ring_counts()
            state = engine.train(params, [one] * AUTOTUNE_RESNET_STEPS)
            torch.cuda.synchronize()
            digest = hashlib.sha256()
            for leaf in tree.leaves(state["params"]):
                digest.update(leaf.detach().cpu().numpy().tobytes())
            # The gradient buckets' allreduce decisions (the start's
            # parameter broadcast resolves the same buckets too).
            rode = sorted({(s["attrs"]["bytes"], s["attrs"]["bucket"],
                            s["attrs"]["impl"]) for s in tracer.drain()
                           if s["name"] == "autotune.decision"
                           and s["attrs"]["op"] == "allreduce"})
            runs[mode] = {"losses": losses, "step_ms": step_ms,
                          "launches": _ring_counts(),
                          "digest": digest.hexdigest(),
                          "buckets_rode": [list(r) for r in rode]}
            del params, state
        config.set("obs_trace", False)
        config.set("autotune_mode", "off")
        out["resnet"] = runs
        del init
        torch.cuda.empty_cache()
        out["bench"] = autotune.bench_section(
            comm=comm, sizes=AUTOTUNE_BENCH_SIZES, trials=AUTOTUNE_TRIALS,
            ab_elements=1 << 18)
        comm.host_ring = _host_ring(dist, hostcomm, comm)
        try:
            cpu = autotune.run_pass(comm=comm, ops=("allreduce",),
                                    sizes=(AUTOTUNE_CPU_ELEMENTS,),
                                    placement="cpu", trials=AUTOTUNE_TRIALS,
                                    install=False)
        finally:
            comm.host_ring.close()
            comm.host_ring = None
        out["cpu_cells"] = cpu["cells"]
        return out
    except BaseException:
        import traceback

        print(f"autotune rank {out.get('rank')}: {traceback.format_exc()}",
              file=sys.stderr, flush=True)
        raise
    finally:
        lifecycle.stop()


def _steady(ms):
    rest = ms[1:] or ms
    return sum(rest) / len(rest)


def _bytes_bucket(n: int) -> str:
    from torchmpi_tpu_torch.obs.metrics import bytes_bucket

    return bytes_bucket(n)


def phase_autotune(smi: str) -> dict:
    """The autotune phase: every check of the docstring's item 26."""
    from torchmpi_tpu_torch.runtime import launch

    t0 = time.perf_counter()
    res = launch.spawn(2, autotune_rank_main, (), timeout_s=600)
    r0 = res[0]
    cells = r0["doc"]["cells"]
    off, cache = r0["resnet"]["off"], r0["resnet"]["cache"]
    rec = {
        "phase": "autotune", "card": smi, "ranks": 2,
        "sizes": list(AUTOTUNE_SIZES), "trials": AUTOTUNE_TRIALS,
        "pass_s": r0["pass_s"],
        "cells": {k: {"ms": c["ms"], "winner": c["winner"],
                      "default": c["default"], "reps": c["reps"]}
                  for k, c in cells.items()},
        "pass_launches": {r["rank"]: r["pass_launches"] for r in res},
        "candidates_held": len(r0["held"]),
        "max_abs_err": max(h["max_abs_err"] for r in res for h in r["held"]),
        "resnet50": {
            "dtype": "float32", "image": 224, "classes": 1000,
            "batch_per_rank": RESNET_BATCH, "mode": "eager_async",
            "steps": AUTOTUNE_RESNET_STEPS,
            "bucket_elements": r0["bucket_elements"],
            "buckets_rode_under_cache": cache["buckets_rode"],
            "off_step_ms": off["step_ms"], "cache_step_ms": cache["step_ms"],
            "off_steady_step_ms": _steady(off["step_ms"]),
            "cache_steady_step_ms": _steady(cache["step_ms"]),
            "off_losses": off["losses"], "cache_losses": cache["losses"],
            "b1_launches": {"off": off["launches"]["ring_allreduce"],
                            "cache": cache["launches"]["ring_allreduce"]}},
        "bench_section": {"cells": r0["bench"]["cells"],
                          "ab": r0["bench"]["ab"]},
        "cpu_pass": {k: {"ms": c["ms"], "winner": c["winner"],
                         "bytes": c["bytes"]}
                     for k, c in r0["cpu_cells"].items()},
        "seconds": time.perf_counter() - t0}
    emit(**rec)
    bad = []
    for r in res:
        if r["doc"] != r0["doc"] or r["cpu_cells"] != r0["cpu_cells"]:
            bad.append(f"rank {r['rank']}: its pass doc differs from rank 0's")
        if not all(h["equal"] for h in r["held"]):
            bad.append(f"rank {r['rank']}: candidates unequal to plain: "
                       f"{[h for h in r['held'] if not h['equal']][:3]}")
        if not all(r["pass_launches"][k] > 0 for k in RING_KERNELS):
            bad.append(f"rank {r['rank']}: pass launches "
                       f"{r['pass_launches']}")
        ro, rc = r["resnet"]["off"], r["resnet"]["cache"]
        if ro["losses"] != rc["losses"] or ro["digest"] != rc["digest"]:
            bad.append(f"rank {r['rank']}: cache's ResNet-50 differs from "
                       f"off's: {ro['losses']} {rc['losses']}")
        if not all(math.isfinite(x) for x in ro["losses"]):
            bad.append(f"rank {r['rank']}: non-finite loss {ro['losses']}")
        if rc["buckets_rode"] != cache["buckets_rode"]:
            bad.append(f"rank {r['rank']}: its buckets rode "
                       f"{rc['buckets_rode']}, rank 0's "
                       f"{cache['buckets_rode']}")
    if sorted(b for b, _, _ in cache["buckets_rode"]) != sorted(
            4 * n for n in r0["bucket_elements"]):
        bad.append(f"not every bucket resolved by measurement: "
                   f"{cache['buckets_rode']}")
    for n in r0["bucket_elements"]:
        key = f"allreduce|float32|{_bytes_bucket(4 * n)}|tpu|singlenode"
        if key not in cells:
            bad.append(f"no exact cell {key}")
    for k, c in cells.items():
        if c["winner"] != min(c["ms"], key=c["ms"].get):
            bad.append(f"cell {k}: winner {c['winner']} of {c['ms']}")
    ab = r0["bench"]["ab"]
    if not (ab["default_ms"] > 0 and ab["autotuned_ms"] > 0):
        bad.append(f"bench_section A/B {ab}")
    if {i for c in r0["cpu_cells"].values() for i in c["ms"]} != {
            "hostcomm", "xla", "pallas"}:
        bad.append(f"host-column candidates {r0['cpu_cells']}")
    if bad:
        raise AssertionError(f"autotune: {bad}")
    return {"launches": {
        "autotune_pass": {k: sum(r["pass_launches"][k] for r in res)
                          for k in RING_KERNELS},
        "autotune_resnet": {k: sum(r["resnet"][m]["launches"][k]
                                   for r in res for m in ("off", "cache"))
                            for k in RING_KERNELS}},
        "rec": rec}


def phase_retune(smi: str) -> dict:
    """The retune drill on the card (``tools/retune_drill.py``): every
    check of the drill must hold.  Its ranks' counts start at 0 in each
    spawned process and are read from their records."""
    import tempfile

    from torchmpi_tpu_torch.tools import retune_drill

    with tempfile.TemporaryDirectory(dir=HERE, prefix=".retune_") as d:
        out = retune_drill.run("cuda", d)
    summary = retune_drill.summary(out)
    failed = retune_drill.checks(out)
    emit(phase="retune", card=smi, **summary, failed=failed)
    if failed:
        raise AssertionError(f"retune: {failed}")
    return {"b1": summary["b1_launches_all_ranks"],
            "compiled": {k: summary["compiled_launches_all_ranks"][v]
                         for k, v in COUNTERS.items()},
            "summary": summary}


def ring_kernel_record(name, rings, train_launches, train_rec,
                       async_launches, async_rec, mnist_rec, options,
                       hierarchy, vit_rings, elastic, numerics, autotune,
                       retune):
    """One ``kernels`` entry of a ring kernel at p = 2: B1 at the path's own
    work, the 43 rings of a ResNet-50 compiled step, with the 4 buckets of
    an eager_async step beside (times, bound and the largest error over
    them, the ring_kernels cases and step 1's rings of both train phases);
    B2 and B3 at n = 25,557,032 in f32, the collectives path's size (and
    at p = 4 beside).
    Launches of every path (train_resnet_async: its two eager_async
    runs; train_mnist: the example's three runs; train_mnist_options: its
    five runs, the profiler's window inside the first; tester: the ring
    sweep; hierarchy: the world-level allreduce under the span over both
    levels of a 2x2 split, B1 only; vit_dp: ViT-B/16's gradient rings on
    both ranks, B1 only; elastic: config 1's rings in the worlds the
    elastic drill re-forms, B1 only; numerics: config 1's rings at p = 4
    in the numerics drill's runs (off, audit, the checked audit run, NaN),
    B1 only; autotune_pass: the eager pass's candidates on both ranks;
    autotune_resnet: ResNet-50's buckets under off and cache; retune: the
    retune drill's rings and boundary passes on 4 ranks, B1 only)."""
    replaces, function, kind, library = RING_KERNELS[name]
    big = next(r for r in rings[2]["records"]
               if r["kind"] == kind and "kernel_ms" in r)
    by_path = {"train_resnet": train_launches[name],
               "collectives": rings[2]["collectives_launches"][name],
               "train_resnet_async": sum(
                   n for label, n in async_launches.items()
                   if label.startswith("eager_async"))
               if name == "ring_allreduce" else 0,
               "train_mnist": mnist_rec["launches"][name],
               "train_mnist_options": sum(
                   r["launches_total"][name]
                   for r in options["mnist_options"]["runs"].values()),
               "tester": options["tester"]["ring"]["launches"][name],
               "hierarchy": hierarchy["launches"][name],
               "vit_dp": vit_rings if name == "ring_allreduce" else 0,
               "elastic": elastic if name == "ring_allreduce" else 0,
               "numerics": numerics if name == "ring_allreduce" else 0,
               "autotune_pass": autotune["autotune_pass"][name],
               "autotune_resnet": autotune["autotune_resnet"][name],
               "retune": retune if name == "ring_allreduce" else 0}
    timing = ("kernel_ms", "plain_ms", "library_ms", "bound_ms")
    err = max(r["max_abs_err"] for p in (2, 4)
              for r in rings[p]["records"] if r["kind"] == kind)
    rec = {"name": name, "route": "cuda", "source": RING_SRC,
           "replaces": replaces, "replaces_function": function,
           "launches": sum(by_path.values()), "launches_by_path": by_path,
           "bound_by": "bytes", "library": library,
           "design": RING_DESIGN[name]}
    if kind == "allreduce":
        step, buckets = rings[2]["resnet_rings"], rings[2]["bucket_rings"]
        err = max([err, step["max_abs_err"], hierarchy["ring_max_abs_err"]]
                  + [rings[p]["bucket_rings"]["max_abs_err"] for p in (2, 4)]
                  + [h["max_abs_err"]
                     for r in (train_rec, async_rec, mnist_rec)
                     for h in r["step1_rings_vs_plain"]])
        return {**rec, "max_abs_err": err, "ms": step["kernel_ms"],
                **{k: step[k] for k in timing},
                "shape": (f"the {step['rings']} rings of one ResNet-50 step "
                          f"({step['elements']} f32 elements, largest "
                          f"{step['largest']}, tail {step['tail']}), mean, "
                          f"p=2 ranks on one card"),
                "largest_ring_ms": step["largest_ms"],
                "tail_ring_ms": step["tail_ms"],
                "at_async_buckets": {
                    **{k: buckets[k] for k in timing},
                    "sizes": buckets["sizes"],
                    "largest_ring_ms": buckets["largest_ms"]},
                "at_n_25557032": {k: big[k] for k in timing}}
    big4 = next(r for r in rings[4]["records"]
                if r["kind"] == kind and "kernel_ms" in r)
    return {**rec, "max_abs_err": err, "ms": big["kernel_ms"],
            **{k: big[k] for k in timing},
            "shape": "n=25557032 f32, p=2 ranks on one card",
            "at_p4": {k: big4[k] for k in timing}}


def conv_kernel_record(recs, launches):
    """The ``kernels`` entry of B7: the 7x7x512 bf16 case's times, the
    largest error over every case, the f32 case at the same shape and the
    other cases beside; launches of the path in both types."""
    main, f32 = recs["7x7x512_bfloat16"], recs["7x7x512_float32"]
    timing = ("kernel_ms", "plain_ms", "library_ms", "library_fwd_bwd_ms",
              "bound_ms", "bound_by", "bound_rate")
    keys = timing + ("max_abs_err", "design", "kernel_tflops", "split_ms",
                     "split_device_ms")
    return {"name": "conv3x3", "route": "cuda", "source": CONV_SRC,
            "replaces": CONV_REPLACES[0],
            "replaces_function": CONV_REPLACES[1],
            "launches": sum(launches.values()),
            "launches_by_path": {"conv3x3": sum(launches.values())},
            "launches_by_dtype": launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs.values()),
            "ms": main["kernel_ms"], **{k: main[k] for k in timing},
            "design": main["design"], "kernel_tflops": main["kernel_tflops"],
            "library": CONV_LIBRARY,
            "shape": "x (128, 7, 7, 512) w (3, 3, 512, 512) bf16",
            "f32": {**{k: f32[k] for k in keys if k in f32},
                    "launches": launches["float32"]},
            "cases": {case: {k: r[k] for k in keys if k in r}
                      for case, r in recs.items()}}


def kernel_record(name, recs, part, err_keys, launches_by_path, blocks):
    """One entry of the ``kernels`` line: the main bf16 case's times, the
    largest error over every case and every ring block of the mesh phase
    (``blocks``, :func:`mesh_blocks`), and the launches of every path."""
    source, replaces, function, library = KERNELS[name]
    main = recs["main_bf16"] if part is None else recs["main_bf16"][part]
    f32 = recs["main_f32"] if part is None else recs["main_f32"][part]
    timing = ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
              "bound_rate")
    extra = ("design", "kernel_tflops", "bwd_ms", "split_ms",
             "split_device_ms")
    rec = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "replaces_function": function,
        "launches": sum(p[name] for p in launches_by_path.values()),
        "launches_by_path": {path: p[name]
                             for path, p in launches_by_path.items()},
        "max_abs_err": max(r[k] for r in (*recs.values(), *blocks.values())
                           for k in err_keys),
        "mesh_blocks": {b: {"lq": r["lq"], "lk": r["lk"],
                            "causal": r["causal"],
                            "ms": r["fwd_ms" if part is None else "bwd_ms"],
                            **{k: r[k] for k in err_keys}}
                        for b, r in blocks.items()},
        "ms": main["kernel_ms"], **{k: main[k] for k in timing},
        **{k: main[k] for k in extra if k in main},
        "library": library,
        "shape": "B=1 H=32 L=2048 D=128 causal bf16",
        "f32": {**{k: f32[k] for k in timing + extra if k in f32},
                # f32 inputs on a path: the serve phase's f32 prefill (B4),
                # the f32 train phase and ViT's f32 data-parallel run (B4,
                # B5, B6).
                "launches": sum(launches_by_path[path][name] for path in
                                ("serve_f32_prefill", "train_f32",
                                 "vit_dp"))},
        # Head size 64, ViT-B/16's: the kernel phases' ViT cases and the
        # vit phase's launches.
        "head_dim_64": {
            "shape": "BH=768 (64 images x 12 heads) D=64, L=256 "
                     "non-causal; L=196 ragged; L=256 causal",
            "launches": sum(launches_by_path[path][name]
                            for path in VIT_PATHS),
            "cases": {case: {k: r[k] for k in timing + extra
                             + ("launches", "split_launches") if k in r}
                      for case in VIT_CASES
                      for r in [recs[case] if part is None
                                else {**recs[case], **recs[case][part]}]}},
    }
    keys = ("kernel_ms", "kernel_tflops", "bound_ms", "design")
    if part is None:
        rec["f32_bf16out"] = {k: recs["main_f32_bf16out"][k]
                              for k in timing + extra
                              if k in recs["main_f32_bf16out"]}
        rec["f32_out"] = {k: recs["main_bf16_f32out"][k] for k in keys}
        rec["lk_ne_lq"] = {
            case: {**{k: recs[case][k] for k in keys},
                   "out_dtype": recs[case]["out_dtype"]}
            for case in ("lk_ne_lq_bf16", "lk_ne_lq_f32out")}
    else:
        rec["f32_bf16out"] = {k: recs["main_f32_bf16out"][part][k]
                              for k in timing + extra
                              if k in recs["main_f32_bf16out"][part]}
        # The ring carry's form: flash_bwd_block at Lq 512 / Lk 2048, bf16
        # in, f32 out, beside the same call with a bf16 output.
        rec["f32_out"] = {k: recs["block_lk_ne_lq_f32out"][part][k]
                          for k in keys}
        rec["lk_ne_lq"] = {
            case: {**{k: recs[case][part][k] for k in keys},
                   "out_dtype": recs[case]["out_dtype"]}
            for case in ("lk_ne_lq_bf16", "block_lk_ne_lq_f32out")}
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="depth of phases 4-6: 8 to 32 (Llama-3-8B has 32); "
                         "train_f32 takes no more than 16")
    args = ap.parse_args()
    if not 8 <= args.layers <= 32:
        ap.error(f"--layers must be 8 to 32, got {args.layers}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import importlib

    import torchmpi_tpu_torch  # noqa: F401
    from torchmpi_tpu_torch import _build, serving
    from torchmpi_tpu_torch.examples import train_llama as train_mod
    from torchmpi_tpu_torch.models import llama, vit
    from torchmpi_tpu_torch.serving import engine as engine_mod

    fa = importlib.import_module("torchmpi_tpu_torch.ops.flash_attention")
    conv = importlib.import_module("torchmpi_tpu_torch.ops.conv3x3")
    split = importlib.import_module("torchmpi_tpu_torch.ops.bf16_split")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    start = t0 = time.perf_counter()
    libs = _build.build_all()
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=[os.path.relpath(p, HERE) for p in libs])
    took = {"build": time.perf_counter() - t0}
    held = {}

    def timed(name, fn, *fn_args, **fn_kw):
        t = time.perf_counter()
        try:
            return fn(*fn_args, **fn_kw)
        finally:
            took[name] = time.perf_counter() - t
            # What the phase left allocated on the card in this process,
            # before and after a collection of cyclic garbage (which a
            # phase may leave holding card memory until the collector
            # next runs, into the next phase).
            before = torch.cuda.memory_allocated() / 1e9
            gc.collect()
            held[name] = [before, torch.cuda.memory_allocated() / 1e9]

    kernel_recs = timed("kernel", phase_kernel, torch, fa, split)
    bwd_recs = timed("kernel_bwd", phase_kernel_bwd, torch, fa, split)
    conv_recs, conv_launches = timed("conv_kernel", phase_conv_kernel, torch,
                                     conv, split)
    rings = timed("ring_kernels", phase_ring_kernels)
    resnet_rec = timed("train_resnet", phase_train_resnet, torch, rings)
    async_rec, async_launches = timed("train_resnet_async",
                                      phase_train_resnet_async)
    mnist_rec = timed("train_mnist", phase_train_mnist)
    options = timed("options", phase_options)
    hierarchy = timed("hierarchy", phase_hierarchy)
    torch.cuda.empty_cache()
    mesh = timed("mesh", phase_mesh, torch, llama, fa, train_mod,
                 args.layers)
    torch.cuda.empty_cache()
    if args.layers != 32:
        emit(phase="cut", n_layers=args.layers, of=32)
    gen, cfg = timed("generate", phase_generate, torch, llama, fa,
                     args.layers)
    # The kernel's share of the prefill: its time at this very shape,
    # times its launches, over the measured prefill.
    attn_ms = kernel_recs["main_bf16"]["kernel_ms"] * gen["flash_fwd_launches"]
    emit(phase="prefill_breakdown", prefill_ms=gen["prefill_ms"],
         flash_kernel_ms=attn_ms, flash_kernel_share=attn_ms / gen["prefill_ms"])
    torch.cuda.empty_cache()
    serve_counts, prefill_rec, runner, serve_rec = timed(
        "serve", phase_serve, torch, llama, fa, split, engine_mod, serving,
        cfg)
    launches = {"generate": gen["launches"], "serve": serve_counts,
                "serve_f32_prefill": prefill_rec["launches"]}
    launches["frontend"] = timed("frontend", phase_frontend, torch, llama,
                                 fa, engine_mod, serving, cfg, runner,
                                 serve_rec)
    del runner
    torch.cuda.empty_cache()
    launches["router"] = timed("router", phase_router, torch, llama, fa,
                               engine_mod, serving)
    for name in ("frontend", "router"):
        if held[name][0] - held[name][1] > SERVE_CYCLE_GB:
            raise AssertionError(
                f"{name}: cyclic garbage held {held[name][0]:.2f} GB on the "
                f"card until a collection ({held[name][1]:.2f} GB after)")
    # B4's share of the f32 prefill: its f32 time at this very shape, times
    # its launches, over the measured prefill.
    attn_ms = (kernel_recs["main_f32"]["kernel_ms"]
               * prefill_rec["launches"]["flash_attention_fwd"])
    emit(phase="f32_prefill_breakdown",
         prefill_ms=prefill_rec["prefill_ms_flash"], flash_kernel_ms=attn_ms,
         flash_kernel_share=attn_ms / prefill_rec["prefill_ms_flash"])
    torch.cuda.empty_cache()
    train = timed("train", phase_train, torch, llama, fa, split, train_mod,
                  args.layers)
    launches["train"] = train["launches"]
    # The three kernels' share of a steady step: their times at this very
    # shape (kernel phase), times their launches in one step, over the step.
    per_step = train["launches_per_step"][-1]
    kernel_ms = {
        "flash_attention_fwd": kernel_recs["main_bf16"]["kernel_ms"],
        "flash_attention_bwd_dq": bwd_recs["main_bf16"]["dq"]["kernel_ms"],
        "flash_attention_bwd_dkv": bwd_recs["main_bf16"]["dkv"]["kernel_ms"]}
    in_step = {k: per_step[k] * kernel_ms[k] for k in kernel_ms}
    emit(phase="train_breakdown", steady_step_ms=train["steady_step_ms"],
         kernel_ms_per_step=in_step,
         kernel_share={k: v / train["steady_step_ms"]
                       for k, v in in_step.items()},
         kernels_share=sum(in_step.values()) / train["steady_step_ms"])
    torch.cuda.empty_cache()
    f32_layers = min(args.layers, TRAIN_F32_LAYERS)
    emit(phase="cut", path="train_f32", n_layers=f32_layers, of=32,
         why="f32 parameters, gradients and activations of 32 layers would "
             "not fit the card's 80 GB")
    train_f32 = timed("train_f32", phase_train, torch, llama, fa, split,
                      train_mod, f32_layers, dtype="float32")
    launches["train_f32"] = train_f32["launches"]
    # The same for the f32 step: B4's f32 time (its split included) times
    # its launches, and one whole f32 backward (one split, dq, dk/dv) per
    # layer for B5 and B6, over the step.
    per_step = train_f32["launches_per_step"][-1]
    in_step = {
        "flash_attention_fwd": per_step["flash_attention_fwd"]
        * kernel_recs["main_f32"]["kernel_ms"],
        "flash_attention_bwd_dq+dkv": per_step["flash_attention_bwd_dq"]
        * bwd_recs["main_f32"]["bwd_ms"]}
    emit(phase="train_f32_breakdown",
         steady_step_ms=train_f32["steady_step_ms"],
         kernel_ms_per_step=in_step,
         kernel_share={k: v / train_f32["steady_step_ms"]
                       for k, v in in_step.items()},
         kernels_share=sum(in_step.values()) / train_f32["steady_step_ms"])

    torch.cuda.empty_cache()
    adam = timed("train_adam", phase_train_adam, torch, llama, fa, split,
                 train_mod, args.layers)
    launches["train_adam"] = adam["launches"]
    launches.update(mesh["launches"])
    torch.cuda.empty_cache()
    _, moe_launches = timed("moe", phase_moe, torch, llama, fa, train_mod)
    launches.update(moe_launches)
    torch.cuda.empty_cache()
    pipe = timed("pipeline", phase_pipeline, torch, llama, fa, train_mod)
    launches.update(pipe["launches"])
    torch.cuda.empty_cache()
    vit_rec = timed("vit", phase_vit, torch, vit, llama, fa, split)
    launches.update(vit_rec["launches"])
    torch.cuda.empty_cache()
    launches["mfu"] = timed("mfu", phase_mfu, torch, llama, fa)["launches"]
    torch.cuda.empty_cache()
    timed("parameterserver", phase_parameterserver, torch, fa)
    elastic = timed("elastic", phase_elastic)
    numerics = timed("numerics", phase_numerics)
    autotuned = timed("autotune", phase_autotune, smi)
    retuned = timed("retune", phase_retune, smi)
    launches["retune_compiled"] = retuned["compiled"]
    emit(phase="timing", seconds=took, total_s=time.perf_counter() - start,
         held_gb_after=held)

    print(smi, flush=True)
    emit(kernels=[
        kernel_record("flash_attention_fwd", kernel_recs, None,
                      ("o_max_abs_err",), launches, mesh["blocks"]),
        kernel_record("flash_attention_bwd_dq", bwd_recs, "dq",
                      ("dq_max_abs_err",), launches, mesh["blocks"]),
        kernel_record("flash_attention_bwd_dkv", bwd_recs, "dkv",
                      ("dk_max_abs_err", "dv_max_abs_err"), launches,
                      mesh["blocks"]),
        *(ring_kernel_record(name, rings, resnet_rec["launches"],
                             resnet_rec, async_launches, async_rec,
                             mnist_rec, options, hierarchy,
                             vit_rec["ring_allreduce"],
                             elastic["ring_allreduce_launches"],
                             numerics["b1_launches_all_ranks"],
                             autotuned["launches"], retuned["b1"])
          for name in RING_KERNELS),
        conv_kernel_record(conv_recs, conv_launches),
    ])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


def _children() -> list:
    """The pids of this process's live or unreaped children (Linux)."""
    me, pids = str(os.getpid()), []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except (OSError, ValueError):
            continue
        if stat[stat.rfind(")") + 2:].split()[1] == me:
            pids.append(int(pid))
    return pids


def stop_children() -> None:
    """Leave no process of this run behind.  The spawned phases' queues
    start multiprocessing's resource tracker, a child that would otherwise
    outlive the script as an orphan until it reads the end of its pipe:
    it is stopped and reaped here.  Any other child still present is a
    fault of a phase: it is killed, reaped and named on stderr."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    for pid in _children():
        if pid == getattr(tracker, "_pid", None):
            continue
        print(f"chip_smoke: killing a leftover child, pid {pid}",
              file=sys.stderr, flush=True)
        try:
            os.kill(pid, 9)
            os.waitpid(pid, 0)
        except (ChildProcessError, ProcessLookupError):
            pass
    if getattr(tracker, "_fd", None) is not None:
        tracker._stop()   # closes its pipe and waits for it to exit


if __name__ == "__main__":
    # Registered before main() imports multiprocessing, so that it runs
    # after multiprocessing's own exit handler has released the queues'
    # semaphores and joined the spawned ranks.
    atexit.register(stop_children)
    sys.exit(main())

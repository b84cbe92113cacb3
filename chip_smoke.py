"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines print):

1. the card's name and power limit (``nvidia-smi``); TF32 off, and no
   16-bit reductions in cuBLAS (the reference accumulates 16-bit
   products in float32);
2. build every kernel from ``singa_tpu_torch/ops/csrc`` (one ``nvcc``
   per source, in parallel); each kernel's registers and spills, and
   the spills of the flash kernels' D 64 instantiations;
3. flash-attention forward, o and lse against the plain PyTorch version
   on both routes: the key split (a partial launch and a combine) and
   the unsplit launch.  The serving shape (dense mask, q (1,12,64,64),
   k/v (1,12,1024,64)) and causal B 1, H 2, T 1024 take the split route
   by the card's plan and are forced unsplit too; causal, key-vector and
   ragged T/S cases at every head dim the kernel is built for (per-head
   masks, a fully masked row) run forced each way.  The combine kernel
   alone against its plain version on the serving shape's partials.
   Times at the serving shape for the split route (and its two
   launches), the unsplit route, the plain version and
   ``scaled_dot_product_attention`` pinned to its memory-efficient
   backend, the one float32 takes (a yardstick the port never calls).
   The causal serving shapes on the card's plan (H 12, d 64):
   ``generate``'s prefill at B 4, T 256 (unsplit) and the monolithic
   engine's at B 1, T 128 / 256 / 512 (the key split, whose early query
   tiles have empty ranges; the combine alone there too), each against
   its plain version, timed beside its bound and the pinned
   ``scaled_dot_product_attention`` with ``is_causal``;
4. flash-attention backward: the dq and dk/dv kernels against their
   plain versions at the training shape (B 8, H 12, T = S = 1024, d 64,
   causal) and on ragged cases at d 16/32/64/128 (per-head dense and
   vec masks, fully masked rows, causal with a dense mask); times at the
   training shape for each kernel, its plain version and the backward
   of the pinned ``scaled_dot_product_attention``, and the forward's
   there too;
5. paged decode attention, every variant (float32 pages; bfloat16
   pages, the storage override; int8 pages with bf16 and with fp32
   scales) against its plain version at 1e-4 through the public entry
   and on three forced plans (the card's, unsplit, one page a range):
   at the serving shape (8 slots, 12 heads, d 64, 16-token pages, 64
   pages a slot, NULL tails, mid-page positions), the same with a slot
   at pos -1 (the mean of V over its whole row), d 40 and d 18 with
   5-token pages (element loads), 8-, 12- and 32-token pages at head
   dims 64, 32 and 128, and pools one element off their alignment; the
   split route's partials (read from its scratch buffer) and its merge
   launch, through the call and alone, each against their plain
   versions; 1,000 launches back to back over variants, shapes, plans
   and positions (the one scratch buffer reused in stream order), every
   output checked; times, plans, byte bounds and the wrapper's host µs
   a call (median of 200, no sync) of the float32 and int8 variants at
   the serving shape, and the merge launch's time alone;
3b, 4b. the flash kernels on bfloat16 and float16 operands: the forward
   on both routes at the serving, causal-serving and training shapes and
   ragged cases at every head dim, the split route's partials and its
   combine alone, the dq and dk/dv kernels at the training shape and on
   ragged cases, each against its plain version on the same 16-bit
   operands (outputs within one unit in the last place of their dtype,
   taken at max(|x|, 2^-6); lse and partials within 1e-4); times beside
   the float32 ones, the bound at 2 bytes an element and the TF32 rate
   for the kernels' own products (below; the 3xTF32 bound beside it),
   and ``scaled_dot_product_attention`` in the same dtype (pinned
   as above; a yardstick that rounds P to 16 bits, so another function);
5c. paged decode on a 16-bit query: bf16 over bf16 pages, fp16 over fp16,
   bf16 over int8 (bf16 scales), bf16 over float32, fp16 over int8
   (fp32 scales), on phase 5's shapes and three plans each, the split
   route's halves and misaligned pools, outputs within one unit of the
   query's dtype; times at the serving shape beside float32's;
5a. the fused LSTM cell: its forward and backward kernels against their
   plain versions, and its autograd Function against the plain cell
   under torch's autograd, in float32, bfloat16 and float16, at the
   char-LSTM's training shape (B 64, H 256), its sampling shape (B 1,
   H 256) and ragged shapes (B 3/65, H 5/130/1000); times at the training
   shape for each kernel, its plain version, the whole Function backward
   and cuDNN's ``torch.nn.LSTM`` forward and backward over T 100 divided
   by T (yardsticks the port never calls); the Function backward's
   device launches counted under the profiler; the kernels' registers,
   spills and shared memory;
5b. the elementwise catalogue, path ``ew``: every op and dtype pair
   through its own entry points at the char-LSTM's gate size (T * B *
   4H = 6,553,600 values), then each against its plain version, plus a
   ragged length, NaN / +-inf / +-0 inputs and views 1-8 values into
   their buffers (on and off the output's 16-byte boundary, alike and
   different between operands); times of relu, exp, gelu,
   add, copy to bf16 and clamp against the one torch call each;
6. the serving path: the paged, chunked ``ServingEngine`` on GPT-2-small
   dimensions (fp32, seeded random weights carried in through
   ``GPT.from_jax_decode_params``) serves 8 staggered requests (3, 5 and
   7 sampled, the rest greedy) through its CUDA graphs (the unified step
   and the horizon, a greedy and a sampled twin of each); two greedy
   requests are replayed through the port on the CPU and their tokens
   compared; the prefill chunks' flash calls must take the split route
   (combine launches), and so must the paged decode calls (merge
   launches, ``launches_merge``).  Every serving path (6-7f) is then
   held against its eager twin (``_capture=False``, the same weights
   and stream): every request's tokens bit for bit, greedy and sampled,
   and the credited launches equal to the twin's; at most 2 graph keys
   a sampling mode (1 for the monolithic decode step), at most one
   capture a key, replays; in steady-state decode no upload and one
   fetch a horizon (the monolithic engine: 5 uploads and 1 fetch a
   step); three profiled replays of the unified and the horizon graph,
   whose middle one runs exactly the flash partial and combine and
   paged decode and merge launches it is credited with; each sampled
   request served alone on a fresh engine gives its stream tokens;
7. the quantized serving path: the same weights and stream served with
   ``kv_dtype="int8", weight_dtype="int8"`` (the model on the host, the
   engine on the card); the int8 kernel must launch, on its split route,
   and neither float kernel; a fresh engine must replay every request's
   tokens; the pool
   must hold exactly (d_head + 2) / (2 d_head) of a bf16-storage pool's
   bytes; the teacher-forced drift over a 256-token prompt (int8 against
   float params and pages) must hold the reference's committed
   tolerances; two greedy requests are replayed on the CPU; tokens/s,
   TTFT, KV and weight bytes and peak memory print beside phase 6's;
7a. path ``generate``: ``GPT.generate`` on the card, B 4 of phase 6's
   prompts cut to 200 tokens, 32 new greedy tokens, with
   ``decode_horizon`` None and 8 (one decode loop in the port, a CUDA
   graph replayed 31 times a call; the argument changes nothing):
   exactly 12 flash forward launches a call (the eager prefill, one a
   layer, unsplit), no combine, no other kernel; the two calls' tokens
   identical, and equal to the eager loop's (``_capture=False``), greedy
   and sampled; one graph a loop entry, 122 replays; each row against
   the paged engine's tokens for its prompt, and two rows replayed
   through the port on the CPU, under the margin rule;
7b. path ``serve_slot``: phase 6's stream through ``ServingEngine(
   paged=False)``, horizon 8: 8/8 complete; greedy requests equal phase
   6's tokens under the margin rule; flash forward and its combine
   launched (the chunks' dense-mask split route), paged decode never;
   metrics beside phase 6's;
7c. path ``serve_mono``: the same through the monolithic engine
   (``chunked=False``): the same checks, the combine showing the causal
   split route of the B 1 prefills;
7d. path ``serve_slot_int8``: the stream on the int8 slot layout: no
   flash and no paged decode launch; a fresh engine replays every
   request; the cache holds exactly (d_head + 2) / (2 d_head) of a
   bf16-storage slot cache's bytes;
7e. path ``serve_bf16``: phase 6's stream on the paged engine under
   ``precision="bfloat16"`` (the same seeded masters): 8/8 complete,
   bf16 pools holding exactly half of phase 6's KV bytes, the flash
   forward, its combine and paged decode launched on 16-bit operands
   only (the ``*_lowp`` counters), the prefix pair against the port in
   bf16 on the CPU under the margin rule (16-bit limit:
   ``LOWP_MARGIN_ULPS`` units of the top logit; a tie is within it);
7f. path ``generate_bf16``: phase 7a's batch under bf16: exactly 12 flash
   launches on bf16 operands a call and nothing else; rows against the
   bf16 paged engine and the CPU, under the margin rule; the rows'
   logits against the CPU's on the same tokens, within
   ``LOWP_LOGIT_ULPS`` units of the top logit; two controls with a
   planted fault in the prefill attention (P rounded to bf16, each
   query's own key dropped) print their readings, and the logit check
   must fail the dropped key;
7g. path ``preempt``: preemption with restore and cancel on the chunked
   engine at GPT-2-small widths (phase 6's weights and prompts 0, 2 and
   4, 32 new tokens each), captured, five cases: page pressure on
   float32 pages, slot scarcity on slots, page pressure on int8 pages,
   page pressure with every request sampled, and a live slot cancelled
   and taken by the next request.  Each against the same requests on a
   roomy engine that never preempts: sampled tokens identical, greedy
   ones under the margin rule, the victim against the port on the CPU;
   one preemption, one restore and one kill upload a case; no graph key
   beyond the uninterrupted run's; no upload after the last
   re-admission; the flash forward and paged decode (its int8 variant
   on int8 pages) launched from the restore's start on; the cancelled
   slot inactive on the card after the next step and silent.  The
   preempting step's and the restore's wall ms print on each case's
   line;
7h. path ``admission``: admission control on the chunked engine at
   GPT-2-small widths (phase 6's weights and prompts, 32 new tokens
   each), captured, each case on a fresh engine beside the same requests
   on an uninterrupted engine, a clock the phase moves injected: a
   deadline while decoding on float32 pages (a pool the evicted
   request's pages complete for the next owner) and on slots, the
   request evicted ``EVICTED_DEADLINE`` through one kill upload and its
   slot and pages taken by the next request; a deadline while queued
   and one in prefill; ``max_queue=2`` shedding (one refusal, one shed,
   both ``REJECTED`` without a token); the step-budget watchdog (a clock
   that moves 10 ms a read: a five-chunk admission ``FAILED`` at its
   fourth strike); evacuate and adopt on float32 and int8 pages (every
   adopted request restored, ``PREEMPTED_RESTORED``); deadlines armed
   but far on phase 6's stream (the same tokens, horizons, steps and
   captures as without; the ITL p50 of both).  Greedy tokens under the
   margin rule against the uninterrupted run, statuses and causes the
   reference's, no graph key beyond the uninterrupted run's, no upload
   after the last admission, the flash forward, its combine and paged
   decode (int8 on int8 pages) launched by the adopter's restores.  The
   evicting step's, evacuate's and adopt-to-commit wall ms and the
   restores' prefix-index tokens print on each case's line;
7i. path ``telemetry``: the request spans and fault injection on the
   chunked engine at GPT-2-small widths (phase 6's weights and prompts),
   captured: phase 6's stream on one warm engine untraced and traced
   (``attach_tracer(SpanTracer())``), with the same
   tokens, graph keys, captures, uploads and syncs, every request's
   whole lifecycle in the trace, the trace's Chrome JSON read back, and
   the tracer's host cost a steady step (the median step's wall ms
   traced less untraced, and the time inside the tracer's calls); then,
   each on a fresh traced engine beside the same requests on an
   uninterrupted untraced one, with the clock the phase moves injected:
   ``NaNLogits`` delivered by a horizon block on float32 pages whose
   pool the next request needs (the victim ``FAILED`` with the injected
   cause through one kill upload, the ``fault`` instant on its lane and
   in its postmortem, the next owner in its slot and pages),
   ``ExhaustAllocator`` (three refused attempts, then served),
   ``LatencySpike`` under ``step_budget_ms`` (the admission in flight
   ``FAILED`` at its fourth strike) and ``DropCallback`` (the consumer
   misses one token, the engine's record is whole).  Greedy tokens
   under the margin rule against the uninterrupted run, no graph key
   beyond its, no upload after the last admission but the kill, the
   flash forward, its combine, paged decode and its merge launched;
8. the training path: ``GPTConfig.small(use_flash=True)`` trains 5 steps
   of ``train_one_batch`` with Adam at B 8, T 1024, first eagerly
   (``use_graph=False``), then captured as a CUDA graph
   (``use_graph=True``: step 1 eager, step 2 captures and replays, steps
   3-5 replay) from the same weights and batches (loss, steady step
   time over steps 3-5, tokens/s, peak memory of each; the loss must
   fall; exactly 12 launches of each flash kernel a step, none of the
   combine, the captured run's credited counts equal to the eager
   run's; the two runs' losses and every parameter and Adam moment
   bit for bit; 1 capture and 4 replays; three more replays under
   ``torch.profiler``, the middle one of which runs ``flash_fwd_mma``,
   ``flash_bwd_dq_mma`` and ``flash_bwd_dkv_mma`` as many times each as
   it is credited with, 12; the state is restored after them);
8a. the rest of the Model API there: the checkpoint saved after step 2
   (``save_states``, the zip of npz members) loads into a fresh captured
   model, whose steps 3-5 equal the uninterrupted run's bit for bit,
   taken under an installed ``SpanTracer``: one ``dispatch`` span a
   step and one ``trace_compile`` for the signature, from within step
   3's (the eager warm-up) to within step 4's (the capture), no capture
   beyond the one; ``run_k_steps(4)`` (four replays) equals four ``train_one_batch``
   calls from the same state, restored in place; the captured
   ``predict`` equals its eager first call bit for bit;
9. one full-width training step (B 1, T 128) from the trained weights on
   the card and in the port on the CPU: loss and every gradient compared;
10. the trained model serves 2 requests through the ``ServingEngine``;
8b, 8c. paths ``train_bf16`` and ``train_fp16``: phase 8 (eager twin,
   then captured, held together the same way) under
   ``precision="bfloat16"`` / ``"float16"`` from the same weights and
   batches: the loss falls and ends within 2 % of phase 8's; 12 launches
   of each flash kernel a step, all on 16-bit operands; every parameter
   and optimizer state float32 after the steps; step time and peak
   memory beside float32's; the profiled replay's flash kernels against
   its credited launches, as in phase 8; bf16: the captured ``predict`` against its
   eager first call; fp16 then replays one step with its loss scale
   forced to 2^40: nothing moves and the scale halves;
11. path ``rnn_train``: the char-LSTM of ``bench_rnn.py`` (V 86, H 256,
   T 100, B 64, ``LSTM(use_fused_cell=True)``, SGD 0.1 with momentum
   0.9) takes 10 steps on a seeded batch eagerly and captured from the
   same weights (held together as in phase 8: bit for bit, 1 capture
   and 9 replays, a profiled replay runs ``lstm_cell_kernel`` 200 times,
   the forward's and the backward's credited launches), then captured
   through the plain cell from the same weights (step time, tokens/s,
   loss, peak memory of each; the loss must fall; exactly 100 launches
   of each cell kernel, forward and backward, a fused step, none on the
   plain path; fused and plain losses agree);
12. one full-width fused char-LSTM step on the card and in the port on
   the CPU: loss and every gradient compared;
13. path ``rnn_sample``: the port's char-RNN example with the fused cell
   trains 2 epochs of truncated BPTT (B 16, T 64, Adam 3e-3) on its
   synthetic corpus and samples 120 characters (one forward launch
   each, no backward one); the
   epoch loss must fall and the characters must equal the port's on the
   CPU from the same weights and generator;
15. path ``mlp_train``: ``examples/mlp.py``'s MLP (784-128-128-10, SGD
   0.05 with momentum 0.9) on its synthetic MNIST, B 256, 20 steps,
   captured beside its eager twin from the same seeded weights: every
   loss and state bit for bit, 1 capture and 19 replays, the loss falls;
   phases 15-19 run with cuDNN's deterministic algorithms picked without
   benchmarking (TF32 off as in phase 1);
16. path ``cnn_train``: the zoo's MNIST CNN on ``train_cnn.py``'s
   synthetic MNIST, B 64, 10 steps, captured against eager the same
   way; its first step's logits and loss on the card against the port on
   the CPU from the same states (``CNN_CPU_TOL``);
17. path ``resnet50_train``: ResNet-50 at full width (224x224, 1000
   classes) on ``train_cnn.py``'s synthetic imagenet, B 32, its SGD (lr
   0.005, momentum 0.9, weight decay 1e-5), 5 steps, captured against
   eager bit for bit (parameters, momenta and the BatchNorm buffers);
   steady step, images/s, peak memory and, over two more profiled steps
   of each, the idle share;
18. path ``resnet50_bf16``: the same under ``precision="bfloat16"``; the
   loss at step 5 within 2 % of float32's; the first step's logits
   against float32's from the same weights and batch, within
   ``R50_BF16_LOGIT_FACTOR`` times float32's own change when only its
   input is rounded to bf16 (constant logits must fail that bound);
19. path ``zoo``: alexnet, vgg16, mobilenet, xception (299) and
   resnet18, B 4 at each input size, 1000 classes, seeded inputs: 3
   steps captured against eager bit for bit (AlexNet's and VGG's
   dropout masks from the card's generator, registered with the graph),
   then ``predict`` in eval mode captured against its eager first call.
   No kernel of the port lies on paths 15-19: every counter must read 0
   there;
20. path ``resnet50_dist``: path 17's ResNet-50, weights and batches under
   ``DistOpt`` in a world-1 NCCL group (``init_distributed`` at a free
   local port; NCCL refuses two ranks on one card, see
   ``--nccl-two-ranks``), ``dist_option`` ``plain`` and ``sharded``
   (ZeRO-1, the plain per-grad path at world 1): each captured against
   its eager twin bit for bit, then every loss and state against path
   17's run bit for bit (a mean over one rank is exact); steady step,
   images/s, peak memory, idle share, the collectives of one more step,
   and the host time of the emission-order walk that DistOpt's backward
   makes on every eager step;
21. path ``dist_options``: path 16's MNIST CNN, weights and batches in the
   same group through ``fp16`` (the bf16 all-reduce), ``partial``,
   ``sparse`` (the zoo's options), the sparse ``indices`` encoding and
   gradient accumulation (two step signatures, two captures): each
   captured against its eager twin bit for bit; ``partial`` against
   path 16's run bit for bit, the two sparse encodings against each
   other, ``fp16``'s step-5 loss within 2 % of path 16's.  No kernel of
   the port lies on paths 20-21: every counter must read 0 there;
22. path ``dist_scripts``: ``train_multiprocess -w 1`` and ``train_cnn
   --zero1 1`` as scripts (one NCCL rank each, 2 epochs of synthetic
   MNIST at B 64): exit 0 and a falling epoch loss;
23. path ``tensor_surface``: every function of ``tensor.py`` (every name
   of its ``__all__``) and the Tensor methods and operators on CUDA
   tensors against the same calls on CPU tensors, over float32, int32
   and bool operands: float32 within ``SURFACE_TOL``, integers and bools
   exactly, each result on its input's device, an exception where the
   CPU raises; the in-place methods keep ``data_ptr()``; the random
   fills' range, moments and seeding on the card;
24. path ``profiling``: ``train_cnn.py resnet50 -d imagenet -b 32 -v 1``
   and ``-v 2``, captured and eager, in this process: the step-time line
   and flop table of ``Device.PrintTimeProfiling``, agreeing with the
   device's records, the ``-v 1`` median step within ``PROF_STEP_REL``
   (10 %) of a reference on the same path (captured: path 17's steady
   step; eager: an eager ResNet-50 run timed just before, on the same
   batches with the same Sync each step), a ``torch.profiler`` trace
   with the card's kernels at ``-v 2``; ``DeviceMemPool`` against
   ``torch.cuda``, ``Platform`` against ``nvidia-smi``, ``Sync`` against
   a queued spin; ``Model.on_device`` to the CPU and back between two
   captured MNIST CNN steps, bit for bit with the uninterrupted run (2
   captures against 1); ``Device.set_rng_state`` between replays of a
   captured step with dropout, giving the eager step's mask.  No kernel
   of the port lies on paths 23-24: every counter must read 0 there;
25. path ``resilience``: ResNet-50 B 32 at full width, captured, on path
   17's batches (step s takes batch s mod 5), through
   ``singa_tpu_torch.resilience``: 8 steps through ``ResilientTrainer``
   with a snapshot ``CheckpointManager`` saving every 2 steps, the
   losses and every state bit for bit with a plain run's, every
   published file through its CRC and the newest through
   ``Model.load_states``, the save's copy (``checkpoint_snapshot``) and
   write (``checkpoint_write``) ms and its bytes; a NaN batch at step 5
   under ``rollback``: one rollback to step 4 in place, no new capture,
   the replayed steps and final states bit for bit with the plain run;
   a NaN batch at step 3 under ``skip``: every parameter and momentum
   bit-identical across it, no new capture (BatchNorm's running buffers
   take the NaN batch, as the reference's); the rollback's reseed on a
   captured dropout MLP (the replayed step draws another mask, two runs
   and the eager twin bit for bit); ``DataLoader(to_device=)``
   batches against the host's; the SIGKILL drill: ``train_cnn.py
   resnet50 -d imagenet -b 32 --ckpt-every 3`` in processes of its own
   (cuDNN deterministic, TF32 off, set before ``main``), killed at step
   5 and inside the 2nd save (snapshot, staged), both resumed, every
   step's loss bit for bit with the uninterrupted run's; then, alone on
   the card, the median step with and without a save in flight,
   captured and eager.  No kernel of the port lies on path 25: every
   counter must read 0 there;
3c. (with 3b) flash on mixed operands: bf16 queries over float32 keys and
   values (the float chunk under a bf16 policy over float32 cache rows)
   at the serving shape: one float32 launch, o in bf16 within one unit
   of its plain version;
14. one line comparing each captured serving path with its eager twin
   (tokens/s, TTFT p50, ITL p50 and p99, peak memory, captures and
   replays), one comparing each captured training path with its eager
   twin (steady step, tokens/s, peak memory, replays; the predict
   errors), one for paths 15-19 (steady step, rate, peak memory,
   replays, idle share, the CPU and float32 comparisons, each beside its
   eager twin), one for paths 20-22 (the same, the collectives a step,
   the NCCL version, the scripts' epoch losses), one for paths 23-24,
   one for path 25, one ``kernels`` JSON line, then the result line.

The kernels' launch counters are zeroed just before each path (5b, 6,
7, 7a-7i, 8, 8b, 8c, 11, 13, 15-19, 20-21 and 23-25; each case of 7g,
7h and 7i) and read just after it; a kernel's
``launches`` is the sum over them, ``launches_by_path`` splits it.  On
a captured path a replay adds the launches its capture recorded (the
capture itself launches nothing), so the counts are the kernels the
card ran; the eager twins' runs are not in the sums.  The
``*_lowp`` rows count the launches on 16-bit operands (also counted in
the row without the suffix) and carry the bf16 figures (fp16's and the
other paged combinations under ``by_dtype`` / ``by_combination``).

    python3 chip_smoke.py --profile [serve[_eager]|serve_int8|
                                     serve_slot[_eager]|generate[_eager]|
                                     train[_eager]|train_bf16[_eager]|
                                     train_fp16[_eager]|rnn_train[_eager]|
                                     rnn_train_plain|resnet50[_eager]]

runs phases 1-2 and then the serving stream (float or int8 pages, or
float slots; on an engine whose graphs the same stream with other token
values captured first; with ``_eager`` the eager twin), one
``GPT.generate`` call of path 7a (captured, or the eager loop), or two training
steps (GPT in float32 or under the bf16 or fp16 policy, the fused
char-LSTM or the char-LSTM through the plain cell, or path 17's
ResNet-50 under ``train_cnn.py``'s cuDNN settings: not deterministic,
no benchmarking; captured, or with ``_eager`` the eager twin) after two
warm-up steps (on the captured
path: the eager first step and the capture), once under ``torch.profiler`` (CPU and CUDA activity),
and prints the device's busy and idle share over the run, device time by
kernel group and the costliest kernels.

    python3 chip_smoke.py --preempt | --admission | --telemetry

runs phases 1-2 and then path 7g, 7h or 7i alone.

    python3 chip_smoke.py --nccl-two-ranks

runs phase 1 and then two ranks over NCCL through ``parallel.launch``
(rank r on card r modulo the card count), one all-reduce, and prints its
result or the group's error.

    python3 chip_smoke.py --compare-serve [layouts|precision|graphs]

runs phases 1-2 and then the paged engine captured and its eager twin
alternately, four runs of each (with ``layouts``: the paged, slot and
monolithic engines, three runs of each; with ``precision``: the float32
and the bf16 paged engines, four each; with ``graphs``: the paged,
int8, slot, monolithic and bf16 engines, each captured and eager, three
runs of each), each kind on one engine whose graphs a first stream
captured, and prints each run's tokens/s, TTFT p50, ITL p50 and p99 and
wall time and their spread.

Kernel times are the median of single launches timed with CUDA events,
each after a 64 MiB write that evicts the 50 MB L2, so operands come
from device memory as on the main paths, and behind a ~1 ms device spin,
so the events bracket the call's device work and not the time the host
takes to issue it.  ``bound_ms`` is the larger of
bytes moved (each input read once, each output written once) over
3.35 TB/s and float32 operations over 495 / 3 = 165 TFLOP/s, the
3xTF32 tensor-core rate (three TF32 products at 495 TFLOP/s a float32
product; H100 SXM data sheet).  The flash rows also print the bound at
the SIMT float32 rate of 67 TFLOP/s, the bound of PR 6 and before.  The
16-bit rows count 2 bytes an element of q, k, v, dO and the outputs, and
their operations as the TF32 products the card needs for them at 495
TFLOP/s: a 16-bit value is exact in TF32, so a product of two 16-bit
operands (QK^T, dO V^T) is one TF32 product and a product of a 16-bit
operand with float32 P or dS (P V, dS K, dS^T Q, P^T dO) is two.  That
is 6 d TF32 operations a (query, key) pair for the forward, 8 d for dq
and 12 d for dk/dv, against 12 d, 18 d and 24 d at 3xTF32; the 3xTF32
bound of the same rows prints beside it.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from singa_tpu_torch import autograd as tautograd  # noqa: E402
from singa_tpu_torch import device as tdevice  # noqa: E402
from singa_tpu_torch import layer as tlayer  # noqa: E402
from singa_tpu_torch import model as tmodel  # noqa: E402
from singa_tpu_torch import opt as topt  # noqa: E402
from singa_tpu_torch.examples import char_rnn  # noqa: E402
from singa_tpu_torch.examples import mlp  # noqa: E402
from singa_tpu_torch.examples.cnn import train_cnn as cnn_train  # noqa: E402
from singa_tpu_torch import parallel as tparallel  # noqa: E402
from singa_tpu_torch.examples.cnn.model import (  # noqa: E402
    cnn as cnn_model)
from singa_tpu_torch.examples.cnn.data import (  # noqa: E402
    synthetic as cnn_synthetic)
from singa_tpu_torch.models import gpt as tgpt  # noqa: E402
from singa_tpu_torch.ops import _build  # noqa: E402
from singa_tpu_torch.ops import elementwise as ew  # noqa: E402
from singa_tpu_torch.ops import flash_attention as fa  # noqa: E402
from singa_tpu_torch.ops import lstm_cell as lc  # noqa: E402
from singa_tpu_torch.ops import paged_attention as pa  # noqa: E402
from singa_tpu_torch.serving import ServingEngine  # noqa: E402
from singa_tpu_torch.serving import (  # noqa: E402
    DropCallback, ExhaustAllocator, FaultPlan, LatencySpike, NaNLogits)
from singa_tpu_torch.telemetry import (  # noqa: E402
    PID_HOST, PID_REQUESTS, SpanTracer)
from singa_tpu_torch.telemetry import tracer as ttracer  # noqa: E402
from singa_tpu_torch.serving.engine import _to_device  # noqa: E402
from singa_tpu_torch import tensor as ttensor  # noqa: E402
from singa_tpu_torch.tensor import Tensor as TTensor  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
# float32 products: on the tensor cores as 3xTF32 (three TF32 products at
# 495 TFLOP/s each), the bound of every row; the SIMT float32 rate, PR 6's
# bound, is printed beside it
TF32_FLOP_PER_S = 495e12
FP32_TC_FLOP_PER_S = TF32_FLOP_PER_S / 3
# TF32 operations a (query, key) pair, in units of d, of the flash
# kernels on 16-bit operands: one TF32 product for a product of two
# 16-bit operands, two where P or dS (float32) is one operand
LOWP_TF32_PAIR = {"fwd": 2 + 2 * 2, "dq": 2 + 2 + 2 * 2,
                  "dkv": 2 + 2 + 2 * 2 + 2 * 2}
FP32_FLOP_PER_S = 67e12
# n_sm that makes the forward's plan split wherever a head has 2+ key tiles
SPLIT_SM = 1 << 20
FLASH_TOL = 1e-4
PAGED_TOL = 1e-4
MARGIN_TOL = 1e-3
# the margin a first difference may have when the logits are 16-bit, in
# units in the last place of the top logit: both sides round every op to
# 16 bits, the card in cuBLAS's and the kernels' summation order, the CPU
# in its own, so near-ties flip.  The card's bf16 logits differ from the
# CPU's by up to 4 such units on the same tokens (the logit check's
# reading on an H100), so the difference of two logits moves by up to 8
# and a flip at a margin under 8 is within rounding.  A tie (margin 0)
# is always within it: both sides take the first index of the largest
# logit, and which index that is depends on the last bit.  The rule has
# little power on these flat random-weight logits (a planted fault's
# first differences land at 1-2 units); the logit check has it
LOWP_MARGIN_ULPS = 8
# the largest difference the card's bf16 logits may have from the CPU's
# on the same tokens, in units in the last place of each position's top
# logit: sound runs read 4 on an H100, prefill attention with each
# query's own key dropped reads 91
LOWP_LOGIT_ULPS = 16
REPS = 30
# the reference's committed drift tolerances for int8 serving
# (tests/test_quantized_serving.py), over a DRIFT_T-token prompt
LOGIT_MAE_TOL, LOGIT_MAX_TOL, LOG_PPL_TOL = 0.05, 0.25, 0.02
DRIFT_T = 256

# serving configuration of phase 5 (GPT-2-small widths, 12 layers)
N_SLOTS, PAGE, CHUNK, HORIZON, NEW = 8, 16, 64, 8, 32
# the generate path: rows of phase 6's prompts cut to GEN_T tokens
GEN_B, GEN_T = 4, 200
# training configuration (GPT-2-small, fp32, Adam)
TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_LR = 8, 1024, 5, 3e-4


def _log(msg):
    print(msg, flush=True)


def _bound(nbytes, flops, flop_rate=FP32_TC_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_FLUSH = None
# device cycles of the spin queued after the flush (about 1 ms): the host
# enqueues the timed call behind it, so the events bracket device work
# and not the host's Python
BACKLOG_CYCLES = 2_000_000


def _time_ms(fn, reps=REPS):
    """Median single-launch time of ``fn`` in ms, L2 evicted before
    each launch, the call enqueued behind a spin so that its host time
    is not counted."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        torch.cuda._sleep(BACKLOG_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def phase_card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    card = r.stdout.strip().splitlines()[0]
    _log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # 16-bit products accumulate in float32 as the reference's do (cuBLAS
    # may otherwise reduce in 16 bits)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    _log(f"bounds: bytes at {HBM_BYTES_PER_S / 1e12:g} TB/s; float32 "
         f"operations at the 3xTF32 tensor-core rate "
         f"{FP32_TC_FLOP_PER_S / 1e12:g} TFLOP/s (PR 6 and before: the SIMT "
         f"float32 rate {FP32_FLOP_PER_S / 1e12:g} TFLOP/s)")
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)}")
    return card


def _ptxas_kernels(report):
    """``[(kernel, registers, spill store bytes, spill load bytes)]`` from
    a ``ptxas -v`` log, the kernel's name cut from its mangled form."""
    out, name, spills = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            # _ZN<len><anonymous namespace><len><name>I<template args>E...
            a = re.match(r"_ZN(\d+)", name)
            if a:
                rest = name[a.end() + int(a.group(1)):]
                b = re.match(r"(\d+)", rest)
                if b:
                    n = int(b.group(1))
                    name = rest[b.end():b.end() + n] + re.sub(
                        r"Ev.*", "", rest[b.end() + n:])[:40]
            spills = (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1))) + spills)
            name = None
    return out


def phase_build():
    t0 = time.perf_counter()
    built = _build.build()
    _log(f"build: {time.perf_counter() - t0:.2f}s wall, per library "
         + json.dumps({k: round(v, 2) for k, v in built.items()}))
    for name in _build.SOURCES:
        kernels = _ptxas_kernels(_build.ptxas_report(name))
        _log(f"ptxas {name}: " + " | ".join(
            f"{k} {r} regs, spill {st}/{ld} B" for k, r, st, ld in kernels))
        if name.startswith("flash"):
            d64 = [(k, st + ld) for k, _, st, ld in kernels if "ILi64E" in k]
            _log(f"ptxas {name} D 64 instantiations: "
                 + ", ".join(f"{k} {b} B spilled" for k, b in d64))


def _sdpa(*args, **kw):
    """``scaled_dot_product_attention`` pinned to its memory-efficient
    backend, the one float32 runs through (a yardstick the port never
    calls)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return torch.nn.functional.scaled_dot_product_attention(*args, **kw)


SDPA_NAME = "scaled_dot_product_attention (EFFICIENT_ATTENTION backend)"


def _fwd_route(q3, k3, v3, m3, scale, mode, causal, n_sm):
    """The forward kernel on the route that a card of ``n_sm`` SMs
    takes (``None``: this card, through the public wrapper)."""
    if n_sm is None:
        return fa.flash_attention_fwd(q3, k3, v3, m3, scale, mode, causal)
    BH, T, _ = q3.shape
    S = k3.shape[1]
    plan = fa._fwd_split_plan(BH, T, S, causal, n_sm)
    if plan.n_split > 1:
        return fa._fwd_split(q3, k3, v3, m3, scale, mode, causal, plan)
    _, mask_bh = fa._kernel_operands("flash_attention", q3, k3, v3, m3, mode)
    return fa._fwd_unsplit(q3, k3, v3, m3, scale, mode, mask_bh, causal,
                           plan)


def _fwd_case(q, k, v, mask, causal, n_sm):
    """Forward kernel (route chosen by ``n_sm``) against its plain
    version: ``(max abs error over o and lse, route)``."""
    q3, k3, v3, m3, scale, mode = fa._prepare(q, k, v, mask, None)
    q3, k3, v3 = q3.contiguous(), k3.contiguous(), v3.contiguous()
    before = fa.launches_combine
    o, lse = _fwd_route(q3, k3, v3, m3, scale, mode, causal, n_sm)
    route = "split" if fa.launches_combine > before else "unsplit"
    ro, rlse = fa.flash_attention_fwd_reference(q3, k3, v3, m3, scale, mode,
                                                causal)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())):
        return float("inf"), route
    return max(float((o - ro).abs().max()),
               float((lse - rlse).abs().max())), route


def phase_flash():
    """The forward kernel against its plain version on both routes, the
    combine kernel against its plain version, and times at the serving
    shape.  Returns the ``(forward, combine)`` rows for the kernels line
    (numbers at the serving shape)."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    H, d, C, L = 12, 64, 64, 1024
    scale = 1.0 / np.sqrt(d)
    # serving shape: a 64-token chunk at positions 512..575 of a
    # 1024-column page row, the (C, L) mask col <= position
    q, k, v = rnd(1, H, C, d), rnd(1, H, L, d), rnd(1, H, L, d)
    positions = 512 + torch.arange(C, device="cuda")
    cols = torch.arange(L, device="cuda")
    mask = torch.where(cols[None] <= positions[:, None], 0.0, -1e9)
    mask = mask[None, None].contiguous()
    # (q, k, v, mask, causal, routes): None takes the card's plan, 1 forces
    # the unsplit route, SPLIT_SM the split one where there are 2+ key tiles
    cases = {"dense(serving)": (q, k, v, mask, False, (None, 1))}
    cases["causal B1 H2 T1024"] = (rnd(1, 2, 1024, d), rnd(1, 2, 1024, d),
                                   rnd(1, 2, 1024, d), None, True, (None, 1))
    qc, kc, vc = rnd(1, H, 512, d), rnd(1, H, 512, d), rnd(1, H, 512, d)
    cases["causal"] = (qc, kc, vc, None, True, (1, SPLIT_SM))
    vec = torch.zeros(1, 1, 1, L, device="cuda")
    vec[..., 900:] = -1e9
    cases["vec"] = (q, k, v, vec, False, (1, SPLIT_SM))
    # every head dim the kernel is built for, at ragged T/S (the
    # reference's closed-form key padding), with per-head masks and a
    # fully masked row, on both routes
    for dd, (B, Hh, T, S), causal in ((16, (2, 3, 70, 200), False),
                                      (32, (2, 2, 33, 77), False),
                                      (64, (1, 2, 130, 260), True),
                                      (128, (1, 2, 150, 150), True)):
        m = torch.where(torch.rand(B, Hh, T, S, generator=g, device="cuda")
                        < 0.2, -1e9, 0.0)
        m[-1, -1, T // 2] = -1e9
        cases[f"ragged d{dd} per-head"] = (
            rnd(B, Hh, T, dd), rnd(B, Hh, S, dd), rnd(B, Hh, S, dd), m,
            causal, (1, SPLIT_SM))
    vb = torch.zeros(2, 1, 1, 77, device="cuda")
    vb[1, ..., 60:] = -1e9
    cases["ragged d32 per-batch vec"] = (
        rnd(2, 2, 33, 32), rnd(2, 2, 77, 32), rnd(2, 2, 77, 32), vb, False,
        (1, SPLIT_SM))
    err_serving = None
    for name, (a, b, c, m, causal, routes) in cases.items():
        for n_sm in routes:
            err, route = _fwd_case(a, b, c, m, causal, n_sm)
            ok = err <= FLASH_TOL
            _log(f"flash {name} [{route}]: max_abs_err {err:.3e} (o and lse, "
                 f"tol {FLASH_TOL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash {name} ({route}) disagrees with "
                                     f"its plain version: {err}")
            if name == "dense(serving)" and n_sm is None:
                if route != "split":
                    raise AssertionError("the serving shape did not split")
                err_serving = err
    # the combine kernel alone, on the serving shape's partials
    q3, k3, v3, m3, _, mode = fa._prepare(q, k, v, mask, scale)
    plan = fa._fwd_split_plan(H, C, L, False, fa._sm_count(0))
    parts = fa.flash_attention_fwd_partial(q3, k3, v3, m3, scale, mode,
                                           False, plan)
    co, clse = fa.flash_attention_fwd_combine(*parts, C, L, False, plan.per)
    ro, rlse = fa.flash_attention_fwd_combine_reference(*parts, C, L, False,
                                                        plan.per)
    torch.cuda.synchronize()
    err_combine = max(float((co - ro).abs().max()),
                      float((clse - rlse).abs().max()))
    _log(f"flash combine (serving shape, {plan.n_split} ranges of "
         f"{plan.per} key tile(s)): max_abs_err {err_combine:.3e} (tol "
         f"{FLASH_TOL:g})")
    if not err_combine <= FLASH_TOL:
        raise AssertionError(f"flash combine disagrees with its plain "
                             f"version: {err_combine}")
    ms = _time_ms(lambda: fa.flash_attention(q, k, v, mask, sm_scale=scale))
    unsplit_ms = _time_ms(lambda: _fwd_route(q3, k3, v3, m3, scale, mode,
                                             False, 1))
    partial_ms = _time_ms(lambda: fa.flash_attention_fwd_partial(
        q3, k3, v3, m3, scale, mode, False, plan))
    combine_ms = _time_ms(lambda: fa.flash_attention_fwd_combine(
        *parts, C, L, False, plan.per))
    combine_plain = _time_ms(lambda: fa.flash_attention_fwd_combine_reference(
        *parts, C, L, False, plan.per))
    plain_ms = _time_ms(lambda: fa.flash_attention_reference(
        q, k, v, mask, sm_scale=scale))
    lib_ms = _time_ms(lambda: _sdpa(q, k, v, attn_mask=mask, scale=scale))
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + mask.numel()
                  + q.numel() + H * C)          # q,k,v,mask in; o,lse out
    flops = 4 * H * C * L * d                   # two products, 2 flop/FMA
    bound_ms, bound_by = _bound(nbytes, flops)
    _log(f"flash serving shape (split route, {plan.n_split} ranges, "
         f"{plan.n_split * H} blocks): kernel {ms:.4f} ms (partial "
         f"{partial_ms:.4f} + combine {combine_ms:.4f}), unsplit route "
         f"{unsplit_ms:.4f} ms ({H} blocks), plain {plain_ms:.4f} ms, "
         f"{SDPA_NAME} {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
         f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP; SIMT bound "
         f"{_bound(nbytes, flops, FP32_FLOP_PER_S)[0]:.4f} ms)")
    c_bytes = 4 * sum(t.numel() for t in parts) + 4 * (q.numel() + H * C)
    c_bound, c_by = _bound(c_bytes, 3 * parts[0].numel())
    _log(f"flash combine serving shape: kernel {combine_ms:.4f} ms, plain "
         f"{combine_plain:.4f} ms, bound {c_bound:.6f} ms ({c_by}: "
         f"{c_bytes / 1e6:.2f} MB)")
    fwd = {"name": "flash_attention_fwd", "route": "cuda",
           "source": "singa_tpu_torch/ops/csrc/flash_attention_fwd.cu",
           "replaces": "singa_tpu/ops/pallas_kernels.py:102",
           "max_abs_err": err_serving, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
           "serving_split": {"n_split": plan.n_split, "per": plan.per,
                             "partial_ms": partial_ms,
                             "unsplit_route_ms": unsplit_ms},
           "causal_serving": _flash_causal_serving(rnd)}
    combine = {"name": "flash_attention_fwd_combine", "route": "cuda",
               "source": "singa_tpu_torch/ops/csrc/flash_attention_fwd.cu",
               "replaces": "singa_tpu/ops/pallas_kernels.py:254",
               "max_abs_err": err_combine, "ms": combine_ms,
               "plain_ms": combine_plain, "bound_ms": c_bound,
               "bound_by": c_by, "library_ms": None}
    return fwd, combine


# the causal prefill shapes of the serving paths: GPT.generate at B 4 with
# a 256-token bucket, and the monolithic engine's per-request prefill at
# B 1 with its 128/256/512-token buckets
CAUSAL_SERVING = ((4, 256), (1, 128), (1, 256), (1, 512))


def _flash_causal_serving(rnd):
    """The forward kernel on the card's plan against its plain version at
    the causal serving shapes (H 12, d 64): the route the plan takes
    (unsplit at B 4, the key split at B 1, where the early query tiles'
    later ranges are empty), the split route's combine alone against its
    plain version, and times beside the bound and the pinned
    ``scaled_dot_product_attention`` with ``is_causal``."""
    H, d = 12, 64
    scale = 1.0 / np.sqrt(d)
    n_sm = fa._sm_count(0)
    out = {}
    for B, T in CAUSAL_SERVING:
        q, k, v = rnd(B, H, T, d), rnd(B, H, T, d), rnd(B, H, T, d)
        err, route = _fwd_case(q, k, v, None, True, None)
        plan = fa._fwd_split_plan(B * H, T, T, True, n_sm)
        want = "split" if plan.n_split > 1 else "unsplit"
        name = f"B{B} H{H} T{T} causal"
        _log(f"flash {name} [{route}, plan {tuple(plan)}, "
             f"{B * H * -(-T // 64) * plan.n_split} blocks]: max_abs_err "
             f"{err:.3e} (o and lse, tol {FLASH_TOL:g})")
        if not err <= FLASH_TOL or route != want:
            raise AssertionError(f"flash {name}: error {err}, route {route} "
                                 f"(plan {tuple(plan)})")
        row = {"route": route, "n_split": plan.n_split, "per": plan.per,
               "max_abs_err": err}
        if plan.n_split > 1:
            q3, k3, v3 = (t.reshape(B * H, T, d) for t in (q, k, v))
            parts = fa.flash_attention_fwd_partial(q3, k3, v3, None, scale,
                                                   "none", True, plan)
            co, clse = fa.flash_attention_fwd_combine(*parts, T, T, True,
                                                      plan.per)
            ro, rlse = fa.flash_attention_fwd_combine_reference(
                *parts, T, T, True, plan.per)
            torch.cuda.synchronize()
            row["combine_err"] = max(float((co - ro).abs().max()),
                                     float((clse - rlse).abs().max()))
            empty = sum(len(rs) < plan.n_split
                        for rs in fa._split_ranges(plan, T, T, True))
            _log(f"flash {name} combine alone: max_abs_err "
                 f"{row['combine_err']:.3e} ({empty} of {-(-T // 64)} query "
                 f"tiles with empty ranges)")
            if not row["combine_err"] <= FLASH_TOL:
                raise AssertionError(f"flash {name} combine disagrees: "
                                     f"{row['combine_err']}")
        row["ms"] = _time_ms(lambda: fa.flash_attention(
            q, k, v, sm_scale=scale, causal=True))
        row["plain_ms"] = _time_ms(lambda: fa.flash_attention_reference(
            q, k, v, sm_scale=scale, causal=True))
        row["library_ms"] = _time_ms(lambda: _sdpa(q, k, v, is_causal=True,
                                                   scale=scale))
        nbytes = 4 * (4 * q.numel() + B * H * T)      # q,k,v in; o,lse out
        flops = 4 * _needed_pairs(B * H, T, T, True) * d
        row["bound_ms"], row["bound_by"] = _bound(nbytes, flops)
        _log(f"flash {name}: kernel {row['ms']:.4f} ms, plain "
             f"{row['plain_ms']:.4f} ms, {SDPA_NAME} causal "
             f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
             f"({row['bound_by']}: {nbytes / 1e6:.2f} MB, "
             f"{flops / 1e9:.3f} GFLOP)")
        out[f"B{B} T{T}"] = row
    return out


def _needed_pairs(BH, T, S, causal):
    """(query, key) pairs the function needs when no row is fully
    masked: all, or with ``causal`` row r's first min(S, r + 1) columns.
    The rest of the reference's diagonal 128-block is a tiling choice:
    those pairs give exactly zero unless a row is fully masked."""
    if not causal:
        return BH * T * S
    return BH * int(np.minimum(S, np.arange(T) + 1).sum())


def _bwd_inputs(g, B, H, T, S, d, mask, causal, dtype=torch.float32):
    """Operands of the backward kernels in ``dtype``: q/k/v, a cotangent
    at a tenth of unit scale, and ``o``, ``lse`` and ``delta`` (float32,
    from the upcast operands) from the forward kernel."""
    q, k, v = (torch.randn(B, H, n, d, generator=g, device="cuda").to(dtype)
               for n in (T, S, S))
    do = (0.1 * torch.randn(B, H, T, d, generator=g, device="cuda")).to(
        dtype)
    q3, k3, v3, m3, scale, mode = fa._prepare(q, k, v, mask, None)
    do3 = do.reshape(B * H, T, d)
    o3, lse = fa.flash_attention_fwd(q3, k3, v3, m3, scale, mode, causal)
    delta = (do3.float() * o3.float()).sum(dim=-1)
    return (q3, k3, v3, m3, lse, delta, do3, scale, mode, causal), \
        (q, k, v, do)


def phase_flash_bwd():
    """The dq and dk/dv kernels against their plain versions at the
    training shape (B 8, H 12, T = S = 1024, d 64, causal) and on ragged
    cases; times at the training shape for each kernel, its plain
    version and the backward of ``scaled_dot_product_attention`` (a
    yardstick the port never calls); the forward kernel's time at the
    training shape too, checked there against its plain version.  Returns
    ``(dq_row, dkv_row, fwd_train)``."""
    g = torch.Generator(device="cuda").manual_seed(1)
    B, H, T, d = TRAIN_B, 12, TRAIN_T, 64
    cases = {"train(causal)": (B, H, T, T, d, None, True)}
    # ragged T/S at every head dim: per-head dense and vec masks, fully
    # masked rows, causal with a dense mask
    for dd, (b, h, t, s), causal, kind in (
            (16, (2, 3, 70, 200), False, "dense"),
            (32, (2, 2, 33, 77), False, "vec"),
            (128, (1, 2, 150, 150), True, "dense"),
            (64, (1, 2, 130, 260), True, "dense"),
            (64, (2, 2, 100, 70), False, "vec")):
        shape = (b, h, t if kind == "dense" else 1, s)
        m = torch.where(torch.rand(*shape, generator=g, device="cuda") < 0.2,
                        -1e9, 0.0)
        if kind == "dense":
            m[-1, -1, t // 2] = -1e9               # a fully masked row
            m[0, 0, 0] = -1e9
        cases[f"ragged d{dd} {kind}{' causal' if causal else ''}"] = (
            b, h, t, s, dd, m, causal)
    errs = {}
    for name, (b, h, t, s, dd, m, causal) in cases.items():
        args, _ = _bwd_inputs(g, b, h, t, s, dd, m, causal)
        dq = fa.flash_attention_bwd_dq(*args)
        dk, dv = fa.flash_attention_bwd_dkv(*args)
        rq = fa.flash_attention_bwd_dq_reference(*args)
        rk, rv = fa.flash_attention_bwd_dkv_reference(*args)
        torch.cuda.synchronize()
        e_dq = float((dq - rq).abs().max())
        e_dkv = max(float((dk - rk).abs().max()), float((dv - rv).abs().max()))
        ok = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv)) \
            and max(e_dq, e_dkv) <= FLASH_TOL
        _log(f"flash bwd {name}: max_abs_err dq {e_dq:.3e} dk/dv "
             f"{e_dkv:.3e} (tol {FLASH_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash bwd {name} disagrees with its plain "
                                 f"version: dq {e_dq}, dk/dv {e_dkv}")
        errs[name] = (e_dq, e_dkv)
    # the forward kernel at the training shape (unsplit route), then times
    args, (q, k, v, do) = _bwd_inputs(g, B, H, T, T, d, None, True)
    q3, k3, v3 = args[:3]
    before = fa.launches_combine
    fo, flse = fa.flash_attention_fwd(q3, k3, v3, None, args[7], "none", True)
    ro, rlse = fa.flash_attention_fwd_reference(q3, k3, v3, None, args[7],
                                                "none", True)
    torch.cuda.synchronize()
    fwd_err = max(float((fo - ro).abs().max()),
                  float((flse - rlse).abs().max()))
    ok = (bool(torch.isfinite(fo).all()) and bool(torch.isfinite(flse).all())
          and fwd_err <= FLASH_TOL and fa.launches_combine == before)
    _log(f"flash fwd train(causal) [unsplit]: max_abs_err {fwd_err:.3e} (o "
         f"and lse, tol {FLASH_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash fwd at the training shape disagrees "
                             f"with its plain version ({fwd_err}) or split")
    del fo, flse, ro, rlse
    dq_ms = _time_ms(lambda: fa.flash_attention_bwd_dq(*args))
    dkv_ms = _time_ms(lambda: fa.flash_attention_bwd_dkv(*args))
    dq_plain = _time_ms(lambda: fa.flash_attention_bwd_dq_reference(*args))
    dkv_plain = _time_ms(lambda: fa.flash_attention_bwd_dkv_reference(*args))
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    out = _sdpa(qs, ks, vs, is_causal=True)
    sdpa_bwd = _time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                                    retain_graph=True))
    fwd_ms = _time_ms(lambda: fa.flash_attention_fwd(q3, k3, v3, None,
                                                     args[7], "none", True))
    fwd_plain = _time_ms(lambda: fa.flash_attention_fwd_reference(
        q3, k3, v3, None, args[7], "none", True))
    sdpa_fwd = _time_ms(lambda: _sdpa(q, k, v, is_causal=True))
    BH = B * H
    pairs = _needed_pairs(BH, T, T, True)
    qkv_bytes = 4 * BH * T * d
    ins = 4 * qkv_bytes + 2 * 4 * BH * T              # q,k,v,dO; lse,delta
    rows = {}
    for name, ms, plain, outs, flop_pair in (
            ("flash_attention_bwd_dq", dq_ms, dq_plain, 1, 6 * d),
            ("flash_attention_bwd_dkv", dkv_ms, dkv_plain, 2, 8 * d)):
        nbytes = ins + outs * qkv_bytes
        flops = pairs * flop_pair
        bound_ms, bound_by = _bound(nbytes, flops)
        _log(f"{name} training shape: kernel {ms:.4f} ms, plain {plain:.4f} "
             f"ms, {SDPA_NAME} backward (dq, dk, dv together) {sdpa_bwd:.4f} "
             f"ms, bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} "
             f"MB, {flops / 1e9:.3f} GFLOP over {pairs} causal pairs; SIMT "
             f"bound {_bound(nbytes, flops, FP32_FLOP_PER_S)[0]:.4f} ms)")
        err = errs["train(causal)"][0 if outs == 1 else 1]
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "singa_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "replaces": ("singa_tpu/ops/pallas_kernels.py:146" if outs == 1
                         else "singa_tpu/ops/pallas_kernels.py:185"),
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sdpa_bwd}
    f_bytes = 4 * qkv_bytes + 4 * BH * T              # q,k,v in; o, lse out
    f_bound, f_by = _bound(f_bytes, pairs * 4 * d)
    fwd_train = {"max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": fwd_plain,
                 "library_ms": sdpa_fwd, "bound_ms": f_bound, "bound_by": f_by}
    _log(f"flash_attention_fwd training shape (unsplit route, "
         f"{BH * T // 64} blocks): kernel {fwd_ms:.4f} ms, plain "
         f"{fwd_plain:.4f} ms, {SDPA_NAME} {sdpa_fwd:.4f} ms, bound "
         f"{f_bound:.4f} ms ({f_by}; SIMT bound "
         f"{_bound(f_bytes, pairs * 4 * d, FP32_FLOP_PER_S)[0]:.4f} ms)")
    return rows["flash_attention_bwd_dq"], rows["flash_attention_bwd_dkv"], \
        fwd_train


def _paged_case(seed, S, H, d, P, Ps, pos_h, variant="f32",
                q_dtype=torch.float32):
    """Random pools of ``S * Ps + 1`` pages; each slot's table holds
    distinct pages up to its position and NULL (page 0) after it; a slot
    at ``pos < 0`` holds stale pages in half its row and NULL in the
    rest (it attends the whole row).  ``variant``: ``f32``, ``bf16`` or
    ``f16`` pages, or int8 pages with ``int8_bf16`` / ``int8_f32`` scales
    in [0.002, 0.03); the query in ``q_dtype``.  Returns the positional
    operands and the scale keywords."""
    N = S * Ps + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(S, H, d, generator=g, device="cuda").to(q_dtype)
    scales = {}
    if variant.startswith("int8"):
        kp, vp = (torch.randint(-127, 128, (N, H, P, d), generator=g,
                                device="cuda", dtype=torch.int8)
                  for _ in range(2))
        sd = torch.bfloat16 if variant == "int8_bf16" else torch.float32
        scales = {k: (0.002 + 0.028 * torch.rand(N, H, P, generator=g,
                                                 device="cuda")).to(sd)
                  for k in ("k_scales", "v_scales")}
    else:
        kp, vp = (torch.randn(N, H, P, d, generator=g, device="cuda").to(
            PAGE_DTYPES[variant]) for _ in range(2))
    pos_h = np.asarray(pos_h, np.int32)
    rng = np.random.RandomState(seed)
    free = list(rng.permutation(np.arange(1, N)))
    table_h = np.zeros((S, Ps), np.int32)
    for s in range(S):
        n = pos_h[s] // P + 1 if pos_h[s] >= 0 else Ps // 2
        table_h[s, :n] = [free.pop() for _ in range(n)]
    return (q, kp, vp, torch.from_numpy(table_h).cuda(),
            torch.from_numpy(pos_h).cuda()), scales


# the paged decode variants: float32 pages (the float path), bfloat16
# pages (the storage override), int8 pages with bf16 / fp32 scales
PAGED_VARIANTS = ("f32", "bf16", "int8_bf16", "int8_f32")
PAGE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
               "f16": torch.float16}
# serving-shape positions: mid-page frontiers from 5 to max_len - 1
SERVING_POS = (100, 257, 511, 30, 700, 1023, 5, 300)


def _paged_bound(args, scales, P, pos_h):
    """Bytes the function must move (q and pos in, out; the table entries
    of the pages it reads; the K and V rows at columns <= pos, and their
    scales, once; a slot at pos < 0 reads V and its scales over its
    whole row, and no K) and float32 operations (2 flop a multiply-add:
    the q.k and the p.v products, the latter alone at pos < 0), and the
    bound they give."""
    q, kp, _, table, _ = args
    S, H, d = q.shape
    L = table.shape[1] * P
    scored = pos_h >= 0
    cols = np.where(scored, np.minimum(pos_h, L - 1) + 1, L)
    pages = int((-(-cols // P)).sum())
    live_cols = int(cols.sum())
    row_bytes = d * kp.element_size()
    if scales:
        row_bytes += scales["k_scales"].element_size()
    kv_rows = int((cols * np.where(scored, 2, 1)).sum()) * H
    nbytes = (2 * q.numel() * q.element_size() + 4 * (S + pages)
              + kv_rows * row_bytes)
    flops = 2 * H * d * kv_rows
    return nbytes, flops, live_cols, _bound(nbytes, flops)


def _paged_routes(q, table):
    """The plans phase 5 forces: the card's, unsplit, one page a range."""
    S, H, _ = q.shape
    Ps = table.shape[1]
    return {"card": pa._split_plan(S, H, Ps, pa._sm_count(0)),
            "unsplit": (1, Ps), "page_a_range": (Ps, 1)}


def _paged_force(args, scales, plan):
    """The kernel's C entry on ``args`` under ``plan``."""
    q = args[0]
    return pa._launch(*args, 1.0 / float(np.sqrt(q.shape[2])),
                      scales.get("k_scales"), scales.get("v_scales"), plan)


def _paged_force_parts(args, scales, plan):
    """One call under a split ``plan``, its partials scratch kept:
    ``(output, partials (S, H, R, d + 2) float32)`` after the call."""
    kept, alloc = [], pa._scratch
    pa._scratch = lambda device, n: kept.append(alloc(device, n)) or kept[-1]
    try:
        out = _paged_force(args, scales, plan)
    finally:
        pa._scratch = alloc
    torch.cuda.synchronize()
    S, H, d = args[0].shape
    return out, kept[0].view(S, H, plan[0], d + 2)


def _misaligned(t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _paged_split_parts(args, scales, plan):
    """The split route's two halves held apart: after one call under
    ``plan``, the partial states the live ranges left in the scratch
    buffer against ``paged_decode_partial_reference`` (max |delta| /
    max(1, |ref|): the sums are not normalised), and, over the slots
    with two or more live ranges (the others write no partials), the
    call's output and the merge launch alone (``pa._merge_launch``) on
    the kernel's own partials against ``paged_decode_merge_reference``
    on them.  Returns the two errors."""
    q, kp, _, table, pos = args
    S, H, d = q.shape
    R, ppr = plan
    got, part = _paged_force_parts(args, scales, plan)
    ml, acc = part[..., :2], part[..., 2:]
    n_live = pa._live_ranges(pos, R, ppr, kp.shape[2], table.shape[1])
    split = n_live > 1
    if not bool(split.any()):
        return 0.0, 0.0
    live = (torch.arange(R, device="cuda")[None] < n_live[:, None]) \
        & split[:, None]
    live = live[:, None, :].expand(S, H, R)
    pml, pacc = pa.paged_decode_partial_reference(*args, plan, **scales)

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp(min=1))[live].max())

    merged = pa.paged_decode_merge_reference(ml, acc, pos, plan, kp.shape[2],
                                             table.shape[1])
    alone = pa._merge_launch(part, pos, torch.zeros_like(q), kp.shape[2],
                             table.shape[1], plan)
    torch.cuda.synchronize()
    return (max(rel(ml, pml), rel(acc, pacc)),
            max(float((got - merged)[split].abs().max()),
                float((alone - merged)[split].abs().max())))


def _paged_back_to_back(n=1000):
    """The split route's scratch under load: ``n`` launches back to back
    with no sync, cycling over the variants, three shapes (serving, d 40,
    d 18 with P 5), four plans and eight position vectors each (pos -1
    to max_len - 1), so that launches of one plan and shape reuse one
    partials buffer in stream order; then every output against its
    plain version.  Returns the max abs error."""
    rng = np.random.RandomState(31)
    cases = []
    for variant in PAGED_VARIANTS:
        for seed, S, H, d, P, Ps in ((21, 8, 12, 64, 16, 64),
                                     (22, 4, 3, 40, 16, 32),
                                     (23, 5, 2, 18, 5, 20)):
            L = Ps * P
            args, scales = _paged_case(seed, S, H, d, P, Ps, [L - 1] * S,
                                       variant)
            poss = [rng.randint(-1, L, S).astype(np.int32)
                    for _ in range(8)]
            poss[0][0], poss[1][-1] = -1, L - 1
            plans = list(_paged_routes(args[0], args[3]).values()) \
                + [(-(-Ps // 3), 3)]
            cases.append((args[:4], scales,
                          [torch.from_numpy(p).cuda() for p in poss], plans))
    runs = []
    for i in range(n):
        c = i % len(cases)
        args, scales, poss, plans = cases[c]
        j, k = (i // len(cases)) % 8, (i // len(cases) // 2) % 4
        runs.append((c, j, _paged_force(args + (poss[j],), scales,
                                        plans[k])))
    torch.cuda.synchronize()
    refs, worst = {}, 0.0
    for c, j, got in runs:
        if (c, j) not in refs:
            args, scales, poss, _ = cases[c]
            refs[c, j] = pa.paged_decode_attention_reference(
                *args, poss[j], **scales)
        worst = max(worst, float((got - refs[c, j]).abs().max()))
    _log(f"paged decode back to back: {n} launches over {len(cases)} "
         f"cases x 8 positions x 4 plans, max_abs_err {worst:.3e} (tol "
         f"{PAGED_TOL:g})")
    if not worst <= PAGED_TOL:
        raise AssertionError(f"paged decode back to back: error {worst}")


def _host_us(fn, n=200):
    """Median host µs of one call of ``fn`` over ``n`` calls issued with
    no sync between them (the wrapper's own time)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def phase_paged():
    """Every variant against its plain version on three routes (the
    card's plan, unsplit, one page a range) at the serving shape, at the
    serving shape with a slot at pos -1, at odd head dims (d 40, d 18
    with P 5) and on the earlier page sizes; on pools one element off
    their alignment; the split route's partials and merge held apart;
    1,000 launches back to back.  Times, bounds, plans and host µs a call
    of the float32 and the int8 (bf16-scale) variants at the serving
    shape, and of the merge launch alone.  Returns the float, the int8
    and the merge rows of the kernels line."""
    S, H, d, P, Ps = N_SLOTS, 12, 64, PAGE, 1024 // PAGE
    pos_h = np.array(SERVING_POS, np.int32)
    shapes = {"serving": (1, S, H, d, P, Ps, pos_h),
              "serving pos -1": (9, S, H, d, P, Ps, pos_h[:-1].tolist()
                                 + [-1]),
              "d40 P16": (10, 4, 12, 40, 16, 32, [-1, 15, 16, 511]),
              "d18 P5": (11, 4, 3, 18, 5, 20, [-1, 4, 5, 99])}
    # other page sizes and head dims, positions on and off page edges
    for seed, (dd, PP, pp) in enumerate(((64, 8, [7, 8, 0, 250, 511]),
                                         (32, 12, [11, 12, 131, 0]),
                                         (128, 32, [31, 32, 500, 1]))):
        shapes[f"d{dd} P{PP}"] = (2 + seed, len(pp), 4, dd, PP,
                                  -(-512 // PP), pp)
    err_serving, cases, worst_parts = {}, {}, [0.0, 0.0]

    def check(label, got, ref):
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= PAGED_TOL
        _log(f"paged decode {label}: max_abs_err {err:.3e} (tol "
             f"{PAGED_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"paged decode {label} disagrees with its "
                                 f"plain version: {err}")
        return err

    for variant in PAGED_VARIANTS:
        for name, shape in shapes.items():
            args, scales = _paged_case(*shape, variant=variant)
            ref = pa.paged_decode_attention_reference(*args, **scales)
            err = check(f"{variant} {name} public",
                        pa.paged_decode_attention(*args, **scales), ref)
            err_serving.setdefault(variant, err)
            cases.setdefault(variant, (args, scales))
            for route, plan in _paged_routes(args[0], args[3]).items():
                check(f"{variant} {name} {route} {plan}",
                      _paged_force(args, scales, plan), ref)
                if plan[0] > 1:
                    parts = _paged_split_parts(args, scales, plan)
                    if max(parts) > PAGED_TOL:
                        raise AssertionError(f"paged decode {variant} "
                                             f"{name} {route}: partials / "
                                             f"merge off by {parts}")
                    worst_parts = [max(a, b) for a, b in
                                   zip(worst_parts, parts)]
            if name in ("serving", "d40 P16"):
                q, kp, vp, table, pos = args
                off = {k: _misaligned(v) for k, v in scales.items()}
                check(f"{variant} {name} pools one element off",
                      pa.paged_decode_attention(
                          q, _misaligned(kp), _misaligned(vp), table, pos,
                          **off), ref)
    _log(f"paged decode split route held apart: partials relative error "
         f"{worst_parts[0]:.3e}, merge max_abs_err {worst_parts[1]:.3e} "
         f"(tol {PAGED_TOL:g})")
    _paged_back_to_back()
    rows = []
    for variant, name, replaces in (
            ("f32", "paged_decode_attention",
             "singa_tpu/ops/paged_attention.py:45"),
            ("int8_bf16", "paged_decode_attention_q8",
             "singa_tpu/ops/paged_attention.py:53")):
        args, scales = cases[variant]
        plan = _paged_routes(args[0], args[3])["card"]

        def call():
            return pa.paged_decode_attention(*args, **scales)

        ms = _time_ms(call)
        unsplit_ms = _time_ms(lambda: _paged_force(args, scales, (1, Ps)))
        plain_ms = _time_ms(lambda: pa.paged_decode_attention_reference(
            *args, **scales))
        host_us = _host_us(call)
        nbytes, _, live_cols, (bound_ms, bound_by) = _paged_bound(
            args, scales, P, pos_h)
        _log(f"paged decode {variant} serving shape: kernel {ms:.4f} ms on "
             f"the card's plan {plan} ({S * H * plan[0]} blocks), unsplit "
             f"route {unsplit_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
             f"{bound_ms:.6f} ms ({bound_by}: {nbytes / 1e6:.4f} MB over "
             f"{live_cols} live rows); host {host_us:.1f} us a call "
             f"(median of 200, no sync)")
        rows.append({"name": name, "route": "cuda",
                     "source": "singa_tpu_torch/ops/csrc/paged_decode.cu",
                     "replaces": replaces,
                     "max_abs_err": err_serving[variant], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None,
                     "plan": list(plan), "blocks": S * H * plan[0],
                     "unsplit_ms": unsplit_ms, "host_us": host_us})
    rows.append(_paged_merge_row(*cases["f32"], max(worst_parts[1], 0.0)))
    return rows


def _paged_merge_row(args, scales, err):
    """The merge launch at the serving shape on the card's plan, alone,
    on the partials the float32 call left: its time against
    ``paged_decode_merge_reference``'s on the same partials, and its
    bound (the live ranges' partials of the split slots read once, their
    output rows written once, pos)."""
    q, kp, _, table, pos = args
    S, H, d = q.shape
    P, Ps = kp.shape[2], table.shape[1]
    plan = _paged_routes(q, table)["card"]
    R = plan[0]
    part = _paged_force_parts(args, scales, plan)[1]
    out = torch.zeros_like(q)
    ms = _time_ms(lambda: pa._merge_launch(part, pos, out, P, Ps, plan))
    plain_ms = _time_ms(lambda: pa.paged_decode_merge_reference(
        part[..., :2], part[..., 2:], pos, plan, P, Ps))
    n_live = pa._live_ranges(pos, R, plan[1], P, Ps).cpu().numpy()
    split = n_live[n_live > 1]
    nbytes = 4 * (S + H * int((split * (d + 2)).sum()) + H * d * len(split))
    flops = 2 * H * (d + 1) * int(split.sum())
    bound_ms, bound_by = _bound(nbytes, flops)
    _log(f"paged decode merge alone, serving shape, plan {plan}: "
         f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
         f"({bound_by}: {nbytes / 1e3:.1f} kB, {len(split)} split slots)")
    return {"name": "paged_decode_merge", "route": "cuda",
            "source": "singa_tpu_torch/ops/csrc/paged_decode.cu",
            "replaces": "singa_tpu/ops/paged_attention.py:88",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "plan": list(plan)}


# ---- the kernels on 16-bit operands (phases 3b, 4b, 5c) -------------------

LOWP = (torch.bfloat16, torch.float16)
LOWP_NAME = {torch.bfloat16: "bf16", torch.float16: "fp16"}
# 16-bit outputs: at most one unit in the last place of their dtype from
# the plain version (both compute the float32 function of the same
# operands and round once, so a float32 difference flips at most the last
# bit), the unit taken at max(|got|, |ref|, ULP_FLOOR): float32 sums of
# unit-scale terms carry ~1e-7 of absolute error, which near a result of
# 0 is many of its own units, so an output below 2^-6 is held to the
# unit at 2^-6 (bf16 1.2e-4, fp16 1.5e-5); lse and the float32 partials
# at LOWP_F32_TOL
ULP_TOL = 1.0
ULP_FLOOR = 2.0 ** -6
LOWP_F32_TOL = 1e-4


def _ulps(got, ref):
    """Largest ``|got - ref|`` in units in the last place of the output's
    16-bit dtype, the unit taken at ``max(|got|, |ref|, ULP_FLOOR)``; inf
    where either is not finite."""
    if not (bool(torch.isfinite(got).all())
            and bool(torch.isfinite(ref).all())):
        return float("inf")
    if got.numel() == 0:
        return 0.0
    p = {torch.bfloat16: 8, torch.float16: 11}[got.dtype]
    g, r = got.float(), ref.float()
    _, e = torch.frexp(torch.clamp(torch.maximum(g.abs(), r.abs()),
                                   min=ULP_FLOOR))
    ulp = torch.ldexp(torch.ones_like(g), e - p)
    return float(((g - r).abs() / ulp).max())


def _lowp_check(label, errs):
    """``errs``: [(kind, error)] with kind ``ulp`` (16-bit output) or
    ``abs`` (float32 output); raises past the tolerances."""
    ok = all(e <= (ULP_TOL if k == "ulp" else LOWP_F32_TOL) for k, e in errs)
    _log(f"{label}: " + ", ".join(
        f"{e:.3g} {'ulp' if k == 'ulp' else 'abs'}" for k, e in errs)
        + f" (tol {ULP_TOL:g} ulp, {LOWP_F32_TOL:g} abs) "
        + ("ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{errs}")


def _fwd_case_lowp(q, k, v, mask, causal, n_sm):
    """The forward on 16-bit operands (route by ``n_sm``) against its plain
    version: ``(o ulps, lse abs error, route, o abs error)``."""
    q3, k3, v3, m3, scale, mode = fa._prepare(q, k, v, mask, None)
    q3, k3, v3 = q3.contiguous(), k3.contiguous(), v3.contiguous()
    before = fa.launches_combine_lowp
    o, lse = _fwd_route(q3, k3, v3, m3, scale, mode, causal, n_sm)
    route = "split" if fa.launches_combine_lowp > before else "unsplit"
    ro, rlse = fa.flash_attention_fwd_reference(q3, k3, v3, m3, scale, mode,
                                                causal)
    torch.cuda.synchronize()
    if o.dtype != q.dtype:
        raise AssertionError(f"flash forward returned {o.dtype} for "
                             f"{q.dtype} operands")
    return (_ulps(o, ro), float((lse - rlse).abs().max()), route,
            _abs(o, ro))


def _abs(got, ref):
    return float((got.float() - ref.float()).abs().max())


def _lowp_bytes(*tensors, extra=0):
    return sum(t.numel() * t.element_size() for t in tensors) + extra


def phase_flash_mixed():
    """Phase 3c: flash on mixed operands, the float chunk under a bf16
    policy over float32 cache rows: bf16 queries (1, 12, 64, 64) over
    float32 keys and values (1, 12, 1024, 64) under the chunk's dense
    mask.  The entry promotes the operands to float32 and runs that
    route (a float32 launch, no 16-bit one), returning o in q's dtype;
    held against the plain version on the same mixed operands within one
    bf16 unit."""
    g = torch.Generator(device="cuda").manual_seed(5)
    H, d, C, L = 12, 64, 64, 1024
    q = torch.randn(1, H, C, d, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(1, H, L, d, generator=g, device="cuda")
            for _ in range(2))
    cols = torch.arange(L, device="cuda")
    positions = 512 + torch.arange(C, device="cuda")
    mask = torch.where(cols[None] <= positions[:, None], 0.0, -1e9)
    before = (fa.launches, fa.launches_lowp)
    o = fa.flash_attention(q, k, v, mask[None, None])
    ref = fa.flash_attention_reference(q, k, v, mask[None, None])
    torch.cuda.synchronize()
    ran = (fa.launches - before[0], fa.launches_lowp - before[1])
    err = _ulps(o, ref)
    _log(f"flash mixed (bf16 q, float32 k/v, serving chunk shape): o "
         f"{o.dtype}, {err:.3g} ulp against the plain version (tol "
         f"{ULP_TOL:g}); launches {ran[0]} (16-bit {ran[1]})")
    if o.dtype != torch.bfloat16 or err > ULP_TOL or ran != (1, 0):
        raise AssertionError(f"flash on mixed operands: {o.dtype}, {err} "
                             f"ulp, launches {ran}")
    return err


def phase_flash_lowp(rows):
    """Phases 3b and 4b: the flash kernels on bfloat16 and float16
    operands.  The forward on both routes (the card's plan and forced
    each way) at the serving shape (dense mask), the causal serving
    shapes, the training shape and ragged cases at every head dim; the
    split route's partials and its combine alone; the dq and dk/dv
    kernels at the training shape and on ragged cases; each against its
    plain version on the same 16-bit operands (outputs within one ulp,
    lse and partials within 1e-4).  Times beside the float32 rows of
    ``rows`` (phases 3-4), the bound at 2 bytes an element and the TF32
    products the kernels need (``LOWP_TF32_PAIR``; the 3xTF32 bound
    beside it), and ``scaled_dot_product_attention`` pinned to its
    memory-efficient backend in the same dtype (a yardstick that rounds
    P to 16 bits, so another function).  Returns the 16-bit rows of the
    kernels line (numbers of the bf16 cases; fp16's under
    ``by_dtype``)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    f32 = {r["name"]: r for r in rows}
    H, d, C, L = 12, 64, 64, 1024
    scale = 1.0 / np.sqrt(d)
    n_sm = fa._sm_count(0)
    out = {n: {} for n in ("fwd", "combine", "dq", "dkv")}
    for dt in LOWP:
        tag = LOWP_NAME[dt]

        def rnd(*shape):
            return torch.randn(*shape, generator=g, device="cuda").to(dt)

        q, k, v = rnd(1, H, C, d), rnd(1, H, L, d), rnd(1, H, L, d)
        positions = 512 + torch.arange(C, device="cuda")
        cols = torch.arange(L, device="cuda")
        mask = torch.where(cols[None] <= positions[:, None], 0.0, -1e9)
        mask = mask[None, None].contiguous()
        cases = {"dense(serving)": (q, k, v, mask, False, (None, 1))}
        for B, T in CAUSAL_SERVING:
            cases[f"B{B} T{T} causal"] = (rnd(B, H, T, d), rnd(B, H, T, d),
                                          rnd(B, H, T, d), None, True,
                                          (None,))
        vec = torch.zeros(1, 1, 1, L, device="cuda")
        vec[..., 900:] = -1e9
        cases["vec"] = (q, k, v, vec, False, (1, SPLIT_SM))
        for dd, (B, Hh, T, S), causal in ((16, (2, 3, 70, 200), False),
                                          (32, (2, 2, 33, 77), False),
                                          (64, (1, 2, 130, 260), True),
                                          (128, (1, 2, 150, 150), True)):
            m = torch.where(torch.rand(B, Hh, T, S, generator=g,
                                       device="cuda") < 0.2, -1e9, 0.0)
            m[-1, -1, T // 2] = -1e9
            cases[f"ragged d{dd} per-head"] = (
                rnd(B, Hh, T, dd), rnd(B, Hh, S, dd), rnd(B, Hh, S, dd), m,
                causal, (1, SPLIT_SM))
        err_serving = None
        for name, (a, b, c, m, causal, routes) in cases.items():
            for r in routes:
                eo, el, route, ea = _fwd_case_lowp(a, b, c, m, causal, r)
                _lowp_check(f"flash {tag} {name} [{route}] o, lse",
                            [("ulp", eo), ("abs", el)])
                if name == "dense(serving)" and r is None:
                    if route != "split":
                        raise AssertionError("the 16-bit serving shape did "
                                             "not split")
                    err_serving = (eo, ea)
        # the split route's halves at the serving shape
        q3, k3, v3, m3, _, mode = fa._prepare(q, k, v, mask, scale)
        plan = fa._fwd_split_plan(H, C, L, False, n_sm)
        parts = fa.flash_attention_fwd_partial(q3, k3, v3, m3, scale, mode,
                                               False, plan)
        rparts = fa.flash_attention_fwd_partial_reference(
            q3, k3, v3, m3, scale, mode, False, plan)
        co, clse = fa.flash_attention_fwd_combine(*parts, C, L, False,
                                                  plan.per, dt)
        ro, rlse = fa.flash_attention_fwd_combine_reference(
            *parts, C, L, False, plan.per, dt)
        torch.cuda.synchronize()
        e_parts = max(float(((a - b).abs() / b.abs().clamp(min=1)).max())
                      for a, b in zip(parts, rparts))
        e_comb = (_ulps(co, ro), float((clse - rlse).abs().max()),
                  _abs(co, ro))
        _lowp_check(f"flash {tag} serving partials (relative), combine "
                    f"alone o, lse", [("abs", e_parts), ("ulp", e_comb[0]),
                                      ("abs", e_comb[1])])
        ms = _time_ms(lambda: fa.flash_attention(q, k, v, mask,
                                                 sm_scale=scale))
        plain = _time_ms(lambda: fa.flash_attention_reference(
            q, k, v, mask, sm_scale=scale))
        lib = _time_ms(lambda: _sdpa(q, k, v, attn_mask=mask.to(dt),
                                     scale=scale))
        nbytes = _lowp_bytes(q, k, v, mask, q, extra=4 * H * C)
        bound, by = _bound(nbytes, LOWP_TF32_PAIR["fwd"] * H * C * L * d,
                           TF32_FLOP_PER_S)
        bound3 = _bound(nbytes, 4 * H * C * L * d)[0]
        c_ms = _time_ms(lambda: fa.flash_attention_fwd_combine(
            *parts, C, L, False, plan.per, dt))
        c_plain = _time_ms(lambda: fa.flash_attention_fwd_combine_reference(
            *parts, C, L, False, plan.per, dt))
        c_bytes = 4 * sum(t.numel() for t in parts) + _lowp_bytes(
            q, extra=4 * H * C)
        c_bound, c_by = _bound(c_bytes, 3 * parts[0].numel())
        _log(f"flash {tag} serving shape (split route): kernel {ms:.4f} ms "
             f"(float32 {f32['flash_attention_fwd']['ms']:.4f}), plain "
             f"{plain:.4f} ms, {SDPA_NAME} {tag} {lib:.4f} ms (rounds P to "
             f"16 bits: another function), bound {bound:.4f} ms ({by}: "
             f"{nbytes / 1e6:.2f} MB; at 3xTF32 {bound3:.4f} ms); combine "
             f"{c_ms:.4f} ms (float32 "
             f"{f32['flash_attention_fwd_combine']['ms']:.4f}), plain "
             f"{c_plain:.4f} ms, bound {c_bound:.6f} ms ({c_by})")
        out["fwd"][tag] = {"max_abs_err": err_serving[1],
                           "max_ulp_err": err_serving[0], "ms": ms,
                           "plain_ms": plain, "bound_ms": bound,
                           "bound_by": by, "library_ms": lib,
                           "bound_3xtf32_ms": bound3,
                           "float32_ms": f32["flash_attention_fwd"]["ms"]}
        out["combine"][tag] = {"max_abs_err": e_comb[2],
                               "max_ulp_err": e_comb[0], "ms": c_ms,
                               "plain_ms": c_plain, "bound_ms": c_bound,
                               "bound_by": c_by, "library_ms": None,
                               "float32_ms":
                               f32["flash_attention_fwd_combine"]["ms"]}
        # the backward: the training shape and ragged cases
        bcases = {"train(causal)": (TRAIN_B, H, TRAIN_T, TRAIN_T, d, None,
                                    True)}
        for dd, (b, h, t, s_), causal, kind in (
                (16, (2, 3, 70, 200), False, "dense"),
                (32, (2, 2, 33, 77), False, "vec"),
                (128, (1, 2, 150, 150), True, "dense")):
            shape = (b, h, t if kind == "dense" else 1, s_)
            m = torch.where(torch.rand(*shape, generator=g, device="cuda")
                            < 0.2, -1e9, 0.0)
            if kind == "dense":
                m[-1, -1, t // 2] = -1e9
            bcases[f"ragged d{dd} {kind}"] = (b, h, t, s_, dd, m, causal)
        for name, (b, h, t, s_, dd, m, causal) in bcases.items():
            args, (q_, k_, v_, do_) = _bwd_inputs(g, b, h, t, s_, dd, m,
                                                  causal, dt)
            dq = fa.flash_attention_bwd_dq(*args)
            dk, dv = fa.flash_attention_bwd_dkv(*args)
            rq = fa.flash_attention_bwd_dq_reference(*args)
            rk, rv = fa.flash_attention_bwd_dkv_reference(*args)
            torch.cuda.synchronize()
            e_dq, e_dkv = _ulps(dq, rq), max(_ulps(dk, rk), _ulps(dv, rv))
            a_dq, a_dkv = _abs(dq, rq), max(_abs(dk, rk), _abs(dv, rv))
            _lowp_check(f"flash bwd {tag} {name} dq, dk/dv",
                        [("ulp", e_dq), ("ulp", e_dkv)])
            if name != "train(causal)":
                continue
            q3, k3, v3 = args[:3]
            fo, flse = fa.flash_attention_fwd(q3, k3, v3, None, args[7],
                                              "none", True)
            ro, rlse = fa.flash_attention_fwd_reference(q3, k3, v3, None,
                                                        args[7], "none",
                                                        True)
            torch.cuda.synchronize()
            _lowp_check(f"flash {tag} train(causal) [unsplit] o, lse",
                        [("ulp", _ulps(fo, ro)),
                         ("abs", float((flse - rlse).abs().max()))])
            del fo, flse, ro, rlse
            BH, T = b * h, t
            pairs = _needed_pairs(BH, T, T, True)
            qkv = q3.numel() * q3.element_size()
            ins = 4 * qkv + 2 * 4 * BH * T
            qs, ks, vs = (x.detach().requires_grad_() for x in (q_, k_, v_))
            so = _sdpa(qs, ks, vs, is_causal=True)
            sdpa_bwd = _time_ms(lambda: torch.autograd.grad(
                so, (qs, ks, vs), do_, retain_graph=True))
            for key, fn, plain_fn, outs, flop_pair, f32name in (
                    ("dq", fa.flash_attention_bwd_dq,
                     fa.flash_attention_bwd_dq_reference, 1, 6 * d,
                     "flash_attention_bwd_dq"),
                    ("dkv", fa.flash_attention_bwd_dkv,
                     fa.flash_attention_bwd_dkv_reference, 2, 8 * d,
                     "flash_attention_bwd_dkv")):
                k_ms = _time_ms(lambda: fn(*args))
                p_ms = _time_ms(lambda: plain_fn(*args))
                bnd, bby = _bound(ins + outs * qkv,
                                  pairs * LOWP_TF32_PAIR[key] * d,
                                  TF32_FLOP_PER_S)
                bnd3 = _bound(ins + outs * qkv, pairs * flop_pair)[0]
                _log(f"{f32name} {tag} training shape: kernel {k_ms:.4f} ms "
                     f"(float32 {f32[f32name]['ms']:.4f}), plain {p_ms:.4f} "
                     f"ms, {SDPA_NAME} {tag} backward {sdpa_bwd:.4f} ms, "
                     f"bound {bnd:.4f} ms ({bby}; at 3xTF32 {bnd3:.4f} ms)")
                out[key][tag] = {"max_abs_err": a_dq if outs == 1 else a_dkv,
                                 "max_ulp_err": e_dq if outs == 1 else e_dkv,
                                 "ms": k_ms, "plain_ms": p_ms,
                                 "bound_ms": bnd, "bound_by": bby,
                                 "bound_3xtf32_ms": bnd3,
                                 "library_ms": sdpa_bwd,
                                 "float32_ms": f32[f32name]["ms"]}
            f_ms = _time_ms(lambda: fa.flash_attention_fwd(
                q3, k3, v3, None, args[7], "none", True))
            f_plain = _time_ms(lambda: fa.flash_attention_fwd_reference(
                q3, k3, v3, None, args[7], "none", True))
            f_sdpa = _time_ms(lambda: _sdpa(q_, k_, v_, is_causal=True))
            f_bound, f_by = _bound(4 * qkv + 4 * BH * T,
                                   pairs * LOWP_TF32_PAIR["fwd"] * d,
                                   TF32_FLOP_PER_S)
            f_bound3 = _bound(4 * qkv + 4 * BH * T, pairs * 4 * d)[0]
            out["fwd"][tag]["train_shape"] = {
                "ms": f_ms, "plain_ms": f_plain, "library_ms": f_sdpa,
                "bound_ms": f_bound,
                "bound_by": f_by, "bound_3xtf32_ms": f_bound3,
                "float32_ms": f32["flash_attention_fwd"]["train_shape"]["ms"]}
            _log(f"flash_attention_fwd {tag} training shape: kernel "
                 f"{f_ms:.4f} ms (float32 "
                 f"{f32['flash_attention_fwd']['train_shape']['ms']:.4f}), "
                 f"plain {f_plain:.4f} ms, "
                 f"{SDPA_NAME} {tag} {f_sdpa:.4f} ms, bound {f_bound:.4f} ms "
                 f"({f_by}; at 3xTF32 {f_bound3:.4f} ms)")
    result = []
    for key, name, replaces in (
            ("fwd", "flash_attention_fwd_lowp",
             "singa_tpu/ops/pallas_kernels.py:102"),
            ("combine", "flash_attention_fwd_combine_lowp",
             "singa_tpu/ops/pallas_kernels.py:269"),
            ("dq", "flash_attention_bwd_dq_lowp",
             "singa_tpu/ops/pallas_kernels.py:146"),
            ("dkv", "flash_attention_bwd_dkv_lowp",
             "singa_tpu/ops/pallas_kernels.py:185")):
        src = "fwd" if key in ("fwd", "combine") else "bwd"
        row = {"name": name, "route": "cuda",
               "source": f"singa_tpu_torch/ops/csrc/flash_attention_{src}.cu",
               "replaces": replaces} | out[key]["bf16"]
        row["by_dtype"] = out[key]
        row["low_precision"] = "bf16 operands; fp16 under by_dtype"
        result.append(row)
    return result


# the combinations of phase 5c: (query, pages) as the engines produce them,
# and a float16 query over int8 pages with float32 scales
PAGED_LOWP = ((torch.bfloat16, "bf16"), (torch.float16, "f16"),
              (torch.bfloat16, "int8_bf16"), (torch.bfloat16, "f32"),
              (torch.float16, "int8_f32"))


def phase_paged_lowp(rows):
    """Phase 5c: paged decode on a 16-bit query, for each combination of
    ``PAGED_LOWP``, on phase 5's shapes (the serving shape, a slot at
    pos -1, d 40 and d 18 with 5-token pages, other page sizes) and
    three plans each (the card's, unsplit, one page a range): the output
    in the query's dtype within one ulp of the plain version; the split
    route's partials within 1e-4 (relative to max(1, |ref|)) and its
    merge alone within one ulp; pools one element off their alignment.
    Times at the serving shape beside the float32 rows of ``rows``.
    Returns the row of the kernels line (bf16 query over bf16 pages;
    the other combinations under ``by_combination``)."""
    f32 = {r["name"]: r for r in rows}
    S, H, d, P, Ps = N_SLOTS, 12, 64, PAGE, 1024 // PAGE
    pos_h = np.array(SERVING_POS, np.int32)
    shapes = {"serving": (1, S, H, d, P, Ps, pos_h),
              "serving pos -1": (9, S, H, d, P, Ps, pos_h[:-1].tolist()
                                 + [-1]),
              "d40 P16": (10, 4, 12, 40, 16, 32, [-1, 15, 16, 511]),
              "d18 P5": (11, 4, 3, 18, 5, 20, [-1, 4, 5, 99]),
              "d128 P32": (4, 4, 4, 128, 32, 16, [31, 32, 500, 1])}
    combos = {}
    for qdt, variant in PAGED_LOWP:
        tag = f"{LOWP_NAME[qdt]} query, {variant} pages"
        worst = worst_abs = 0.0
        for name, shape in shapes.items():
            args, scales = _paged_case(*shape, variant=variant, q_dtype=qdt)
            ref = pa.paged_decode_attention_reference(*args, **scales)
            got = pa.paged_decode_attention(*args, **scales)
            torch.cuda.synchronize()
            if got.dtype != qdt:
                raise AssertionError(f"paged decode {tag}: output "
                                     f"{got.dtype}")
            errs = [("ulp", _ulps(got, ref))]
            if name == "serving":
                worst_abs = _abs(got, ref)
            for route, plan in _paged_routes(args[0], args[3]).items():
                errs.append(("ulp", _ulps(_paged_force(args, scales, plan),
                                          ref)))
                if plan[0] > 1:
                    errs += _paged_split_lowp(args, scales, plan)
            if name in ("serving", "d40 P16"):
                q, kp, vp, table, pos = args
                off = {k_: _misaligned(v_) for k_, v_ in scales.items()}
                errs.append(("ulp", _ulps(pa.paged_decode_attention(
                    q, _misaligned(kp), _misaligned(vp), table, pos, **off),
                    ref)))
            _lowp_check(f"paged decode {tag} {name} (public, 3 plans, "
                        f"split halves, misaligned)", errs)
            worst = max(worst, max(e for k_, e in errs if k_ == "ulp"))
            if name == "serving":
                serving = (args, scales)
        args, scales = serving
        ms = _time_ms(lambda: pa.paged_decode_attention(*args, **scales))
        plain = _time_ms(lambda: pa.paged_decode_attention_reference(
            *args, **scales))
        nbytes, _, _, (bound, by) = _paged_bound(args, scales, P, pos_h)
        f32name = ("paged_decode_attention_q8" if variant.startswith("int8")
                   else "paged_decode_attention")
        _log(f"paged decode {tag} serving shape: kernel {ms:.4f} ms "
             f"({f32name} float32 query {f32[f32name]['ms']:.4f}), plain "
             f"{plain:.4f} ms, bound {bound:.6f} ms ({by}: "
             f"{nbytes / 1e6:.4f} MB)")
        combos[tag] = {"max_abs_err": worst_abs, "max_ulp_err": worst,
                       "ms": ms, "plain_ms": plain,
                       "bound_ms": bound, "bound_by": by, "library_ms": None,
                       "float32_query_ms": f32[f32name]["ms"]}
    main = combos["bf16 query, bf16 pages"]
    return {"name": "paged_decode_attention_lowp", "route": "cuda",
            "source": "singa_tpu_torch/ops/csrc/paged_decode.cu",
            "replaces": "singa_tpu/ops/paged_attention.py:45"} | main | {
                "by_combination": combos,
                "low_precision": "bf16 query over bf16 pages; the rest "
                                 "under by_combination"}


def _paged_split_lowp(args, scales, plan):
    """The split route's halves on a 16-bit query: the partials a call
    left against the plain partials (relative to max(1, |ref|)), and the
    merge launch alone on them, in the query's dtype, against the plain
    merge rounded to it (ulps), over the slots with 2+ live ranges."""
    q, kp, _, table, pos = args
    S, H, d = q.shape
    R, ppr = plan
    part = _paged_force_parts(args, scales, plan)[1]
    n_live = pa._live_ranges(pos, R, ppr, kp.shape[2], table.shape[1])
    split = n_live > 1
    if not bool(split.any()):
        return []
    live = (torch.arange(R, device="cuda")[None] < n_live[:, None]) \
        & split[:, None]
    live = live[:, None, :].expand(S, H, R)
    pml, pacc = pa.paged_decode_partial_reference(*args, plan, **scales)
    rel = max(float(((a - b).abs() / b.abs().clamp(min=1))[live].max())
              for a, b in ((part[..., :2], pml), (part[..., 2:], pacc)))
    merged = pa.paged_decode_merge_reference(part[..., :2], part[..., 2:],
                                             pos, plan, kp.shape[2],
                                             table.shape[1]).to(q.dtype)
    alone = pa._merge_launch(part, pos, torch.zeros_like(q), kp.shape[2],
                             table.shape[1], plan)
    torch.cuda.synchronize()
    return [("abs", rel), ("ulp", _ulps(alone[split], merged[split]))]


# the char-LSTM of bench_rnn.py at the reference char-RNN shape
# (bench_rnn.py:92): vocab, hidden, sequence, batch
RNN_V, RNN_H, RNN_T, RNN_B = 86, 256, 100, 64
LSTM_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# tolerance by output type: float32 max abs error 1e-5 (summation order
# only); bfloat16 and float16 one unit in the last place relative to
# max(1, |ref|) (both sides compute in float32 and round once, so a value
# near a tie may land on either side)
LSTM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7,
            torch.float16: 2.0 ** -10}


def _lstm_operands(g, B, H, dtype=torch.float32):
    """One cell step's operands on the card: h in (-1, 1), c and xw
    normal, W_hh and b uniform in +-1/sqrt(H) (the layer's init), drawn
    in float32 and rounded to ``dtype``."""
    u = 1.0 / np.sqrt(H)

    def unif(*shape, lim=1.0):
        return (torch.rand(*shape, generator=g, device="cuda") * 2 - 1) * lim

    ops = (torch.randn(B, 4 * H, generator=g, device="cuda"),
           unif(B, H), torch.randn(B, H, generator=g, device="cuda"),
           unif(H, 4 * H, lim=u), unif(4 * H, lim=u))
    return tuple(t.to(dtype) for t in ops)


def _lstm_err(got, ref):
    """Float32 outputs: max abs error; bfloat16 / float16: max |delta| /
    max(1, |ref|)."""
    d = (got.float() - ref.float()).abs()
    if got.dtype == torch.float32:
        return float(d.max())
    return float((d / ref.float().abs().clamp(min=1.0)).max())


def _lstm_case(ops, g):
    """Both kernels against their plain versions on the same operands
    and cotangents, then the autograd Function (forward and backward
    kernels, the products) against the plain version under torch's
    autograd: ``(forward err, backward kernel err, gradient err,
    finite)``.  Errors by ``_lstm_err`` for the kernels (the backward
    kernel writes float32) and for low-precision gradients; float32
    gradients as max|delta| / max|g| over each tensor."""
    B, H = ops[1].shape
    dt = ops[1].dtype
    dh = torch.randn(B, H, generator=g, device="cuda").to(dt)
    dc = torch.randn(B, H, generator=g, device="cuda").to(dt)
    kern = lc.lstm_cell_forward(*ops) + lc.lstm_cell_backward(*ops, dh, dc)
    plain = lc.lstm_cell_reference(*ops) \
        + lc.lstm_cell_backward_reference(*ops, dh, dc)
    if any(a.dtype != b.dtype or a.shape != b.shape
           for a, b in zip(kern, plain)):
        raise AssertionError(f"lstm cell: kernel outputs {kern} against "
                             f"{plain}")
    fwd = max(_lstm_err(a, b) for a, b in zip(kern[:2], plain[:2]))
    bwd = max(_lstm_err(a, b) for a, b in zip(kern[2:], plain[2:]))
    leaves = [t.detach().requires_grad_() for t in ops]
    grads = [torch.autograd.grad(fn(*leaves), leaves, (dh, dc))
             for fn in (lc.lstm_cell_fused, lc.lstm_cell_reference)]
    torch.cuda.synchronize()
    if dt == torch.float32:
        grad = max(float((a - b).abs().max())
                   / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(*grads))
    else:
        grad = max(_lstm_err(a, b) for a, b in zip(*grads))
    finite = all(bool(torch.isfinite(t).all()) for t in kern + grads[0])
    return fwd, bwd, grad, finite


def _count_device_launches(fn):
    """Device activities (kernels, copies, fills) that one call of
    ``fn`` issues, under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kern), kern


def phase_lstm():
    """The LSTM cell's forward and backward kernels against their plain
    versions, and the autograd Function against the plain cell under
    torch's autograd, in float32, bfloat16 and float16, at the training
    shape (B 64, H 256), the sampling shape (B 1, H 256) and ragged shapes
    (B 3/65 x H 5/130/1000).  Times at the training shape: each kernel,
    its plain version, the whole Function backward (the kernel and the
    products), and, as yardsticks the port never calls, cuDNN's
    ``torch.nn.LSTM`` forward over the same T 100 sequence and weights
    divided by T, and its backward ((forward + backward) - forward) over
    T.  The Function backward's device launches are counted under the
    profiler.  Returns the rows for the kernels line."""
    report = [line.strip() for line in
              _build.ptxas_report("lstm_cell").splitlines()
              if "entry function" in line or "Used" in line
              or "spill" in line]
    _log("ptxas lstm_cell:\n  " + "\n  ".join(report))
    _log("lstm cell dynamic shared memory a block: " + ", ".join(
        f"{str(dt)[6:]} {lc.smem_bytes(dt)} B" for dt in LSTM_DTYPES))
    g = torch.Generator(device="cuda").manual_seed(4)
    cases = {"train": (RNN_B, RNN_H), "sample": (1, RNN_H)}
    for B in (3, 65):
        for H in (5, 130, 1000):
            cases[f"B{B} H{H}"] = (B, H)
    errs = {}
    for dt in LSTM_DTYPES:
        tol = LSTM_TOL[dt]
        for name, (B, H) in cases.items():
            fwd, bwd, grad, finite = _lstm_case(_lstm_operands(g, B, H, dt),
                                                g)
            ok = finite and fwd <= tol and bwd <= LSTM_TOL[torch.float32] \
                and grad <= tol
            _log(f"lstm cell {str(dt)[6:]} {name} (B {B}, H {H}, "
                 f"{lc.grid_blocks(B, H)} blocks): forward err {fwd:.3e} "
                 f"(tol {tol:g}), backward kernel err {bwd:.3e} (tol "
                 f"{LSTM_TOL[torch.float32]:g}), gradients err {grad:.3e} "
                 f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"lstm cell {dt} {name} disagrees with its plain "
                    f"version: forward {fwd}, backward {bwd}, gradients "
                    f"{grad}, finite {finite}")
            errs[dt, name] = (fwd, bwd)
    B, H, T, V = RNN_B, RNN_H, RNN_T, RNN_V
    xw, h, c, W_hh, b = ops = _lstm_operands(g, B, H)
    dh = torch.randn(B, H, generator=g, device="cuda")
    dc = torch.randn(B, H, generator=g, device="cuda")
    ms = _time_ms(lambda: lc.lstm_cell_forward(*ops))
    plain_ms = _time_ms(lambda: lc.lstm_cell_reference(*ops))
    bwd_ms = _time_ms(lambda: lc.lstm_cell_backward(*ops, dh, dc))
    bwd_plain_ms = _time_ms(
        lambda: lc.lstm_cell_backward_reference(*ops, dh, dc))
    fn_bwd_ms = _time_ms(lambda: lc.cell_backward(ops, dh, dc))
    low = {}
    for dt in LSTM_DTYPES[1:]:
        lops = tuple(t.to(dt) for t in ops)
        ldh, ldc = dh.to(dt), dc.to(dt)
        low[str(dt)[6:]] = {
            "ms": _time_ms(lambda: lc.lstm_cell_forward(*lops)),
            "bwd_ms": _time_ms(lambda: lc.lstm_cell_backward(*lops, ldh,
                                                             ldc))}
    n_launch, names = _count_device_launches(
        lambda: lc.cell_backward(ops, dh, dc))
    _log(f"lstm cell: one float32 Function backward issues {n_launch} "
         f"device launches: {[n[:60] for n in names]}")
    if n_launch > 4:
        raise AssertionError(f"the float32 cell backward issues {n_launch} "
                             f"device launches (at most 4): {names}")
    # cuDNN's LSTM (gates i, f, g, o as here): weight_ih = W_ih^T,
    # weight_hh = W_hh^T, bias_ih = b, bias_hh = 0, over one-hot input
    W_ih = (torch.rand(V, 4 * H, generator=g, device="cuda") * 2 - 1) \
        / np.sqrt(H)
    ids = torch.randint(0, V, (T, B), generator=g, device="cuda")
    x = torch.nn.functional.one_hot(ids, V).float()
    cudnn = torch.nn.LSTM(V, H).cuda()
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(W_ih.T)
        cudnn.weight_hh_l0.copy_(W_hh.T)
        cudnn.bias_ih_l0.copy_(b)
        cudnn.bias_hh_l0.zero_()
        hc0 = (h[None].contiguous(), c[None].contiguous())
        y_lib, _ = cudnn(x, hc0)
        xws = x @ W_ih
        hh, cc = h, c
        for t in range(T):
            hh, cc = lc.lstm_cell_forward(xws[t], hh, cc, W_hh, b)
        lib_err = float((y_lib[-1] - hh).abs().max())
    gy = torch.randn(y_lib.shape, generator=g, device="cuda")

    def cudnn_fwd():
        return cudnn(x, hc0)

    def cudnn_fwd_bwd():
        cudnn.zero_grad(set_to_none=True)
        y, _ = cudnn(x, hc0)
        torch.autograd.backward(y, gy)

    # the resolution of a timing: a one-element add timed the same way
    one = torch.zeros(1, device="cuda")
    floor_ms = _time_ms(lambda: one.add_(1))
    lib_fwd_ms = _time_ms(cudnn_fwd)
    lib_ms = lib_fwd_ms / T
    lib_bwd_ms = (_time_ms(cudnn_fwd_bwd) - lib_fwd_ms) / T
    _log(f"lstm cell: cuDNN LSTM over T {T} agrees with {T} kernel steps to "
         f"{lib_err:.3e} (last h)")
    if not lib_err <= 1e-4:
        raise AssertionError(f"cuDNN yardstick disagrees: {lib_err}")
    # bytes: each input read once, each output written once (float32;
    # backward: xw, h, c, dh, dc, W_hh, b in; dgates, dc_prev, h1 out);
    # operations: the recurrent product, the gate adds and the pointwise
    # work (forward 4 a (row, unit); backward 30, the recompute included)
    nbytes = 4 * (B * 4 * H + 2 * B * H + H * 4 * H + 4 * H + 2 * B * H)
    flops = 2 * B * H * 4 * H + 2 * B * 4 * H + 4 * B * H
    bound_ms, bound_by = _bound(nbytes, flops)
    bwd_bytes = 4 * (B * 4 * H + 4 * B * H + H * 4 * H + 4 * H
                     + B * 4 * H + B * H + B * (H + 1))
    bwd_flops = 2 * B * H * 4 * H + 2 * B * 4 * H + 30 * B * H
    bwd_bound_ms, bwd_bound_by = _bound(bwd_bytes, bwd_flops)
    blocks = lc.grid_blocks(B, H)
    _log(f"lstm cell training shape (B {B}, H {H}, grid {lc.grid(B, H)}: "
         f"{blocks} blocks of 256 threads), float32: forward kernel "
         f"{ms:.4f} ms, plain "
         f"{plain_ms:.4f} ms, cuDNN LSTM forward / T {lib_ms:.4f} ms, bound "
         f"{bound_ms:.6f} ms ({bound_by}: {nbytes} B, {flops / 1e6:.2f} "
         f"MFLOP)")
    _log(f"lstm cell backward: kernel {bwd_ms:.4f} ms, plain "
         f"{bwd_plain_ms:.4f} ms, whole Function backward {fn_bwd_ms:.4f} "
         f"ms, cuDNN LSTM backward / T {lib_bwd_ms:.4f} ms, bound "
         f"{bwd_bound_ms:.6f} ms ({bwd_bound_by}: {bwd_bytes} B, "
         f"{bwd_flops / 1e6:.2f} MFLOP)")
    _log("lstm cell low precision at the training shape: "
         + json.dumps(low))
    _log(f"timing floor (a one-element add timed the same way): "
         f"{floor_ms:.4f} ms")
    src = "singa_tpu_torch/ops/csrc/lstm_cell.cu"
    fwd_row = {"name": "lstm_cell", "route": "cuda", "source": src,
               "replaces": "singa_tpu/ops/pallas_kernels.py:581",
               "max_abs_err": errs[torch.float32, "train"][0], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms, "blocks": blocks,
               "low_precision": low, "flush_floor_ms": floor_ms}
    bwd_row = {"name": "lstm_cell_bwd", "route": "cuda", "source": src,
               "replaces": "singa_tpu/ops/pallas_kernels.py:655",
               "max_abs_err": errs[torch.float32, "train"][1],
               "ms": bwd_ms, "plain_ms": bwd_plain_ms,
               "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by,
               "library_ms": lib_bwd_ms, "blocks": blocks,
               "function_backward_ms": fn_bwd_ms,
               "function_backward_launches": n_launch}
    return fwd_row, bwd_row


EW_N = RNN_T * RNN_B * 4 * RNN_H      # the char-LSTM's gate tensor size
EW_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# tolerance relative to max(1, |ref|) by output type: float32 as stated;
# bfloat16 and float16 one unit in the last place (both sides compute in
# float32 and round once, so they may fall on either side of a tie)
EW_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7,
          torch.float16: 2.0 ** -10}
EW_SPECIAL = (float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1.0,
              -1.0, 0.5, -0.5, 3.7, -2.25, 1e-3)


def _ew_cases():
    """Every catalogue call the phase makes: ``(label, fn, plain, args,
    out_dtype)`` over every op and dtype pair at the gate size
    (``a`` uniform in (-3, 3), ``b`` of either sign with |b| in
    (0.5, 3)), a ragged length, and the NaN / +-inf / +-0 values (binary
    ops over every pair of them)."""
    g = torch.Generator(device="cuda").manual_seed(6)
    a32 = torch.rand(EW_N, generator=g, device="cuda") * 6 - 3
    b32 = (torch.rand(EW_N, generator=g, device="cuda") * 2.5 + 0.5) \
        * torch.where(torch.rand(EW_N, generator=g, device="cuda") < 0.5,
                      -1.0, 1.0)
    sp = torch.tensor(EW_SPECIAL, device="cuda")
    spa = sp.repeat_interleave(len(EW_SPECIAL))
    spb = sp.repeat(len(EW_SPECIAL))
    ragged = 1_000_003
    for din in EW_DTYPES:
        a, b = a32.to(din), b32.to(din)
        for dout in EW_DTYPES:
            for name in list(ew.EW_UNARY) + ["copy"]:
                yield (f"{name} {din}->{dout}", ew.ew_unary,
                       ew.ew_unary_reference, (name, a), dout)
            for name in ew.EW_BINARY:
                yield (f"{name} {din}->{dout}", ew.ew_binary,
                       ew.ew_binary_reference, (name, a, b), dout)
        yield (f"clamp {din}", ew.clamp, ew.clamp_reference,
               (a, -0.75, 1.5), None)
    for name in list(ew.EW_UNARY) + ["copy"]:
        yield (f"{name} ragged {ragged}", ew.ew_unary, ew.ew_unary_reference,
               (name, a32[:ragged]), None)
        yield (f"{name} special", ew.ew_unary, ew.ew_unary_reference,
               (name, sp), None)
    yield ("copy special ->bf16", ew.ew_unary, ew.ew_unary_reference,
           ("copy", sp), torch.bfloat16)
    yield ("copy special ->f16", ew.ew_unary, ew.ew_unary_reference,
           ("copy", sp), torch.float16)
    for name in ew.EW_BINARY:
        yield (f"{name} ragged {ragged}", ew.ew_binary,
               ew.ew_binary_reference,
               (name, a32[:ragged], b32[:ragged]), None)
        yield (f"{name} special", ew.ew_binary, ew.ew_binary_reference,
               (name, spa, spb), None)
    yield ("clamp special", ew.clamp, ew.clamp_reference, (sp, -0.75, 1.5),
           None)
    # views: alike (4 or 8 values in, on a 16-byte boundary with the fresh
    # output: head, vector body, tail) and different (1-3 values in, off
    # the output's boundary or each other's: element by element)
    a16, b16 = a32[:ragged + 16].to(torch.bfloat16), \
        b32[:ragged + 16].to(torch.float16)
    for off in (4, 8, 1, 2, 3):
        x, y = a32[off:off + ragged], b32[off:off + ragged]
        yd = b32[off + 1:off + 1 + ragged]
        yield (f"exp view +{off}", ew.ew_unary, ew.ew_unary_reference,
               ("exp", x), None)
        yield (f"copy view +{off} ->bf16", ew.ew_unary,
               ew.ew_unary_reference, ("copy", x), torch.bfloat16)
        yield (f"copy bf16 view +{off} ->f32", ew.ew_unary,
               ew.ew_unary_reference, ("copy", a16[off:off + ragged]),
               torch.float32)
        yield (f"add views +{off} +{off}", ew.ew_binary,
               ew.ew_binary_reference, ("add", x, y), None)
        yield (f"div views +{off} +{off + 1}", ew.ew_binary,
               ew.ew_binary_reference, ("div", x, yd), None)
        yield (f"max f16 views +{off} +{off}", ew.ew_binary,
               ew.ew_binary_reference,
               ("max", b16[off:off + ragged], b16[off:off + ragged]),
               torch.bfloat16)
        yield (f"clamp view +{off}", ew.clamp, ew.clamp_reference,
               (x, -0.75, 1.5), None)


def _ew_call(fn, args, out_dtype):
    return fn(*args) if fn in (ew.clamp, ew.clamp_reference) \
        else fn(*args, out_dtype=out_dtype)


def _ew_err(got, ref):
    """``(max |delta|, max |delta| / max(1, |ref|))`` over the entries
    that differ; NaN against NaN and equal values (infinities too) count
    as agreeing, a NaN or infinity on one side only as infinite error."""
    g, r = got.float(), ref.float()
    same = (g == r) | (torch.isnan(g) & torch.isnan(r))
    if bool(same.all()):
        return 0.0, 0.0
    d = (g - r).abs()
    d = torch.where(same, torch.zeros_like(d), d)
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    return float(d.max()), float((d / r.abs().clamp(min=1.0)).max())


def phase_ew():
    """The elementwise catalogue.  Path ``ew``: its own entry points
    (``ew_unary``, ``ew_binary``, ``clamp``) over every op and dtype pair
    at the char-LSTM's gate size, counters zeroed just before and read
    just after.  Then each call again against its plain version (those
    launches are not counted); times of relu, exp, gelu, add, copy to
    bf16 and clamp at the gate size in float32 against the one torch
    call each (bytes: each input read once and the output written once;
    operations: float32 ones a value, gelu's tanh counted as one).
    Returns ``(row, launches)``."""
    _zero_launches()
    for _, fn, _, args, dout in _ew_cases():
        _ew_call(fn, args, dout)
    torch.cuda.synchronize()
    launches = _read_launches()
    _log("ew launches " + json.dumps(launches))
    worst32, worst, n = 0.0, 0.0, 0
    for label, fn, plain, args, dout in _ew_cases():
        got = _ew_call(fn, args, dout)
        ref = _ew_call(plain, args, dout)
        abs_err, rel_err = _ew_err(got, ref)
        tol = EW_TOL[got.dtype]
        if got.dtype != ref.dtype or got.shape != ref.shape \
                or not rel_err <= tol:
            raise AssertionError(f"elementwise {label}: {got.dtype} "
                                 f"{tuple(got.shape)} against {ref.dtype} "
                                 f"{tuple(ref.shape)}, max abs err "
                                 f"{abs_err}, relative {rel_err} (tol "
                                 f"{tol})")
        if got.dtype == torch.float32 and "special" not in label:
            worst32 = max(worst32, abs_err)
        worst = max(worst, rel_err)
        n += 1
    _log(f"elementwise: {n} cases agree with their plain versions; worst "
         f"max abs err {worst32:.3e} over the float32-out cases, worst "
         f"relative {worst:.3e} over all (tol 1e-5 float32, one ulp bf16 / "
         f"f16)")
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand(EW_N, generator=g, device="cuda") * 6 - 3
    y = torch.rand(EW_N, generator=g, device="cuda") * 6 - 3
    F = torch.nn.functional
    timed = {
        "relu": (lambda: ew.ew_unary("relu", x),
                 lambda: ew.ew_unary_reference("relu", x),
                 lambda: torch.relu(x), 8, 1),
        "exp": (lambda: ew.ew_unary("exp", x),
                lambda: ew.ew_unary_reference("exp", x),
                lambda: torch.exp(x), 8, 1),
        "gelu": (lambda: ew.ew_unary("gelu", x),
                 lambda: ew.ew_unary_reference("gelu", x),
                 lambda: F.gelu(x, approximate="tanh"), 8, 9),
        "add": (lambda: ew.ew_binary("add", x, y),
                lambda: ew.ew_binary_reference("add", x, y),
                lambda: torch.add(x, y), 12, 1),
        "copy->bf16": (lambda: ew.ew_unary("copy", x, torch.bfloat16),
                       lambda: ew.ew_unary_reference("copy", x,
                                                     torch.bfloat16),
                       lambda: x.to(torch.bfloat16), 6, 0),
        "clamp": (lambda: ew.clamp(x, -0.75, 1.5),
                  lambda: ew.clamp_reference(x, -0.75, 1.5),
                  lambda: torch.clamp(x, -0.75, 1.5), 8, 2),
    }
    by_op = {}
    for name, (kern, plain, lib, bytes_per, ops_per) in timed.items():
        ms, plain_ms, lib_ms = (_time_ms(f) for f in (kern, plain, lib))
        bound_ms, bound_by = _bound(bytes_per * EW_N, ops_per * EW_N)
        by_op[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by}
        _log(f"elementwise {name} ({EW_N} elements): kernel {ms:.4f} ms, "
             f"plain {plain_ms:.4f} ms, torch {lib_ms:.4f} ms, bound "
             f"{bound_ms:.4f} ms ({bound_by}: {bytes_per * EW_N} B)")
    relu = by_op["relu"]
    return {"name": "elementwise", "route": "cuda",
            "source": "singa_tpu_torch/ops/csrc/elementwise.cu",
            "replaces": "singa_tpu/ops/pallas_kernels.py:486",
            "max_abs_err": worst32, "ms": relu["ms"],
            "plain_ms": relu["plain_ms"], "bound_ms": relu["bound_ms"],
            "bound_by": relu["bound_by"], "library_ms": relu["library_ms"],
            "by_op": by_op}, launches


def _requests(cfg):
    """8 prompts of 100-300 tokens; requests 1 and 6 share a 64-token
    prefix."""
    rng = np.random.RandomState(7)
    lens = rng.randint(100, 301, size=8)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    prompts[6][:64] = prompts[1][:64]
    return prompts


def _prefill_logits(params, cfg, tokens, quant, device):
    """Logits at every position of ``tokens`` from the port's paged
    prefill blocks (one chunk over fresh pages on ``device``), with
    float or int8 ``params`` and pages (int8 rows, bf16 scales)."""
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    T = len(tokens)
    n_pages = -(-T // PAGE)
    shape = (n_pages + 1, H, PAGE, dh)

    def zeros(shp, dt):
        return torch.zeros(shp, dtype=dt, device=device)

    fdt = params["tok"].dtype
    pages = [(zeros(shape, torch.int8), zeros(shape, torch.int8),
              zeros(shape[:3], torch.bfloat16),
              zeros(shape[:3], torch.bfloat16)) if quant
             else (zeros(shape, fdt), zeros(shape, fdt))
             for _ in range(cfg.n_layers)]
    row = torch.arange(1, n_pages + 1, dtype=torch.int32, device=device)
    positions = torch.arange(T, device=device)
    ids = torch.from_numpy(np.asarray(tokens, np.int32)).to(device)[None]
    with torch.no_grad():
        h = tgpt._embed(params, ids, positions, cfg.use_rope)
        for bp, kv in zip(params["blocks"], pages):
            kp, vp, ks, vs = tgpt._layer_kv(kv)
            h = tgpt._block_chunk_prefill_paged(
                bp, h, kp, vp, row, positions, H, 1.0 / np.sqrt(dh),
                cfg.use_rope, cfg.rope_base, k_scale=ks, v_scale=vs)[0]
        return tgpt._logits(params, h)[0]


def _top2_ulps(lg):
    """Top-2 margins of logit rows ``lg`` (..., V) and the unit in the
    last place of each top logit (None for float32 logits)."""
    top = torch.topk(lg, 2, dim=-1).values.float()
    margin = top[..., 0] - top[..., 1]
    if lg.dtype not in LOWP:
        return margin, None
    _, e = torch.frexp(top[..., 0].abs())
    bits = 8 if lg.dtype == torch.bfloat16 else 11
    return margin, torch.pow(2.0, (e - bits).float())


def _cpu_margin(cpu_model, tokens, weight_dtype=None):
    """Top-2 logit margin at the end of ``tokens``, from the port's
    plain path on the CPU (float, or int8 weights and pages; in the
    model's compute dtype), the margin a first difference may have
    (``MARGIN_TOL``, or for 16-bit logits ``LOWP_MARGIN_ULPS`` units in
    the last place of the top logit if that is more), and that unit
    (None for float32 logits)."""
    params = cpu_model.decode_params(weight_dtype)
    lg = _prefill_logits(params, cpu_model.config, tokens,
                         weight_dtype is not None, "cpu")[-1]
    margin, ulp = _top2_ulps(lg)
    tol = MARGIN_TOL
    if ulp is not None:
        ulp = float(ulp)
        tol = max(tol, LOWP_MARGIN_ULPS * ulp)
    return float(margin), tol, ulp


# the sampled requests of the staggered stream (the rest are greedy)
SAMPLED = {3: dict(temperature=0.8, top_k=40, seed=3),
           5: dict(temperature=1.0, seed=5),
           7: dict(temperature=0.7, top_k=8, seed=7)}


def _serve(eng, prompts, deadline_ms=None):
    """The staggered stream: four requests, two steps, four more, run to
    the end; requests 3, 5 and 7 sample (``SAMPLED``), the rest are
    greedy; every request carries ``deadline_ms``.  The steps that admit
    come first (until the queue and the admission lane are empty), then
    the steady state, whose uploads, syncs and horizons are counted.
    Returns ``(rids, results, steady)``."""
    sampling = [dict(SAMPLED.get(i, {}), deadline_ms=deadline_ms)
                for i in range(len(prompts))]
    rids = [eng.submit(p, NEW, **kw_i)
            for p, kw_i in zip(prompts[:4], sampling[:4])]
    eng.step()
    eng.step()
    rids += [eng.submit(p, NEW, **kw_i)
             for p, kw_i in zip(prompts[4:], sampling[4:])]
    while eng.queue or eng._lane is not None:
        eng.step()
    before = eng.metrics.snapshot()
    res = eng.run()
    after = eng.metrics.snapshot()
    return rids, res, {k: after[k] - before[k] for k in (
        "host_uploads", "host_syncs", "horizon_blocks")}


def _check_steady(label, eng, steady):
    """Steady-state decode uploads nothing and fetches once a horizon
    (chunked engines); the monolithic engine uploads its 5 arrays and
    fetches once a step."""
    _log(f"{label} steady state: {json.dumps(steady)}")
    if eng.chunked:
        ok = (steady["host_uploads"] == 0 and steady["horizon_blocks"] > 0
              and steady["host_syncs"] == steady["horizon_blocks"])
    else:
        ok = (steady["host_syncs"] > 0 and steady["host_uploads"]
              == 5 * steady["host_syncs"])
    if not ok:
        raise AssertionError(f"{label}: steady state {steady}")


def _check_graphs(label, eng):
    """The graph pin, as the reference pins its programs: at most 2 keys
    a sampling mode on a chunked engine, 1 on the monolithic one; at
    most one capture a key, and replays; the eager twin captures
    nothing."""
    log, caps, reps = eng.trace_log, eng.graph_captures, eng.graph_replays
    _log(f"{label} graphs: keys {log}, captures {caps}, replays {reps}")
    pin = 2 if eng.chunked else 1
    sampled = [k for k in log if k.endswith(":sampled")]
    if len(sampled) > pin or len(log) - len(sampled) > pin \
            or len(set(log)) != len(log):
        raise AssertionError(f"{label}: graph keys {log} over the pin")
    if not eng._capture:
        if caps or reps:
            raise AssertionError(f"{label}: the eager twin captured {caps}")
        return
    if not 1 <= sum(caps.values()) <= len(log) \
            or sum(reps.values()) <= sum(caps.values()):
        raise AssertionError(f"{label}: captures {caps}, replays {reps}")


def _slice_setup():
    """GPT-2-small widths with seeded weights on the card, the engine
    arguments and the prompts; one short warm-up run (cuBLAS handles,
    allocator) on an engine of its own."""
    cfg = tgpt.GPTConfig.small()
    tree = tgpt.seeded_decode_params(cfg, seed=0)
    model = tgpt.GPT.from_jax_decode_params(tree, cfg)      # on the card
    kw = dict(n_slots=N_SLOTS, page_tokens=PAGE, chunk_tokens=CHUNK,
              decode_horizon=HORIZON)
    prompts = _requests(cfg)
    _warm(model, kw, prompts)
    return cfg, tree, model, kw, prompts


def _warm(model, kw, prompts, device=None):
    warm = ServingEngine(model, device=device, **kw)
    warm.submit(prompts[0][:80], 9)
    warm.run()
    torch.cuda.synchronize()


def _tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _drive(eng, prompts, cfg, label):
    """The serving path once: counts zeroed and peak memory reset just
    before the staggered stream, both read just after.  Checks that
    every request completed with valid tokens.  Returns ``(rids, res,
    launches, stats)``."""
    gc.collect()                    # earlier paths' engines and models
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    rids, res, steady = _serve(eng, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    snap = eng.metrics.snapshot()
    stats = {"wall_s": wall, "tokens_per_s": snap["tokens_per_s"],
             "ttft_p50_ms": snap["ttft_p50_ms"],
             "itl_p50_ms": snap["itl_p50_ms"],
             "itl_p99_ms": snap["itl_p99_ms"],
             "kv_bytes_committed": snap["kv_bytes_committed"],
             "weight_bytes": _tree_bytes(eng.params),
             "peak_memory_bytes": torch.cuda.max_memory_allocated(),
             "graph_captures": dict(eng.graph_captures),
             "graph_replays": dict(eng.graph_replays)}
    _log(f"{label} launches " + json.dumps(launches))
    _log(f"{label}: {len(rids)} requests in {wall:.3f}s; "
         f"ttft_p50_ms {snap['ttft_p50_ms']} itl_p50_ms {snap['itl_p50_ms']}"
         f" itl_p99_ms {snap['itl_p99_ms']} tokens_per_s "
         f"{snap['tokens_per_s']} prefix_cache_hit_rate "
         f"{snap['prefix_cache_hit_rate']} host_syncs_per_token "
         f"{snap['host_syncs_per_token']} uploads_per_token "
         f"{snap['uploads_per_token']} kv_bytes_committed "
         f"{stats['kv_bytes_committed']} weight_bytes "
         f"{stats['weight_bytes']} peak_memory_bytes "
         f"{stats['peak_memory_bytes']}")
    _log(f"{label} metrics " + json.dumps(snap))
    done = sum(r in res for r in rids)
    if done != len(prompts):
        raise AssertionError(f"{label}: {done} of {len(prompts)} "
                             f"requests completed")
    for r in rids:
        toks = res[r]
        if toks.shape != (NEW,) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{label} request {r}: bad tokens {toks}")
    _check_steady(label, eng, steady)
    _check_graphs(label, eng)
    return rids, res, launches, stats


def _eager_twin(label, make, prompts, cfg, rids, res, launches, stats):
    """The path's eager twin: ``make(_capture=False)``, an engine on the
    same weights that runs the same steps without graphs, drives the
    same stream.  Every request's tokens equal the captured engine's
    bit for bit, greedy and sampled; the captured run's credited
    launches equal the twin's.  The two runs' metrics print side by
    side and the twin's land in ``stats["eager"]``."""
    eng = make(_capture=False)
    e_rids, e_res, e_launches, e_stats = _drive(eng, prompts, cfg,
                                                f"{label} eager twin")
    del eng
    same = [bool(np.array_equal(res[a], e_res[b]))
            for a, b in zip(rids, e_rids)]
    _log(f"{label} captured against eager: {sum(same)} of {len(same)} "
         f"requests bit for bit (sampled: {sorted(SAMPLED)}); " + " ".join(
             f"{k} {stats[k]} / {e_stats[k]}" for k in (
                 "tokens_per_s", "ttft_p50_ms", "itl_p50_ms", "itl_p99_ms",
                 "peak_memory_bytes")))
    if not all(same):
        raise AssertionError(f"{label}: captured tokens differ from the "
                             f"eager twin's: {same}")
    if launches != e_launches:
        raise AssertionError(f"{label}: credited launches {launches} differ "
                             f"from the eager twin's {e_launches}")
    stats["eager"] = e_stats
    return e_stats


def _margin_check(label, cpu_model, prompt, a, b, weight_dtype=None):
    """Greedy tokens ``a`` and ``b`` after ``prompt``: identical, or a
    first difference where the CPU's top-2 logit margin is below
    ``MARGIN_TOL``."""
    if np.array_equal(a, b):
        _log(f"{label}: {len(a)} greedy tokens identical")
        return
    j = int(np.flatnonzero(a != b)[0])
    margin, tol, ulp = _cpu_margin(cpu_model,
                                   np.concatenate([prompt, a[:j]]),
                                   weight_dtype)
    in_ulps = "" if ulp is None else f" = {margin / ulp:g} ulp"
    _log(f"{label}: first difference at token {j}, CPU top-2 logit margin "
         f"{margin:.3e}{in_ulps} (limit {tol:.3e})")
    if margin >= tol and margin > 0:
        raise AssertionError(f"{label} differs at token {j} with margin "
                             f"{margin}")


def _cpu_oracle(cpu_model, kw, prompts, res, rids, weight_dtype=None):
    """The prefix-sharing pair of greedy requests through the port on
    the CPU, held to :func:`_margin_check`."""
    torch.set_num_threads(os.cpu_count() or 1)
    qkw = {} if weight_dtype is None else dict(kv_dtype="int8",
                                               weight_dtype=weight_dtype)
    ceng = ServingEngine(cpu_model, device="cpu",
                         **dict(kw, n_slots=2, **qkw))
    pair = [1, 6]
    crids = [ceng.submit(prompts[i], NEW) for i in pair]
    cres = ceng.run()
    tag = "int8 " if weight_dtype else ""
    for i, cr in zip(pair, crids):
        _margin_check(f"{tag}oracle request {i} against the CPU run",
                      cpu_model, prompts[i], res[rids[i]], cres[cr],
                      weight_dtype)


def _sampled_alone(eng, prompts, rids, res, label):
    """Each sampled request of the stream served alone on a fresh
    captured engine gives the tokens it gave in the stream: its k-th
    token takes the k-th draw of its seed's generator, whatever its
    neighbours (every slot of a sampled graph draws)."""
    for i, kw_i in SAMPLED.items():
        rid = eng.submit(prompts[i], NEW, **kw_i)
        got = eng.run()[rid]
        if not np.array_equal(got, res[rids[i]]):
            raise AssertionError(f"{label}: sampled request {i} alone gave "
                                 f"{got}, in the stream {res[rids[i]]}")
    _log(f"{label}: sampled requests {sorted(SAMPLED)} alone give their "
         f"stream tokens (captures {eng.graph_captures}, replays "
         f"{eng.graph_replays})")


def phase_slice():
    """Returns ``(launches, stats, setup)``: ``setup`` carries the
    configuration, the seeded tree, the engine arguments, the prompts,
    the model on the host and this path's tokens to the later serving
    phases."""
    cfg, tree, model, kw, prompts = _slice_setup()
    eng = ServingEngine(model, **kw)
    rids, res, launches, stats = _drive(eng, prompts, cfg, "slice")
    for name in ("flash_attention_fwd", "flash_attention_fwd_combine",
                 "paged_decode_attention",
                 "paged_decode_merge"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the "
                                 f"serving path")
    if eng.metrics.snapshot()["prefix_cache_hit_rate"] <= 0:
        raise AssertionError("the shared 64-token prefix was not reused")
    stats["graph_kernels"] = _serving_graph_kernels(
        eng, "serve", {"unified": CHUNK_KERNELS | PAGED_KERNELS,
                       "horizon": PAGED_KERNELS})
    del eng
    _eager_twin("serve", lambda **k: ServingEngine(model, **kw, **k),
                prompts, cfg, rids, res, launches, stats)
    _sampled_alone(ServingEngine(model, **kw), prompts, rids, res, "serve")
    del model
    cpu_model = tgpt.GPT.from_jax_decode_params(tree, cfg, device="cpu")
    _cpu_oracle(cpu_model, kw, prompts, res, rids)
    return launches, stats, {"cfg": cfg, "tree": tree, "kw": kw,
                             "prompts": prompts, "cpu_model": cpu_model,
                             "rids": rids, "res": res}


def _teacher_forced_drift(cpu_model, qparams, cfg):
    """One 256-token prompt through the prefill blocks on the card,
    float params and pages against int8 ones: logit MAE, max |delta|
    and the log-perplexity drift (the prompt's own next tokens)."""
    tokens = np.random.RandomState(11).randint(
        0, cfg.vocab_size, DRIFT_T).astype(np.int32)
    fparams = _to_device(cpu_model.decode_params(), torch.device("cuda"))
    lf = _prefill_logits(fparams, cfg, tokens, False, "cuda").double()
    lq = _prefill_logits(qparams, cfg, tokens, True, "cuda").double()
    del fparams
    diff = (lq - lf).abs()
    nxt = torch.from_numpy(tokens[1:].astype(np.int64)).cuda()

    def log_ppl(lg):
        lp = torch.log_softmax(lg[:-1], dim=-1)
        return float(-lp.gather(1, nxt[:, None]).mean())

    return {"logit_mae": float(diff.mean()), "logit_max": float(diff.max()),
            "log_ppl_drift": abs(log_ppl(lq) - log_ppl(lf))}


def phase_slice_int8(setup, float_stats):
    """Quantized serving: the same model (seeded weights on the host,
    carried in through ``GPT.from_jax_decode_params``) served from the
    card with int8 KV pages and int8 decode weights, the same staggered
    stream.  Checks: 8/8 complete; the int8 paged decode kernel launched
    and neither float kernel; a fresh engine replays identical tokens
    (greedy and sampled); the pool's bytes are exactly (d_head + 2) /
    (2 d_head) of a bf16-storage engine's; the teacher-forced drift is
    within the reference's committed tolerances; the greedy pair agrees
    with the port on the CPU under the top-2 margin rule."""
    cfg, kw, prompts, cpu_model = (setup[k] for k in ("cfg", "kw", "prompts",
                                                       "cpu_model"))
    qkw = dict(kw, kv_dtype="int8", weight_dtype="int8")
    _warm(cpu_model, qkw, prompts, device="cuda")      # quantizes, memoised
    eng = ServingEngine(cpu_model, device="cuda", **qkw)
    rids, res, launches, stats = _drive(eng, prompts, cfg, "int8 slice")
    for name in ("paged_decode_attention_q8",
                 "paged_decode_merge"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the "
                                 f"quantized serving path")
    for name in ("flash_attention_fwd", "paged_decode_attention"):
        if launches[name] != 0:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"on the quantized path")
    stats["graph_kernels"] = _serving_graph_kernels(
        eng, "serve_int8", {"unified": PAGED_KERNELS,
                            "horizon": PAGED_KERNELS})
    _eager_twin("serve_int8",
                lambda **k: ServingEngine(cpu_model, device="cuda", **qkw,
                                          **k),
                prompts, cfg, rids, res, launches, stats)
    fresh = ServingEngine(cpu_model, device="cuda", **qkw)
    frids, fres, _ = _serve(fresh, prompts)
    same = [bool(np.array_equal(res[a], fres[b]))
            for a, b in zip(rids, frids)]
    _log(f"int8 determinism: a fresh engine replays {sum(same)} of "
         f"{len(same)} requests identically (requests {sorted(SAMPLED)} "
         f"sampled)")
    if not all(same):
        raise AssertionError(f"a fresh int8 engine gave other tokens: "
                             f"{same}")
    del fresh
    dh = cfg.d_model // cfg.n_heads
    b16 = ServingEngine(cpu_model, device="cuda",
                        **dict(kw, kv_dtype="bfloat16"))
    ratio = eng.kv.nbytes() / b16.kv.nbytes()
    del b16
    want = (dh + 2) / (2 * dh)
    f32_ratio = stats["kv_bytes_committed"] / float_stats[
        "kv_bytes_committed"]
    _log(f"int8 pool bytes: {eng.kv.nbytes()} = {ratio} of the bf16 pool "
         f"(want exactly {want}), {f32_ratio} of the float32 slice's "
         f"{float_stats['kv_bytes_committed']}")
    if ratio != want or f32_ratio != (dh + 2) / (4 * dh):
        raise AssertionError(f"int8 pool byte ratio {ratio}, {f32_ratio}")
    drift = _teacher_forced_drift(cpu_model, eng.params, cfg)
    _log(f"int8 drift over a {DRIFT_T}-token prompt: logit MAE "
         f"{drift['logit_mae']:.3e} (tol {LOGIT_MAE_TOL}), max "
         f"{drift['logit_max']:.3e} (tol {LOGIT_MAX_TOL}), log-perplexity "
         f"drift {drift['log_ppl_drift']:.3e} (tol {LOG_PPL_TOL})")
    if not (drift["logit_mae"] <= LOGIT_MAE_TOL
            and drift["logit_max"] <= LOGIT_MAX_TOL
            and drift["log_ppl_drift"] <= LOG_PPL_TOL):
        raise AssertionError(f"int8 drift over tolerance: {drift}")
    _log("serving, float32 vs int8 (this call): tokens/s "
         f"{float_stats['tokens_per_s']} vs {stats['tokens_per_s']}; TTFT "
         f"p50 {float_stats['ttft_p50_ms']} vs {stats['ttft_p50_ms']} ms; "
         f"kv_bytes_committed {float_stats['kv_bytes_committed']} vs "
         f"{stats['kv_bytes_committed']}; decode weight bytes "
         f"{float_stats['weight_bytes']} vs {stats['weight_bytes']}; peak "
         f"memory {float_stats['peak_memory_bytes']} vs "
         f"{stats['peak_memory_bytes']} bytes")
    del eng
    _cpu_oracle(cpu_model, kw, prompts, res, rids, weight_dtype="int8")
    return launches, stats | drift


def _card_model(setup):
    """Phase 6's seeded model on the card (built once, kept in
    ``setup``)."""
    if "model" not in setup:
        setup["model"] = tgpt.GPT.from_jax_decode_params(setup["tree"],
                                                         setup["cfg"])
    return setup["model"]


def _generate_rows(prompts):
    """The first GEN_B of phase 6's prompts with GEN_T tokens or more,
    cut to GEN_T."""
    return [p[:GEN_T] for p in prompts if p.size >= GEN_T][:GEN_B]


def phase_generate(setup):
    """Path ``generate``: ``GPT.generate`` on the card at B 4 (phase 6's
    prompts cut to 200 tokens, a 256-token bucket), 32 new greedy tokens,
    with ``decode_horizon`` None and 8 (the port runs one decode loop
    for either).  Each call launches the flash forward exactly once a
    layer, unsplit (no combine), and nothing else of the port's kernels.
    Checks: the two calls give identical tokens; each row matches the paged engine's
    tokens for its prompt, and two rows replayed through the port on the
    CPU match, under the margin rule."""
    cfg, cpu_model = setup["cfg"], setup["cpu_model"]
    model = _card_model(setup)
    rows = _generate_rows(setup["prompts"])
    batch = np.stack(rows)
    gc.collect()
    torch.cuda.synchronize()
    _zero_launches()
    toks, stats = {}, {}
    for K in (None, HORIZON):
        before = _read_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        toks[K] = model.generate(batch, NEW, decode_horizon=K)
        wall = time.perf_counter() - t0
        after = _read_launches()
        call = {k: after[k] - before[k] for k in after}
        stats[K] = {"wall_s": wall, "tokens_per_s": GEN_B * NEW / wall,
                    "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        _log(f"generate B {GEN_B} T {GEN_T} (bucket "
             f"{tgpt.bucket_length(GEN_T, cfg.max_len)}), {NEW} new, "
             f"decode_horizon {K}: {wall:.3f}s, "
             f"{stats[K]['tokens_per_s']:.1f} tokens/s; launches "
             + json.dumps({k: v for k, v in call.items() if v}))
        want = dict.fromkeys(call, 0) | {"flash_attention_fwd": cfg.n_layers}
        if call != want:
            raise AssertionError(f"generate (decode_horizon {K}) launched "
                                 f"{call}, expected {want}")
        t = toks[K]
        if t.shape != (GEN_B, NEW) or t.min() < 0 or t.max() >= cfg.vocab_size:
            raise AssertionError(f"generate: bad tokens {t}")
    launches = _read_launches()
    if not np.array_equal(toks[None], toks[HORIZON]):
        raise AssertionError("generate: decode_horizon 8 changed the "
                             "tokens")
    _log(f"generate: decode_horizon None and 8 give identical tokens "
         f"({GEN_B} x {NEW})")
    stats["eager"] = _generate_twins("generate", model, batch, toks[None],
                                     stats[HORIZON], 2 * (2 * (NEW - 1) - 1))
    eng = ServingEngine(model, **setup["kw"])
    rids = [eng.submit(r, NEW) for r in rows]
    res = eng.run()
    del eng
    for i, (r, rid) in enumerate(zip(rows, rids)):
        _margin_check(f"generate row {i} against the paged engine",
                      cpu_model, r, toks[None][i], res[rid])
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = cpu_model.generate(batch[:2], NEW)
    _log(f"generate: 2 rows on the CPU in {time.perf_counter() - t0:.1f}s")
    for i in range(2):
        _margin_check(f"generate row {i} against the CPU run", cpu_model,
                      rows[i], toks[None][i], cpu[i])
    return launches, stats


def _generate_twins(label, model, batch, toks, captured, want_replays):
    """``generate``'s decode loop captured against its eager twin
    (``_capture=False``) on one batch: the greedy ``toks`` (its second,
    all-replay call's time and peak memory in ``captured``) and a
    sampled pair of calls (temperature 0.8, top-k 40, seed 11), each bit
    for bit; one graph an entry (B, dtype, greedy or sampled), at most
    ``GEN_CACHE_MAX`` entries, ``want_replays`` replays in all (every
    step after an entry's first two: 2 (NEW - 1) - 1 a key over two
    calls).  Returns the eager twin's stats."""
    def timed(**kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = model.generate(batch, NEW, **kw)
        wall = time.perf_counter() - t0
        return out, {"wall_s": wall, "tokens_per_s": GEN_B * NEW / wall,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated()}

    eager, e_stats = timed(_capture=False)
    samp = dict(temperature=0.8, top_k=40, seed=11)
    s1, _ = timed(**samp)
    s2, s_stats = timed(**samp)
    s_eager, _ = timed(_capture=False, **samp)
    caps, reps = model.graph_captures, model.graph_replays
    keys = [k for k in model._gen_entries if k[1] == GEN_B]
    entry_bytes = sum(t.numel() * t.element_size()
                      for k in keys for layer in model._gen_entries[k].caches
                      for t in layer)
    _log(f"{label} captured against eager: greedy tokens/s "
         f"{captured['tokens_per_s']:.1f} / {e_stats['tokens_per_s']:.1f}, "
         f"peak memory {captured['peak_memory_bytes']} / "
         f"{e_stats['peak_memory_bytes']} bytes; sampled tokens/s "
         f"{s_stats['tokens_per_s']:.1f}; entries {list(model._gen_entries)}"
         f" ({entry_bytes} bytes of static caches at B {GEN_B}); captures "
         f"{caps}, replays {reps}")
    if not (np.array_equal(eager, toks) and np.array_equal(s1, s2)
            and np.array_equal(s1, s_eager)):
        raise AssertionError(f"{label}: captured tokens differ from the "
                             f"eager loop's")
    if np.array_equal(s1, toks):
        raise AssertionError(f"{label}: sampling gave the greedy tokens")
    if len(model._gen_entries) > tgpt.GEN_CACHE_MAX \
            or caps.get("generate") != len(model._gen_entries) \
            or len(keys) != 2 or reps.get("generate") != want_replays:
        raise AssertionError(f"{label}: entries {list(model._gen_entries)}, "
                             f"captures {caps}, replays {reps}")
    e_stats["entry_cache_bytes"] = entry_bytes
    return e_stats


def _greedy_against_serve(setup, label, rids, res):
    """Every greedy request of the stream (all but ``SAMPLED``) against
    phase 6's paged tokens, under the margin rule."""
    for i, p in enumerate(setup["prompts"]):
        if i not in SAMPLED:
            _margin_check(f"{label} request {i} against serve",
                          setup["cpu_model"], p, res[rids[i]],
                          setup["res"][setup["rids"][i]])


def _beside(label, stats, float_stats):
    _log(f"serving, paged vs {label} (this call): tokens/s "
         f"{float_stats['tokens_per_s']} vs {stats['tokens_per_s']}; TTFT "
         f"p50 {float_stats['ttft_p50_ms']} vs {stats['ttft_p50_ms']} ms; "
         f"kv_bytes_committed {float_stats['kv_bytes_committed']} vs "
         f"{stats['kv_bytes_committed']}; peak memory "
         f"{float_stats['peak_memory_bytes']} vs "
         f"{stats['peak_memory_bytes']} bytes")


PAGED_COUNTERS = ("paged_decode_attention", "paged_decode_attention_q8",
                  "paged_decode_merge")


def phase_serve_layout(setup, label, kw, float_stats):
    """Paths ``serve_slot`` (``ServingEngine(paged=False)``, horizon 8:
    the prefill chunks' flash calls take the dense-mask split route,
    decode is the slot einsum) and ``serve_mono`` (``chunked=False,
    paged=False``: one causal flash prefill a request at B 1, 128/256/
    512-token buckets, the causal split route): phase 6's stream through
    the card model after a warm-up run; every greedy request against
    phase 6's tokens; the flash forward and its combine launched, paged
    decode never; metrics beside phase 6's."""
    model = _card_model(setup)
    _warm(model, kw, setup["prompts"])
    eng = ServingEngine(model, **kw)
    rids, res, launches, stats = _drive(eng, setup["prompts"], setup["cfg"],
                                        label)
    if kw.get("chunked", True):
        stats["graph_kernels"] = _serving_graph_kernels(
            eng, label, {"unified": CHUNK_KERNELS})
    del eng
    _eager_twin(label, lambda **k: ServingEngine(model, **kw, **k),
                setup["prompts"], setup["cfg"], rids, res, launches, stats)
    for name in ("flash_attention_fwd", "flash_attention_fwd_combine"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on {label}")
    for name in PAGED_COUNTERS:
        if launches[name] != 0:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"on {label}")
    _greedy_against_serve(setup, label, rids, res)
    _beside(label, stats, float_stats)
    return launches, stats


def phase_serve_slot_int8(setup):
    """Path ``serve_slot_int8``: the stream on the int8 slot layout
    (``kv_dtype="int8", weight_dtype="int8"``, the model on the host and
    the engine on the card).  Checks: 8/8 complete; no flash and no paged
    decode launch (the quantized chunk and slot decode are einsums); a
    fresh engine replays every request; the cache holds exactly (d_head
    + 2) / (2 d_head) of a bf16-storage slot cache's bytes."""
    cfg, kw, prompts, cpu_model = (setup[k] for k in ("cfg", "kw", "prompts",
                                                       "cpu_model"))
    qkw = dict(kw, paged=False, kv_dtype="int8", weight_dtype="int8")
    _warm(cpu_model, qkw, prompts, device="cuda")
    eng = ServingEngine(cpu_model, device="cuda", **qkw)
    rids, res, launches, stats = _drive(eng, prompts, cfg, "serve_slot_int8")
    for name, n in launches.items():
        if n != 0:
            raise AssertionError(f"{name} launched {n} times on the int8 "
                                 f"slot path")
    _eager_twin("serve_slot_int8",
                lambda **k: ServingEngine(cpu_model, device="cuda", **qkw,
                                          **k),
                prompts, cfg, rids, res, launches, stats)
    fresh = ServingEngine(cpu_model, device="cuda", **qkw)
    frids, fres, _ = _serve(fresh, prompts)
    del fresh
    same = [bool(np.array_equal(res[a], fres[b])) for a, b in zip(rids, frids)]
    _log(f"serve_slot_int8 determinism: a fresh engine replays {sum(same)} "
         f"of {len(same)} requests identically (requests {sorted(SAMPLED)} "
         f"sampled)")
    if not all(same):
        raise AssertionError(f"a fresh int8 slot engine gave other tokens: "
                             f"{same}")
    dh = cfg.d_model // cfg.n_heads
    b16 = ServingEngine(cpu_model, device="cuda",
                        **dict(kw, paged=False, kv_dtype="bfloat16"))
    ratio = eng.kv.nbytes() / b16.kv.nbytes()
    del b16, eng
    _log(f"serve_slot_int8 cache bytes: {stats['kv_bytes_committed']} = "
         f"{ratio} of the bf16 slot cache (want exactly "
         f"{(dh + 2) / (2 * dh)})")
    if ratio != (dh + 2) / (2 * dh):
        raise AssertionError(f"int8 slot cache byte ratio {ratio}")
    return launches, stats


# the preemption path: two low-priority requests, then a high-priority
# one that cannot be admitted beside them (prompts of phase 6's stream,
# all greedy there)
PRE_LO, PRE_HI = (0, 2), 4
# the sampled case's draws
PRE_SAMPLED = dict(temperature=0.8, top_k=40)


def _pre_pages(kw, prompts):
    """``kv_pages`` that holds both low-priority requests and less than
    the high-priority one beside them: page pressure."""
    P = kw["page_tokens"]
    need = [-(-(prompts[i].size + NEW) // P) for i in PRE_LO + (PRE_HI,)]
    return 1 + need[0] + need[1] + (need[2] - 1)     # page 0 reserved


def _pre_drive(eng, prompts, sampling, cancel=False):
    """The preemption stream on ``eng``: the two low-priority requests
    until both have a token, then the high-priority one (with
    ``cancel``: the first low-priority request cancelled live first, the
    high-priority one then taking its slot and pages, at priority 0);
    every (re-)admission driven out, then the tail run on its own.
    Returns the rids, the results and the run's figures: wall time, the
    preempting step's and the restore's wall ms, the restore's prompt
    and cached tokens, the tail's uploads and the launch counts at the
    restore's start."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(prompts[i], NEW, **sampling[i]) for i in PRE_LO]
    while not all(eng.requests[r].tokens for r in rids):
        eng.step()
    st = {}
    if cancel:
        victim = eng.requests[rids[0]]
        slot = eng._slot_req.index(victim)
        st["cancelled_tokens"] = len(victim.tokens)
        if not eng.cancel(rids[0]):
            raise AssertionError("preempt cancel: cancel of a live request "
                                 "returned False")
        eng.step()
        st["killed_slot_active"] = bool(eng._dstate["active"][slot])
    rids.append(eng.submit(prompts[PRE_HI], NEW,
                           priority=0 if cancel else 1,
                           **sampling[PRE_HI]))
    mark = t_rs = None
    victim = eng.requests[rids[1]]
    while eng.queue or eng._lane is not None:
        p0, r0 = eng.metrics.preemptions, eng.metrics.restores
        hits = eng.metrics._prefix_hit_tokens
        before = _read_launches()
        ts = time.perf_counter()
        eng.step()
        te = time.perf_counter()
        if eng.metrics.preemptions > p0:
            st["preempt_step_ms"] = (te - ts) * 1e3
            st["restore_tokens"] = victim.prompt.size + len(victim.tokens)
        if eng.metrics.restores > r0:
            mark, t_rs = before, ts
            st["restore_cached"] = eng.metrics._prefix_hit_tokens - hits
        if t_rs is not None and "restore_ms" not in st \
                and eng._lane is None:
            st["restore_ms"] = (te - t_rs) * 1e3
    up0 = eng.metrics.host_uploads
    res = eng.run()
    torch.cuda.synchronize()
    st["wall_s"] = time.perf_counter() - t0
    st["tail_uploads"] = eng.metrics.host_uploads - up0
    st["restore_start_launches"] = mark
    return rids, res, st


def phase_preempt_alone():
    """Path ``preempt`` on its own (``--preempt``): phase 6's seeded
    model, engine arguments and prompts, then phase 7g."""
    cfg, tree, model, kw, prompts = _slice_setup()
    del model
    cpu_model = tgpt.GPT.from_jax_decode_params(tree, cfg, device="cpu")
    phase_preempt({"cfg": cfg, "tree": tree, "kw": kw, "prompts": prompts,
                   "cpu_model": cpu_model})


def phase_preempt(setup):
    """Path ``preempt``: preemption with restore and cancel on the card,
    GPT-2-small with phase 6's seeded weights, each case captured on an
    engine with ``preemption=True`` beside the same requests on a roomy
    engine that never preempts (the uninterrupted run): page pressure on
    float32 pages (``kv_pages`` fits both low-priority requests and not
    the high-priority one), slot scarcity on slots (2 slots), page
    pressure on int8 pages, page pressure with every request sampled,
    and a cancel of a live slot whose slot and pages the next request
    takes.  Checks: one preemption a case, the victim PREEMPTED_RESTORED
    and each kill one kill upload; sampled tokens identical to the
    uninterrupted run's, greedy ones under the margin rule and the
    victim's against the port on the CPU;
    no graph key the uninterrupted run does not use, one capture a key
    at most; nothing uploaded after the last re-admission; from the
    restore's start on, the flash forward (the restore's chunks) and
    paged decode launched on the float pages, the int8 variant on int8
    pages; the cancelled request emits nothing more and its slot is
    inactive on the card after the next step."""
    cfg, prompts, cpu_model = setup["cfg"], setup["prompts"], \
        setup["cpu_model"]
    model = _card_model(setup)
    base = dict(page_tokens=PAGE, chunk_tokens=CHUNK, decode_horizon=HORIZON)
    tight = _pre_pages(base, prompts)
    greedy = {i: {} for i in PRE_LO + (PRE_HI,)}
    sampled = {i: dict(PRE_SAMPLED, seed=20 + i) for i in greedy}
    cases = [("pages", dict(base, n_slots=4, kv_pages=tight), greedy),
             ("slots", dict(base, n_slots=2, paged=False), greedy),
             ("pages_int8", dict(base, n_slots=4, kv_pages=tight,
                                 kv_dtype="int8"), greedy),
             ("sampled", dict(base, n_slots=4, kv_pages=tight), sampled),
             ("cancel", dict(base, n_slots=2), greedy)]
    t_phase = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    victim_cpu = cpu_model.generate(prompts[PRE_LO[1]][None], NEW)[0]
    t_cpu = time.perf_counter() - t_phase
    gc.collect()
    total = dict.fromkeys(_read_launches(), 0)
    stats = {}
    for label, kw, sampling in cases:
        cancel = label == "cancel"
        # the uninterrupted run: a roomy pool, a slot for each request
        ref_kw = {k: v for k, v in kw.items() if k != "kv_pages"}
        if not cancel:
            ref_kw["n_slots"] = 4
        ref = ServingEngine(model, **ref_kw)
        t0 = time.perf_counter()
        if cancel:
            r = ref.submit(prompts[PRE_HI], NEW, **sampling[PRE_HI])
            want = [None, None, ref.run()[r]]
        else:
            rr = [ref.submit(prompts[i], NEW, **sampling[i])
                  for i in PRE_LO + (PRE_HI,)]
            out = ref.run()
            want = [out[r] for r in rr]
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t0
        eng = ServingEngine(model, preemption=not cancel, **kw)
        _zero_launches()
        rids, res, st = _pre_drive(eng, prompts, sampling, cancel)
        end = _read_launches()
        for k in total:
            total[k] += end[k]
        snap = eng.metrics.snapshot()
        st.update(ref_wall_s=ref_wall, **{k: snap[k] for k in (
            "preemption_count", "restore_count", "host_kill_uploads",
            "preempted_restored_count", "cancelled_count")},
            graph_captures=dict(eng.graph_captures),
            ref_graph_captures=dict(ref.graph_captures))
        mark = st.pop("restore_start_launches")
        if mark is not None:
            st["restore_launches"] = {k: end[k] - mark[k] for k in end
                                      if end[k] != mark[k]}
        stats[label] = st
        _log(f"preempt {label}: " + json.dumps(st))
        _check_graphs(f"preempt {label}", eng)
        if not set(eng.trace_log) <= set(ref.trace_log):
            raise AssertionError(f"preempt {label}: keys {eng.trace_log} "
                                 f"beyond the uninterrupted run's "
                                 f"{ref.trace_log}")
        if st["tail_uploads"] != 0:
            raise AssertionError(f"preempt {label}: {st['tail_uploads']} "
                                 f"uploads after the last re-admission")
        if cancel:
            if (st["cancelled_count"] != 1 or st["host_kill_uploads"] != 1
                    or st["killed_slot_active"]
                    or len(eng.requests[rids[0]].tokens)
                    != st["cancelled_tokens"] or rids[0] in res):
                raise AssertionError(f"preempt cancel: {st}")
        else:
            status = eng.statuses()
            if (st["preemption_count"] != 1 or st["restore_count"] != 1
                    or st["host_kill_uploads"] != 1
                    or status[rids[1]] != "PREEMPTED_RESTORED"
                    or "restore_ms" not in st):
                raise AssertionError(f"preempt {label}: {st}, {status}")
            rl = st["restore_launches"]
            need = (("paged_decode_attention_q8",) if label == "pages_int8"
                    else ("paged_decode_attention", "flash_attention_fwd")
                    if label != "slots" else ("flash_attention_fwd",))
            for name in need:
                if rl.get(name, 0) <= 0:
                    raise AssertionError(f"preempt {label}: {name} did not "
                                         f"launch on the restore: {rl}")
        for j, (r, w) in enumerate(zip(rids, want)):
            if w is None:
                continue
            got = res[r]
            if sampling is sampled:
                if not np.array_equal(got, w):
                    raise AssertionError(
                        f"preempt {label} request {j}: sampled tokens "
                        f"{got} against the uninterrupted {w}")
            else:
                i = (PRE_LO + (PRE_HI,))[j]
                _margin_check(f"preempt {label} request {j} against the "
                              f"uninterrupted run", cpu_model, prompts[i],
                              got, w)
        if sampling is sampled:
            _log(f"preempt {label}: 3 sampled requests identical to the "
                 f"uninterrupted run")
        if label in ("pages", "slots"):
            _margin_check(f"preempt {label} victim against the CPU",
                          cpu_model, prompts[PRE_LO[1]], res[rids[1]],
                          victim_cpu)
        del eng, ref
    _log(f"preempt phase (7g): {time.perf_counter() - t_phase:.1f}s (the "
         f"victim on the CPU {t_cpu:.1f}s); launches "
         + json.dumps({k: v for k, v in total.items() if v}))
    return total, stats


# the admission path: the requests of each case (indices into phase 6's
# prompts, all greedy); ADM_LIVE's third is evicted live and ADM_NEXT
# takes its slot and pages, ADM_EVAC's first two share a 64-token prefix
ADM_LIVE, ADM_NEXT = (2, 7, 3), 4
ADM_EVAC = (1, 6, 2, 3)
ADM_WEDGED, ADM_AFTER = 1, 2        # 296 tokens: five 64-token chunks


class AdmClock:
    """The metrics clock of the admission path: moved by hand, and with
    ``jump`` set moved on by ``jump`` seconds at every read."""

    def __init__(self):
        self.t = 0.0
        self.jump = 0.0

    def __call__(self):
        self.t += self.jump
        return self.t


def _adm_ref(model, kw, prompts, idx):
    """The uninterrupted run: ``idx``'s prompts, greedy, NEW tokens each,
    on a fresh engine with ``kw``.  Returns ``(tokens, engine)``."""
    ref = ServingEngine(model, **kw)
    rids = [ref.submit(prompts[i], NEW) for i in idx]
    res = ref.run()
    torch.cuda.synchronize()
    return [res[r] for r in rids], ref


def _adm_same(label, cpu_model, prompts, idx, got, want, path="admission"):
    for i, a, b in zip(idx, got, want):
        _margin_check(f"{path} {label} request {i} against the "
                      f"uninterrupted run", cpu_model, prompts[i], a, b)


def _adm_until_admitted(eng):
    """Step until the queue and the admission lane are empty."""
    while eng.queue or eng._lane is not None:
        eng.step()


def _adm_deadline_live(model, cpu_model, prompts, kw, label):
    """Three greedy requests, the second with a 50 ms deadline, all live
    and in steady-state horizons; the clock moves 1 s and a fourth
    request, waiting for a slot (and on pages for the pages), is
    admitted into the evicted request's slot and pages.  Returns the
    case's figures."""
    idx = ADM_LIVE + (ADM_NEXT,)
    want, ref = _adm_ref(model, dict(kw, kv_pages=None), prompts, idx)
    clk = AdmClock()
    eng = ServingEngine(model, clock=clk, **kw)
    _zero_launches()
    rids = [eng.submit(prompts[i], NEW,
                       deadline_ms=50.0 if i == ADM_LIVE[1] else None)
            for i in ADM_LIVE]
    while not all(eng.requests[r].tokens for r in rids):
        eng.step()
    for _ in range(2):
        eng.step()
    victim = eng.requests[rids[1]]
    slot = eng._slot_req.index(victim)
    pages = set(eng.kv.table_row(slot).tolist()) - {0} if eng.paged \
        else set()
    clk.t += 1.0
    rids.append(eng.submit(prompts[ADM_NEXT], NEW))
    t0 = time.perf_counter()
    eng.step()                      # drain, sweep, kill, first chunk
    evict_ms = (time.perf_counter() - t0) * 1e3
    killed = not bool(eng._dstate["active"][slot])
    _adm_until_admitted(eng)
    nxt = eng.requests[rids[3]]
    taken = (eng._slot_req[slot] is nxt,
             len(pages & set(eng.kv.table_row(slot).tolist()))
             if eng.paged else 0)
    up0 = eng.metrics.host_uploads
    res = eng.run()
    torch.cuda.synchronize()
    st = {"evict_step_ms": evict_ms,
          "tail_uploads": eng.metrics.host_uploads - up0,
          "host_kill_uploads": eng.metrics.host_kill_uploads,
          "evicted_tokens": len(victim.tokens),
          "next_owner_in_slot": taken[0],
          "next_owner_pages_of_evicted": taken[1],
          "graph_captures": dict(eng.graph_captures),
          "ref_graph_captures": dict(ref.graph_captures),
          "statuses": [eng.requests[r].status.value for r in rids],
          "cause": eng.postmortem(rids[1])["cause"]}
    _log(f"admission {label}: " + json.dumps(st))
    if (st["statuses"] != ["COMPLETED", "EVICTED_DEADLINE", "COMPLETED",
                           "COMPLETED"]
            or st["cause"] != "deadline exceeded while decoding "
                              "(overdue 950.0ms)"
            or st["host_kill_uploads"] != 1 or st["tail_uploads"] != 0
            or not killed or rids[1] in res or not taken[0]
            or (eng.paged and taken[1] < 1)
            or st["graph_captures"] != st["ref_graph_captures"]):
        raise AssertionError(f"admission {label}: {st}")
    if not set(eng.trace_log) <= set(ref.trace_log):
        raise AssertionError(f"admission {label}: keys {eng.trace_log} "
                             f"beyond the uninterrupted run's "
                             f"{ref.trace_log}")
    keep = [0, 2, 3]
    _adm_same(label, cpu_model, prompts, [idx[j] for j in keep],
              [res[rids[j]] for j in keep], [want[j] for j in keep])
    if not np.array_equal(victim.tokens, want[1][:len(victim.tokens)]):
        _margin_check(f"admission {label} evicted request's tokens",
                      cpu_model, prompts[ADM_LIVE[1]],
                      np.asarray(victim.tokens),
                      want[1][:len(victim.tokens)])
    return st


def _adm_queued_prefill(model, cpu_model, prompts, kw):
    """One slot: a request overdue while queued behind a live one, then
    the 296-token prompt overdue after its first chunk, then a request
    served after both."""
    want, _ = _adm_ref(model, dict(kw, n_slots=1), prompts,
                       (ADM_LIVE[0], ADM_AFTER))
    clk = AdmClock()
    eng = ServingEngine(model, clock=clk, **dict(kw, n_slots=1))
    _zero_launches()
    ra = eng.submit(prompts[ADM_LIVE[0]], NEW)
    rq = eng.submit(prompts[ADM_LIVE[1]], NEW, deadline_ms=50.0)
    while not eng.requests[ra].tokens:
        eng.step()
    clk.t += 1.0
    eng.run()
    rp = eng.submit(prompts[ADM_WEDGED], NEW, deadline_ms=50.0)
    eng.step()
    in_lane = eng._lane is not None and eng._lane.req.rid == rp
    clk.t += 1.0
    eng.step()
    rz = eng.submit(prompts[ADM_AFTER], NEW)
    res = eng.run()
    torch.cuda.synchronize()
    st = {"statuses": [eng.requests[r].status.value
                       for r in (ra, rq, rp, rz)],
          "causes": [eng.postmortem(r)["cause"] for r in (rq, rp)],
          "tokens": [len(eng.requests[r].tokens) for r in (rq, rp)],
          "host_kill_uploads": eng.metrics.host_kill_uploads,
          "in_lane": in_lane}
    _log("admission queued_prefill: " + json.dumps(st))
    if (st["statuses"] != ["COMPLETED", "EVICTED_DEADLINE",
                           "EVICTED_DEADLINE", "COMPLETED"]
            or st["causes"] != [
                "deadline exceeded while queued (overdue 950.0ms)",
                "deadline exceeded while in prefill (overdue 950.0ms)"]
            or st["tokens"] != [0, 0] or st["host_kill_uploads"] != 0
            or not in_lane):
        raise AssertionError(f"admission queued_prefill: {st}")
    _adm_same("queued_prefill", cpu_model, prompts,
              (ADM_LIVE[0], ADM_AFTER), [res[ra], res[rz]], want)
    return st


def _adm_shed(model, cpu_model, prompts, kw):
    """The reference's bounded-queue flow at ``max_queue=2`` on one
    slot: the third arrival refused, a higher-priority fourth shedding
    the newest low-priority request."""
    idx = (ADM_LIVE[0], ADM_LIVE[2])
    want, _ = _adm_ref(model, dict(kw, n_slots=1), prompts, idx)
    eng = ServingEngine(model, max_queue=2, **dict(kw, n_slots=1))
    _zero_launches()
    a = eng.submit(prompts[idx[0]], NEW)
    b = eng.submit(prompts[ADM_LIVE[1]], NEW)
    c = eng.submit(prompts[ADM_LIVE[1]], NEW)
    d = eng.submit(prompts[idx[1]], NEW, priority=1)
    res = eng.run()
    torch.cuda.synchronize()
    rej = (b, c)
    st = {"statuses": [eng.requests[r].status.value for r in (a, b, c, d)],
          "causes": [eng.postmortem(r)["cause"] for r in rej],
          "tokens": [len(eng.requests[r].tokens) for r in rej],
          "rejected_count": eng.metrics.snapshot()["rejected_count"]}
    _log("admission max_queue: " + json.dumps(st))
    if (st["statuses"] != ["COMPLETED", "REJECTED", "REJECTED",
                           "COMPLETED"]
            or st["causes"] != [f"admission overload: shed for "
                                f"higher-priority rid{d}",
                                "admission overload: queue full"]
            or st["tokens"] != [0, 0] or st["rejected_count"] != 2):
        raise AssertionError(f"admission max_queue: {st}")
    _adm_same("max_queue", cpu_model, prompts, idx, [res[a], res[d]], want)
    return st


def _adm_watchdog(model, cpu_model, prompts, kw):
    """``step_budget_ms=5`` on a clock that moves 10 ms at every read:
    the 296-token prompt's admission (five chunks) is struck at every
    step and ends FAILED at its fourth strike; then, the clock still,
    the next request is served."""
    want, _ = _adm_ref(model, kw, prompts, (ADM_AFTER,))
    clk = AdmClock()
    eng = ServingEngine(model, clock=clk, step_budget_ms=5.0, **kw)
    _zero_launches()
    clk.jump = 0.01
    rw = eng.submit(prompts[ADM_WEDGED], NEW)
    steps = 0
    while eng.requests[rw].status.value in ("QUEUED", "RUNNING"):
        eng.step()
        steps += 1
        if steps > 8:
            break
    clk.jump = 0.0
    rz = eng.submit(prompts[ADM_AFTER], NEW)
    res = eng.run()
    torch.cuda.synchronize()
    st = {"status": eng.requests[rw].status.value, "steps": steps,
          "strikes": eng.requests[rw].slow_strikes,
          "cause": eng.postmortem(rw)["cause"],
          "slow_steps": eng.metrics.slow_steps}
    _log("admission watchdog: " + json.dumps(st))
    if (st["status"] != "FAILED" or steps != 4 or st["strikes"] != 4
            or st["cause"] != "stall watchdog: 4 steps over the 5ms budget"
            or rw in res):
        raise AssertionError(f"admission watchdog: {st}")
    _adm_same("watchdog", cpu_model, prompts, (ADM_AFTER,), [res[rz]], want)
    return st


def _adm_evacuate(model, cpu_model, prompts, kw, label):
    """Engine A: ADM_EVAC's four requests live, two horizons, then
    ``evacuate()``; engine B adopts each stranded request (a restore of
    its prompt and emitted tokens through the chunked prefill) and runs
    to the end.  Returns the case's figures."""
    want, ref = _adm_ref(model, kw, prompts, ADM_EVAC)
    a = ServingEngine(model, **kw)
    _zero_launches()
    rids = [a.submit(prompts[i], NEW) for i in ADM_EVAC]
    while not all(a.requests[r].tokens for r in rids):
        a.step()
    for _ in range(2):
        a.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stranded = a.evacuate()
    evac_ms = (time.perf_counter() - t0) * 1e3
    emitted = [len(r.tokens) for r in stranded]
    records = [a.postmortem(r)["status"] for r in rids]
    b = ServingEngine(model, **kw)
    mark = _read_launches()
    t0 = time.perf_counter()
    new = [b.adopt(r) for r in stranded]
    _adm_until_admitted(b)
    torch.cuda.synchronize()
    adopt_ms = (time.perf_counter() - t0) * 1e3
    restore = {k: v - mark[k] for k, v in _read_launches().items()
               if v != mark[k]}
    up0 = b.metrics.host_uploads
    res = b.run()
    torch.cuda.synchronize()
    del a
    st = {"evacuate_ms": evac_ms, "adopt_to_commit_ms": adopt_ms,
          "emitted": emitted,
          "restore_tokens": sum(p.size for p in (prompts[i]
                                                 for i in ADM_EVAC))
          + sum(emitted),
          "restore_cached": b.metrics._prefix_hit_tokens,
          "restore_count": b.metrics.restores,
          "tail_uploads": b.metrics.host_uploads - up0,
          "records": records,
          "statuses": [b.requests[r].status.value for r in new],
          "restore_launches": restore,
          "graph_captures": dict(b.graph_captures),
          "ref_graph_captures": dict(ref.graph_captures)}
    _log(f"admission {label}: " + json.dumps(st))
    # the int8 chunk prefill attends through the reference's einsum
    need = (("paged_decode_attention_q8", "paged_decode_merge")
            if kw.get("kv_dtype") else
            ("paged_decode_attention", "paged_decode_merge",
             "flash_attention_fwd", "flash_attention_fwd_combine"))
    if (set(records) != {"REROUTED"} or min(emitted) < 1
            or st["statuses"] != ["PREEMPTED_RESTORED"] * 4
            or st["restore_count"] != 4 or st["tail_uploads"] != 0
            or any(restore.get(k, 0) <= 0 for k in need)):
        raise AssertionError(f"admission {label}: {st}")
    if not set(b.trace_log) <= set(ref.trace_log):
        raise AssertionError(f"admission {label}: keys {b.trace_log} "
                             f"beyond the uninterrupted run's "
                             f"{ref.trace_log}")
    _adm_same(label, cpu_model, prompts, ADM_EVAC, [res[r] for r in new],
              want)
    return st


def _timed_probe(eng, name, acc):
    """Wrap ``eng``'s method ``name`` on the instance: ``acc`` gains its
    calls and host seconds."""
    fn = getattr(eng, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            acc[name + "_calls"] += 1
            acc[name + "_ms"] += (time.perf_counter() - t0) * 1e3
    setattr(eng, name, timed)


def _adm_far(model, prompts, kw):
    """Phase 6's eight-request stream on two fresh engines, without
    deadlines and with a 1e6 ms one on every request: the same tokens,
    horizons, steps and captures.  The deadlines' host cost is timed
    where it is paid: the horizon gate's probe ``_deadline_overdue``
    and the sweep, summed over the run's steps.  The ITL p50 of both
    runs is printed too; it is 0 where most gaps fall inside a horizon,
    whose tokens share one emission time."""
    runs = []
    probe = {}
    _zero_launches()
    for dl in (None, 1e6):
        eng = ServingEngine(model, **kw)
        if dl is not None:
            probe = dict.fromkeys(("_deadline_overdue_calls",
                                   "_deadline_overdue_ms",
                                   "_sweep_deadlines_calls",
                                   "_sweep_deadlines_ms"), 0)
            _timed_probe(eng, "_deadline_overdue", probe)
            _timed_probe(eng, "_sweep_deadlines", probe)
        rids, res, steady = _serve(eng, prompts, deadline_ms=dl)
        torch.cuda.synchronize()
        snap = eng.metrics.snapshot()
        runs.append(([res[r] for r in rids], dict(eng.graph_captures),
                     eng.trace_log, steady, snap))
        del eng
    st = {k: [r[4][k] for r in runs] for k in (
        "itl_p50_ms", "steps", "horizon_blocks", "deadline_requests",
        "evicted_deadline_count")}
    st["deadline_ms"] = [None, 1e6]
    st["steady"] = runs[0][3]
    st.update(probe)
    st["probe_ms_per_step"] = ((probe["_deadline_overdue_ms"]
                                + probe["_sweep_deadlines_ms"])
                               / runs[1][4]["steps"])
    _log("admission deadline_far: " + json.dumps(st))
    (t0, c0, k0, s0, n0), (t1, c1, k1, s1, n1) = runs
    if (not all(np.array_equal(a, b) for a, b in zip(t0, t1))
            or c0 != c1 or k0 != k1 or s0 != s1
            or n0["steps"] != n1["steps"]
            or n0["horizon_blocks"] != n1["horizon_blocks"]):
        raise AssertionError(f"admission deadline_far: {st}")
    if (st["deadline_requests"] != [0, len(prompts)]
            or any(st["evicted_deadline_count"])
            or not probe["_sweep_deadlines_calls"]):
        raise AssertionError(f"admission deadline_far: {st}")
    return st


def phase_admission_alone():
    """Path ``admission`` on its own (``--admission``): phase 6's seeded
    model, engine arguments and prompts, then phase 7h."""
    cfg, tree, model, kw, prompts = _slice_setup()
    del model
    cpu_model = tgpt.GPT.from_jax_decode_params(tree, cfg, device="cpu")
    phase_admission({"cfg": cfg, "tree": tree, "kw": kw,
                     "prompts": prompts, "cpu_model": cpu_model})


def phase_admission(setup):
    """Path ``admission``: deadlines, the bounded queue, the step-budget
    watchdog and evacuate/adopt on the card, GPT-2-small with phase 6's
    seeded weights, captured, each case on a fresh engine beside the
    same requests on an uninterrupted one, an injected clock moved by
    the phase: a deadline while decoding on float32 pages (a pool that
    the evicted request's pages complete for the next owner) and on
    slots; a deadline while queued and one in prefill; ``max_queue=2``
    shedding; the watchdog; evacuate and adopt on float32 and int8
    pages; deadlines armed but far on phase 6's stream.  Greedy tokens
    under the margin rule against the uninterrupted run; statuses and
    causes the reference's; one kill upload a live eviction and none
    after the last admission; no graph key beyond the uninterrupted
    run's; from the adopter's first restore on, the flash forward, its
    combine and paged decode (int8 on int8 pages) launched."""
    prompts, cpu_model = setup["prompts"], setup["cpu_model"]
    model = _card_model(setup)
    base = dict(n_slots=3, page_tokens=PAGE, chunk_tokens=CHUNK,
                decode_horizon=HORIZON)
    need = [-(-(prompts[i].size + NEW) // PAGE) for i in ADM_LIVE]
    tight = dict(base, kv_pages=1 + sum(need), prefix_cache=False)
    t_phase = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    gc.collect()
    total = dict.fromkeys(_read_launches(), 0)
    stats = {}
    cases = [
        ("deadline_pages", lambda: _adm_deadline_live(
            model, cpu_model, prompts, tight, "deadline_pages")),
        ("deadline_slots", lambda: _adm_deadline_live(
            model, cpu_model, prompts, dict(base, paged=False),
            "deadline_slots")),
        ("queued_prefill", lambda: _adm_queued_prefill(
            model, cpu_model, prompts, base)),
        ("max_queue", lambda: _adm_shed(model, cpu_model, prompts, base)),
        ("watchdog", lambda: _adm_watchdog(model, cpu_model, prompts,
                                           base)),
        ("evacuate_pages", lambda: _adm_evacuate(
            model, cpu_model, prompts, dict(base, n_slots=4),
            "evacuate_pages")),
        ("evacuate_int8", lambda: _adm_evacuate(
            model, cpu_model, prompts, dict(base, n_slots=4,
                                            kv_dtype="int8"),
            "evacuate_int8")),
        ("deadline_far", lambda: _adm_far(model, prompts, setup["kw"]))]
    for label, case in cases:
        t0 = time.perf_counter()
        stats[label] = case()
        stats[label]["case_s"] = time.perf_counter() - t0
        end = _read_launches()
        for k in total:
            total[k] += end[k]
        gc.collect()
    _log(f"admission phase (7h): {time.perf_counter() - t_phase:.1f}s; "
         f"launches " + json.dumps({k: v for k, v in total.items() if v}))
    return total, stats


# the telemetry path: case 2's victim (ADM_LIVE[1]) fails at token
# TEL_NAN_AT, the third of the first horizon block it is in (its prefill
# gives token 0, the unified steps of the next prefill 1-3), while the
# other two are live; TEL_DROP_AT is the token whose delivery case 5
# drops
TEL_NAN_AT, TEL_DROP_AT = 6, 5


def _tel_counted(tr):
    """Wrap ``tr``'s recording methods on the instance: the returned dict
    gains their calls and host seconds."""
    acc = {"tracer_calls": 0, "tracer_s": 0.0}
    for name in ("span", "instant"):
        fn = getattr(tr, name)

        def timed(*a, _fn=fn, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                acc["tracer_calls"] += 1
                acc["tracer_s"] += time.perf_counter() - t0
        setattr(tr, name, timed)
    return acc


def _tel_stream(eng, prompts):
    """Phase 6's stream once on ``eng``, counted from drained mirrors (a
    run can end with a no-op horizon block in flight): ``(tokens, uploads,
    syncs, steady step host ms, steps)``.  A steady step is one after
    the last admission; its host ms is ``step()``'s wall time."""
    eng._drain_horizon()
    torch.cuda.synchronize()
    up, sy = eng.metrics.host_uploads, eng.metrics.host_syncs
    step, steady = eng.step, []

    def timed():
        admitting = bool(eng.queue) or eng._lane is not None
        t0 = time.perf_counter()
        out = step()
        if not admitting:
            steady.append((time.perf_counter() - t0) * 1e3)
        return out
    eng.step = timed
    try:
        rids, res, _ = _serve(eng, prompts)
    finally:
        del eng.step
    torch.cuda.synchronize()
    return ([res[r] for r in rids], eng.metrics.host_uploads - up,
            eng.metrics.host_syncs - sy, steady)


def _tel_traced(model, prompts, kw):
    """Phase 6's stream on one engine: a warm run, a run untraced, then
    ``attach_tracer(SpanTracer())`` and a run traced: the same tokens,
    graph keys, captures, uploads and syncs; the trace holds every
    request's whole lifecycle and loads back from its Chrome JSON; what
    the tracer costs the host a steady step prints (the median steady
    step traced less untraced, and the time inside the tracer's
    calls)."""
    eng = ServingEngine(model, **kw)
    _zero_launches()
    _tel_stream(eng, prompts)
    keys, caps = list(eng.trace_log), dict(eng.graph_captures)
    plain = _tel_stream(eng, prompts)
    tr = SpanTracer()
    acc = _tel_counted(tr)
    eng.attach_tracer(tr)
    traced = _tel_stream(eng, prompts)
    with tempfile.TemporaryDirectory() as d:
        with open(tr.export(os.path.join(d, "trace.json"))) as f:
            events = json.load(f)["traceEvents"]
    lanes = {}
    for e in events:
        if e.get("pid") == PID_REQUESTS and e["ph"] != "M":
            lanes.setdefault(e["tid"], set()).add(e["name"])
    rids = sorted(lanes)
    whole = all({"queued", "admitted", "prefill_chunk", "first_token",
                 "token", "terminal", f"req{r}"} <= lanes[r] for r in rids)
    spans = sorted({e["name"] for e in events
                    if e["ph"] == "X" and e.get("pid") == PID_HOST})
    med = [float(np.median(run[3])) for run in (plain, traced)]
    n_steps = len(traced[3])
    st = {"tokens_identical": all(np.array_equal(a, b) for a, b in
                                  zip(plain[0], traced[0])),
          "uploads": [plain[1], traced[1]],
          "syncs": [plain[2], traced[2]],
          "keys": eng.trace_log, "keys_before": keys,
          "graph_captures": dict(eng.graph_captures),
          "captures_before": caps, "events": tr.n_events,
          "requests_traced": len(rids), "whole_lifecycle": whole,
          "host_spans": spans,
          "steady_step_host_ms_median": med,
          "tracer_cost_ms_per_step": med[1] - med[0],
          "tracer_calls_per_step": acc["tracer_calls"] / n_steps,
          "tracer_call_ms_per_step": acc["tracer_s"] * 1e3 / n_steps}
    _log("telemetry traced: " + json.dumps(st))
    greedy = [i for i in range(len(prompts)) if i not in SAMPLED]
    if (not all(np.array_equal(plain[0][i], traced[0][i]) for i in greedy)
            or eng.trace_log != keys or dict(eng.graph_captures) != caps
            or plain[1] != traced[1] or plain[2] != traced[2]
            or len(rids) != len(prompts) or not whole
            or not set(spans) <= {
                "unified_step", "decode_horizon"}
            or "decode_horizon" not in spans):
        raise AssertionError(f"telemetry traced: {st}")
    return st


def _tel_nan(model, cpu_model, prompts, kw):
    """ADM_LIVE's three requests live on a pool that holds them and no
    more, ADM_NEXT queued behind them; ``NaNLogits`` on the second at
    token TEL_NAN_AT, which a horizon block delivers: it ends FAILED
    with the injected cause through one kill, and ADM_NEXT takes its
    slot and pages and decodes the uninterrupted run's tokens."""
    idx = ADM_LIVE + (ADM_NEXT,)
    want, ref = _adm_ref(model, dict(kw, kv_pages=None), prompts, idx)
    tr = SpanTracer()
    plan = FaultPlan(NaNLogits(rid=1, at_token=TEL_NAN_AT))
    eng = ServingEngine(model, faults=plan, tracer=tr, **kw)
    _zero_launches()
    rids = [eng.submit(prompts[i], NEW) for i in idx]
    victim = eng.requests[rids[1]]
    emit_block, in_block = eng._emit_block, []

    def watched(pending):
        n = len(plan.events)
        emit_block(pending)
        in_block.append(len(plan.events) > n)
    eng._emit_block = watched
    slot = pages = None
    steps = 0
    while victim.status.value != "FAILED":
        if victim in eng._slot_req:
            slot = eng._slot_req.index(victim)
            pages = set(eng.kv.table_row(slot).tolist()) - {0}
        eng.step()
        steps += 1
        if steps > 200 or victim.status.value == "COMPLETED":
            raise AssertionError(f"telemetry nan_logits: the fault did not "
                                 f"fire ({plan.events}, {victim.status})")
    del eng._emit_block
    t0 = time.perf_counter()
    eng.step()                      # drain, the grant, the kill, a chunk
    grant_ms = (time.perf_counter() - t0) * 1e3
    killed = not bool(eng._dstate["active"][slot])
    nxt = eng.requests[rids[3]]
    pf = eng._lane
    taken = (bool(pf is not None and pf.req is nxt and pf.slot == slot),
             len(pages & set(eng.kv.table_row(slot).tolist())))
    _adm_until_admitted(eng)
    up0 = eng.metrics.host_uploads
    res = eng.run()
    torch.cuda.synchronize()
    faults = [e for e in tr.to_chrome()["traceEvents"]
              if e["name"] == "fault"]
    pm = eng.postmortem(rids[1])
    st = {"statuses": [eng.requests[r].status.value for r in rids],
          "cause": pm["cause"], "victim_tokens": len(victim.tokens),
          "fired_in_horizon_block": any(in_block),
          "events": plan.events,
          "fault_instants": [(e["pid"], e["tid"], e["args"]["fault"])
                             for e in faults],
          "postmortem_fault": [e["detail"] for e in pm["events"]
                               if e["kind"] == "fault"],
          "plan_postmortems": [p["rid"] for p in plan.postmortems],
          "host_kill_uploads": eng.metrics.host_kill_uploads,
          "tail_uploads": eng.metrics.host_uploads - up0,
          "next_owner_in_slot": taken[0],
          "next_owner_pages_of_victim": taken[1],
          "victim_pages": len(pages), "grant_step_ms": grant_ms,
          "graph_captures": dict(eng.graph_captures),
          "ref_graph_captures": dict(ref.graph_captures)}
    _log("telemetry nan_logits: " + json.dumps(st))
    tag = f"nan_logits:rid{rids[1]}:tok{TEL_NAN_AT}"
    if (st["statuses"] != ["COMPLETED", "FAILED", "COMPLETED", "COMPLETED"]
            or st["cause"] != f"injected fault: nan_logits at token "
                              f"{TEL_NAN_AT}"
            or st["victim_tokens"] != TEL_NAN_AT
            or not st["fired_in_horizon_block"] or plan.events != [tag]
            or st["fault_instants"] != [(PID_REQUESTS, rids[1], tag)]
            or st["postmortem_fault"] != [tag]
            or st["plan_postmortems"] != [rids[1]]
            or st["host_kill_uploads"] != 1 or st["tail_uploads"] != 0
            or not killed or not taken[0] or taken[1] < 1
            or st["graph_captures"] != st["ref_graph_captures"]):
        raise AssertionError(f"telemetry nan_logits: {st}")
    if not set(eng.trace_log) <= set(ref.trace_log):
        raise AssertionError(f"telemetry nan_logits: keys {eng.trace_log} "
                             f"beyond the uninterrupted run's "
                             f"{ref.trace_log}")
    keep = [0, 2, 3]
    _adm_same("nan_logits", cpu_model, prompts, [idx[j] for j in keep],
              [res[rids[j]] for j in keep], [want[j] for j in keep],
              path="telemetry")
    if not np.array_equal(victim.tokens, want[1][:TEL_NAN_AT]):
        _margin_check("telemetry nan_logits victim's tokens", cpu_model,
                      prompts[ADM_LIVE[1]], np.asarray(victim.tokens),
                      want[1][:TEL_NAN_AT])
    return st


def _tel_exhaust(model, cpu_model, prompts, kw):
    """``ExhaustAllocator(at_admission=2, count=3)``: the first request
    admitted, the next three admission attempts refused while the queue
    waits with slots free, then every request served with the
    uninterrupted run's tokens."""
    idx = ADM_LIVE
    want, ref = _adm_ref(model, kw, prompts, idx)
    plan = FaultPlan(ExhaustAllocator(at_admission=2, count=3))
    eng = ServingEngine(model, faults=plan, tracer=SpanTracer(), **kw)
    _zero_launches()
    rids = [eng.submit(prompts[i], NEW) for i in idx]
    waited = 0
    while eng.queue:
        if eng._lane is None and eng.kv.free_slots and len(eng.queue) == 2:
            waited += 1
        eng.step()
    res = eng.run()
    torch.cuda.synchronize()
    st = {"events": plan.events, "attempts": plan.attempts,
          "steps_queue_waited": waited,
          "statuses": [eng.requests[r].status.value for r in rids],
          "graph_captures": dict(eng.graph_captures),
          "ref_graph_captures": dict(ref.graph_captures)}
    _log("telemetry exhaust_allocator: " + json.dumps(st))
    if (plan.events != [f"alloc_exhausted:attempt{i}" for i in (2, 3, 4)]
            or st["statuses"] != ["COMPLETED"] * 3 or waited < 3
            or plan.postmortems
            or not set(eng.trace_log) <= set(ref.trace_log)):
        raise AssertionError(f"telemetry exhaust_allocator: {st}")
    _adm_same("exhaust_allocator", cpu_model, prompts, idx,
              [res[r] for r in rids], want, path="telemetry")
    return st


def _tel_spike(model, cpu_model, prompts, kw):
    """``LatencySpike(at_step=0, ms=10, count=4)`` slept on the injected
    clock under ``step_budget_ms=5``: the 296-token prompt's admission
    (five chunks) is struck at each of its first four steps and ends
    FAILED with the watchdog's cause; the next request is served."""
    want, ref = _adm_ref(model, kw, prompts, (ADM_AFTER,))
    clk = AdmClock()
    plan = FaultPlan(LatencySpike(at_step=0, ms=10.0, count=4),
                     sleep=lambda s: setattr(clk, "t", clk.t + s))
    eng = ServingEngine(model, clock=clk, step_budget_ms=5.0, faults=plan,
                        tracer=SpanTracer(), **kw)
    _zero_launches()
    rw = eng.submit(prompts[ADM_WEDGED], NEW)
    rz = eng.submit(prompts[ADM_AFTER], NEW)
    res = eng.run()
    torch.cuda.synchronize()
    st = {"statuses": [eng.requests[r].status.value for r in (rw, rz)],
          "cause": eng.postmortem(rw)["cause"], "events": plan.events,
          "strikes": eng.requests[rw].slow_strikes,
          "slow_steps": eng.metrics.slow_steps,
          "plan_postmortems": [p["rid"] for p in plan.postmortems]}
    _log("telemetry latency_spike: " + json.dumps(st))
    if (st["statuses"] != ["FAILED", "COMPLETED"]
            or st["cause"] != "stall watchdog: 4 steps over the 5ms budget"
            or plan.events != [f"latency_spike:step{i}" for i in range(4)]
            or st["strikes"] != 4 or st["plan_postmortems"] != [rw]
            or not set(eng.trace_log) <= set(ref.trace_log)):
        raise AssertionError(f"telemetry latency_spike: {st}")
    _adm_same("latency_spike", cpu_model, prompts, (ADM_AFTER,),
              [res[rz]], want, path="telemetry")
    return st


def _tel_drop(model, cpu_model, prompts, kw):
    """``DropCallback`` on the first of two requests at token
    TEL_DROP_AT: its consumer misses exactly that token, the engine's
    record is whole and the uninterrupted run's."""
    idx = ADM_LIVE[:2]
    want, ref = _adm_ref(model, kw, prompts, idx)
    plan = FaultPlan(DropCallback(rid=0, at_token=TEL_DROP_AT))
    eng = ServingEngine(model, faults=plan, tracer=SpanTracer(), **kw)
    _zero_launches()
    seen = {}
    rids = [eng.submit(prompts[i], NEW,
                       on_token=lambda r, t: seen.setdefault(r, []).append(t))
            for i in idx]
    res = eng.run()
    torch.cuda.synchronize()
    toks = [list(eng.requests[r].tokens) for r in rids]
    st = {"events": plan.events, "seen": [len(seen[r]) for r in rids],
          "tokens": [len(t) for t in toks],
          "statuses": [eng.requests[r].status.value for r in rids]}
    _log("telemetry drop_callback: " + json.dumps(st))
    if (plan.events != [f"callback_dropped:rid{rids[0]}:tok{TEL_DROP_AT}"]
            or seen[rids[0]] != toks[0][:TEL_DROP_AT]
            + toks[0][TEL_DROP_AT + 1:]
            or seen[rids[1]] != toks[1] or st["tokens"] != [NEW, NEW]
            or st["statuses"] != ["COMPLETED"] * 2
            or not set(eng.trace_log) <= set(ref.trace_log)):
        raise AssertionError(f"telemetry drop_callback: {st}")
    _adm_same("drop_callback", cpu_model, prompts, idx,
              [res[r] for r in rids], want, path="telemetry")
    return st


def phase_telemetry_alone():
    """Path ``telemetry`` on its own (``--telemetry``): phase 6's seeded
    model, engine arguments and prompts, then phase 7i."""
    cfg, tree, model, kw, prompts = _slice_setup()
    del model
    cpu_model = tgpt.GPT.from_jax_decode_params(tree, cfg, device="cpu")
    phase_telemetry({"cfg": cfg, "tree": tree, "kw": kw,
                     "prompts": prompts, "cpu_model": cpu_model})


def phase_telemetry(setup):
    """Path ``telemetry``: the request spans and fault injection on the
    card, GPT-2-small with phase 6's seeded weights, captured: phase 6's
    stream traced against untraced on one warm engine (the same tokens,
    graph keys, captures, uploads and syncs; every request's lifecycle
    in the trace; the tracer's host cost a steady step), then four fault
    plans, each on a fresh traced engine beside the same requests on an
    uninterrupted untraced one: ``NaNLogits`` mid-horizon on float32
    pages that the next request takes (one kill upload, the next
    owner's tokens the uninterrupted run's), ``ExhaustAllocator``,
    ``LatencySpike`` under ``step_budget_ms`` and ``DropCallback``.
    Greedy tokens under the margin rule, statuses and causes the
    reference's, no graph key beyond the uninterrupted run's, the flash
    forward, its combine, paged decode and its merge launched."""
    prompts, cpu_model = setup["prompts"], setup["cpu_model"]
    model = _card_model(setup)
    base = dict(n_slots=3, page_tokens=PAGE, chunk_tokens=CHUNK,
                decode_horizon=HORIZON)
    need = [-(-(prompts[i].size + NEW) // PAGE) for i in ADM_LIVE]
    tight = dict(base, kv_pages=1 + sum(need), prefix_cache=False)
    t_phase = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    gc.collect()
    total = dict.fromkeys(_read_launches(), 0)
    stats = {}
    cases = [
        ("traced", lambda: _tel_traced(model, prompts, setup["kw"])),
        ("nan_logits", lambda: _tel_nan(model, cpu_model, prompts, tight)),
        ("exhaust_allocator", lambda: _tel_exhaust(model, cpu_model,
                                                   prompts, base)),
        ("latency_spike", lambda: _tel_spike(model, cpu_model, prompts,
                                             base)),
        ("drop_callback", lambda: _tel_drop(model, cpu_model, prompts,
                                            base))]
    for label, case in cases:
        t0 = time.perf_counter()
        stats[label] = case()
        stats[label]["case_s"] = time.perf_counter() - t0
        end = _read_launches()
        for k in total:
            total[k] += end[k]
        gc.collect()
    path_kernels = ("flash_attention_fwd", "flash_attention_fwd_combine",
                    "paged_decode_attention", "paged_decode_merge")
    _log(f"telemetry phase (7i): {time.perf_counter() - t_phase:.1f}s; "
         f"launches " + json.dumps({k: v for k, v in total.items() if v}))
    if any(total[k] <= 0 for k in path_kernels):
        raise AssertionError(f"telemetry: a kernel of the path was not "
                             f"launched: {total}")
    return total, stats


def synthetic_stream(vocab, n, seed=0):
    """Deterministic next-token structure, the rule of the JAX package's
    ``examples/transformer/train.py``: x[t+1] = (3*x[t] + 7) % vocab,
    with a uniformly random token one time in ten."""
    rng = np.random.RandomState(seed)
    x = np.zeros(n, np.int32)
    x[0] = rng.randint(vocab)
    for i in range(1, n):
        x[i] = (3 * x[i - 1] + 7) % vocab if rng.rand() > 0.1 \
            else rng.randint(vocab)
    return x


def _train_batches(cfg):
    """The seeded stream's ``TRAIN_STEPS`` batches of B x T ids and their
    next ids."""
    data = synthetic_stream(cfg.vocab_size,
                            TRAIN_STEPS * TRAIN_B * TRAIN_T + 1, seed=0)
    batches = []
    for s in range(TRAIN_STEPS):
        seg = data[s * TRAIN_B * TRAIN_T:(s + 1) * TRAIN_B * TRAIN_T + 1]
        batches.append((seg[:-1].reshape(TRAIN_B, TRAIN_T),
                        seg[1:].reshape(TRAIN_B, TRAIN_T)))
    return batches


def _train_setup(precision=None, use_graph=True):
    """GPT-2-small (``use_flash=True``, under ``precision``) with weights
    from a seeded card generator (the same for every precision),
    Adam(lr 3e-4), compiled on the first batch (``use_graph=True``: the
    captured step; False: its eager twin); the batches of the seeded
    stream."""
    cfg = tgpt.GPTConfig.small(use_flash=True, precision=precision)
    dev = tdevice.create_cuda_gpu(seed=0)
    batches = _train_batches(cfg)
    model = tgpt.GPT(cfg, device=dev)
    model.set_optimizer(topt.Adam(lr=TRAIN_LR))
    model.compile([TTensor(data=batches[0][0], device=dev,
                           requires_grad=False)], is_train=True,
                  use_graph=use_graph)
    torch.cuda.synchronize()
    return cfg, model, batches


def _zero_launches():
    fa.launches = fa.launches_combine = fa.launches_dq = fa.launches_dkv = 0
    fa.launches_lowp = fa.launches_combine_lowp = fa.launches_dq_lowp = 0
    fa.launches_dkv_lowp = 0
    pa.launches = pa.launches_q8 = pa.launches_merge = pa.launches_lowp = 0
    lc.launches = lc.launches_bwd = ew.launches = 0


def _read_launches():
    """Every kernel counter; a ``*_lowp`` entry counts the launches on
    16-bit operands, which the entry without the suffix counts too."""
    return {"flash_attention_fwd": fa.launches,
            "flash_attention_fwd_combine": fa.launches_combine,
            "flash_attention_bwd_dq": fa.launches_dq,
            "flash_attention_bwd_dkv": fa.launches_dkv,
            "paged_decode_attention": pa.launches,
            "paged_decode_attention_q8": pa.launches_q8,
            "paged_decode_merge": pa.launches_merge,
            "lstm_cell": lc.launches, "lstm_cell_bwd": lc.launches_bwd,
            "elementwise": ew.launches,
            "flash_attention_fwd_lowp": fa.launches_lowp,
            "flash_attention_fwd_combine_lowp": fa.launches_combine_lowp,
            "flash_attention_bwd_dq_lowp": fa.launches_dq_lowp,
            "flash_attention_bwd_dkv_lowp": fa.launches_dkv_lowp,
            "paged_decode_attention_lowp": pa.launches_lowp}


def _host_states(model):
    """Every parameter, buffer and optimizer state, copied to the host
    (optimizer entries under ``opt.``)."""
    out = {n: t.data.detach().to("cpu", copy=True)
           for n, t in model.get_states().items()}
    out.update({f"opt.{t.name}": t.data.detach().to("cpu", copy=True)
                for t in model.optimizer.state_tensors()})
    return out


def _device_states(model):
    """The same, cloned on the card (for an in-place restore)."""
    model_states = {n: t.data.detach().clone()
                    for n, t in model.get_states().items()}
    opt_states = {t.name: t.data.detach().clone()
                  for t in model.optimizer.state_tensors()}
    return model_states, opt_states


def _restore(model, saved):
    model.set_states(saved[0])
    model.optimizer.set_states(saved[1])


def _same_states(label, a, b):
    """``a`` and ``b`` bit for bit, by name; the differing names (and
    their largest difference) print before the check fails."""
    if set(a) != set(b):
        raise AssertionError(f"{label}: state names differ: "
                             f"{sorted(set(a) ^ set(b))[:6]}")
    bad = [(n, float((a[n].double() - b[n].double()).abs().max()))
           for n in sorted(a) if not torch.equal(a[n], b[n])]
    _log(f"{label}: {len(a) - len(bad)} of {len(a)} states bit-equal"
         + (f"; differing {bad[:6]}" if bad else ""))
    if bad:
        raise AssertionError(f"{label}: {len(bad)} states differ")


def _train_run(model, batches, label, after_step=None, unit="tokens",
               warm=2):
    """One ``train_one_batch(x, y, *rest)`` a batch ``(x, y, *rest)``,
    each ending in ``loss.item()``; launch counters zeroed just before
    the steps and read just after; ``after_step(s)`` runs between steps,
    outside the timed window.  The steady step is steps ``warm`` and on:
    on the captured path step 0 runs eagerly and step 1 captures, then
    replays (a step of two signatures: ``warm`` 4).  The rate counts
    ``unit``: ``tokens`` (every id of a batch) or ``images`` (its first
    axis)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    losses, walls = [], []
    for s, (x, y, *rest) in enumerate(batches):
        t0 = time.perf_counter()
        _, loss = model.train_one_batch(x, y, *rest)
        lv = loss.item()                      # synchronises
        walls.append(time.perf_counter() - t0)
        losses.append(lv)
        _log(f"{label} step {s}: loss {lv:.6f}, {walls[-1] * 1e3:.1f} ms")
        if after_step is not None:
            after_step(s)
    torch.cuda.synchronize()
    launches = _read_launches()
    steady = walls[warm:]
    per_step = batches[0][0].size if unit == "tokens" \
        else batches[0][0].shape[0]
    rate = f"{unit}_per_s"
    stats = {"losses": losses, "step_ms": [w * 1e3 for w in walls],
             "steady_step_ms": float(np.mean(steady)) * 1e3, "unit": unit,
             rate: per_step * len(steady) / sum(steady),
             "peak_memory_bytes": torch.cuda.max_memory_allocated(),
             "graph_replays": dict(model.graph_replays),
             "graph_captures": dict(model.graph_captures)}
    _log(f"{label}: steady step {stats['steady_step_ms']:.2f} ms (steps "
         f"{warm}-{len(batches) - 1}; steps 0, 1: {stats['step_ms'][0]:.1f}, "
         f"{stats['step_ms'][1]:.1f} ms), {stats[rate]:.0f} "
         f"{unit}/s, peak memory {stats['peak_memory_bytes']} bytes "
         f"({stats['peak_memory_bytes'] / 2**30:.2f} GiB); graph captures "
         f"{stats['graph_captures']}, replays {stats['graph_replays']}; "
         f"launches " + json.dumps({k: v for k, v in launches.items() if v}))
    return launches, stats


def _graph_against_eager(label, g_launch, g_stats, e_launch, e_stats,
                         g_states, e_states, captures=1, first_calls=None):
    """The captured run against its eager twin (the same seeded weights
    and batches): every loss and every state bit for bit (the same
    kernels on the same operands in the same order); the launch counts
    the replays were credited equal the eager run's; ``captures``
    captures (one a step signature) and steps - ``first_calls`` replays
    (``first_calls``: the eager calls, one a signature unless a call
    creates state), so no eager step ran after those."""
    steps = len(g_stats["losses"])
    replays = steps - (captures if first_calls is None else first_calls)
    u = g_stats["unit"]
    _log(f"{label} captured against eager: losses {g_stats['losses']} / "
         f"{e_stats['losses']}; steady step {g_stats['steady_step_ms']:.2f}"
         f" / {e_stats['steady_step_ms']:.2f} ms "
         f"({e_stats['steady_step_ms'] / g_stats['steady_step_ms']:.3f}x), "
         f"{u}/s {g_stats[u + '_per_s']:.0f} / "
         f"{e_stats[u + '_per_s']:.0f}, peak memory "
         f"{g_stats['peak_memory_bytes'] / 2**30:.2f} / "
         f"{e_stats['peak_memory_bytes'] / 2**30:.2f} GiB")
    if g_stats["losses"] != e_stats["losses"]:
        raise AssertionError(f"{label}: captured losses differ from eager")
    _same_states(f"{label} captured against eager", g_states, e_states)
    if g_launch != e_launch:
        raise AssertionError(f"{label}: credited launches {g_launch} differ "
                             f"from the eager run's {e_launch}")
    if g_stats["graph_captures"] != {"train": captures} \
            or g_stats["graph_replays"] != {"train": replays} \
            or e_stats["graph_replays"]:
        raise AssertionError(f"{label}: captures {g_stats['graph_captures']}"
                             f", replays {g_stats['graph_replays']} (want "
                             f"{captures} and {replays}); eager twin "
                             f"{e_stats['graph_replays']}")


def _graph_kernels(model, label, want):
    """:func:`_replay_kernels` on the captured training step; the state
    is restored in place after the replays, so the run goes on from
    where it was."""
    entry = next(e for k, e in model._graphs.items() if k[0] == "train")
    saved = _device_states(model)
    found = _replay_kernels(entry, label, want)
    _restore(model, saved)
    return found


def _replay_kernels(entry, label, want):
    """Three more replays of a captured graph (``entry``) under
    ``torch.profiler``, with a marker kernel (``torch.cuda._sleep``'s
    ``spin_kernel``) after the first and after the second: the middle
    replay's kernels counted by name, and each count held equal to the
    launches that replay was credited with (``want`` maps a kernel's
    name to the counters of :func:`_read_launches` it stands for).  The
    replays either side keep the middle one clear of the trace's edges,
    where the tracer can lose a graph's first records.  The counters
    are zeroed first (the path's own were read already)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    _zero_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        entry.graph.replay()
        torch.cuda._sleep(1000)
        entry.replay()          # the one credited
        torch.cuda._sleep(1000)
        entry.graph.replay()
        torch.cuda.synchronize()
    credited = _read_launches()
    kernels = sorted((e.time_range.start, e.name) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    marks = [i for i, (_, n) in enumerate(kernels) if "spin_kernel" in n]
    if len(marks) != 2:
        raise AssertionError(f"{label}: {len(marks)} marker kernels in the "
                             f"trace, want 2")
    parts = (kernels[:marks[0]], kernels[marks[0] + 1:marks[1]],
             kernels[marks[1] + 1:])
    found = {n: {"in_replay": sum(n in k for _, k in parts[1]),
                 "credited": sum(credited[c] for c in counters),
                 "first_and_last": [sum(n in k for _, k in parts[0]),
                                    sum(n in k for _, k in parts[2])]}
             for n, counters in want.items()}
    _log(f"{label}: three replays ran {[len(p) for p in parts]} device "
         f"activities; the middle one's kernels by name against its "
         f"credited launches " + json.dumps(found))
    bad = {n: f for n, f in found.items()
           if f["in_replay"] != f["credited"] or f["credited"] == 0}
    if bad:
        raise AssertionError(f"{label}: the replayed graph's kernels differ "
                             f"from the credited launches: {bad}")
    return found


def _predict_check(model, x, label):
    """``predict`` three times on one batch: the first call is the eager
    forward (on the capture stream), the second captures and replays,
    the third replays; both replays must give the eager logits bit for
    bit."""
    model.eval()
    p = [model.predict(x) for _ in range(3)]
    torch.cuda.synchronize()
    err = max(float((q.data.float() - p[0].data.float()).abs().max())
              for q in p[1:])
    _log(f"{label} predict: logits {tuple(p[0].shape)} {p[0].dtype}; "
         f"captured against eager max |delta| {err}; captures "
         f"{model.graph_captures}, replays {model.graph_replays}")
    if not all(torch.equal(q.data, p[0].data) for q in p[1:]) \
            or model.graph_replays.get("predict") != 2 \
            or not torch.isfinite(p[0].data).all():
        raise AssertionError(f"{label}: captured predict differs from eager")
    model.train(True)
    return err


# the flash kernels of a training step by name, and the counters of
# _read_launches that each one's launches tick
FLASH_KERNELS = {"flash_fwd_mma": ("flash_attention_fwd",),
                 "flash_bwd_dq_mma": ("flash_attention_bwd_dq",),
                 "flash_bwd_dkv_mma": ("flash_attention_bwd_dkv",)}
# the serving graphs' kernels: the unified step's prompt chunk (flash on
# its split route and the combine) and every paged decode iteration (the
# kernel, float or int8, and its merge)
CHUNK_KERNELS = {"flash_fwd_mma": ("flash_attention_fwd",),
                 "flash_fwd_combine": ("flash_attention_fwd_combine",)}
PAGED_KERNELS = {"paged_decode_kernel": ("paged_decode_attention",
                                         "paged_decode_attention_q8"),
                 "paged_merge_kernel": ("paged_decode_merge",)}


def _serving_graph_kernels(eng, label, want):
    """:func:`_replay_kernels` on each of an engine's graphs that
    ``want`` names (kind -> kernels; the greedy twin where it was
    captured, else the sampled one), after its stream: the engine is
    not used again."""
    found = {}
    for kind, kernels in want.items():
        keys = sorted((k for k in eng._gc.graphs if k[0] == kind),
                      key=lambda k: k[1].endswith(":sampled"))
        if not keys:
            raise AssertionError(f"{label}: no {kind} graph was captured")
        found[keys[0][1]] = _replay_kernels(eng._gc.graphs[keys[0]],
                                            f"{label} {keys[0][1]}", kernels)
    return found


def phase_train():
    """The training slice: GPT-2-small, fp32, B 8, T 1024, Adam, 5 steps
    through ``train_one_batch``, first eagerly (``use_graph=False``),
    then captured (``use_graph=True``) from the same weights; launch
    counters zeroed just before each run and read just after; the
    checkpoint of step 2 is saved on the way.  Returns ``(model,
    launches, stats, batches, checkpoint)``."""
    _log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
         f"{torch.backends.cudnn.allow_tf32}")
    cfg = tgpt.GPTConfig.small(use_flash=True)
    batches = _train_batches(cfg)
    ckpt = os.path.join(REPO, "build", "train_step2.zip")

    def save(model, s):
        if s == 1:
            model.save_states(ckpt)

    model, launches, stats = _twins(
        "train", lambda g: _train_setup(use_graph=g)[1], batches,
        unit="tokens", falls=True, after_step=save)
    want = cfg.n_layers * TRAIN_STEPS
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        if launches[name] != want:
            raise AssertionError(f"{name}: {launches[name]} launches on the "
                                 f"training path, expected {want}")
    if launches["flash_attention_fwd_combine"] != 0:
        raise AssertionError("the training shape took the split route")
    stats["graph_kernels"] = _graph_kernels(model, "train", FLASH_KERNELS)
    # what handing the logits out of the graph costs a step: one clone
    logits = next(e.outputs[0].data for k, e in model._graphs.items()
                  if k[0] == "train")
    clone_ms = _time_ms(logits.clone, reps=5)
    clone_bound = 2 * logits.numel() * 4 / HBM_BYTES_PER_S * 1e3
    del logits
    _log(f"train: the step's logits {TRAIN_B}x{TRAIN_T}x{cfg.vocab_size} "
         f"cloned out of the graph in {clone_ms:.3f} ms a step (bound "
         f"{clone_bound:.3f} ms: read and write at 3.35 TB/s)")
    stats["output_clone_ms"] = clone_ms
    return model, launches, stats, batches, ckpt


def phase_graph_api(model, stats, batches, ckpt):
    """The rest of the Model API on the fp32 training path: the step-2
    checkpoint loads into a fresh captured model, which takes steps 3-5
    as the uninterrupted run did (losses and every state bit for bit);
    ``run_k_steps(4)`` (four replays) against four ``train_one_batch``
    calls from the same state, restored in place (the graph reads the
    restored storage); ``predict`` captured against its eager first
    call.  Steps 3-5 run under an installed ``SpanTracer``: one
    ``dispatch`` a step, and one ``trace_compile`` that starts in step
    3's dispatch (the eager warm-up) and ends in step 4's (the
    capture)."""
    cfg, fresh, _ = _train_setup()
    t0 = time.perf_counter()
    aux = fresh.load_states(ckpt)
    load_s = time.perf_counter() - t0
    size = os.path.getsize(ckpt)
    os.remove(ckpt)
    tr = ttracer.install(SpanTracer())
    try:
        resumed = [fresh.train_one_batch(x, y)[1].item()
                   for x, y in batches[2:]]
    finally:
        ttracer.uninstall()
    disp, comp = tr.spans("dispatch"), tr.spans("trace_compile")
    _log(f"checkpoint: {size} bytes, loaded in {load_s:.2f}s (aux {aux}); "
         f"steps 3-5 resumed {resumed} against {stats['losses'][2:]}; "
         f"traced: {len(disp)} dispatch, {len(comp)} trace_compile "
         f"({[round(d * 1e3, 1) for _, _, d in comp]} ms), captures "
         f"{fresh.graph_captures}, keys {[k[0] for k in fresh._graphs]}")
    if resumed != stats["losses"][2:]:
        raise AssertionError("the resumed run's losses differ")
    if len(disp) != len(resumed) or len(comp) != 1 \
            or fresh.graph_captures != {"train": 1} \
            or len(fresh._graphs) != 1:
        raise AssertionError("traced training: want a dispatch a step, one "
                             "trace_compile and one capture")
    (_, c0, cd), (_, d0, dd), (_, d1, d1d) = comp[0], disp[0], disp[1]
    if not (d0 <= c0 <= d0 + dd and d1 <= c0 + cd <= d1 + d1d):
        raise AssertionError("trace_compile does not run from the warm-up "
                             "step into the capturing step")
    _same_states("checkpoint resumed against uninterrupted",
                 _host_states(fresh), _host_states(model))
    x, y = batches[0]
    saved = _device_states(fresh)
    replays = fresh.graph_replays.get("train", 0)
    _, loss_k = fresh.run_k_steps(4, x, y)
    after_k = _host_states(fresh)
    replays_k = fresh.graph_replays.get("train", 0) - replays
    _restore(fresh, saved)
    del saved
    for _ in range(4):
        _, loss_c = fresh.train_one_batch(x, y)
    _log(f"run_k_steps(4): loss {loss_k.item()} against four calls' "
         f"{loss_c.item()}; {replays_k} replays; captures "
         f"{fresh.graph_captures}")
    if loss_k.item() != loss_c.item() or replays_k != 4 \
            or fresh.graph_captures != {"train": 1}:
        raise AssertionError("run_k_steps(4) differs from four calls")
    _same_states("run_k_steps(4) against four calls", after_k,
                 _host_states(fresh))
    del after_k, fresh
    gc.collect()
    return {"predict_err": _predict_check(model, x, "train")}


# ---- the 16-bit paths (phases 7e, 7f, 8b, 8c) ------------------------------

def _lowp_launches(label, launches, names):
    """Each of ``names`` launched, and every launch on 16-bit operands."""
    for name in names:
        if launches[name] <= 0 or launches[name + "_lowp"] != launches[name]:
            raise AssertionError(f"{label}: {name} launched {launches[name]} "
                                 f"times, {launches[name + '_lowp']} of them "
                                 f"on 16-bit operands")


def _bf16_models(setup):
    """Phase 6's seeded masters under ``precision="bfloat16"``: on the
    card, and on the host (the CPU oracle), kept in ``setup``."""
    if "model16" not in setup:
        cfg16 = tgpt.GPTConfig.small(precision="bfloat16")
        setup["cfg16"] = cfg16
        setup["model16"] = tgpt.GPT.from_jax_decode_params(setup["tree"],
                                                           cfg16)
        setup["cpu_model16"] = tgpt.GPT.from_jax_decode_params(
            setup["tree"], cfg16, device="cpu")
    return setup["cfg16"], setup["model16"], setup["cpu_model16"]


def phase_serve_bf16(setup, float_stats):
    """Path ``serve_bf16``: phase 6's stream on the paged engine under
    ``precision="bfloat16"`` (the same seeded float32 masters through
    ``GPT.from_jax_decode_params``).  Checks: 8/8 complete; the pools are
    bfloat16 and the committed KV bytes exactly half of phase 6's; the
    flash forward, its combine, paged decode and its merge launched,
    every flash and paged launch on 16-bit operands; the prefix-sharing
    pair against the port on the CPU in bfloat16 under the margin rule
    (16-bit limit, ``LOWP_MARGIN_ULPS``)."""
    cfg16, model, cpu_model = _bf16_models(setup)
    kw, prompts = setup["kw"], setup["prompts"]
    _warm(model, kw, prompts)
    eng = ServingEngine(model, **kw)
    if eng.kv.caches[0][0].dtype != torch.bfloat16:
        raise AssertionError(f"serve_bf16 pools are "
                             f"{eng.kv.caches[0][0].dtype}")
    rids, res, launches, stats = _drive(eng, prompts, cfg16, "serve_bf16")
    stats["graph_kernels"] = _serving_graph_kernels(
        eng, "serve_bf16", {"unified": CHUNK_KERNELS | PAGED_KERNELS,
                            "horizon": PAGED_KERNELS})
    del eng
    _eager_twin("serve_bf16", lambda **k: ServingEngine(model, **kw, **k),
                prompts, cfg16, rids, res, launches, stats)
    _lowp_launches("serve_bf16", launches,
                   ("flash_attention_fwd", "flash_attention_fwd_combine",
                    "paged_decode_attention"))
    if launches["paged_decode_merge"] <= 0:
        raise AssertionError("serve_bf16: the paged merge never launched")
    ratio = stats["kv_bytes_committed"] / float_stats["kv_bytes_committed"]
    _log(f"serve_bf16 KV bytes committed {stats['kv_bytes_committed']} = "
         f"{ratio} of phase 6's (want exactly 0.5)")
    if ratio != 0.5:
        raise AssertionError(f"serve_bf16 KV byte ratio {ratio}")
    _cpu_oracle(cpu_model, kw, prompts, res, rids)
    _beside("bf16 paged", stats, float_stats)
    setup["rids16"], setup["res16"] = rids, res
    return launches, stats


def phase_generate_bf16(setup):
    """Path ``generate_bf16``: ``GPT.generate`` on the card under
    ``precision="bfloat16"``, phase 7a's batch: exactly 12 flash forward
    launches a call, all on bfloat16 operands, no combine, nothing else;
    each row against the bf16 paged engine's tokens for its prompt and
    against the port's bf16 ``generate`` on the CPU, under the margin
    rule; then :func:`_lowp_logit_check`."""
    cfg16, model, cpu_model = _bf16_models(setup)
    rows = _generate_rows(setup["prompts"])
    batch = np.stack(rows)
    model.generate(batch[:1, :40], 4)           # warm-up, not counted
    gc.collect()
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    toks = model.generate(batch, NEW)
    wall = time.perf_counter() - t0
    launches = _read_launches()
    stats = {"wall_s": wall, "tokens_per_s": GEN_B * NEW / wall}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    again = model.generate(batch, NEW)          # all replays
    wall = time.perf_counter() - t0
    if not np.array_equal(again, toks):
        raise AssertionError("generate_bf16: a second call differs")
    stats["captured"] = {"tokens_per_s": GEN_B * NEW / wall,
                         "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    stats["eager"] = _generate_twins(
        "generate_bf16", model, batch, toks, stats["captured"],
        2 + 2 * (2 * (NEW - 1) - 1))     # the B 1 warm-up's 2 replays too
    _log(f"generate_bf16 B {GEN_B} T {GEN_T}, {NEW} new: {wall:.3f}s, "
         f"{stats['tokens_per_s']:.1f} tokens/s; launches "
         + json.dumps({k: v for k, v in launches.items() if v}))
    want = dict.fromkeys(launches, 0) | {
        "flash_attention_fwd": cfg16.n_layers,
        "flash_attention_fwd_lowp": cfg16.n_layers}
    if launches != want:
        raise AssertionError(f"generate_bf16 launched {launches}, expected "
                             f"{want}")
    if toks.shape != (GEN_B, NEW) or toks.min() < 0 \
            or toks.max() >= cfg16.vocab_size:
        raise AssertionError(f"generate_bf16: bad tokens {toks}")
    eng = ServingEngine(model, **setup["kw"])
    rids = [eng.submit(r, NEW) for r in rows]
    res = eng.run()
    del eng
    for i, (r, rid) in enumerate(zip(rows, rids)):
        _margin_check(f"generate_bf16 row {i} against the bf16 paged engine",
                      cpu_model, r, toks[i], res[rid])
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = cpu_model.generate(batch, NEW)
    _log(f"generate_bf16: {GEN_B} rows on the CPU in "
         f"{time.perf_counter() - t0:.1f}s")
    for i in range(GEN_B):
        _margin_check(f"generate_bf16 row {i} against the CPU run",
                      cpu_model, rows[i], toks[i], cpu[i])
    _lowp_logit_check(model, cfg16, cpu_model, rows, batch, toks, cpu)
    return launches, stats


def _faulty_prefill_attention(kind):
    """A planted fault in ``generate``'s prefill attention, a control of
    the 16-bit checks: ``"p16"`` rounds the softmax weights P to
    the operands' dtype before P V (what a 16-bit tensor-core kernel
    or ``scaled_dot_product_attention`` does: another function than the
    reference's); ``"diag"`` drops each query's own key (an off-by-one
    causal mask; row 0 keeps its one key)."""
    def attention(q, k, v, mask=None, sm_scale=1.0, causal=False):
        if mask is not None or not causal:
            raise AssertionError("the control expects generate's prefill")
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
        r = torch.arange(q.shape[2], device=q.device)
        keep = r[None] <= r[:, None]
        if kind == "diag":
            keep = (r[None] < r[:, None]) | ((r[None] == 0)
                                             & (r[:, None] == 0))
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        if kind == "p16":
            return torch.matmul(p.to(q.dtype), v)
        return torch.matmul(p, v.float()).to(q.dtype)
    return attention


def _causal_logits(params, cfg, tokens, device):
    """Logits at every position of ``tokens`` through ``generate``'s
    prefill blocks (causal flash attention, no cache) on ``device``."""
    H = cfg.n_heads
    scale = 1.0 / np.sqrt(cfg.d_model // H)
    ids = torch.from_numpy(np.asarray(tokens, np.int64)).to(device)[None]
    with torch.no_grad():
        h = tgpt._embed(params, ids, torch.arange(ids.shape[1],
                                                  device=device),
                        cfg.use_rope)
        for bp in params["blocks"]:
            h = tgpt._block_prefill(bp, h, H, scale, cfg.use_rope,
                                    cfg.rope_base)[0]
        return tgpt._logits(params, h)[0]


def _logit_err_ulps(got, want):
    """Largest ``|got - want|`` of a position's logits, in units of the
    last place of that position's top logit in ``want``; the largest
    over positions."""
    _, ulp = _top2_ulps(want)
    err = (got.float() - want.float()).abs().amax(dim=-1)
    return float((err / ulp).max())


def _lowp_logit_check(model, cfg16, cpu_model, rows, batch, toks, cpu):
    """The bf16 logits, and the readings behind the two 16-bit limits.
    Logits of the card's rows (prompt and generated tokens, one causal
    prefill) against the port's on the CPU on the same tokens: the
    largest difference in ulps of the top logit must stay under
    ``LOWP_LOGIT_ULPS``.  The top-2 margins at the generated positions
    (the share below 1, 2, 4 and 8 ulps is the share at which a flipped
    token passes a margin limit that large).  Two controls, ``generate``
    with a planted fault in its prefill attention
    (:func:`_faulty_prefill_attention`): the margin at each row's first
    difference from the CPU's tokens, and the logit difference, which
    must reach ``LOWP_LOGIT_ULPS`` for the dropped key."""
    params, cpu_params = model.decode_params(), cpu_model.decode_params()
    seqs = [np.concatenate([r, toks[i][:-1]]) for i, r in enumerate(rows)]
    want = [_causal_logits(cpu_params, cfg16, q, "cpu") for q in seqs]
    errs, ulps = [], []
    for q, w in zip(seqs, want):
        got = _causal_logits(params, cfg16, q, "cuda").cpu()
        errs.append(_logit_err_ulps(got, w))
        margin, ulp = _top2_ulps(got[-NEW:])
        ulps.append(margin / ulp)
    ulps = torch.cat(ulps)
    _log(f"generate_bf16 logits against the CPU's over {len(seqs)} rows: "
         f"largest difference {max(errs):g} ulp of the top logit (rows "
         f"{', '.join(f'{e:g}' for e in errs)}; limit {LOWP_LOGIT_ULPS})")
    _log(f"generate_bf16 margins over {ulps.numel()} generated positions "
         f"(ulps of the top logit): min {float(ulps.min()):g}, median "
         f"{float(ulps.median()):g}; share below 1, 2, 4, 8 ulps: "
         + ", ".join(f"{float((ulps < u).float().mean()):.4f}"
                     for u in (1, 2, 4, 8)))
    if max(errs) >= LOWP_LOGIT_ULPS:
        raise AssertionError(f"generate_bf16 logits differ from the CPU's "
                             f"by {max(errs)} ulp")
    caught = {}
    for kind in ("p16", "diag"):
        saved = tgpt.flash_attention
        tgpt.flash_attention = _faulty_prefill_attention(kind)
        try:
            bad = model.generate(batch, NEW)
            bad_err = max(_logit_err_ulps(
                _causal_logits(params, cfg16, q, "cuda").cpu(), w)
                for q, w in zip(seqs, want))
        finally:
            tgpt.flash_attention = saved
        caught[kind] = bad_err >= LOWP_LOGIT_ULPS
        for i, r in enumerate(rows):
            if np.array_equal(bad[i], cpu[i]):
                _log(f"margin control {kind} row {i}: {NEW} greedy tokens "
                     f"identical to the CPU run")
                continue
            j = int(np.flatnonzero(bad[i] != cpu[i])[0])
            margin, tol, ulp = _cpu_margin(
                cpu_model, np.concatenate([r, cpu[i][:j]]))
            fails = margin >= tol and margin > 0
            _log(f"margin control {kind} row {i}: first difference at token "
                 f"{j}, CPU top-2 logit margin {margin:.3e} = "
                 f"{margin / ulp:g} ulp (limit {tol:.3e}): the margin rule "
                 f"{'fails' if fails else 'passes'} it")
        _log(f"logit control {kind}: largest difference from the CPU's "
             f"logits {bad_err:g} ulp of the top logit (limit "
             f"{LOWP_LOGIT_ULPS}): the logit check "
             f"{'fails' if caught[kind] else 'passes'} it")
    if not caught["diag"]:
        raise AssertionError("the logit check passed generate with the "
                             "diagonal key dropped")


def phase_train_lowp(precision, f32_stats):
    """Paths ``train_bf16`` and ``train_fp16``: phase 8's runs, eager
    twin and captured, under ``precision`` (the same seeded weights and
    batches), held together as phase 8's are.  Checks: the loss falls,
    stays finite and ends within 2 % of phase 8's float32 loss at step 5
    (the bound of the reference's ``test_bf16_tracks_fp32_mlp``);
    exactly 12 launches a step of each flash kernel, all on 16-bit
    operands, no combine; every parameter and optimizer state float32
    after the steps.  Step time and peak memory print beside float32's.
    ``bfloat16``: the captured ``predict`` against its eager first call.
    ``float16`` then takes one captured step with its loss scale forced
    to 2^40 (in place: the replay reads it), so that the 16-bit
    gradients overflow: every parameter and optimizer state must come
    back bit-unchanged and the scale must halve."""
    label = {"bfloat16": "train_bf16", "float16": "train_fp16"}[precision]
    cfg = tgpt.GPTConfig.small(use_flash=True, precision=precision)
    batches = _train_batches(cfg)
    model, launches, stats = _twins(
        label, lambda g: _train_setup(precision, use_graph=g)[1], batches,
        unit="tokens", falls=True)
    peak = stats["peak_memory_bytes"]
    _log(f"{label}: steady step {stats['steady_step_ms']:.1f} ms (float32 "
         f"{f32_stats['steady_step_ms']:.1f}), {stats['tokens_per_s']:.0f} "
         f"tokens/s (float32 {f32_stats['tokens_per_s']:.0f}), peak memory "
         f"{peak / 2**30:.2f} GiB (float32 "
         f"{f32_stats['peak_memory_bytes'] / 2**30:.2f})")
    _tracks_f32(label, stats["losses"], f32_stats["losses"])
    want = cfg.n_layers * TRAIN_STEPS
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        if launches[name] != want or launches[name + "_lowp"] != want:
            raise AssertionError(f"{label}: {name} {launches[name]} "
                                 f"launches ({launches[name + '_lowp']} "
                                 f"16-bit), expected {want}")
    if launches["flash_attention_fwd_combine"] != 0:
        raise AssertionError(f"{label}: the training shape took the split "
                             f"route")
    stats["graph_kernels"] = _graph_kernels(model, label, FLASH_KERNELS)
    opt = model.optimizer
    states = list(model.get_states().items()) + [
        (t.name, t) for t in opt.state_tensors()
        if t.data.is_floating_point() and not t.name.startswith("loss")]
    bad = [n for n, t in states if t.data.dtype != torch.float32]
    if bad:
        raise AssertionError(f"{label}: not float32 after the steps: {bad}")
    _log(f"{label}: all {len(states)} parameters and optimizer states are "
         f"float32 after {TRAIN_STEPS} steps")
    if precision == "bfloat16":
        stats["predict_err"] = _predict_check(model, batches[0][0], label)
    if precision == "float16":
        ls = model.precision_policy.loss_scale
        _log(f"{label}: loss scale {float(ls.scale.data)} after "
             f"{TRAIN_STEPS} steps, good steps {int(ls.good_steps.data)}")
        before = {n: t.data.detach().clone() for n, t in states}
        ls.scale.data.fill_(2.0 ** 40)
        x, y = batches[0]
        replays = model.graph_replays["train"]
        _, loss = model.train_one_batch(x, y)
        torch.cuda.synchronize()
        moved = [n for n, t in states if not torch.equal(t.data, before[n])]
        new_scale = float(ls.scale.data)
        _log(f"{label} forced overflow (loss scale 2^40), a replay: loss "
             f"{loss.item():.6f}, {len(moved)} of {len(states)} tensors "
             f"moved, scale now {new_scale} (want {2.0 ** 39})")
        if moved or new_scale != 2.0 ** 39 or bool(ls.found_inf.data) \
                or model.graph_replays["train"] != replays + 1:
            raise AssertionError(f"{label}: the overflowed step was not a "
                                 f"no-op: moved {moved[:5]}, scale "
                                 f"{new_scale}")
        stats["overflow_step"] = {"moved": len(moved), "scale": new_scale}
    del model, opt, states
    return launches, stats


def _loss_and_grads(model, x, y):
    """One training step's loss and gradients (no update)."""
    logits = model.forward(x)
    B, T, V = logits.shape
    loss = tautograd.softmax_cross_entropy(
        tautograd.reshape(logits, (B * T, V)),
        tautograd.reshape(y, (B * T,)))
    grads = {p.name: g.data for p, g in tautograd.backward(loss)}
    return loss.item(), grads


def phase_card_vs_cpu(model):
    """One training step at full width (B 1, T 128) from the same weights
    on the card (kernels) and in the port on the CPU (plain versions).
    Tolerances: loss to a relative 1e-5 and every gradient to max |delta|
    <= 1e-3 max |g| — float32 on both sides (TF32 off), summation order
    differs (cuBLAS against the CPU's BLAS, the kernels against their
    plain versions).  The attention key biases have an exact gradient of
    zero (softmax is shift-invariant per row), so both sides hold float
    noise there: their bound takes max |g| of the block's key weights."""
    cfg = model.config
    data = synthetic_stream(cfg.vocab_size, 129, seed=1)
    x, y = data[:-1].reshape(1, 128), data[1:].reshape(1, 128)
    states = {k: t.numpy() for k, t in model.get_states().items()}
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = tgpt.GPT.from_jax_states(states, cfg, device="cpu")
    cpu.compile([x], is_train=True)
    loss_c, grads_c = _loss_and_grads(cpu, TTensor(data=x, device="cpu"),
                                      TTensor(data=y, device="cpu"))
    cpu_s = time.perf_counter() - t0
    model.train(True)
    dev = model.device
    loss_g, grads_g = _loss_and_grads(model, TTensor(data=x, device=dev),
                                      TTensor(data=y, device=dev))
    rel = abs(loss_g - loss_c) / abs(loss_c)
    _log(f"card vs cpu: loss card {loss_g:.7f} cpu {loss_c:.7f} (relative "
         f"{rel:.2e}, tol 1e-5); cpu step {cpu_s:.1f}s")
    if set(grads_g) != set(grads_c) or not rel <= 1e-5:
        raise AssertionError("card and CPU training steps disagree")
    worst = (0.0, "")
    for name, gc in grads_c.items():
        ref = grads_c[name[:-1] + "W"] if name.endswith("attn.Wk.b") else gc
        d = float((grads_g[name].cpu() - gc).abs().max())
        ratio = d / max(float(ref.abs().max()), 1e-30)
        worst = max(worst, (ratio, name))
    _log(f"card vs cpu: worst gradient max|delta|/max|g| {worst[0]:.2e} "
         f"({worst[1]}; tol 1e-3) over {len(grads_c)} tensors")
    if worst[0] > 1e-3:
        raise AssertionError(f"gradient {worst[1]} disagrees: {worst[0]}")
    return {"loss_rel": rel, "grad_worst_ratio": worst[0]}


def phase_serve_trained(model):
    """The paths join: the trained model's ``decode_params()`` serves 2
    requests through the ``ServingEngine`` to completion."""
    model.eval()
    cfg = model.config
    eng = ServingEngine(model, n_slots=2, page_tokens=PAGE,
                        chunk_tokens=CHUNK, decode_horizon=HORIZON)
    data = synthetic_stream(cfg.vocab_size, 200, seed=2)
    rids = [eng.submit(data[:40], 16), eng.submit(data[50:170], 16)]
    res = eng.run()
    torch.cuda.synchronize()
    for r in rids:
        toks = res.get(r)
        if toks is None or toks.shape != (16,) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"trained model, request {r}: {toks}")
    _log(f"trained model served {len(rids)} requests: "
         f"{[res[r][:6].tolist() for r in rids]} ...")


# the rnn_train configuration: bench_rnn.py's fused cell, SGD with
# momentum, 10 steps on one seeded batch
RNN_STEPS, RNN_LR, RNN_MOMENTUM = 10, 0.1, 0.9
# the rnn_sample configuration: the example's defaults
SAMPLE_B, SAMPLE_T, SAMPLE_EPOCHS, SAMPLE_LR, SAMPLE_LEN = 16, 64, 2, 3e-3, 120


class CharLSTM(tmodel.Model):
    """``bench_rnn.py``'s char-LSTM on the port: one-hot input,
    ``LSTM(H)``, ``Linear(V)``, mean cross-entropy over T * B."""

    def __init__(self, V, H, fused):
        super().__init__()
        self.V, self.H = V, H
        self.lstm = tlayer.LSTM(H, use_fused_cell=fused)
        self.fc = tlayer.Linear(V)

    def forward(self, x):
        y, _, _ = self.lstm(tautograd.onehot(x, self.V))
        T, B = y.shape[0], y.shape[1]
        return self.fc(tautograd.reshape(y, (T * B, self.H)))

    def train_one_batch(self, x, t):
        logits = self.forward(x)
        loss = tautograd.softmax_cross_entropy(logits, t)
        self.optimizer(loss)
        return logits, loss


def _rnn_batch():
    rng = np.random.RandomState(0)
    x = rng.randint(0, RNN_V, (RNN_T, RNN_B)).astype(np.int32)
    t = rng.randint(0, RNN_V, RNN_T * RNN_B).astype(np.int32)
    return x, t


def _rnn_model(fused, device, states=None, use_graph=True):
    """The char-LSTM compiled with ``use_graph`` on ``device`` (weights
    from the device's generator seeded 0, or ``states``)."""
    dev = tdevice.get_device(device)
    dev.set_rand_seed(0)
    m = CharLSTM(RNN_V, RNN_H, fused)
    m.set_optimizer(topt.SGD(lr=RNN_LR, momentum=RNN_MOMENTUM))
    x, _ = _rnn_batch()
    m.compile([TTensor(data=x, device=dev, requires_grad=False)],
              is_train=True, use_graph=use_graph)
    if states is not None:
        m.set_states(states)
    return m


def phase_rnn_train():
    """The char-LSTM of ``bench_rnn.py`` at the reference char-RNN shape
    (V 86, H 256, T 100, B 64), fp32 with TF32 off, SGD(0.1, momentum
    0.9), 10 steps through the fused cell: captured (``use_graph=True``)
    and its eager twin from the same weights, held together as phase 8's
    runs are (losses and every state bit for bit, the credited launches
    equal the eager ones, 1 capture and 9 replays, one profiled replay
    running ``lstm_cell_kernel`` as often as it is credited with cell
    launches, forward and backward); then the same captured from the same weights
    through the plain cell (the scan-path yardstick).  Checks: the loss
    falls on each; exactly T launches of the cell's forward and T of its
    backward kernel a fused step, none on the scan path; fused and scan
    agree to a relative 1e-4 at every step (fp32 on both; the plain
    cell's product and the kernel's sum in other orders).  Returns
    ``(fused model, launches, stats)``."""
    start = {k: t.data.detach().clone() for k, t in
             _rnn_model(True, "cuda", use_graph=False).get_states().items()}
    fused, f_launch, f_stats = _twins(
        "rnn_train", lambda g: _rnn_model(True, "cuda", start, g),
        [_rnn_batch()] * RNN_STEPS, unit="tokens", falls=True)
    f_stats["graph_kernels"] = _graph_kernels(
        fused, "rnn_train", {"lstm_cell_kernel": ("lstm_cell",
                                                  "lstm_cell_bwd")})
    scan = _rnn_model(False, "cuda", states=start)
    s_launch, s_stats = _train_run(scan, [_rnn_batch()] * RNN_STEPS,
                                   "rnn_train scan")
    losses = s_stats["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"rnn_train scan: the loss did not fall: "
                             f"{losses}")
    del scan, start
    want = RNN_T * RNN_STEPS
    if f_launch["lstm_cell"] != want or f_launch["lstm_cell_bwd"] != want \
            or s_launch["lstm_cell"] != 0 or s_launch["lstm_cell_bwd"] != 0:
        raise AssertionError(f"lstm_cell launches: fused {f_launch} "
                             f"(want {want} of each), scan {s_launch} "
                             f"(want 0)")
    rel = max(abs(a - b) / abs(b) for a, b in zip(f_stats["losses"],
                                                  s_stats["losses"]))
    _log(f"rnn_train fused vs scan: worst relative loss difference "
         f"{rel:.2e} over {RNN_STEPS} steps (tol 1e-4); steady step "
         f"{f_stats['steady_step_ms']:.2f} against {s_stats['steady_step_ms']:.2f}"
         f" ms, tokens/s {f_stats['tokens_per_s']:.0f} against "
         f"{s_stats['tokens_per_s']:.0f}, peak memory "
         f"{f_stats['peak_memory_bytes']} against "
         f"{s_stats['peak_memory_bytes']} bytes")
    if not rel <= 1e-4:
        raise AssertionError(f"fused and scan losses differ by {rel}")
    return fused, f_launch, {"fused": f_stats, "scan": s_stats,
                             "loss_rel": rel}


def _rnn_loss_and_grads(model, x, t):
    model.train(True)
    loss = tautograd.softmax_cross_entropy(model.forward(x), t)
    grads = {p.name: g.data for p, g in tautograd.backward(loss)}
    return loss.item(), grads


def phase_rnn_card_vs_cpu(model):
    """One full-width fused step (V 86, H 256, T 100, B 64) from the
    trained weights on the card (the cell kernel) and in the port on the
    CPU (the plain cell), without the update.  Tolerances as phase 9's:
    loss to a relative 1e-5, every gradient to max |delta| <= 1e-3 max
    |g|."""
    x, t = _rnn_batch()
    states = {k: v.numpy() for k, v in model.get_states().items()}
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = _rnn_model(True, "cpu", states=states)
    t0 = time.perf_counter()
    loss_c, grads_c = _rnn_loss_and_grads(cpu, TTensor(data=x, device="cpu"),
                                          TTensor(data=t, device="cpu"))
    cpu_s = time.perf_counter() - t0
    dev = model.device
    loss_g, grads_g = _rnn_loss_and_grads(model, TTensor(data=x, device=dev),
                                          TTensor(data=t, device=dev))
    rel = abs(loss_g - loss_c) / abs(loss_c)
    worst = max((float((grads_g[n].cpu() - g).abs().max())
                 / max(float(g.abs().max()), 1e-30), n)
                for n, g in grads_c.items())
    _log(f"rnn card vs cpu: loss card {loss_g:.7f} cpu {loss_c:.7f} "
         f"(relative {rel:.2e}, tol 1e-5); worst gradient max|delta|/max|g| "
         f"{worst[0]:.2e} ({worst[1]}; tol 1e-3) over {len(grads_c)} "
         f"tensors; cpu step {cpu_s:.1f}s")
    if set(grads_g) != set(grads_c) or not rel <= 1e-5 \
            or not worst[0] <= 1e-3:
        raise AssertionError("card and CPU char-LSTM steps disagree")
    return {"loss_rel": rel, "grad_worst_ratio": worst[0]}


def _sample_margin(cpu_model, data, text, j, temperature=0.8):
    """How close step ``j``'s draw came to switching characters: the
    distance of its uniform number from the nearest edge of the CPU's
    cumulative distribution (``rng.choice`` takes one uniform a draw).
    Logits that moved by e change that distribution by less than e / T
    at every edge, so a difference needs this margin below that."""
    dev = tdevice.get_device("cpu")
    cpu_model.eval()
    hx = cx = None
    for ch in text[:j + 1]:
        x = TTensor(data=np.array([[data.c2i[ch]]], np.int32), device=dev)
        logits, hx, cx = cpu_model.forward(x, hx, cx)
    p = logits.numpy().astype(np.float64)[0] / temperature
    p = np.exp(p - p.max())
    p /= p.sum()
    cdf = p.cumsum()
    cdf /= cdf[-1]
    u = np.random.RandomState(0).random_sample(j + 1)[j]
    return float(np.abs(cdf - u).min())


def phase_rnn_sample():
    """The port's char-RNN example (``CharRNN(vocab, hidden=256)`` with
    the LSTM's fused flag set) on its synthetic corpus: 2 epochs of
    truncated BPTT at B 16, T 64 with Adam(3e-3), carrying ``hx, cx``;
    then ``sample()`` draws 120 characters, one T 1, B 1 step each.
    Launch counters are zeroed before each part and read after it.
    Checks: the epoch loss falls; exactly T forward and T backward
    launches a training step, one forward launch a sampled character and
    no backward one; the card's characters equal those the port
    samples on the CPU from the same weights and generator, or first
    differ at a draw within ``MARGIN_TOL`` of a distribution edge.
    Returns ``(launches, stats)``."""
    dev = tdevice.get_device("cuda")
    dev.set_rand_seed(0)
    data = char_rnn.Data(char_rnn.synthetic_corpus())
    m = char_rnn.CharRNN(data.vocab, hidden=RNN_H)
    m.lstm.use_fused_cell = True
    m.set_optimizer(topt.Adam(lr=SAMPLE_LR))
    zeros = np.zeros((1, SAMPLE_B, RNN_H), np.float32)
    m.compile([TTensor(data=np.zeros((SAMPLE_T, SAMPLE_B), np.int32),
                       device=dev)], is_train=True, use_graph=True)
    gc.collect()
    torch.cuda.synchronize()
    _zero_launches()
    epoch_loss, steps = [], 0
    t0 = time.perf_counter()
    for _ in range(SAMPLE_EPOCHS):
        hx = TTensor(data=zeros, device=dev)
        cx = TTensor(data=zeros, device=dev)
        tot, nb = 0.0, 0
        for bx, by in data.batches(SAMPLE_B, SAMPLE_T):
            loss, hx, cx = m.train_one_batch(bx, by, hx, cx)
            if hx.creator is not None or hx.data.requires_grad:
                raise AssertionError("the carried state kept its graph")
            tot += loss.item()
            nb += 1
        epoch_loss.append(tot / nb)
        steps += nb
    train_s = time.perf_counter() - t0
    train_launches = _read_launches()
    _zero_launches()
    t0 = time.perf_counter()
    text = char_rnn.sample(m, data, dev, length=SAMPLE_LEN)
    sample_s = time.perf_counter() - t0
    sample_launches = _read_launches()
    launches = {k: train_launches[k] + sample_launches[k]
                for k in train_launches}
    _log(f"rnn_sample: epoch losses {epoch_loss}, {steps} steps in "
         f"{train_s:.2f}s ({steps * SAMPLE_B * SAMPLE_T / train_s:.0f} "
         f"chars/s); {SAMPLE_LEN} characters sampled in {sample_s:.3f}s; "
         f"lstm_cell launches (forward, backward): training "
         f"{train_launches['lstm_cell']}, {train_launches['lstm_cell_bwd']}"
         f"; sampling {sample_launches['lstm_cell']}, "
         f"{sample_launches['lstm_cell_bwd']}")
    _log(f"rnn_sample text: {text!r}")
    if not epoch_loss[-1] < epoch_loss[0]:
        raise AssertionError(f"rnn_sample: the loss did not fall: "
                             f"{epoch_loss}")
    if train_launches["lstm_cell"] != steps * SAMPLE_T \
            or train_launches["lstm_cell_bwd"] != steps * SAMPLE_T \
            or sample_launches["lstm_cell"] != SAMPLE_LEN \
            or sample_launches["lstm_cell_bwd"] != 0:
        raise AssertionError(f"rnn_sample launches: training "
                             f"{train_launches}, sampling {sample_launches}")
    states = {k: v.numpy() for k, v in m.get_states().items()}
    torch.set_num_threads(os.cpu_count() or 1)
    cpu_dev = tdevice.get_device("cpu")
    cpu = char_rnn.CharRNN(data.vocab, hidden=RNN_H)
    cpu.lstm.use_fused_cell = True
    cpu.compile([TTensor(data=np.zeros((SAMPLE_T, SAMPLE_B), np.int32),
                         device=cpu_dev)], is_train=False)
    cpu.set_states(states)
    cpu_text = char_rnn.sample(cpu, data, cpu_dev, length=SAMPLE_LEN)
    if cpu_text == text:
        _log(f"rnn_sample oracle: {SAMPLE_LEN} characters identical to the "
             f"CPU run")
        margin = None
    else:
        j = next(i for i, (a, b) in enumerate(zip(text, cpu_text)) if a != b)
        margin = _sample_margin(cpu, data, cpu_text, j - 1)
        _log(f"rnn_sample oracle: first difference at character {j}, draw "
             f"margin {margin:.3e} on the CPU")
        if margin >= MARGIN_TOL:
            raise AssertionError(f"the card's sample differs from the CPU's "
                                 f"at character {j} with margin {margin}")
    return launches, {"epoch_loss": epoch_loss, "train_s": train_s,
                      "sample_s": sample_s, "margin": margin}


# ---------------------------------------------------------------------------
# the MLP and CNN workloads (phases 15-19)
# ---------------------------------------------------------------------------

# path mlp_train: examples/mlp.py's MLP at its widths
MLP_B, MLP_STEPS, MLP_LR = 256, 20, 0.05
# path cnn_train: the MNIST CNN on synthetic MNIST
CNN_B, CNN_STEPS = 64, 10
# the card's first-step logits and loss against the CPU's: float32 on
# both sides, convolutions by cuDNN's chosen algorithms (TF32 off) on the
# card and by the CPU's direct ones; observed differences are ~1e-6 of
# the logits' unit scale, so the limit leaves a 100x margin
CNN_CPU_TOL = 1e-4
# path resnet50_train: ResNet-50 at full width, synthetic imagenet
R50_B, R50_STEPS, R50_LR = 32, 5, 0.005
# resnet50_bf16's first-step logits against float32's, in multiples of
# float32's own change when only its input is rounded to bf16: the
# port's ResNet-50 on the CPU (64-128 px, B 4-16) puts the bf16 policy at
# 2.3-2.5 of it, one rounding at every layer against one at the input
R50_BF16_LOGIT_FACTOR = 4.0
# path zoo: each model, B ZOO_B at its input size, 1000 classes
ZOO_B, ZOO_STEPS = 4, 3
ZOO = (("alexnet", 224), ("vgg16", 224), ("mobilenet", 224),
       ("xceptionnet", 299), ("resnet18", 224))


def _cnn_determinism():
    """cuDNN's deterministic algorithms, picked without benchmarking (the
    captured run and its eager twin must take the same ones); TF32 stays
    off (phase 1)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _zoo_model(name, seed=0, use_graph=True, x=None, precision=None,
               lr=R50_LR, comm=None, create=cnn_train.create_model, **kw):
    """A model of the port's CNN zoo on the card (``create(name,
    **kw)``), its weights drawn from the card's generator seeded
    ``seed`` (the dropout draws follow from the same generator), with
    train_cnn.py's optimizer (SGD, momentum 0.9, weight decay 1e-5; in a
    ``DistOpt`` over ``comm`` when given), compiled on ``x`` (with
    ``comm``)."""
    dev = tdevice.get_device("cuda")
    dev.set_rand_seed(seed)
    m = create(name, **kw)
    sgd = topt.SGD(lr=lr, momentum=0.9, weight_decay=1e-5)
    m.set_optimizer(sgd if comm is None
                    else topt.DistOpt(sgd, communicator=comm))
    m.compile([TTensor(data=x, device=dev, requires_grad=False)],
              is_train=True, use_graph=use_graph, precision=precision,
              communicator=comm)
    torch.cuda.synchronize()
    return m


def _no_kernels(label, launches):
    """The CNN paths run no hand-written kernel (no TPU kernel lies on
    them): every counter 0."""
    if any(launches.values()):
        raise AssertionError(f"{label}: kernel launches on a path that has "
                             f"none: {launches}")


def _twins(label, make, batches, unit="images", profile=0, falls=False,
           after_step=None, captures=1, first_calls=None):
    """``make(use_graph)``'s eager twin, then its captured model, over
    ``batches`` through ``_train_run`` (``after_step(model, s)`` between
    the captured run's steps), held together by ``_graph_against_eager``
    (every loss and state, BatchNorm buffers and optimizer states
    included, bit for bit); the losses must be finite, and with
    ``falls`` the last below the first; with ``profile``, that many more
    steps of each under ``torch.profiler`` give its idle share.
    ``captures``: the step signatures among the batches (each is
    captured once); ``first_calls``: the eager calls (one a signature
    unless a call creates state, which makes another signature's next
    call a first call again).  Returns ``(captured model, launches,
    stats)``, the eager run's stats under ``"eager"``."""
    gc.collect()
    first_calls = captures if first_calls is None else first_calls
    warm = first_calls + captures
    eager = make(False)
    e_launch, e_stats = _train_run(eager, batches, f"{label}_eager",
                                   unit=unit, warm=warm)
    e_states = _host_states(eager)
    if profile:
        e_stats["idle_share"] = _idle_share(eager, batches[:profile])
    del eager
    gc.collect()
    model = make(True)
    step = None if after_step is None else lambda s: after_step(model, s)
    launches, stats = _train_run(model, batches, label, step, unit, warm)
    losses = stats["losses"]
    if not all(np.isfinite(losses)) or (falls and not losses[-1] < losses[0]):
        raise AssertionError(f"{label}: losses {losses} (must be finite"
                             + (" and fall)" if falls else ")"))
    _graph_against_eager(label, launches, stats, e_launch, e_stats,
                         _host_states(model), e_states, captures,
                         first_calls)
    del e_states
    if profile:
        stats["idle_share"] = _idle_share(model, batches[:profile])
        _log(f"{label}: idle share captured {stats['idle_share']:.4f}, eager "
             f"{e_stats['idle_share']:.4f} over {profile} steps")
    stats["eager"] = e_stats
    return model, launches, stats


def _tracks_f32(label, losses, f32_losses):
    """The last loss within 2 % of float32's at the same step (the bound
    of the reference's ``test_bf16_tracks_fp32_mlp``); returns the
    relative difference."""
    a, b = losses[-1], f32_losses[-1]
    rel = abs(a - b) / b
    _log(f"{label}: loss at step {len(losses)} {a:.6f} against float32's "
         f"{b:.6f} (relative {rel:.4f}, tol 0.02)")
    if not rel <= 0.02:
        raise AssertionError(f"{label}: step-{len(losses)} loss {rel:.4f} "
                             f"off float32's")
    return rel


def _idle_share(model, batches):
    """The device's idle share over ``train_one_batch`` on ``batches``
    under ``torch.profiler`` (the model's state moves on)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x, y, *rest in batches:
            model.train_one_batch(x, y, *rest)
        torch.cuda.synchronize()
    busy, window, _ = _busy(prof)
    return 1 - busy / window


def phase_mlp_train():
    """Path ``mlp_train``: ``examples/mlp.py``'s MLP (784-128-128-10, SGD
    0.05 with momentum 0.9) on its synthetic MNIST, B 256, 20 steps,
    captured beside its eager twin (bit for bit); the loss must fall."""
    x, y = mlp.synthetic_mnist(n=MLP_B * MLP_STEPS, seed=0)
    batches = [(x[s * MLP_B:(s + 1) * MLP_B], y[s * MLP_B:(s + 1) * MLP_B])
               for s in range(MLP_STEPS)]

    def make(use_graph):
        dev = tdevice.get_device("cuda")
        dev.set_rand_seed(0)
        m = mlp.MLP()
        m.set_optimizer(topt.SGD(lr=MLP_LR, momentum=0.9))
        m.compile([TTensor(data=x[:MLP_B], device=dev, requires_grad=False)],
                  is_train=True, use_graph=use_graph)
        return m

    _, launches, stats = _twins("mlp_train", make, batches, unit="samples",
                                falls=True)
    _no_kernels("mlp_train", launches)
    return launches, stats


def _first_step(model, x, y):
    """The training-mode forward of a step (logits, loss), no update."""
    model.train(True)
    logits = model.forward(x)
    loss = tautograd.softmax_cross_entropy(logits, y)
    return logits.data.detach().cpu(), float(loss.item())


def phase_cnn_train():
    """Path ``cnn_train``: the MNIST CNN of the zoo on train_cnn.py's
    synthetic MNIST, B 64, 10 steps, captured beside its eager twin (bit
    for bit); the card's first-step logits and loss against the port's on
    the CPU from the same states, within ``CNN_CPU_TOL``."""
    x, y = cnn_synthetic.load("mnist", num=CNN_B * CNN_STEPS, seed=0)
    batches = [(x[s * CNN_B:(s + 1) * CNN_B], y[s * CNN_B:(s + 1) * CNN_B])
               for s in range(CNN_STEPS)]

    def make(use_graph):
        return _zoo_model("cnn", use_graph=use_graph, x=x[:CNN_B],
                          num_classes=10, num_channels=1)

    start = {k: t.data.detach().cpu() for k, t in
             make(False).get_states().items()}
    model, launches, stats = _twins("cnn_train", make, batches, falls=True)
    _no_kernels("cnn_train", launches)
    stats["states"] = _host_states(model)
    card = _zoo_model("cnn", use_graph=False, x=x[:CNN_B], num_classes=10,
                      num_channels=1)
    card.set_states(start)
    cpu = cnn_train.create_model("cnn", num_classes=10, num_channels=1)
    cpu.set_optimizer(topt.SGD(lr=R50_LR))
    cpu.compile([TTensor(data=x[:CNN_B], device="cpu")], is_train=True)
    cpu.set_states(start)
    xb, yb = batches[0]
    lc, loss_c = _first_step(card, TTensor(data=xb, device=card.device),
                             TTensor(data=yb, device=card.device))
    lh, loss_h = _first_step(cpu, TTensor(data=xb, device="cpu"),
                             TTensor(data=yb, device="cpu"))
    err = float((lc - lh).abs().max())
    rel = abs(loss_c - loss_h) / abs(loss_h)
    _log(f"cnn_train card against CPU, first step: logits max |delta| "
         f"{err:.3e}, loss {loss_c:.7f} / {loss_h:.7f} (relative {rel:.2e});"
         f" tol {CNN_CPU_TOL:g}")
    if not (err <= CNN_CPU_TOL and rel <= CNN_CPU_TOL):
        raise AssertionError("cnn_train: the card's first step differs from "
                             "the CPU's")
    stats["card_vs_cpu"] = {"logits_max_abs_err": err, "loss_rel_err": rel}
    return launches, stats


def _imagenet_batches():
    """train_cnn.py's synthetic imagenet (``-d imagenet``: 1000 classes,
    3x224x224), R50_STEPS batches of R50_B, uploaded to the card once."""
    x, y = cnn_synthetic.load("imagenet", num=R50_B * R50_STEPS, seed=0)
    return [(torch.from_numpy(x[s * R50_B:(s + 1) * R50_B]).cuda(),
             torch.from_numpy(y[s * R50_B:(s + 1) * R50_B]).cuda())
            for s in range(R50_STEPS)]


def phase_resnet50_train(batches, precision=None, f32_stats=None):
    """Paths ``resnet50_train`` and ``resnet50_bf16``: ResNet-50 at full
    width (224x224, 1000 classes), B 32, train_cnn.py's SGD (lr 0.005,
    momentum 0.9, weight decay 1e-5), 5 steps, captured beside its eager
    twin from the same seeded weights and batches: losses, parameters,
    momenta and BatchNorm buffers bit for bit.  Steady step, images/s
    and peak memory of each, and the idle share over two more profiled
    steps.  Under ``precision="bfloat16"`` the loss at step 5 must lie
    within 2 % of float32's, and the first step's logits must agree
    with float32's (``_bf16_logit_check``)."""
    label = "resnet50_bf16" if precision else "resnet50_train"

    def make(use_graph):
        return _zoo_model("resnet50", use_graph=use_graph,
                          x=batches[0][0], precision=precision,
                          num_classes=1000)

    model, launches, stats = _twins(label, make, batches, profile=2)
    if precision is None:               # path resnet50_dist holds to them
        stats["states"] = _host_states(model)
    del model
    _no_kernels(label, launches)
    if f32_stats is not None:
        _log(f"{label}: steady step {stats['steady_step_ms']:.2f} ms "
             f"(float32 {f32_stats['steady_step_ms']:.2f})")
        stats["loss_rel_f32"] = _tracks_f32(label, stats["losses"],
                                            f32_stats["losses"])
        stats["logits_vs_f32"] = _bf16_logit_check(label, batches[0])
    return launches, stats


def _first_logits(batch, precision=None, states=None):
    """ResNet-50's first training step (eager) on ``batch`` from the
    seeded weights, or from ``states``: its logits on the host in
    float32, its loss, and the weights it started from."""
    m = _zoo_model("resnet50", use_graph=False, x=batch[0],
                   precision=precision, num_classes=1000)
    if states is not None:
        m.set_states(states)
    start = {k: t.data.detach().clone() for k, t in m.get_states().items()}
    out, loss = m.train_one_batch(*batch)
    logits = out.data.detach().float().cpu()
    return logits, float(loss.item()), start


def _bf16_logit_check(label, batch):
    """The bf16 step's first logits ``l16`` against float32's ``l32``
    from the same weights and batch, as ``|l16 - l32|`` over the logits'
    spread ``|l32 - rowmean(l32)|`` (Frobenius norms).  The loss at 1000
    classes sits near ln 1000 whatever the logits, so the loss bound
    cannot see a broken bf16 path; these logits can.  A randomly
    initialised ResNet-50 that normalises by batch moments amplifies
    any rounding, so the yardstick is float32's own change when only
    its input is rounded to bf16: ``l16`` must lie within
    ``R50_BF16_LOGIT_FACTOR`` times it.  Constant logits (each row's
    mean) must fail that bound; the next image's float32 logits are
    printed as a second control."""
    l32, loss32, start = _first_logits(batch)
    l16, loss16, _ = _first_logits(batch, "bfloat16", start)
    rounded = (batch[0].bfloat16().float(), batch[1])
    l_in, _, _ = _first_logits(rounded, None, start)
    del start
    gc.collect()
    spread = float((l32 - l32.mean(1, keepdim=True)).norm())

    def rel(got):
        return float((got - l32).norm()) / spread

    err, yard = rel(l16), rel(l_in)
    bound = R50_BF16_LOGIT_FACTOR * yard
    controls = {"constant": rel(l32.mean(1, keepdim=True).expand_as(l32)),
                "next image": rel(l32.roll(1, 0))}
    _log(f"{label}: first-step logits against float32's from the same "
         f"weights: {err:.5f} of the spread {spread:.4f}; float32 on the "
         f"bf16-rounded input {yard:.5f}, so the bound is "
         f"{R50_BF16_LOGIT_FACTOR:g} x that = {bound:.5f} (ratio "
         f"{err / yard:.3f}); max |delta| "
         f"{float((l16 - l32).abs().max()):.5f} of max |l32| "
         f"{float(l32.abs().max()):.4f}; loss {loss16:.6f} / {loss32:.6f}; "
         f"controls " + ", ".join(f"{k} {v:.4f}"
                                  for k, v in controls.items()))
    if not err <= bound:
        raise AssertionError(f"{label}: first-step logits {err:.5f} off "
                             f"float32's (bound {bound:.5f})")
    if not controls["constant"] > bound:
        raise AssertionError(f"{label}: the logit bound {bound:.5f} passes "
                             f"constant logits")
    return {"rel": err, "rounded_input_rel": yard, "bound": bound,
            "controls": controls}


def phase_zoo():
    """Path ``zoo``: alexnet, vgg16, mobilenet, xception (at 299) and
    resnet18, B 4 at each model's input size, 1000 classes, seeded
    normal inputs: 3 steps captured (the eager first call, the capture,
    a replay) against the eager twin, bit for bit (the dropout masks of
    alexnet and vgg16 drawn from the registered generator), then
    ``predict`` in eval mode, captured against its eager first call."""
    launches, stats = {}, {}
    rng = np.random.RandomState(0)
    for name, size in ZOO:
        t0 = time.perf_counter()
        batches = [(rng.randn(ZOO_B, 3, size, size).astype(np.float32),
                    rng.randint(0, 1000, ZOO_B).astype(np.int32))
                   for _ in range(ZOO_STEPS)]

        def make(use_graph, name=name, x=batches[0][0]):
            return _zoo_model(name, use_graph=use_graph, x=x,
                              num_classes=1000)

        model, launch, st = _twins(f"zoo {name}", make, batches)
        _no_kernels(f"zoo {name}", launch)
        st["predict_err"] = _predict_check(model, batches[0][0],
                                           f"zoo {name}")
        del model
        gc.collect()
        st["seconds"] = time.perf_counter() - t0
        launches[name], stats[name] = launch, st
    return _sum_launches(launches), stats


# paths resnet50_dist and dist_options: the data-parallel updates over a
# world-1 NCCL group on the card (NCCL refuses two ranks on one card)
DIST_R50_OPTIONS = ("plain", "sharded")
DIST_OPTIONS = ("fp16", "partial", "sparse", "sparse_indices", "accum")
# dist_scripts: the CNN examples' multi-process scripts at world 1
DIST_SCRIPTS = {
    "train_multiprocess": ["-m", "singa_tpu_torch.examples.cnn."
                           "train_multiprocess", "cnn", "-w", "1", "-n",
                           "512", "-b", "64", "-m", "2"],
    "train_cnn_zero1": ["-m", "singa_tpu_torch.examples.cnn.train_cnn",
                        "cnn", "--zero1", "1", "-n", "512", "-b", "64", "-m",
                        "2"]}


def _free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _dist_group():
    """A world-1 process group over the card (NCCL, at a free local port,
    through ``init_distributed``) and its communicator."""
    tparallel.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    comm = tparallel.Communicator.from_devices()
    _log(f"process group: backend {torch.distributed.get_backend()}, world "
         f"{comm.world_size}, device {comm.device}, NCCL "
         f"{'.'.join(map(str, torch.cuda.nccl.version()))}")
    return comm


def _per_step_collectives(model, comm, batch):
    """One more step's collectives: the communicator's calls by op and
    DistOpt's all-reduces (a replay is credited what its capture
    issued)."""
    before = comm.comm_stats()["calls"]
    ar = model.optimizer.comm_stats()["allreduce_calls"]
    model.train_one_batch(*batch)
    torch.cuda.synchronize()
    after = comm.comm_stats()["calls"]
    return {"by_op": {f"{op}/{axis}": n - before.get((op, axis), 0)
                      for (op, axis), n in after.items()
                      if n != before.get((op, axis), 0)},
            "distopt_allreduce": (model.optimizer.comm_stats()
                                  ["allreduce_calls"] - ar)}


def _against_plain(label, stats, states, ref_stats, ref_states):
    """A world-1 data-parallel run against the plain SGD run from the same
    weights and batches: every loss and state bit for bit (the mean over
    one rank is exact), ``partial_idx`` aside."""
    if stats["losses"] != ref_stats["losses"]:
        raise AssertionError(f"{label}: losses {stats['losses']} differ from "
                             f"the plain run's {ref_stats['losses']}")
    states = {k: v for k, v in states.items() if k != "opt.partial_idx"}
    _same_states(f"{label} against the plain run", states, ref_states)


@contextlib.contextmanager
def _timed_order_walk():
    """The host seconds of each ``autograd._emission_order`` call made
    inside the block (``DistOpt``'s backward walks the graph for its
    order on every eager step; a replay runs no Python)."""
    walks, walk = [], tautograd._emission_order

    def timed(root):
        t0 = time.perf_counter()
        try:
            return walk(root)
        finally:
            walks.append(time.perf_counter() - t0)

    tautograd._emission_order = timed
    try:
        yield walks
    finally:
        tautograd._emission_order = walk


def phase_resnet50_dist(batches, comm, r50_stats):
    """Path ``resnet50_dist``: path 17's ResNet-50 (224x224, 1000
    classes, B 32, its SGD) under ``DistOpt`` over the world-1 NCCL
    group, ``dist_option`` ``plain`` and ``sharded`` (ZeRO-1, which takes
    the plain per-grad path at world 1), each captured against its eager
    twin bit for bit and, losses and every state, against path 17's run
    from the same weights and batches; the steady step, images/s, idle
    share, peak memory and collectives a step."""
    launches, out = {}, {}
    for option in DIST_R50_OPTIONS:
        label = f"resnet50_dist {option}"

        def make(use_graph):
            return _zoo_model("resnet50", use_graph=use_graph,
                              x=batches[0][0], num_classes=1000, comm=comm)

        bt = [(x, y, option) for x, y in batches]
        with _timed_order_walk() as walks:
            model, launch, stats = _twins(label, make, bt, profile=2)
        _no_kernels(label, launch)
        stats["order_walk_ms"] = 1e3 * float(np.median(walks))
        _log(f"{label}: the emission-order walk of DistOpt's backward, "
             f"host {stats['order_walk_ms']:.3f} ms (median of "
             f"{len(walks)} calls: eager steps and captures) against the "
             f"eager steady step {stats['eager']['steady_step_ms']:.2f} ms")
        _against_plain(label, stats, _host_states(model), r50_stats,
                       r50_stats["states"])
        stats["collectives_per_step"] = _per_step_collectives(model, comm,
                                                              bt[0])
        _log(f"{label}: collectives a step {stats['collectives_per_step']}")
        del model
        gc.collect()
        launches[option], out[option] = launch, stats
    return _sum_launches(launches), out


class _DistCNN(cnn_model.CNN):
    """The MNIST CNN with the two ``DistOpt`` updates the zoo's options
    do not name: the sparse exchange's ``indices`` encoding and gradient
    accumulation (``accumulate``, then ``accum_update`` with k 2)."""

    def train_one_batch(self, x, y, dist_option="plain", spars=None):
        if dist_option not in ("sparse_indices", "accumulate",
                               "accum_update"):
            return super().train_one_batch(x, y, dist_option, spars)
        out = self.forward(x)
        loss = self.softmax_cross_entropy(out, y)
        if dist_option == "sparse_indices":
            self.optimizer.backward_and_sparse_update(loss, spars=0.05,
                                                      encoding="indices")
        elif dist_option == "accumulate":
            self.optimizer.backward_and_accumulate(loss)
        else:
            self.optimizer.backward_and_accum_update(loss, 2)
        return out, loss


def phase_dist_options(comm, cnn_stats):
    """Path ``dist_options``: path 16's MNIST CNN (B 64, its weights and
    batches) under ``DistOpt`` over the world-1 NCCL group through
    ``fp16`` (the bf16 all-reduce), ``partial``, ``sparse`` (both
    encodings) and gradient accumulation, each captured against its eager
    twin bit for bit; ``partial`` equals path 16's plain run bit for bit
    (one rank's mean is its gradient), the two sparse encodings equal
    each other, and ``fp16``'s loss at step 5 lies within 2 % of the
    plain run's."""
    x, y = cnn_synthetic.load("mnist", num=CNN_B * CNN_STEPS, seed=0)
    launches, out, states = {}, {}, {}
    for option in DIST_OPTIONS:
        label = f"dist_options {option}"
        bt = [(x[s * CNN_B:(s + 1) * CNN_B], y[s * CNN_B:(s + 1) * CNN_B],
               option if option != "accum"
               else ("accumulate", "accum_update")[s % 2])
              for s in range(CNN_STEPS)]

        def make(use_graph):
            return _zoo_model("cnn", use_graph=use_graph, x=x[:CNN_B],
                              comm=comm, create=lambda n, **kw: _DistCNN(
                                  **kw), num_classes=10, num_channels=1)

        # accumulation: two signatures; the update's first call creates
        # the momenta, so accumulate's next call is a first call again
        accum = option == "accum"
        model, launch, stats = _twins(label, make, bt,
                                      captures=2 if accum else 1,
                                      first_calls=3 if accum else None)
        _no_kernels(label, launch)
        states[option] = _host_states(model)
        stats["collectives_per_step"] = _per_step_collectives(model, comm,
                                                              bt[-1])
        _log(f"{label}: collectives a step {stats['collectives_per_step']}")
        del model
        launches[option], out[option] = launch, stats
    _against_plain("dist_options partial", out["partial"], states["partial"],
                   cnn_stats, cnn_stats["states"])
    if out["sparse"]["losses"] != out["sparse_indices"]["losses"]:
        raise AssertionError("dist_options: the sparse encodings' losses "
                             "differ")
    _same_states("dist_options sparse dense against indices",
                 states["sparse"], states["sparse_indices"])
    out["fp16"]["loss_rel_plain"] = _tracks_f32(
        "dist_options fp16", out["fp16"]["losses"][:5],
        cnn_stats["losses"][:5])
    return _sum_launches(launches), out


def _two_rank_probe():
    """One rank of ``--nccl-two-ranks``: an all-reduce over the group."""
    comm = tparallel.Communicator.from_devices()
    x = torch.full((4,), float(comm.global_rank + 1), device=comm.device)
    y = comm.all_reduce(x)
    torch.cuda.synchronize()
    return y.tolist()


def phase_nccl_two_ranks():
    """``--nccl-two-ranks``: two ranks over NCCL on this host's cards
    (rank r on card r modulo the count: both on the one card of a
    one-card host) through ``launch``, one all-reduce; prints its result
    or the error the group raised."""
    n = torch.cuda.device_count()
    try:
        got = tparallel.launch(_two_rank_probe, 2, timeout=300)
        _log(f"two NCCL ranks on {n} card(s): all_reduce gave {got} (want "
             f"[3.0, 3.0, 3.0, 3.0])")
    except (RuntimeError, TimeoutError) as e:
        _log(f"two NCCL ranks on {n} card(s) failed: {e}")


def _sum_launches(by_run):
    return {k: sum(run[k] for run in by_run.values())
            for k in next(iter(by_run.values()))}


def phase_dist_scripts():
    """Path ``dist_scripts``: ``train_multiprocess -w 1`` and
    ``train_cnn --zero1 1`` as scripts (each launches one rank over NCCL
    on the card; 2 epochs of synthetic MNIST, B 64): exit 0 and a falling
    epoch loss.  Their processes' kernel counters are their own; the CNN
    runs no kernel of the port."""
    out = {}
    for label, argv in DIST_SCRIPTS.items():
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable] + argv, cwd=REPO,
                           capture_output=True, text=True, timeout=600)
        text = r.stdout + r.stderr
        lines = [ln for ln in text.splitlines()
                 if re.search(r"epoch \d+: loss=", ln)]
        losses = [float(v) for v in
                  re.findall(r"epoch \d+: loss=([0-9.]+)", text)]
        seconds = time.perf_counter() - t0
        _log(f"dist_scripts {label}: exit {r.returncode} in {seconds:.1f}s; "
             + " | ".join(ln.strip() for ln in lines))
        if r.returncode != 0 or len(losses) != 2 \
                or not losses[1] < losses[0]:
            raise AssertionError(f"dist_scripts {label}: exit "
                                 f"{r.returncode}, epoch losses {losses}\n"
                                 f"{text[-3000:]}")
        out[label] = {"epoch_losses": losses, "seconds": seconds}
    return out


# path tensor_surface: every function and method of the port's tensor.py
# on CUDA tensors against the same call on CPU tensors (float32 within
# SURFACE_TOL, integers and bools exactly)
SURFACE_TOL = 1e-5
SURFACE_DTYPES = ("float32", "int32", "bool")
SURFACE_UNARY = ("Abs", "Exp", "Log", "Sign", "Sqrt", "Square", "ReLU",
                 "Sigmoid", "Tanh", "Cos", "Sin", "Tan", "Cosh", "Sinh",
                 "Acos", "Asin", "Atan", "Acosh", "Asinh", "Atanh", "Ceil",
                 "Floor", "Round", "Reciprocal", "Erf", "Gelu", "SoftPlus",
                 "SoftSign", "Neg")
SURFACE_DOMAIN = {"Log": (0.1, 4.0), "Sqrt": (0.1, 4.0), "Exp": (-2.0, 1.3),
                  "Acos": (-0.9, 0.9), "Asin": (-0.9, 0.9),
                  "Atanh": (-0.9, 0.9), "Acosh": (1.0, 4.0),
                  "Tan": (-1.2, 1.2), "Reciprocal": (0.5, 2.0)}
SURFACE_BINARY = ("Add", "Sub", "EltwiseMult", "Div", "Pow", "Mod", "Atan2",
                  "Maximum", "Minimum", "LT", "LE", "GT", "GE", "EQ", "NE")
SURFACE_REDUCE = {"Sum": ({}, {"axis": 1}, {"axis": (0, 1)},
                          {"axis": 0, "keepdims": True}),
                  "Average": ({}, {"axis": 1}), "Max": ({}, {"axis": 0}),
                  "Min": ({}, {"axis": (0, 1), "keepdims": True}),
                  "Prod": ({}, {"axis": 1}), "ArgMax": ({}, {"axis": 0}),
                  "ArgMin": ({}, {"axis": None}), "SumAll": ({},),
                  "MaxAll": ({},), "MinAll": ({},), "Norm": ({},),
                  "SumRows": ({},), "SumColumns": ({},),
                  "AverageRows": ({},), "AverageColumns": ({},),
                  "L2Norm": ({},), "L1Norm": ({},)}
SURFACE_DRAWS = 20_000


def _kept(t, op):
    """``op(t)``, which must keep ``t``'s storage (an in-place method);
    returns ``t``."""
    ptr = t.data.data_ptr()
    op(t)
    if t.data.data_ptr() != ptr:
        raise AssertionError("an in-place method moved its tensor")
    return t


def _surface_dtype_calls(d):
    """The calls of ``_surface_calls`` on operands of dtype ``d``."""
    def a(x):
        return x("a", d, (3, 4), -0.5, 0.5)

    def b(x):
        return x("b", d, (4, 5), -0.5, 0.5)

    def p(x):
        return ttensor.SoftMax(x("p", "float32", (6, 5)))

    def ids(x):
        return x("ids", "int32", (6,), 0.5, 1.5)

    return (
        ("Mult", lambda T, x: T.Mult(a(x), b(x))),
        ("Mult vector", lambda T, x: T.Mult(a(x), x("v", d, (4,)))),
        ("GEMM", lambda T, x: T.GEMM(a(x), b(x), x("c", d, (3, 5)),
                                     alpha=0.5, beta=2.0)),
        ("GEMM trans", lambda T, x: T.GEMM(
            x("at", d, (4, 3)), x("bt", d, (5, 4)), transA=True,
            transB=True)),
        ("GEMV", lambda T, x: T.GEMV(a(x), x("v", d, (4,)),
                                     x("w", d, (3,)), beta=0.5)),
        ("Dot", lambda T, x: T.Dot(a(x), x("a2", d, (3, 4)))),
        ("Einsum", lambda T, x: T.Einsum("bij,jk->bik", x(
            "batch", d, (2, 3, 4)), b(x))),
        ("einsum", lambda T, x: T.einsum("ii->i", x("sq", d,
                                                    (3, 3)))),
        ("SoftMax", lambda T, x: T.SoftMax(a(x))),
        ("LogSoftMax", lambda T, x: T.LogSoftMax(a(x), axis=0)),
        ("Clamp", lambda T, x: T.Clamp(a(x), -0.25, 0.25)),
        ("Threshold", lambda T, x: T.Threshold(a(x), 0.1)),
        ("Reshape", lambda T, x: T.Reshape(a(x), (4, 3))),
        ("Transpose", lambda T, x: T.Transpose(x("c3", d, (2, 3, 4)))),
        ("Broadcast", lambda T, x: T.Broadcast(x("r", d, (1, 4)),
                                               (3, 4))),
        ("ConcatOn", lambda T, x: T.ConcatOn([a(x), a(x)], 1)),
        ("SliceOn", lambda T, x: T.SliceOn(a(x), 1, 3, 1)),
        ("ConcatenateRows", lambda T, x: T.ConcatenateRows(
            [a(x), a(x)])),
        ("ConcatenateColumns", lambda T, x: T.ConcatenateColumns(
            [a(x), a(x)])),
        ("CopyRows", lambda T, x: T.CopyRows(a(x), 0, 2)),
        ("CopyColumns", lambda T, x: T.CopyColumns(a(x), 1, 4)),
        ("Stack", lambda T, x: T.Stack([a(x), a(x)], 1)),
        ("Repeat", lambda T, x: T.Repeat(a(x), 2, 1)),
        ("Tile", lambda T, x: T.Tile(a(x), (2, 1))),
        ("Squeeze", lambda T, x: T.Squeeze(x("r", d, (1, 4)))),
        ("Unsqueeze", lambda T, x: T.Unsqueeze(a(x), -1)),
        ("Flatten", lambda T, x: T.Flatten(x("c3", d, (2, 3, 4)))),
        ("Gather", lambda T, x: T.Gather(a(x), [0, -1, 7, -3])),
        ("zeros_like", lambda T, x: T.zeros_like(a(x))),
        ("ones_like", lambda T, x: T.ones_like(a(x))),
        ("from_raw_tensor", lambda T, x: T.from_raw_tensor(
            a(x).data)),
        ("as_array", lambda T, x: T.from_raw_tensor(T.as_array(
            a(x)))),
        ("to_numpy", lambda T, x: T.to_numpy(a(x)).tolist()),
        ("getitem", lambda T, x: a(x)[1:, ::2]),
        ("transpose", lambda T, x: a(x).T),
        ("reshape", lambda T, x: a(x).reshape((2, 6))),
        ("as_type", lambda T, x: a(x).as_type(T.float64)),
        ("clone", lambda T, x: a(x).clone()),
        ("operators", lambda T, x: (a(x) + 1, 2.5 - a(x), a(x) * 3,
                                    a(x) / 2, a(x) ** 2,
                                    a(x) < 0.1, a(x) @ b(x))),
        ("size", lambda T, x: (a(x).size(), a(x).memsize(),
                               a(x).ndim, len(a(x)))),
        ("to_host", lambda T, x: a(x).to_host()),
        ("CrossEntropyFwd", lambda T, x: T.CrossEntropyFwd(p(x), ids(x))),
        ("SoftmaxCrossEntropyBwd", lambda T, x: T.SoftmaxCrossEntropyBwd(
            p(x), ids(x))))


def _surface_calls():
    """``(label, fn(T, x))``: ``T`` is the port's tensor module, ``x(key,
    dtype, shape, lo, hi)`` a seeded Tensor on the device under test;
    the label's first word names the function or method called."""
    calls = []

    def add(label, fn):
        calls.append((label, fn))

    for n in SURFACE_UNARY:
        lo, hi = SURFACE_DOMAIN.get(n, (-2.0, 2.0))
        for d in SURFACE_DTYPES:
            add(f"{n} {d}", lambda T, x, n=n, d=d, lo=lo, hi=hi:
                getattr(T, n)(x(n, d, (3, 4), lo, hi)))
    for n in SURFACE_BINARY:
        for d in SURFACE_DTYPES:
            lo, hi = (0.5, 2.0) if n == "Pow" else (-2.0, 2.0)
            for s in (2, 0.5, True):
                add(f"{n} {d} {s!r}", lambda T, x, n=n, d=d, s=s, lo=lo,
                    hi=hi: getattr(T, n)(x(n, d, (3, 4), lo, hi), s))
            for e in SURFACE_DTYPES:
                add(f"{n} {d} {e}", lambda T, x, n=n, d=d, e=e, lo=lo, hi=hi:
                    getattr(T, n)(x(n, d, (3, 4), lo, hi),
                                  x(n + "b", e, (3, 4), 0.5, 1.5)))
    for n, kws in SURFACE_REDUCE.items():
        for d in SURFACE_DTYPES:
            for k, kw in enumerate(kws):
                add(f"{n} {d} {k}", lambda T, x, n=n, d=d, kw=kw:
                    getattr(T, n)(x(n, d, (3, 4), -0.25, 0.25), **kw))
    for d in SURFACE_DTYPES:
        for label, fn in _surface_dtype_calls(d):
            add(f"{label} {d}", fn)
    for label, fn in (
            ("Axpy", lambda T, t, o: T.Axpy(0.5, o, t)),
            ("Scale", lambda T, t, o: T.Scale(1.5, t)),
            ("set_value", lambda T, t, o: t.set_value(0.25)),
            ("Fill", lambda T, t, o: T.Fill(t, -1.0)),
            ("copy_data", lambda T, t, o: t.copy_data(o)),
            ("copy_from_numpy", lambda T, t, o: t.copy_from_numpy(
                np.full((3, 4), 3.0))),
            ("reset_like", lambda T, t, o: t.reset_like(o)),
            ("setitem", lambda T, t, o: t.__setitem__((slice(None), 1), 9.0)),
            ("iadd", lambda T, t, o: t.__iadd__(o)),
            ("isub", lambda T, t, o: t.__isub__(0.5)),
            ("imul", lambda T, t, o: t.__imul__(o)),
            ("itruediv", lambda T, t, o: t.__itruediv__(2.0)),
            ("AddColumn", lambda T, t, o: T.AddColumn(o[:, 0], t)),
            ("SubColumn", lambda T, t, o: T.SubColumn(o[:, 1], t)),
            ("MultColumn", lambda T, t, o: T.MultColumn(o[:, 2], t)),
            ("DivColumn", lambda T, t, o: T.DivColumn(T.Abs(o[:, 3]) + 1,
                                                      t)),
            ("AddRow", lambda T, t, o: T.AddRow(o[0], t)),
            ("SubRow", lambda T, t, o: T.SubRow(o[1], t)),
            ("MultRow", lambda T, t, o: T.MultRow(o[2], t)),
            ("DivRow", lambda T, t, o: T.DivRow(T.Abs(o[0]) + 1, t))):
        add(f"{label} in place", lambda T, x, label=label, fn=fn: _kept(
            x("p" + label, "float32", (3, 4)),
            lambda t: fn(T, t, x("o" + label, "float32", (3, 4)))))
    for d in ("float32", "int32"):
        add(f"zeros {d}", lambda T, x, d=d: T.zeros((2, 3), dtype=d,
                                                    device=x.device))
        add(f"ones {d}", lambda T, x, d=d: T.ones((2, 3), dtype=d,
                                                  device=x.device))
        add(f"full {d}", lambda T, x, d=d: T.full((2,), 7, dtype=d,
                                                  device=x.device))
        add(f"arange {d}", lambda T, x, d=d: T.arange(1, 9, 2, dtype=d,
                                                      device=x.device))
        add(f"eye {d}", lambda T, x, d=d: T.eye(3, dtype=d,
                                                device=x.device))
        add(f"from_numpy {d}", lambda T, x, d=d: T.from_numpy(
            np.arange(4.0).astype(d), device=x.device))
    return calls


def _surface_run(device, calls):
    """Every call on seeded Tensors on ``device``: its result, or the
    exception it raised."""
    import zlib
    dev = tdevice.get_device(device)

    def x(key, dtype, shape=(3, 4), lo=-2.0, hi=2.0):
        rng = np.random.RandomState(
            zlib.crc32(repr((key, dtype, shape)).encode()))
        if dtype == "bool":
            arr = rng.rand(*shape) < 0.5
        elif dtype == "int32":      # no negative ints for a positive range
            arr = rng.randint(0 if lo >= 0 else -3, 4, shape).astype(
                np.int32)
        else:
            arr = rng.uniform(lo, hi, shape).astype(np.float32)
        return TTensor(data=torch.from_numpy(arr).to(dev.torch_device),
                       device=dev)
    x.device = dev
    out = {}
    for label, fn in calls:
        try:
            out[label] = fn(ttensor, x)
        except Exception as e:      # held against the CPU's outcome
            out[label] = e
    return out


def _surface_err(label, got, want, device):
    """The largest difference of a result on the card from the CPU's
    (0 for exact kinds); raises where they disagree in kind, dtype,
    shape, exact values or device."""
    if isinstance(want, Exception) or isinstance(got, Exception):
        if not (isinstance(want, Exception) and isinstance(got, Exception)):
            raise AssertionError(f"tensor_surface {label}: card {got!r}, "
                                 f"CPU {want!r}")
        return 0.0
    if isinstance(want, (tuple, list)):
        return max([_surface_err(label, g, w, device)
                    for g, w in zip(got, want)] or [0.0])
    if isinstance(want, (int, bool)):
        if got != want:
            raise AssertionError(f"tensor_surface {label}: {got} != {want}")
        return 0.0
    if isinstance(want, float):
        err = abs(got - want)
        if not (err <= SURFACE_TOL or (np.isnan(got) and np.isnan(want))):
            raise AssertionError(f"tensor_surface {label}: {got} != {want}")
        return err
    on = "cpu" if label.startswith("to_host") else device
    if got.data.device.type != on or got.device.torch_device.type != on:
        raise AssertionError(f"tensor_surface {label}: result on "
                             f"{got.data.device}, not {on}")
    g, w = got.data.detach().cpu(), want.data.detach()
    if g.dtype != w.dtype or g.shape != w.shape:
        raise AssertionError(f"tensor_surface {label}: {g.dtype} "
                             f"{tuple(g.shape)} != {w.dtype} "
                             f"{tuple(w.shape)}")
    if not g.is_floating_point():
        if not torch.equal(g, w):
            raise AssertionError(f"tensor_surface {label}: values differ")
        return 0.0
    if not torch.equal(g.isnan(), w.isnan()):
        raise AssertionError(f"tensor_surface {label}: NaNs differ")
    fin = w.isfinite()
    if not torch.equal(g[~fin & ~w.isnan()], w[~fin & ~w.isnan()]):
        raise AssertionError(f"tensor_surface {label}: infinities differ")
    err = float((g[fin].double() - w[fin].double()).abs().max()) \
        if fin.any() else 0.0
    if not err <= SURFACE_TOL:
        raise AssertionError(f"tensor_surface {label}: max |delta| {err}")
    return err


def _surface_draws(device):
    """The random fills on ``device``: in place, the dtype and shape
    kept, the range and moments of SURFACE_DRAWS draws (5 sigma), one
    seed one sequence."""
    for fill, args, mean, std in (("Uniform", (-1.0, 3.0), 1.0,
                                   4 / np.sqrt(12)),
                                  ("Gaussian", (0.5, 2.0), 0.5, 2.0),
                                  ("Bernoulli", (0.3,), 0.3,
                                   np.sqrt(0.21))):
        draws = []
        for seed in (5, 5, 6):
            dev = tdevice.Device(device, seed=seed)
            t = TTensor(shape=(SURFACE_DRAWS,), device=dev)
            _kept(t, lambda t: getattr(ttensor, fill)(*args, t))
            draws.append(t.data.double().cpu())
        x = draws[0]
        if not (torch.equal(x, draws[1]) and not torch.equal(x, draws[2])):
            raise AssertionError(f"tensor_surface {fill}: not seeded")
        m, s = float(x.mean()), float(x.std())
        if abs(m - mean) > 5 * std / np.sqrt(SURFACE_DRAWS) or \
                abs(s - std) > 0.05 * std:
            raise AssertionError(f"tensor_surface {fill}: mean {m}, std {s}")
        if fill == "Uniform" and not (-1 <= float(x.min()) and
                                      float(x.max()) <= 3):
            raise AssertionError("tensor_surface Uniform: out of range")
        if fill == "Bernoulli" and set(x.unique().tolist()) - {0.0, 1.0}:
            raise AssertionError("tensor_surface Bernoulli: not 0/1")


def phase_tensor_surface():
    """Path ``tensor_surface``: every function of the port's tensor.py
    (every name of its ``__all__``) and the Tensor methods and operators
    on CUDA tensors against the same calls on CPU tensors, over float32,
    int32 and bool operands: float32 within ``SURFACE_TOL``, integers and
    bools exactly, the same dtype and shape, each result on its input's
    device (the CPU for ``to_host``), an exception where the CPU raises;
    the in-place methods keep ``data_ptr()``; the random fills' range,
    moments and seeding on the card.  No kernel of the port lies on it:
    every counter must read 0."""
    t0 = time.perf_counter()
    calls = _surface_calls()
    names = {label.split()[0] for label, _ in calls}
    wanted = {n for n in ttensor.__all__ if callable(getattr(ttensor, n))
              and n != "Tensor"} - {"Uniform", "Gaussian", "Bernoulli"}
    if wanted - names:
        raise AssertionError(f"tensor_surface: not called "
                             f"{sorted(wanted - names)}")
    want = _surface_run("cpu", calls)
    torch.cuda.synchronize()
    _zero_launches()
    got = _surface_run("cuda", calls)
    _surface_draws("cuda")
    torch.cuda.synchronize()
    launches = _read_launches()
    _no_kernels("tensor_surface", launches)
    errs = {label: _surface_err(label, got[label], want[label], "cuda")
            for label, _ in calls}
    raised = sum(isinstance(v, Exception) for v in want.values())
    worst = max(errs, key=errs.get)
    stats = {"calls": len(calls), "functions": len(names),
             "raised_on_both": raised, "max_abs_err": errs[worst],
             "worst": worst, "seconds": time.perf_counter() - t0}
    _log(f"tensor_surface: {len(calls)} calls of {len(names)} functions "
         f"and methods on the card against the CPU ({raised} raise on "
         f"both), float32 max |delta| {errs[worst]:.3e} ({worst}; tol "
         f"{SURFACE_TOL:g}), integers and bools exact, results on their "
         f"input's device, in-place methods in place, the fills seeded; "
         f"{stats['seconds']:.1f}s")
    return launches, stats


# path profiling: train_cnn.py -v 1 / -v 2 on ResNet-50 at B 32,
# captured and eager (-v 1 over PROF_V1_STEPS steps, -v 2 over
# PROF_V2_STEPS), then the device surface and Model.on_device
PROF_V1_STEPS, PROF_V2_STEPS = 5, 2
# a -v 1 run's median step against a reference on the same path, within
# PROF_STEP_REL: train_cnn.py also uploads each numpy batch inside the
# timed step (19 MB).  Captured, the reference is resnet50_train's steady
# step (the card's time: +2.6 to +4.9 % on an H100).  Eager, the step is
# the host's (idle share ~0.24) and drifts with the host's load (-4.8 to
# +19 % of resnet50_train's eager step across three calls of the same
# code), so its reference is an eager ResNet-50 run timed in this phase,
# just before it, on the same batches with the same Sync each step
PROF_STEP_REL = 0.1
# FlopCounterMode's count of one ResNet-50 step at B 32 (forward, and
# backward without the input's gradient): about 3 x 8.2 GFLOP an image
PROF_FLOPS = (6e11, 1e12)
ON_DEVICE_STEPS = 6


def _memoised(load):
    """``load`` remembering its results by arguments: the runs of one
    phase draw the same synthetic images once."""
    seen = {}

    def call(*args, **kw):
        key = (args, tuple(sorted(kw.items())))
        if key not in seen:
            seen[key] = load(*args, **kw)
        return seen[key]
    return call


def _train_cnn_profiled(verbosity, graph, steps):
    """``train_cnn.py resnet50 -d imagenet -b 32 -v verbosity`` (``-g``
    when not ``graph``) in this process, from a scratch directory (its
    ``./profile_traces``): the printed table, the device's step times and
    flop tables, and the trace files it wrote (the trace stops when the
    verbosity drops to 0)."""
    import io
    import tempfile
    dev = tdevice.get_device("cuda")
    dev.Reset()
    argv = ["resnet50", "-d", "imagenet", "-b", str(R50_B), "-m", "1",
            "-n", str(R50_B * steps), "-v", str(verbosity)]
    argv += [] if graph else ["-g"]
    out = io.StringIO()
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as scratch:
        os.chdir(scratch)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                res = cnn_train.main(argv)
        finally:
            dev.SetVerbosity(0)
            os.chdir(here)
        wall = time.perf_counter() - t0
        traces = []
        for path in dev.trace_files:
            if path.startswith(scratch):
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
                traces.append({"bytes": os.path.getsize(path),
                               "kernels": sum(1 for e in events
                                              if e.get("cat") == "kernel")})
        dev.trace_files = []
    table = out.getvalue()
    for line in table.splitlines():
        _log(f"  | {line}")
    return {"table": table, "times": list(dev._step_times_ms),
            "costs": dict(dev._cost_tables), "traces": traces,
            "losses": res["step_losses"], "wall_s": wall}


def _eager_reference(steps):
    """The median step of ``steps`` eager ResNet-50 steps at B 32 from
    train_cnn.py's seed, model and optimizer, on the first batches of
    the data a ``-v 1`` run of as many steps loads, each timed as
    ``Model`` times a step at verbosity 1: from before
    ``train_one_batch`` (the numpy batch's upload included) to after
    ``Device.Sync()``."""
    dev = tdevice.get_device("cuda")
    x, y, _ = cnn_train.loader.load(
        "imagenet", num=R50_B * steps, seed=0,
        data_dir=os.environ.get("SINGA_DATA_DIR"))
    m = _zoo_model("resnet50", use_graph=False, x=x[:R50_B],
                   num_classes=1000)
    times = []
    for s in range(steps):
        xb, yb = x[s * R50_B:(s + 1) * R50_B], y[s * R50_B:(s + 1) * R50_B]
        t0 = time.perf_counter()
        m.train_one_batch(xb, yb)
        dev.Sync()
        times.append((time.perf_counter() - t0) * 1e3)
    del m
    gc.collect()
    _log(f"profiling eager reference: steps {times} ms")
    return sorted(times)[steps // 2]


def _check_profiled(label, run, steps, steady=None, rel=0.0):
    """The table's step-time line and flop table; the step times against
    the device's records and (``steady``) a reference step on the same
    path, the median within ``rel`` of it."""
    m = re.search(r"compiled steps timed: (\d+)  mean ([0-9.]+) ms  "
                  r"p50 ([0-9.]+) ms  max ([0-9.]+) ms", run["table"])
    if m is None or int(m.group(1)) != steps or len(run["times"]) != steps:
        raise AssertionError(f"{label}: no step-time line for {steps} "
                             f"steps:\n{run['table']}")
    ts = sorted(run["times"])
    p50 = float(m.group(3))
    if abs(p50 - ts[steps // 2]) > 1e-3 or \
            abs(float(m.group(2)) - sum(ts) / steps) > 1e-3:
        raise AssertionError(f"{label}: the table disagrees with the "
                             f"recorded step times {ts}")
    if not sum(ts) / 1e3 < run["wall_s"]:
        raise AssertionError(f"{label}: steps timed longer than the run")
    if len(run["costs"]) != 1:
        raise AssertionError(f"{label}: {len(run['costs'])} flop tables")
    cost = next(iter(run["costs"].values()))
    if not PROF_FLOPS[0] < cost["flops"] < PROF_FLOPS[1] or \
            any(k.startswith("launches") for k in cost) or \
            "flop count" not in run["table"]:
        raise AssertionError(f"{label}: flop table {cost}")
    if steady is not None and abs(p50 - steady) > rel * steady:
        raise AssertionError(f"{label}: median step {p50:.2f} ms, the "
                             f"reference step {steady:.2f} ms (tol "
                             f"{rel:g})")
    if not all(np.isfinite(run["losses"])):
        raise AssertionError(f"{label}: losses {run['losses']}")
    return {"steps_ms": run["times"], "p50_ms": p50,
            "mean_ms": float(m.group(2)), "flops": cost["flops"],
            "reference_step_ms": steady, "wall_s": run["wall_s"]}


def _on_device_round_trip():
    """The MNIST CNN, captured, ON_DEVICE_STEPS steps: ``on_device`` to
    the CPU and back to the card between steps 2 and 3 (no step on the
    CPU) against the uninterrupted run: every loss and state bit for bit;
    every state and optimizer state is on the CPU in between and back on
    the card as a leaf after, and the next step is a first call again,
    then a capture (2 captures against 1)."""
    x, y = cnn_synthetic.load("mnist", num=CNN_B * ON_DEVICE_STEPS, seed=0)
    batches = [(x[s * CNN_B:(s + 1) * CNN_B], y[s * CNN_B:(s + 1) * CNN_B])
               for s in range(ON_DEVICE_STEPS)]

    def run(move):
        m = _zoo_model("cnn", x=x[:CNN_B], num_classes=10, num_channels=1)
        losses = []
        for s, (xb, yb) in enumerate(batches):
            if move and s == 2:
                m.on_device("cpu")
                if any(t.data.device.type != "cpu" or t.device.lang != "cpp"
                       for t in m._registry()) or m._graphs:
                    raise AssertionError("on_device: a state stayed on the "
                                         "card")
                m.on_device("cuda")
                if any(t.data.device.type != "cuda" or
                       (t.stores_grad and not t.data.is_leaf)
                       for t in m._registry()):
                    raise AssertionError("on_device: a state did not come "
                                         "back as a leaf on the card")
            losses.append(m.train_one_batch(xb, yb)[1].item())
        return m, losses

    whole, lw = run(False)
    sw = _host_states(whole)
    counts = (dict(whole.graph_captures), dict(whole.graph_replays))
    del whole
    moved, lm = run(True)
    if lm != lw:
        raise AssertionError(f"on_device: losses {lm} against {lw}")
    _same_states("on_device round trip", _host_states(moved), sw)
    got = (dict(moved.graph_captures), dict(moved.graph_replays))
    n = ON_DEVICE_STEPS
    if counts != ({"train": 1}, {"train": n - 1}) or \
            got != ({"train": 2}, {"train": n - 2}):
        raise AssertionError(f"on_device: captures and replays {got}, "
                             f"uninterrupted {counts}")
    _log(f"on_device round trip (MNIST CNN, B {CNN_B}, card -> CPU -> card "
         f"between steps 2 and 3): {n} losses and every state bit for bit "
         f"with the uninterrupted run; captures / replays {got} against "
         f"{counts}")
    return {"losses": lm, "captures": got[0], "replays": got[1],
            "uninterrupted": {"captures": counts[0], "replays": counts[1]}}


class _DropNet(tmodel.Model):
    """Linear 256, ReLU, Dropout 0.5, Linear 10: a step that draws."""

    def __init__(self):
        super().__init__()
        self.fc1 = tlayer.Linear(256)
        self.relu = tlayer.ReLU()
        self.drop = tlayer.Dropout(0.5)
        self.fc2 = tlayer.Linear(10)

    def forward(self, x):
        return self.fc2(self.drop(self.relu(self.fc1(x))))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = tautograd.softmax_cross_entropy(out, y)
        self.optimizer(loss)
        return out, loss


def _rng_state_replays():
    """``Device.set_rng_state`` between replays of a captured step with
    dropout: the state taken before a replay, put back (with the model's
    states), gives that replay's mask again, and the eager step from the
    same state and states gives it too, bit for bit; a replay without
    the restore draws another mask."""
    dev = tdevice.get_device("cuda")
    x, y = mlp.synthetic_mnist(n=MLP_B, seed=0)

    def make(use_graph):
        dev.set_rand_seed(0)
        m = _DropNet()
        m.set_optimizer(topt.SGD(lr=MLP_LR, momentum=0.9))
        m.compile([TTensor(data=x, device=dev, requires_grad=False)],
                  is_train=True, use_graph=use_graph)
        return m

    g = make(True)
    for _ in range(2):                 # the eager first call, the capture
        g.train_one_batch(x, y)
    saved = _device_states(g)
    state = dev.get_rng_state()
    out_a, loss_a = g.train_one_batch(x, y)
    states_a = _host_states(g)
    _restore(g, saved)
    dev.set_rng_state(state)
    out_b, _ = g.train_one_batch(x, y)
    out_c, _ = g.train_one_batch(x, y)
    if g.graph_replays != {"train": 4}:
        raise AssertionError(f"rng state: replays {g.graph_replays}")
    if not torch.equal(out_a.data, out_b.data):
        raise AssertionError("rng state: the restored replay drew another "
                             "mask")
    if torch.equal(out_b.data, out_c.data):
        raise AssertionError("rng state: two replays drew one mask")
    e = make(False)
    e.train_one_batch(x, y)            # its optimizer state exists
    _restore(e, saved)
    dev.set_rng_state(state)
    out_e, loss_e = e.train_one_batch(x, y)
    if not torch.equal(out_e.data, out_a.data) or \
            loss_e.item() != loss_a.item():
        raise AssertionError("rng state: the eager step from the same "
                             "state drew another mask")
    _same_states("rng state: eager against the replay", _host_states(e),
                 states_a)
    _log("rng state: a replay after set_rng_state repeats its mask (and "
         "the eager step from that state equals it bit for bit); the next "
         "replay draws a fresh one")
    return {"restored_replay_equal": True, "eager_equal": True}


def _smi(query):
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    return [ln.strip() for ln in r.stdout.strip().splitlines()]


def _device_surface():
    """``DeviceMemPool`` against ``torch.cuda``, ``Platform`` against
    ``nvidia-smi``, and ``Sync`` against a queued spin."""
    dev = tdevice.get_device("cuda")
    pool = tdevice.DeviceMemPool(dev)
    torch.cuda.synchronize()
    got = (pool.used_bytes(), pool.peak_bytes(), pool.stats())
    want = (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated(),
            dict(torch.cuda.memory_stats()))
    if got != want:
        raise AssertionError("DeviceMemPool: counters differ from "
                             "torch.cuda's")
    free, total = pool.GetMemUsage()
    t_free, t_total = torch.cuda.mem_get_info()
    smi_n = len(_smi("index"))
    smi_total, smi_free = (int(v) * 2 ** 20 for v in
                           _smi("memory.total,memory.free")[0].split(","))
    n = tdevice.Platform.GetNumGPUs()
    g_free, g_total = tdevice.Platform.GetGPUMemSize(0)
    if total != t_total or abs(free - t_free) > 64 << 20 or \
            g_total != total or n != smi_n or \
            len(tdevice.Platform.accelerator_devices()) != n or \
            not 0.95 * smi_total <= g_total <= 1.01 * smi_total or \
            not 0 < g_free <= g_total:
        raise AssertionError(
            f"DeviceMemPool / Platform: pool ({free}, {total}), torch "
            f"({t_free}, {t_total}), GetGPUMemSize ({g_free}, {g_total}), "
            f"nvidia-smi {smi_n} card(s), total {smi_total}, free "
            f"{smi_free}; GetNumGPUs {n}")
    if len(tdevice.Platform.CreateCudaGPUs(n)) != n:
        raise AssertionError("Platform.CreateCudaGPUs")
    try:
        tdevice.create_cuda_gpu_on(n)
    except RuntimeError:
        pass
    else:
        raise AssertionError(f"create_cuda_gpu_on({n}) did not raise")
    spin = torch.cuda.Event()
    torch.cuda._sleep(200_000_000)      # about 0.1 s of device time
    spin.record()
    queued = not spin.query()
    dev.Sync()
    if not (queued and spin.query()):
        raise AssertionError(f"Sync: the spin was queued {queued}, done "
                             f"after Sync {spin.query()}")
    out = {"GetNumGPUs": n, "nvidia_smi_cards": smi_n,
           "GetGPUMemSize": [g_free, g_total],
           "nvidia_smi_total_bytes": smi_total,
           "nvidia_smi_free_bytes": smi_free,
           "pool_used_bytes": got[0], "pool_peak_bytes": got[1]}
    _log("device surface: " + json.dumps(out) + "; Sync waits for a queued "
         "0.1 s spin")
    return out


def phase_profiling(r50_stats):
    """Path ``profiling``: ``train_cnn.py resnet50 -d imagenet -b 32`` at
    ``-v 1`` (PROF_V1_STEPS steps) and ``-v 2`` (PROF_V2_STEPS), captured
    and eager, in this process: the reference's step-time line and flop
    table printed by ``Device.PrintTimeProfiling`` and agreeing with the
    device's records, the ``-v 1`` median step within PROF_STEP_REL of
    a reference on the same path (captured: path 17's steady step; eager:
    ``_eager_reference``, timed just before), and at ``-v 2`` a trace file
    with the card's kernels in it; ``DeviceMemPool``, ``Platform`` and
    ``Sync`` (``_device_surface``); the ``on_device`` round trip and
    ``set_rng_state`` between replays.  No kernel of the port lies on
    it: every counter must read 0."""
    t0 = time.perf_counter()
    load = cnn_train.loader.load
    cnn_train.loader.load = _memoised(load)
    torch.cuda.synchronize()
    _zero_launches()
    runs = {}
    try:
        for v, steps in ((1, PROF_V1_STEPS), (2, PROF_V2_STEPS)):
            for graph in (True, False):
                label = f"profiling -v {v} {'captured' if graph else 'eager'}"
                steady = None
                if v == 1:
                    steady = (r50_stats["steady_step_ms"] if graph
                              else _eager_reference(steps))
                run = _train_cnn_profiled(v, graph, steps)
                runs[label] = _check_profiled(label, run, steps, steady,
                                              PROF_STEP_REL)
                if v == 2:
                    if len(run["traces"]) != 1 or \
                            not run["traces"][0]["kernels"] > 0:
                        raise AssertionError(f"{label}: traces "
                                             f"{run['traces']}")
                    runs[label]["trace"] = run["traces"][0]
                elif run["traces"]:
                    raise AssertionError(f"{label}: a trace at -v 1")
                _log(f"{label}: " + json.dumps(runs[label]))
                gc.collect()
    finally:
        cnn_train.loader.load = load
    stats = {"train_cnn": runs, "device": _device_surface(),
             "on_device": _on_device_round_trip(),
             "rng_state": _rng_state_replays()}
    torch.cuda.synchronize()
    launches = _read_launches()
    _no_kernels("profiling", launches)
    stats["seconds"] = time.perf_counter() - t0
    _log(f"profiling phase: {stats['seconds']:.1f}s")
    return launches, stats


# ---- path resilience (phase 25) --------------------------------------------

# in-process runs: ResNet-50 B 32 over path 17's batches (RES_STEPS steps,
# batch s % 5), a save every RES_SAVE_EVERY steps, a NaN batch at
# RES_NAN_STEP (rollback) and at RES_SKIP_STEP (skip)
RES_STEPS, RES_SAVE_EVERY, RES_NAN_STEP, RES_SKIP_STEP = 8, 2, 5, 3
# the steps timed with and without a save in flight; saves start at these
RES_TIMED_STEPS, RES_TIMED_SAVES = 16, (6,)
# the SIGKILL drill: train_cnn.py resnet50 -d imagenet -b 32, 6 steps
# (the fewest that hold a kill at step 5 and a resume at step 3),
# --ckpt-every 3, killed at step 5 (saves written on the training thread)
# or in the 2nd save (staged)
DRILL_STEPS, DRILL_EVERY, DRILL_KILL_STEP, DRILL_KILL_SAVE = 6, 3, 5, 2
DRILL_TIMEOUT = 300
# what train_cnn.py leaves alone and the drill must pin: one process's
# convolution algorithms must be another's; every line the process
# writes to stderr starts with its own clock, "[12.34s] ", so the drill
# can say where a process's time goes (a killed one's too)
DRILL_PRELUDE = ("import sys, time\n"
                 "T0 = time.perf_counter()\n"
                 "class Stamped:\n"
                 "    def __init__(self, f):\n"
                 "        self.f, self.bol = f, True\n"
                 "    def write(self, s):\n"
                 "        out = []\n"
                 "        for part in s.splitlines(True):\n"
                 "            if self.bol:\n"
                 "                out.append(f'[{time.perf_counter() - T0:.2f}s] ')\n"
                 "            out.append(part)\n"
                 "            self.bol = part.endswith('\\n')\n"
                 "        return self.f.write(''.join(out))\n"
                 "    def __getattr__(self, name):\n"
                 "        return getattr(self.f, name)\n"
                 "sys.stderr = Stamped(sys.stderr)\n"
                 "import torch\n"
                 "torch.backends.cudnn.deterministic = True\n"
                 "torch.backends.cudnn.benchmark = False\n"
                 "torch.backends.cuda.matmul.allow_tf32 = False\n"
                 "torch.backends.cudnn.allow_tf32 = False\n"
                 "from singa_tpu_torch.examples.cnn import train_cnn\n"
                 "print('drill: imported', file=sys.stderr, flush=True)\n"
                 "train_cnn.main(sys.argv[1:])\n")


def _res_batch(batches, s):
    return batches[s % len(batches)]


def _res_model(batches, use_graph=True):
    return _zoo_model("resnet50", use_graph=use_graph, x=batches[0][0],
                      num_classes=1000)


def _res_states(model):
    """Every state by name on the host (optimizer states through
    ``get_states``, restored-but-pending ones included, under
    ``opt.``)."""
    out = {n: t.data.detach().to("cpu", copy=True)
           for n, t in model.get_states().items()}
    out.update({f"opt.{k}": torch.as_tensor(np.array(v))
                for k, v in model.optimizer.get_states().items()})
    return out


LOSS_SCALE_STATES = {"opt.loss_scale", "opt.loss_scale_good_steps",
                     "opt.loss_scale_found_inf"}


def _res_same(label, got, want, extra=()):
    """``got`` against ``want`` bit for bit on ``want``'s names; ``got``
    may hold ``extra`` names more (the skip guard's loss scale)."""
    if set(got) - set(want) - set(extra) or set(want) - set(got):
        raise AssertionError(f"{label}: state names differ: "
                             f"{sorted(set(got) ^ set(want))[:6]}")
    _same_states(label, {k: got[k] for k in want}, want)


def _res_steps(trainer, batches, until):
    """Resilient steps until the trainer's index reaches ``until`` (the
    batch of step i is ``_res_batch(batches, i)``); ``(index, loss,
    rolled back)`` of each."""
    out = []
    while trainer.step_index < until and len(out) < 3 * until:
        x, y = _res_batch(batches, trainer.step_index)
        trainer.step(x, y)
        rep = trainer.last
        out.append((rep.index, rep.loss, rep.rolled_back))
    return out


def _res_save_resume(batches, ref, ckdir):
    """ResilientTrainer (skip guard armed) with a snapshot
    CheckpointManager, a save every RES_SAVE_EVERY steps: the losses
    equal the plain run's bit for bit; every published file passes its
    CRC; the newest loads through ``Model.load_states`` into a fresh
    model, equal to the trained one."""
    from singa_tpu_torch import telemetry
    from singa_tpu_torch.resilience import (CheckpointManager,
                                            ResilientTrainer, checkpoint)
    tracer = telemetry.install(telemetry.SpanTracer())
    try:
        model = _res_model(batches)
        ck = CheckpointManager(model, ckdir, fmt="snapshot")
        tr = ResilientTrainer(model, checkpoint=ck,
                              save_every=RES_SAVE_EVERY)
        steps = _res_steps(tr, batches, RES_STEPS)
        ck.wait()
    finally:
        telemetry.uninstall()
    losses = [loss for _, loss, _ in steps]
    _log(f"resilience save: losses {losses} against the plain run's "
         f"{ref['losses']}; captures {model.graph_captures}, replays "
         f"{model.graph_replays}")
    if losses != ref["losses"]:
        raise AssertionError("resilience: the checkpointed run's losses "
                             "differ from the plain run's")
    _res_same("resilience save against the plain run", _res_states(model),
              ref["states"], LOSS_SCALE_STATES)
    entries = ck._load_manifest()["checkpoints"]
    for e in entries:
        f = e["files"][0]
        path = os.path.join(ckdir, f["name"])
        if checkpoint._crc32(path) != f["crc32"] or \
                os.path.getsize(path) != f["size"]:
            raise AssertionError(f"resilience: {f['name']} fails its CRC")
    newest = os.path.join(ckdir, entries[-1]["files"][0]["name"])
    fresh = _res_model(batches, use_graph=False)
    fresh.load_states(newest)
    _res_same("resilience: the newest file through Model.load_states",
              _res_states(model), _res_states(fresh), LOSS_SCALE_STATES)
    del fresh
    snap = [d * 1e3 for _, _, d in tracer.spans("checkpoint_snapshot")]
    write = [d * 1e3 for _, _, d in tracer.spans("checkpoint_write")]
    sizes = [e["files"][0]["size"] for e in entries]
    stats = {"saves": len(snap), "snapshot_ms": snap, "write_ms": write,
             "bytes": sizes[-1], "files": [e["files"][0]["name"]
                                           for e in entries],
             "crc_ok": len(entries)}
    _log(f"resilience save: {len(snap)} saves, snapshot (device-to-host "
         f"copy, training thread) {', '.join(f'{v:.1f}' for v in snap)} "
         f"ms, write (writer thread) {', '.join(f'{v:.1f}' for v in write)}"
         f" ms, {sizes[-1]} bytes a file; {len(entries)} files pass "
         f"their CRC")
    return stats


def _res_rollback(batches, ref, ckdir):
    """A NaN batch at RES_NAN_STEP under ``rollback``: back to the last
    checkpoint in place, with no new capture; the replayed steps equal
    the plain run's bit for bit (no draw on this path)."""
    from singa_tpu_torch.resilience import (CheckpointManager, NaNGrads,
                                            ResilientTrainer,
                                            TrainFaultPlan)
    model = _res_model(batches)
    ck = CheckpointManager(model, ckdir, fmt="snapshot")
    tr = ResilientTrainer(model, checkpoint=ck, save_every=RES_SAVE_EVERY,
                          nonfinite_policy="rollback",
                          faults=TrainFaultPlan(NaNGrads(RES_NAN_STEP)))
    steps = _res_steps(tr, batches, RES_STEPS)
    ck.wait()
    last = {i: loss for i, loss, rolled in steps if not rolled}
    _log(f"resilience rollback: steps {steps}; rollbacks {tr.rollbacks}, "
         f"captures {model.graph_captures}, replays {model.graph_replays}")
    if tr.rollbacks != 1 or model.graph_captures != {"train": 1}:
        raise AssertionError("resilience rollback: want one rollback and "
                             "one capture")
    if not all(np.isfinite(v) for v in last.values()) or \
            [last[i] for i in range(RES_STEPS)] != ref["losses"]:
        raise AssertionError("resilience rollback: the losses after the "
                             "rollback differ from the plain run's")
    _res_same("resilience rollback against the plain run",
              _res_states(model), ref["states"])
    return {"rollbacks": tr.rollbacks, "captures": model.graph_captures,
            "replays": model.graph_replays,
            "rolled_back_at": [i for i, _, r in steps if r]}


def _res_skip(batches):
    """A NaN batch at RES_SKIP_STEP under ``skip``: every parameter and
    every per-parameter optimizer state (the momenta) bit-identical
    across it (the guard in the captured step), no new capture, finite
    losses after it.  The step counter and the loss scale's good-step
    count move, as the reference's do.  BatchNorm's running statistics
    are written by the forward, outside the optimizer, and take the
    batch's NaN statistics, as the reference's do: they are counted, not
    held."""
    from singa_tpu_torch.resilience import (NaNGrads, ResilientTrainer,
                                            TrainFaultPlan)
    model = _res_model(batches)
    tr = ResilientTrainer(model,
                          faults=TrainFaultPlan(NaNGrads(RES_SKIP_STEP)))
    losses = []
    for s in range(RES_SKIP_STEP + 2):
        if s == RES_SKIP_STEP:
            before = _res_states(model)
        tr.step(*_res_batch(batches, s))
        losses.append(tr.last.loss)
        if s == RES_SKIP_STEP:
            after = _res_states(model)
            if not (tr.last.nonfinite and tr.last.skipped):
                raise AssertionError("resilience skip: the step was not "
                                     "skipped")
    running = {n for n in before if ".running_" in n}
    held = {n: before[n] for n in before if n not in running
            and (not n.startswith("opt.") or ":" in n)}
    _same_states("resilience skip: parameters and momenta across the "
                 "poisoned step", {n: after[n] for n in held}, held)
    moved = sorted(n for n in before if n not in held
                   and not torch.equal(after[n], before[n]))
    nan_buffers = sum(1 for n in running if torch.isnan(after[n]).any())
    _log(f"resilience skip: losses {losses}; {len(held)} states "
         f"bit-identical across step {RES_SKIP_STEP}; "
         f"{nan_buffers} of {len(running)} BatchNorm running buffers hold "
         f"NaN after it; scalars moved: "
         f"{[n for n in moved if n not in running]}; captures "
         f"{model.graph_captures}")
    if model.graph_captures != {"train": 1} or \
            not all(np.isfinite(losses[RES_SKIP_STEP + 1:])):
        raise AssertionError("resilience skip: a new capture or a "
                             "non-finite loss after the skip")
    return {"held_states": len(held), "bn_buffers_nan": nan_buffers,
            "bn_buffers": len(running), "losses": losses}


def _res_reseed(root):
    """The rollback's reseed on a captured dropout step (phase 24's
    ``_DropNet``): a NaN batch at step 3 under ``rollback`` (saves every
    2 steps) makes step 2's replay draw another mask than its first run;
    two captured runs and the eager twin give the same losses bit for
    bit (the reseed goes through ``set_rng_state``, which a replay
    reads), with no new capture."""
    from singa_tpu_torch.resilience import (CheckpointManager, NaNGrads,
                                            ResilientTrainer,
                                            TrainFaultPlan)
    dev = tdevice.get_device("cuda")
    x, y = mlp.synthetic_mnist(n=MLP_B, seed=0)
    runs = {}
    for label, graph in (("captured", True), ("again", True),
                         ("eager", False)):
        dev.set_rand_seed(0)
        m = _DropNet()
        m.set_optimizer(topt.SGD(lr=MLP_LR, momentum=0.9))
        m.compile([TTensor(data=x, device=dev, requires_grad=False)],
                  is_train=True, use_graph=graph)
        ck = CheckpointManager(m, os.path.join(root, f"reseed_{label}"),
                               async_save=False)
        tr = ResilientTrainer(m, checkpoint=ck, save_every=2,
                              nonfinite_policy="rollback",
                              faults=TrainFaultPlan(NaNGrads(3)))
        seen = []
        while tr.step_index < 5 and len(seen) < 20:
            tr.step(x, y)
            seen.append((tr.last.index, tr.last.loss))
        runs[label] = (seen, dict(m.graph_captures))
    seen = runs["captured"][0]
    _log(f"resilience reseed: steps {seen}; captures "
         f"{runs['captured'][1]}")
    if [i for i, _ in seen] != [0, 1, 2, 3, 2, 3, 4] or \
            seen[4][1] == seen[2][1]:
        raise AssertionError("resilience reseed: the replay of step 2 drew "
                             "the mask of its first run")
    # repr: the poisoned step's NaN loss compares equal to itself there
    if not repr(runs["captured"][0]) == repr(runs["again"][0]) == \
            repr(runs["eager"][0]) or runs["captured"][1] != {"train": 1}:
        raise AssertionError(f"resilience reseed: runs differ: {runs}")
    return {"replayed_step2_loss": seen[4][1], "first_step2_loss":
            seen[2][1]}


def _res_timing(batches, ckdir, graph):
    """The step (``train_one_batch`` to ``loss.item()``) with a
    background snapshot write in flight against without one, in one run
    (saves at RES_TIMED_SAVES, their copy outside the timed steps;
    steps 0-1 warm up)."""
    from singa_tpu_torch.resilience import CheckpointManager
    model = _res_model(batches, use_graph=graph)
    ck = CheckpointManager(model, ckdir, fmt="snapshot", async_save=True,
                           keep=1)
    clean, flight = [], []
    for s in range(RES_TIMED_STEPS):
        if s in RES_TIMED_SAVES:
            ck.save(s)
        busy = ck.in_flight
        t0 = time.perf_counter()
        _, loss = model.train_one_batch(*_res_batch(batches, s))
        loss.item()
        if s >= 2:
            (flight if busy else clean).append(
                (time.perf_counter() - t0) * 1e3)
    ck.wait()
    out = {"steps_clean": len(clean), "steps_in_flight": len(flight),
           "median_ms": float(np.median(clean)) if clean else None,
           "median_in_flight_ms": (float(np.median(flight)) if flight
                                   else None)}
    _log(f"resilience {'captured' if graph else 'eager'} step: median "
         f"{out['median_ms']} ms over {len(clean)} steps without a save "
         f"in flight, {out['median_in_flight_ms']} ms over {len(flight)} "
         f"with one")
    del model
    gc.collect()
    return out


def _drill_proc(ckdir, extra):
    argv = ["resnet50", "-d", "imagenet", "-b", str(R50_B), "-m", "1",
            "-n", str(R50_B * DRILL_STEPS), "--ckpt-every",
            str(DRILL_EVERY), "--log-steps", "--ckpt", ckdir] + extra
    return subprocess.Popen([sys.executable, "-c", DRILL_PRELUDE] + argv,
                            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _drill_wait(procs):
    """Each ``(label, process, want killed)``: its step losses (the
    ``%r`` strings), its exit code checked."""
    out = {}
    for label, proc, killed in procs:
        _, err = proc.communicate(timeout=DRILL_TIMEOUT)
        if (proc.returncode != 0) != killed:
            raise AssertionError(f"resilience drill {label}: exit "
                                 f"{proc.returncode}\n{err[-3000:]}")
        out[label] = {int(m.group(1)): m.group(2) for m in re.finditer(
            r"step (\d+): loss=(\S+)", err)}
        _log(f"resilience drill {label}: exit {proc.returncode}; "
             + ", ".join(f"{k} at {v}s" for k, v in _drill_clock(err))
             + " of its own clock")
    return out


def _drill_clock(err):
    """Where a drill process's time went, from its stamped stderr: the
    imports, the data, its first and last step, its last line."""
    lines = re.findall(r"^\[(\d+\.\d+)s\] (.*)$", err, re.M)
    steps = [t for t, text in lines if re.search(r"step \d+: loss=", text)]
    marks = [("imports", [t for t, text in lines
                          if "drill: imported" in text]),
             ("data", [t for t, text in lines if "dataset" in text]),
             ("first step", steps[:1]), ("last step", steps[-1:]),
             ("last line", [t for t, _ in lines[-1:]])]
    return [(k, v[0]) for k, v in marks if v]


def _drill_check(label, truth, killed, resumed, resume_at):
    covered = dict(killed)
    covered.update(resumed)
    _log(f"resilience drill {label}: killed run steps {sorted(killed)}, "
         f"resumed at {min(resumed) if resumed else None}")
    if min(resumed) != resume_at or sorted(covered) != sorted(truth) or \
            any(covered[s] != truth[s] for s in truth):
        raise AssertionError(f"resilience drill {label}: {covered} against "
                             f"the uninterrupted {truth}")


class _Drill:
    """``train_cnn.py resnet50 -d imagenet -b 32 --ckpt-every 3`` in
    processes of its own (``DRILL_PRELUDE``; run beside the in-process
    checks, a capture there failed with a cuDNN internal error, so the
    drill has the card to itself): :meth:`start` runs it uninterrupted, SIGKILLed at step 5 (zip,
    ``--ckpt-sync``: an async write outlasts the two steps before the
    kill, which would then find nothing published) and in the 2nd save
    at ``staged`` (snapshot, async: a save waits for the one before it),
    the three at once; :meth:`resume` checks that the killed save left
    the manifest at save 1 and resumes both with ``--resume``;
    :meth:`finish` holds every step's loss against the uninterrupted
    run's, bit for bit, from step 3.  :meth:`stop` ends any process
    left."""

    def __init__(self, root):
        self.dirs = {k: os.path.join(root, f"drill_{k}")
                     for k in ("truth", "step", "save")}
        self.procs = []
        self.t0 = time.perf_counter()

    def _run(self, label, key, extra, killed):
        proc = _drill_proc(self.dirs[key], extra)
        self.procs.append(proc)
        return label, proc, killed

    def start(self):
        snap = ["--ckpt-format", "snapshot"]
        self.first = [
            self._run("truth", "truth", [], False),
            self._run("kill_step", "step", [
                "--ckpt-sync", "--chaos-kill-step", str(DRILL_KILL_STEP)],
                True),
            self._run("kill_save", "save", snap + [
                "--chaos-kill-save", str(DRILL_KILL_SAVE),
                "--chaos-kill-phase", "staged"], True)]
        return self

    def resume(self):
        self.first = _drill_wait(self.first)
        with open(os.path.join(self.dirs["save"], "manifest.json")) as f:
            self.saved = [e["step"] for e in json.load(f)["checkpoints"]]
        _log(f"resilience drill kill_save: manifest steps {self.saved}, "
             f"files {sorted(os.listdir(self.dirs['save']))}")
        if self.saved != [DRILL_EVERY]:
            raise AssertionError("resilience drill: the killed save moved "
                                 "the manifest")
        self.second = [
            self._run("resume_step", "step", ["--resume"], False),
            self._run("resume_save", "save",
                      ["--ckpt-format", "snapshot", "--resume"], False)]

    def finish(self):
        second = _drill_wait(self.second)
        truth = self.first["truth"]
        if sorted(truth) != list(range(DRILL_STEPS)):
            raise AssertionError(f"resilience drill: truth steps "
                                 f"{sorted(truth)}")
        _drill_check("kill at step", truth, self.first["kill_step"],
                     second["resume_step"], DRILL_EVERY)
        _drill_check("kill in save (snapshot, staged)", truth,
                     self.first["kill_save"], second["resume_save"],
                     DRILL_EVERY)
        return {"losses": [truth[s] for s in range(DRILL_STEPS)],
                "manifest_after_kill": self.saved,
                "seconds": time.perf_counter() - self.t0}

    def stop(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _res_loader(batches):
    """``DataLoader(to_device=card)``: the worker's copies equal
    the host batches."""
    from singa_tpu_torch.data import ArrayDataset, DataLoader
    x = np.concatenate([b[0].cpu().numpy() for b in batches[:2]])
    y = np.concatenate([b[1].cpu().numpy() for b in batches[:2]])
    host = list(DataLoader(ArrayDataset(x, y), R50_B, seed=0))
    card = list(DataLoader(ArrayDataset(x, y), R50_B, seed=0,
                           to_device="cuda"))
    for (hx, hy), (cx, cy) in zip(host, card):
        if not (cx.is_cuda and torch.equal(cx.cpu(), torch.from_numpy(hx))
                and torch.equal(cy.cpu(), torch.from_numpy(hy))):
            raise AssertionError("resilience: DataLoader(to_device) batches "
                                 "differ from the host's")
    return len(card)


def phase_resilience(batches):
    """Path ``resilience``: ResNet-50 B 32 at full width, captured,
    through :mod:`singa_tpu_torch.resilience` on path 17's batches: a
    plain run of RES_STEPS steps; the same through ResilientTrainer with
    a snapshot CheckpointManager (``_res_save_resume``); a NaN batch
    under ``rollback`` (``_res_rollback``) and under ``skip``
    (``_res_skip``); the rollback's reseed on a dropout net
    (``_res_reseed``); ``DataLoader(to_device=)``; the SIGKILL drill
    through train_cnn.py (``_Drill``); then, alone on the card again,
    the step with and without a save in flight, captured and eager
    (``_res_timing``).  No kernel of the port lies on it: every counter
    must read 0."""
    import tempfile
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    _zero_launches()
    stats = {}
    parts = {}
    lap = [time.perf_counter()]

    def done(part):
        now = time.perf_counter()
        parts[part] = now - lap[0]
        lap[0] = now

    with tempfile.TemporaryDirectory() as root:
        ref_model = _res_model(batches)
        ref = {"losses": [ref_model.train_one_batch(
            *_res_batch(batches, s))[1].item() for s in range(RES_STEPS)]}
        ref["states"] = _res_states(ref_model)
        del ref_model
        gc.collect()
        done("plain")
        stats["save"] = _res_save_resume(batches, ref,
                                         os.path.join(root, "save"))
        done("save")
        stats["rollback"] = _res_rollback(batches, ref,
                                          os.path.join(root, "rollback"))
        done("rollback")
        stats["skip"] = _res_skip(batches)
        done("skip")
        stats["reseed"] = _res_reseed(root)
        stats["loader_batches"] = _res_loader(batches)
        done("reseed_loader")
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        drill = _Drill(root)
        try:
            drill.start()
            drill.resume()
            stats["drill"] = drill.finish()
        finally:
            drill.stop()
        done("drill")
        stats["step_captured"] = _res_timing(
            batches, os.path.join(root, "timed_captured"), True)
        done("timed_captured")
        stats["step_eager"] = _res_timing(
            batches, os.path.join(root, "timed_eager"), False)
        done("timed_eager")
    torch.cuda.synchronize()
    launches = _read_launches()
    _no_kernels("resilience", launches)
    stats["seconds"] = time.perf_counter() - t0
    stats["seconds_by_part"] = parts
    _log(f"resilience phase: {stats['seconds']:.1f}s ("
         + ", ".join(f"{k} {v:.1f}s" for k, v in parts.items()) + ")")
    return launches, stats


def _kernel_bucket(name):
    if "lstm_cell" in name:
        bwd = ", true>" in name or "Lb1E" in name
        return f"lstm_cell {'backward' if bwd else 'forward'} kernel"
    if "unary_kernel" in name or "binary_kernel" in name:
        return "elementwise kernel"
    if "flash_fwd_combine" in name:
        return "flash_attention_fwd combine kernel"
    if "flash_bwd_dq" in name:
        return "flash_attention_bwd dq kernel"
    if "flash_bwd_dkv" in name:
        return "flash_attention_bwd dk/dv kernel"
    if "flash_fwd" in name:
        return "flash_attention_fwd kernel"
    if "paged_merge" in name:
        return "paged_decode merge kernel"
    if "paged_decode" in name:
        return "paged_decode kernel"
    low = name.lower()
    if any(w in low for w in ("conv", "fprop", "dgrad", "wgrad", "winograd",
                              "implicit_convolve", "cudnn")):
        return "convolutions (cuDNN)"
    if "pool" in low:
        return "pooling"
    if any(w in low for w in ("gemm", "gemv", "xmma", "cutlass", "cublas",
                              "nvjet")):
        return "matmuls (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies and fills"
    return "other kernels (elementwise, reductions, indexing)"


def _int8_engine_setup(cfg, tree, kw, prompts):
    """The quantized slice's set-up from the float one's: the seeded
    model on the host, the int8 engine arguments, one warm-up run that
    quantizes (memoised)."""
    cpu_model = tgpt.GPT.from_jax_decode_params(tree, cfg, device="cpu")
    qkw = dict(kw, kv_dtype="int8", weight_dtype="int8")
    _warm(cpu_model, qkw, prompts, device="cuda")
    return cpu_model, qkw


def _compare_engine(kind, model, cpu_model, kw, qkw, model16=None):
    """An engine of ``kind`` and the kernel counter its run must move:
    ``paged`` the float paged engine, ``int8`` the quantized one,
    ``slot`` the slot chunked engine, ``mono`` the monolithic one,
    ``bf16`` the paged engine of ``model16`` (``precision="bfloat16"``);
    with ``_eager``, its eager twin (``_capture=False``)."""
    base = kind.replace("_eager", "")
    twin = dict(_capture=base == kind)
    if base == "bf16":
        return (ServingEngine(model16, **kw, **twin),
                "paged_decode_attention_lowp")
    if base == "int8":
        return (ServingEngine(cpu_model, device="cuda", **qkw, **twin),
                "paged_decode_attention_q8")
    if base == "paged":
        return ServingEngine(model, **kw, **twin), "paged_decode_attention"
    if base == "slot":
        return (ServingEngine(model, **dict(kw, paged=False), **twin),
                "flash_attention_fwd_combine")
    return (ServingEngine(model, n_slots=N_SLOTS, paged=False, chunked=False,
                          **twin), "flash_attention_fwd_combine")


def phase_compare_serve(kinds=("paged", "paged_eager"), runs=4):
    """Serving engines alternated in one process, ``runs`` runs of each
    over the staggered stream, the order reversed every other round
    (paged, paged_eager, paged_eager, paged, ...).  Each kind has one
    engine, which first serves the stream with other token values (its
    graphs captured before the first timed run); run r serves the
    prompts shifted by r token values (no prefix pages from an earlier
    run), on metrics reset before it.  Prints every run's tokens/s, TTFT
    p50, ITL p50 and p99 and wall time, then the smallest, median and
    largest of each, and the ratio of medians of each ``_eager`` kind to
    its captured kind (of every other kind to the first)."""
    cfg, tree, model, kw, prompts = _slice_setup()
    cpu_model = qkw = model16 = None
    if any(k.startswith("int8") for k in kinds):
        cpu_model, qkw = _int8_engine_setup(cfg, tree, kw, prompts)
    if any(k.startswith("bf16") for k in kinds):
        model16 = tgpt.GPT.from_jax_decode_params(
            tree, tgpt.GPTConfig.small(precision="bfloat16"))
    V = cfg.vocab_size
    engines = {}
    for kind in kinds:
        engines[kind] = _compare_engine(kind, model, cpu_model, kw, qkw,
                                        model16)
        _serve(engines[kind][0], [(p + 1000) % V for p in prompts])
    order = [k for r in range(runs)
             for k in (kinds if r % 2 == 0 else kinds[::-1])]
    out = {k: [] for k in kinds}
    for i, kind in enumerate(order):
        eng, want = engines[kind]
        eng.metrics.reset()
        _, _, launches, stats = _drive(
            eng, [(p + len(out[kind])) % V for p in prompts], cfg,
            f"compare {i} {kind}")
        if launches[want] <= 0:
            raise AssertionError(f"compare {i} {kind}: {want} not launched")
        out[kind].append({k: stats[k] for k in (
            "tokens_per_s", "ttft_p50_ms", "itl_p50_ms", "itl_p99_ms",
            "wall_s")})
    keys = ("tokens_per_s", "ttft_p50_ms", "itl_p50_ms", "itl_p99_ms",
            "wall_s")
    med = {}
    for kind, rs in out.items():
        for key in keys:
            v = sorted(r[key] for r in rs)
            med[kind, key] = float(np.median(v))
            _log(f"compare {kind} {key}: min {v[0]} median "
                 f"{med[kind, key]} max {v[-1]} over {len(v)} runs {v}")
    for kind in kinds[1:]:
        ref = kind.replace("_eager", "") if kind.endswith("_eager") \
            else kinds[0]
        _log(f"compare {kind} / {ref}, ratio of medians: " + json.dumps(
            {key: med[kind, key] / med[ref, key] if med[ref, key] else None
             for key in keys}))


def _busy(prof):
    """A profiler window's device busy time (the union of its kernels'
    spans, us), the window's length (first to last event, us) and its
    device activities."""
    dev_type = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    kern = [e for e in events if e.device_type == dev_type
            and e.time_range.end > e.time_range.start]
    if not kern:
        raise AssertionError("the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    return busy, window, kern


def phase_profile(path):
    """One path once more under ``torch.profiler`` (CPU and CUDA
    activity): ``serve``, the slice's stream; ``serve_int8``, the same
    stream on the quantized engine; ``serve_slot``, the same stream on
    the slot chunked engine; each on an engine that served the stream
    once already with other token values (the same keys: every graph
    captured before the window); with ``_eager`` (``serve``,
    ``serve_slot``), the eager twin; ``generate``, one
    ``GPT.generate`` call of the generate path after a warm-up call
    (captured; ``generate_eager`` the eager loop);
    ``train``, ``train_bf16``, ``train_fp16``, ``resnet50`` (under
    train_cnn.py's cuDNN settings), two captured training steps
    (replays) after two unprofiled ones (the eager first step and the
    capture), and each with ``_eager``, the same steps of the eager
    twin; ``rnn_train`` and ``rnn_train_eager``, the same for the fused
    char-LSTM; ``rnn_train_plain``, the captured steps through the plain
    cell.  Prints
    the device busy and idle share over the window, device time by
    kernel group and by kernel.  Times under the profiler include its
    own host overhead."""
    from torch.profiler import ProfilerActivity, profile
    if path.startswith("serve"):
        cfg, tree, model, kw, prompts = _slice_setup()
        twin = dict(_capture=not path.endswith("_eager"))
        if path.startswith("serve_slot"):
            kw = dict(kw, paged=False)
        if path == "serve_int8":
            del model
            cpu_model, qkw = _int8_engine_setup(cfg, tree, kw, prompts)
            eng = ServingEngine(cpu_model, device="cuda", **qkw)
        else:
            eng = ServingEngine(model, **kw, **twin)
        _serve(eng, [(p + 1) % cfg.vocab_size for p in prompts])

        def run():
            _serve(eng, prompts)
    elif path.startswith("generate"):
        cfg, tree, model, kw, prompts = _slice_setup()
        batch = np.stack(_generate_rows(prompts))
        twin = dict(_capture=path == "generate")
        model.generate(batch, NEW, **twin)

        def run():
            model.generate(batch, NEW, **twin)
    elif path.startswith(("train", "resnet50")):
        base = path.replace("_eager", "")
        if base == "resnet50":
            # train_cnn.py's cuDNN settings: torch's defaults, which it
            # leaves as they are (TF32 stays off as phase 1 set it)
            torch.backends.cudnn.deterministic = False
            torch.backends.cudnn.benchmark = False
            batches = _imagenet_batches()
            model = _zoo_model("resnet50", use_graph=path == base,
                               x=batches[0][0], num_classes=1000)
        else:
            _, model, batches = _train_setup(
                {"train": None, "train_bf16": "bfloat16",
                 "train_fp16": "float16"}[base], use_graph=path == base)
        for x, y in batches[:2]:     # eager first step; capture
            model.train_one_batch(x, y)[1].item()

        def run():
            for x, y in batches[2:4]:
                model.train_one_batch(x, y)
    else:
        model = _rnn_model(path != "rnn_train_plain", "cuda",
                           use_graph=path != "rnn_train_eager")
        batch = _rnn_batch()
        for _ in range(2):
            model.train_one_batch(*batch)[1].item()

        def run():
            for _ in range(2):
                model.train_one_batch(*batch)
    torch.cuda.synchronize()
    _zero_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, window, kern = _busy(prof)
    groups, names = {}, {}
    for e in kern:
        us = e.time_range.end - e.time_range.start
        for d, key in ((groups, _kernel_bucket(e.name)), (names, e.name)):
            n, t = d.get(key, (0, 0.0))
            d[key] = (n + 1, t + us)
    _log(f"profile {path}: cuDNN deterministic "
         f"{torch.backends.cudnn.deterministic}, benchmark "
         f"{torch.backends.cudnn.benchmark}, TF32 "
         f"{torch.backends.cudnn.allow_tf32}; host wall {wall:.3f}s; "
         f"profiled window "
         f"{window / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, idle "
         f"share {1 - busy / window:.4f}; {len(kern)} device activities; "
         f"launches {json.dumps(_read_launches())}")
    for key, (n, t) in sorted(groups.items(), key=lambda x: -x[1][1]):
        _log(f"profile group {key}: {n} activities, {t / 1e3:.2f} ms "
             f"({t / busy:.3f} of busy)")
    for key, (n, t) in sorted(names.items(), key=lambda x: -x[1][1])[:12]:
        _log(f"profile kernel {n:6d} x {t / n:8.2f} us = {t / 1e3:8.2f} ms "
             f"{key[:110]}")


PROFILE_PATHS = ("serve", "serve_eager", "serve_int8", "serve_slot",
                 "serve_slot_eager", "generate", "generate_eager", "train",
                 "train_eager", "train_bf16", "train_bf16_eager",
                 "train_fp16", "train_fp16_eager", "rnn_train",
                 "rnn_train_eager", "rnn_train_plain", "resnet50",
                 "resnet50_eager")
KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    modes = {(): None, ("--profile",): lambda: phase_profile("serve"),
             ("--compare-serve",): phase_compare_serve,
             ("--nccl-two-ranks",): phase_nccl_two_ranks,
             ("--preempt",): phase_preempt_alone,
             ("--admission",): phase_admission_alone,
             ("--telemetry",): phase_telemetry_alone,
             ("--compare-serve", "layouts"):
             lambda: phase_compare_serve(("paged", "slot", "mono"), 3),
             ("--compare-serve", "precision"):
             lambda: phase_compare_serve(("paged", "bf16")),
             ("--compare-serve", "graphs"):
             lambda: phase_compare_serve(tuple(
                 k + e for k in ("paged", "int8", "slot", "mono", "bf16")
                 for e in ("", "_eager")), 3)}
    for path in PROFILE_PATHS:
        modes["--profile", path] = lambda p=path: phase_profile(p)
    if tuple(argv) not in modes:
        print(f"usage: chip_smoke.py [--profile [{'|'.join(PROFILE_PATHS)}]"
              f" | --compare-serve [layouts|precision|graphs] | "
              f"--nccl-two-ranks | --preempt | --admission | --telemetry]",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = phase_card()
    if tuple(argv) != ("--nccl-two-ranks",):     # it runs no kernel
        phase_build()
    if modes[tuple(argv)] is not None:
        modes[tuple(argv)]()
        _log(f"total {time.perf_counter() - t0:.1f}s on {card}")
        return 0
    fwd, combine = phase_flash()
    dq, dkv, fwd["train_shape"] = phase_flash_bwd()
    paged, paged_q8, paged_merge = phase_paged()
    t_k = time.perf_counter()
    lowp = phase_flash_lowp([fwd, combine, dq, dkv])
    lowp.append(phase_paged_lowp([paged, paged_q8]))
    fwd["mixed_operands_ulp"] = phase_flash_mixed()
    _log(f"16-bit kernel phases (3b, 4b, 5c): "
         f"{time.perf_counter() - t_k:.1f}s")
    t_k = time.perf_counter()
    lstm, lstm_bwd = phase_lstm()
    elementwise, ew_launches = phase_ew()
    _log(f"lstm and elementwise kernel phases (5a-5b): "
         f"{time.perf_counter() - t_k:.1f}s")
    rows = [fwd, combine, dq, dkv, elementwise, lstm, lstm_bwd, paged,
            paged_q8, paged_merge] + lowp
    serve_launches, serve_stats, setup = phase_slice()
    int8_launches, int8_stats = phase_slice_int8(setup, serve_stats)
    t_s = time.perf_counter()
    gen_launches, gen_stats = phase_generate(setup)
    slot_launches, slot_stats = phase_serve_layout(
        setup, "serve_slot", dict(setup["kw"], paged=False), serve_stats)
    mono_launches, mono_stats = phase_serve_layout(
        setup, "serve_mono", dict(n_slots=N_SLOTS, paged=False,
                                  chunked=False), serve_stats)
    slot8_launches, slot8_stats = phase_serve_slot_int8(setup)
    _log(f"generate and slot-layout phases (7a-7d): "
         f"{time.perf_counter() - t_s:.1f}s")
    t_s = time.perf_counter()
    serve16_launches, serve16_stats = phase_serve_bf16(setup, serve_stats)
    gen16_launches, gen16_stats = phase_generate_bf16(setup)
    _log(f"bf16 serving phases (7e-7f): {time.perf_counter() - t_s:.1f}s")
    pre_launches, pre_stats = phase_preempt(setup)
    adm_launches, adm_stats = phase_admission(setup)
    tel_launches, tel_stats = phase_telemetry(setup)
    keys = ("tokens_per_s", "ttft_p50_ms", "itl_p50_ms", "itl_p99_ms",
            "peak_memory_bytes")
    _log("serving captured against eager: " + json.dumps({
        label: {k: st[k] for k in keys + ("graph_captures",
                                          "graph_replays")}
        | {"eager": {k: st["eager"][k] for k in keys}}
        for label, st in (("serve", serve_stats),
                          ("serve_int8", int8_stats),
                          ("serve_slot", slot_stats),
                          ("serve_mono", mono_stats),
                          ("serve_slot_int8", slot8_stats),
                          ("serve_bf16", serve16_stats))}
        | {label: {k: st[k] for k in ("tokens_per_s", "peak_memory_bytes")}
           | {"eager": st["eager"]}
           for label, st in (("generate", gen_stats[HORIZON]
                              | {"eager": gen_stats["eager"]}),
                             ("generate_bf16", gen16_stats["captured"]
                              | {"eager": gen16_stats["eager"]}))}))
    del setup
    t_s = time.perf_counter()
    model, train_launches, train_stats, batches, ckpt = phase_train()
    api = phase_graph_api(model, train_stats, batches, ckpt)
    _log(f"training phases (8, 8a): {time.perf_counter() - t_s:.1f}s")
    phase_card_vs_cpu(model)
    phase_serve_trained(model)
    del model
    t_s = time.perf_counter()
    train16_launches, bf16_stats = phase_train_lowp("bfloat16", train_stats)
    trainf16_launches, fp16_stats = phase_train_lowp("float16", train_stats)
    _log(f"16-bit training phases (8b-8c): {time.perf_counter() - t_s:.1f}s")
    t_rnn = time.perf_counter()
    rnn_model, rnn_train_launches, rnn_stats = phase_rnn_train()
    phase_rnn_card_vs_cpu(rnn_model)
    del rnn_model
    rnn_sample_launches, _ = phase_rnn_sample()
    _log(f"rnn phases (11-13): {time.perf_counter() - t_rnn:.1f}s")
    t_cnn = time.perf_counter()
    _cnn_determinism()
    mlp_launches, mlp_stats = phase_mlp_train()
    cnn_launches, cnn_stats = phase_cnn_train()
    r50_batches = _imagenet_batches()
    r50_launches, r50_stats = phase_resnet50_train(r50_batches)
    r50b_launches, r50b_stats = phase_resnet50_train(
        r50_batches, "bfloat16", r50_stats)
    zoo_launches, zoo_stats = phase_zoo()
    _log(f"MLP and CNN phases (15-19): {time.perf_counter() - t_cnn:.1f}s "
         f"(zoo " + ", ".join(f"{n} {st['seconds']:.1f}s"
                              for n, st in zoo_stats.items()) + ")")
    t_d = time.perf_counter()
    comm = _dist_group()
    r50d_launches, r50d_stats = phase_resnet50_dist(r50_batches, comm,
                                                    r50_stats)
    opts_launches, opts_stats = phase_dist_options(comm, cnn_stats)
    torch.distributed.destroy_process_group()
    script_stats = phase_dist_scripts()
    _log(f"data-parallel phases (20-22): {time.perf_counter() - t_d:.1f}s")
    t_p = time.perf_counter()
    surface_launches, surface_stats = phase_tensor_surface()
    prof_launches, prof_stats = phase_profiling(r50_stats)
    _log(f"tensor surface and profiling phases (23-24): "
         f"{time.perf_counter() - t_p:.1f}s")
    res_launches, res_stats = phase_resilience(r50_batches)
    del r50_batches
    for row in rows:
        by_path = {"serve": serve_launches[row["name"]],
                   "serve_int8": int8_launches[row["name"]],
                   "generate": gen_launches[row["name"]],
                   "serve_slot": slot_launches[row["name"]],
                   "serve_mono": mono_launches[row["name"]],
                   "serve_slot_int8": slot8_launches[row["name"]],
                   "serve_bf16": serve16_launches[row["name"]],
                   "generate_bf16": gen16_launches[row["name"]],
                   "preempt": pre_launches[row["name"]],
                   "admission": adm_launches[row["name"]],
                   "telemetry": tel_launches[row["name"]],
                   "train": train_launches[row["name"]],
                   "train_bf16": train16_launches[row["name"]],
                   "train_fp16": trainf16_launches[row["name"]],
                   "rnn_train": rnn_train_launches[row["name"]],
                   "rnn_sample": rnn_sample_launches[row["name"]],
                   "ew": ew_launches[row["name"]],
                   "mlp_train": mlp_launches[row["name"]],
                   "cnn_train": cnn_launches[row["name"]],
                   "resnet50_train": r50_launches[row["name"]],
                   "resnet50_bf16": r50b_launches[row["name"]],
                   "zoo": zoo_launches[row["name"]],
                   "resnet50_dist": r50d_launches[row["name"]],
                   "dist_options": opts_launches[row["name"]],
                   "tensor_surface": surface_launches[row["name"]],
                   "profiling": prof_launches[row["name"]],
                   "resilience": res_launches[row["name"]]}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    _log("captured against eager: " + json.dumps({
        label: {k: st[k] for k in ("steady_step_ms", "tokens_per_s",
                                   "peak_memory_bytes", "graph_replays")}
        | {"eager": {k: st["eager"][k] for k in ("steady_step_ms",
                                                 "tokens_per_s",
                                                 "peak_memory_bytes")}}
        for label, st in (("train", train_stats), ("train_bf16", bf16_stats),
                          ("train_fp16", fp16_stats),
                          ("rnn_train", rnn_stats["fused"]))}
        | {"predict_max_abs_err": {"train": api["predict_err"],
                                   "train_bf16": bf16_stats["predict_err"]}}))
    keys = ("steady_step_ms", "peak_memory_bytes", "graph_replays")
    _log("MLP and CNN paths captured against eager: " + json.dumps({
        label: {k: st[k] for k in keys + (f"{st['unit']}_per_s",)
                + tuple(k for k in ("idle_share", "loss_rel_f32",
                                    "card_vs_cpu", "predict_err")
                        if k in st)}
        | {"eager": {k: st["eager"][k] for k in
                     ("steady_step_ms", "peak_memory_bytes",
                      f"{st['unit']}_per_s") + (
                          ("idle_share",) if "idle_share" in st else ())}}
        for label, st in (("mlp_train", mlp_stats), ("cnn_train", cnn_stats),
                          ("resnet50_train", r50_stats),
                          ("resnet50_bf16", r50b_stats))
        + tuple((f"zoo {n}", st) for n, st in zoo_stats.items())}))
    keys = ("steady_step_ms", "images_per_s", "peak_memory_bytes",
            "idle_share", "graph_replays", "collectives_per_step",
            "loss_rel_plain", "order_walk_ms")
    _log("data-parallel paths (world 1, NCCL "
         + ".".join(map(str, torch.cuda.nccl.version()))
         + ") captured against eager: " + json.dumps({
             f"{label} {option}": {k: st[k] for k in keys if k in st}
             | {"eager": {k: st["eager"][k] for k in keys
                          if k in st["eager"]}}
             for label, by_option in (("resnet50_dist", r50d_stats),
                                      ("dist_options", opts_stats))
             for option, st in by_option.items()}
             | {"dist_scripts": script_stats}))
    _log("tensor surface and profiling: " + json.dumps(
        {"tensor_surface": surface_stats}
        | {"profiling": {k: prof_stats[k] for k in
                         ("train_cnn", "device", "on_device", "rng_state",
                          "seconds")}}))
    _log("resilience: " + json.dumps(res_stats))
    _log(f"total {time.perf_counter() - t0:.1f}s on {card}")
    _log(json.dumps({"kernels": [
        {k: r[k] for k in KEYS + ("launches_by_path",)}
        | {k: r[k] for k in ("train_shape", "serving_split",
                             "causal_serving", "blocks",
                             "by_op", "by_dtype", "by_combination",
                             "bound_3xtf32_ms", "mixed_operands_ulp",
                             "max_ulp_err",
                             "low_precision", "flush_floor_ms", "plan",
                             "unsplit_ms", "host_us",
                             "function_backward_ms",
                             "function_backward_launches") if k in r}
        for r in rows]}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)

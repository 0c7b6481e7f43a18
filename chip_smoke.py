"""Drive mxtpu_torch on one NVIDIA GPU: build its kernels, hold each
against its plain PyTorch version, train BERT-Large with the
``bench_bert`` recipe (adam, b32 x T128) in bf16 compute and in the
API's default f32, train ResNet-50
v1 with the ``bench_resnet50`` recipe (SGD momentum, bf16 compute, b256
x 224^2) in NCHW and NHWC, train examples/train_cifar10.py's resnet20
through the symbolic API (sym → Module.fit), also with a CustomOp
softmax head whose kernels are compiled at run time by rtc.CudaModule,
serve BERT-Large from its export through InferenceServer →
DynamicBatcher → ModelRunner (a captured CUDA graph a bucket), run the
chained-measurement tools (the conv strategy probe on the NHWC conv
kernel, bench_flash, probe_bn_fusion, microbench), and train, check,
rematerialize and decode Transformer-big with the
``bench_transformer`` recipe (adam, b16 x (64 + 64)), train ResNet-50
fed from the input pipeline (``bench_resnet50_pipeline``'s recipe),
step every ResNet of the model zoo, serve BERT-Large from a fleet
of workers through a kill, a warm replacement, scripted faults and the
autoscaler, run detection, and warm serving processes and fleet
replicas from the persistent compile cache.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure:
  1. build every kernel from ``mxtpu_torch/csrc`` (one nvcc per source,
     in parallel); ``cuobjdump -sass`` of the tensor-core kernels (bf16:
     ``fa_fwd_wgmma_kernel``, ``fa_bwd_dq_wgmma_kernel``,
     ``fa_bwd_dkv_wgmma_kernel``, ``conv_nhwc_wgmma_kernel``; f32 as six
     bf16 products of an exact three-way split, no TF32:
     ``fa_fwd_f32_wgmma_kernel``, ``fa_bwd_dq_f32_wgmma_kernel``,
     ``fa_bwd_dkv_f32_wgmma_kernel``, ``conv_nhwc_f32_wgmma_kernel``)
     must show wgmma (HGMMA) and TMA loads (UTMALDG; the conv's im2col
     loads are UTMALDG too) in every instantiation, the f32 ones no
     TF32 HGMMA, and their ptxas reports no spills; so must the ptxas
     reports of the kernels rebuilt on 16-byte vector loads
     (``VECTOR_KERNELS``: the LayerNorm forward and backward, row and
     wide kernels, the fused epilogue's forward and backward, row and
     wide kernels, the BatchNorm forward and backward in both views),
     every instantiation listed;
  2. each BERT forward kernel against its plain version on the card, at
     the serving path's shapes (b=32, T=128, 16 heads of 64, C=1024),
     in f32 and bf16; flash attention also causal at T=127 and Tq !=
     Tk, in f32 at D = 128, 40 and 36 (zero-padded to 40), and causal
     in bf16 at bench_flash's B4 H16 D64 T=4096; the
     fused epilogue at keep=0.9 with its dropout mask recovered
     from the output and compared bit for bit; times of the kernel, the
     plain version and one library call (the fused epilogue at keep=1
     and 0.9, its bound with the mask's integer work, whose instruction
     mix an element is read from the SASS of a probe kernel built from
     csrc/common.cuh's threefry, the probe timed against that floor);
     the fused epilogue's forward also timed at ``FRLN_FWD_TIMES`` (one
     served request, R128 x C1024 f32; at keep=0.9 R300 x C12256 and
     C4095, the widest row instance of the 16-byte and of the scalar
     path, each beside the wide kernel on the same inputs, and C8193,
     the scalar path's wide kernel), beside the composed eager
     ``F.layer_norm(res + h + bias)`` at keep=1 (two calls, not a
     library call);
  3. each BERT backward kernel likewise (flash dq and dk/dv, LayerNorm,
     the fused epilogue at keep=0.9 with dh's zeros equal to the
     dropped set bit for bit, timed also at keep=1), at the training
     shapes (the kernels each LayerNorm and fused epilogue backward call
     launches listed), the LayerNorm backward
     also on its scalar path (C = 1030, and contiguous views off a
     16-byte boundary: a row slice at C = 1031, one element into a
     buffer at C = 1024), flash also causal
     in f32 and bf16 at B4 H16 D64 T=4096 and, forward and backward, at edge
     shapes (D = 32, 128, 96, 64 with diagonal offsets, and D = 42, off
     the multiple of 8 that TMA needs); times beside AD through the
     plain attention; then LayerNorm forward and backward together at
     ``LN_EDGES``: the row kernels' scalar path (C = 1030, a row slice
     at C = 1031, a view one element into a buffer), one row and 1001
     rows, and the wide kernels at C = 12257 (scalar), 32768 (300 rows,
     more than the backward's CTAs) and 131072 (aligned and one element
     in), the widest timed; then the fused epilogue at ``FRLN_EDGES``,
     keep=0.9, the raw forward and the public function's forward and
     backward: the row kernels' scalar path (C = 1030, a view one
     element in), each forward row instance (C = 200, 512, 2048, 4096,
     8192, 12256; 4095 scalar), and the wide kernels at C = 4097, 12257
     and 12289 (scalar), 32768 (timed), 131072 (timed), 393216 (48 KB of
     keep bits a row) and 400000, dh's zeros at 32768 against the forward's
     dropped set bit for bit; and the forward at keep=1 over 2^31 + 5
     rows of C = 1 (bf16: y == beta, mean == u exactly);
  4. the four BatchNorm kernels (channels-major and channels-minor,
     forward and backward) against their plain version in f32 and bf16
     at four of ResNet-50's shapes (N=256: the stem, a layer1 and a
     layer4 ``bn_out``, a downsample; timed) and at the other shapes
     probe_bn_fusion runs (the 14^2 x 1024 stage, the bottlenecks'
     inner widths), at edge shapes (C=3, 37, 100;
     S=49, 196; N*S=1; a channels-minor view and a channels-major view
     at layer1_out's C and S one element off a 16-byte boundary; S=49
     and 196 at N=3 and ResNet-50's widths) and on a constant channel;
     the stem's statistics against f64 sums; a rerun bit-equal; times
     of the kernel, the plain version and cuDNN's BatchNorm with the
     add and ReLU, and the kernels each call launches; the raw
     wrappers must refuse inputs that require grad;
  5. the NHWC conv kernel (#13, the port of ``pallas_conv``) against its
     plain version in f32 and bf16 at N=256 (the conv probe's 14^2 x 256,
     28^2 x 128, 7^2 x 512 and microbench's 56^2 x 64, 14^2 x 512, 3x3,
     C = O) and at edge shapes (N=1; H = W = 5; C != O; 1x1, 2x2, 5x5
     kernels; a 257x1 kernel, past the im2col loads, on the scalar f32
     kernel, refused in bf16); times beside cuDNN (TF32 off) and, in
     f32, both bounds (FMA and split), cuDNN's kernel names printed; its
     refusals (grad, a dtype, a non-contiguous x), and C = 12, O = 4
     (zero-padded to 16 and 8 on copies) against the plain version;
  6. the port's tools, each ``main`` on the card with launch counts read
     around it: microbench (chained bf16 matmuls and cuDNN convs), the
     conv strategy probe (cuDNN, shifted GEMM, kernel #13; its conv
     launches are the kernels line's), bench_flash (causal flash
     fwd+bwd against the plain attention and SDPA at T = 512, 2048 and
     4096, the last with 2 chained steps) and probe_bn_fusion (BN+ReLU
     chains, library vs kernels #8/#9, and conv+BN+ReLU, at ResNet-50's
     stage shapes); a FAILED row or an exception fails the run;
  7. a 2-layer full-width BERT (f32, dropout 0, b=4, T=128): the loss
     and every parameter gradient on the card against the CPU plain
     path, then three TrainStep steps on each side;
  8. BERT-Large trained at full size: ``bert_large(max_length=128,
     dropout=0.1)``, adam lr 1e-4, ``compute_dtype="bfloat16"``,
     ``cast_batch=False``, (32, 128) token batches with y = x: 3
     warm-up steps, then 3 timed windows of 10 steps (ms/step is their
     median), the loss finite and falling, launch counts exactly
     24/24/24/1/1/48/48 and no BatchNorm per step; tokens/s, ms/step,
     MFU, peak memory and a per-family breakdown of one profiled
     ``step(x, y)``; then the same with ``compute_dtype`` left unset
     (f32, the API's default: the f32 flash backward on the main path),
     with the same gates;
  9. a full-width ResNet V1 of one bottleneck per stage (f32, b=4,
     64x64), NCHW and NHWC: the loss, every gradient, three SGD
     momentum steps (lr 1e-3) and the running statistics on the card
     against the CPU plain path;
 10. ResNet-50 v1 trained at full size, NCHW: Xavier weights from torch
     seed 0, one (256, 3, 224, 224) batch and its labels from numpy
     seed 0 reused every step, SGD lr 0.1 momentum 0.9 wd 1e-4, bf16
     compute: 3 warm-up steps, 3 timed windows of 10 steps, the loss
     finite and falling, launches exactly 53/53/0/0 BatchNorm
     fwd/bwd/fwd_cm/bwd_cm and no BERT kernel per step; samples/s,
     ms/step, MFU (FLOPs from the port's conv and dense shapes, 3x
     forward; the reference's 22.49 GFLOP per sample beside it), peak
     memory and a profiled breakdown of one step;
 11. the same in NHWC (``layout="NHWC"``), launches exactly 0/0/53/53
     (8, 10 and 11 run the bucketed update, the default);
 12. bulked training: BERT-Large bf16 (adam, dropout 0.1) and ResNet-50
     NHWC (SGD momentum), each built three times from the same seeds:
     the bucketed step and its ``MXTPU_BATCHED_OPT=0`` twin run 3 steps
     and must agree bit for bit (losses, parameters, buffers, every
     optimizer-state leaf), and ``run_steps`` must equal the eager steps
     bit for bit (BERT: three ``run_steps(x, y, 1)``; ResNet: one
     ``run_steps(x, y, 3)`` over three microbatches), cuDNN
     deterministic for these gates; the ``update`` range's device ms of
     each twin; then ``run_steps(x, y, 10, reuse_batch=True)`` timed as
     ``bench.py``'s ``_measure`` times mxtpu (median of 3 windows, each
     after an eager window on the same step), launches per step exact,
     one call profiled; and a LAMB BERT-Large bf16 run of 5 steps whose
     losses must be finite and fall;
 12b. mxtpu's Gluon loop through the port's public API
     (``initialize``, ``hybridize()``, ``gluon.Trainer(net.collect_params
     (), ...)``, ``autograd.record()``, ``loss.backward()``,
     ``trainer.step(n)``): BERT-Large (b32 x T128, adam lr 1e-4,
     SoftmaxCrossEntropyLoss on the MLM logits as bench_bert shapes
     them, n = the 4096 tokens) in f32 with dropout 0.1 and cast to bf16
     with ``multi_precision=True``, and ResNet-50 v1 NHWC (b64 x 224^2,
     SGD momentum 0.9, lr 0.1, wd 1e-4, f32); after a warm-up step 3
     counted steps, launches exactly 24/24/24/1/1/48/48 a BERT step and
     53/53 channels-minor BatchNorm a ResNet step, the losses finite;
     eager ms/step and one profiled step (device ms, the Trainer
     update's host and device time) beside TrainStep's on the same
     configuration; the weights ``save_parameters`` wrote, loaded into a
     fresh ``bert_large()``, give the f32 logits bit for bit; and one
     Gluon step against one ``MXTPU_BATCHED_OPT=0`` TrainStep step from
     the same weights and batch (f32, dropout 0) on each model: equal
     losses and every weight bit for bit (see ``gluon_gate``);
 13. BERT-Large (24 layers, f32 weights from a numpy seed, carried in
     through ``params_from_mxtpu``) exported (``net.export``) and served
     from the export by ``ModelRunner.from_export`` ({64, 128} x batch
     1..32, one CUDA graph captured a bucket; the weight tensors the
     same before and after the warm-up); each captured bucket against
     the eager plan on the card, one batch each, bit for bit (or within
     1e-3, the difference printed); 4 client threads sending 128
     requests of lengths 16-128, every result checked, 0 requeues,
     launches exactly 24/1/48 a forward read around the run; then the
     same burst with the buckets on the eager plan (the runner's
     private ``_eager_entry``), and the (32, 128) forward's device ms,
     host ms to issue it, a served batch's wall ms, the logits copy and
     the idle share, each for both; peak memory over the ladder, eager
     plan and captured warm-up; a toy runner under ``MXTPU_GUARDS=2``
     (captures and serves exactly, a host read in the guards' scope
     raises, the 8th build of a 3-bucket ladder raises
     ``RecompileChurn``);
 14. one served batch of 8 x 128 against the same export run on the
     CPU (plain path);
 15. rtc: the user kernels of ``RTC_SOURCE`` (y = 2x, a row softmax
     and its loss gradient p - onehot(label)) compiled by
     ``rtc.CudaModule`` and launched through ``CudaKernel.launch``: y =
     2x exact at 8x128 and 4096x4096, the softmax pair against its
     plain version at the head's (128, 10), at (4096, 30522) and at an
     odd width, (33, 30521), times beside the byte bound, the plain
     version and the library call (``torch.softmax``; autograd through
     ``F.cross_entropy``), the host cost of one launch beside
     ``torch.softmax``'s, and, with the launch caches warm, the
     refusals (a wrong dtype, an array on the CPU, a CPU ctx, a float or
     a bool for an int, a non-contiguous array, a list for an array,
     bad grid or block dims, too few arguments, a source that does not
     compile, a missing export);
 16. resnet20 at full width, b16, through the symbolic API: the card's
     Module against the same Module on the CPU (outputs, every
     gradient, three SGD steps at lr 1e-3), the rtc head (a Module
     ending at the logits, the ``softmax_rtc`` CustomOp under
     ``autograd.record``, ``backward(out_grads=[logits.grad])``)
     against SoftmaxOutput on the card over three steps, and a
     checkpoint round trip that predicts bit for bit;
 17. ``train_cifar10``'s recipe: one epoch of ``Module.fit`` over the
     synthetic CIFAR-10 fallback (14 batches of 128; sgd lr 0.01,
     momentum 0.9, wd 1e-4, rescale 1/128; Xavier; Accuracy,
     Speedometer, do_checkpoint), launches exactly 19/19/0/0 BatchNorm
     per batch, the moving statistics untouched, then ``score``; a
     profiled batch; then the same epoch with the rtc head from the
     same parameters and batch order: rtc launches 1/1 and BatchNorm
     19/19 per batch, the per-batch losses within 1e-4 of max(|p|,
     0.01) of the SoftmaxOutput run's;
 18. generation serving: mxtpu's generation model,
     ``BERTModel(30522, 1024, 4096, 24, 16, max_length=512, dropout=0,
     use_token_type=False, causal=True)`` in f32, seeded with the
     port's initializers, its incremental call traced and exported, then
     ``GenerateRunner.from_export(..., kv_cache_spec(8, 512),
     prompt_buckets=(32, 128))`` (8 lanes + scratch, a 0.91 GB KV table)
     and ``warmup(kv=table)`` (one CUDA graph captured an entry, on
     the table the first gates run on; peak memory beside the eager
     plan's; ``donate=False`` runs on the card since phase 24 (e)
     gates it).  Gates: (1) one lane, a 100-token prompt
     prefilled, then 16 decode steps, each step's logits against the
     full causal forward's (flash #1) at the same position, the greedy
     tokens where the top-2 gap exceeds the tolerance; (2) one prefill
     (b=2, s=32) and 4 decode steps against the same runner on the CPU;
     (3) every prefill and decode call of gate 1 launches exactly 1
     LayerNorm (#4), 48 fused epilogues (#6) and no flash kernel, and so
     does every runner call of the server run; (4) ``InferenceServer.
     register_generator`` serves 32 requests (prompts 8-300 tokens,
     those past 128 prefilled in chunks, 24 new tokens; half greedy,
     half top-k 8 with their own seeds) from 4 threads, every stream
     complete, in order, "length", and each greedy one against the same
     request alone through a fresh ``GenerateBatcher``; (5) a batcher
     closed after 8 steps, each request resumed from its
     ``partial_state()`` as a prefix: every index exactly once, the
     greedy tokens those of the run never closed.  Greedy streams that
     first part at a near tie of the full forward's logits (within the
     tolerance) count as agreeing; (6) each captured entry against the
     eager plan from the same random table, logits and table bit for
     bit, and a decode on a second table captured anew there with the
     first table untouched.  Printed, for the captured entries and the
     eager plan: decode tokens/s at
     saturation (``bench.py``'s ``serving_generate`` run: 8 requests of
     64 tokens through one batcher), TTFT and per-token p50/p95 at the
     stream callback, the naive re-prefill tokens/s and the ratio, a
     decode step's wall ms and the host ms of the runner's call, its
     device busy ms and idle share (by family under the eager plan:
     GEMMs, ``cached_attention``, KV copies, #4, #6, the copies to and
     from the host, other), and #4 and #6 timed at the decode step's
     shape (9 x 1024); then (7) the same export under AMP and in int8
     (phase 19b's entropy thresholds): each runner's 9 entries captured
     on its own table and held against the eager plan bit for bit, a
     decode call's launches 1/48/0 and 97 AMP or int8 contractions, a
     prefill (b=2, s=32) and 2 decode steps against the same runner on
     the CPU within ``PASS_CPU_TOL``, a captured decode step's wall ms;
 19. AMP and int8 (``mxtpu_torch.amp``, ``mxtpu_torch.quant``):
     (a) after the Gluon phase, the AMP contraction routes against their
     plain f32 versions (the f32-output GEMM at BERT's five shapes,
     forward and both backward GEMMs; the convolution as the GEMM over
     its patches at ResNet-50's 7x7/2, 3x3 and 1x1/2, forward and
     backward), timed; BERT-Large (bench_bert's recipe, ``amp=True``):
     parameters bf16 over f32 masters and state, 3 steps against the
     f32 step from the same seeds (rtol 3e-2, atol 1e-2, mxtpu's parity
     bar), ``MXTPU_AMP=0`` bit-equal to ``amp=None`` (losses, weights,
     state), launches 24/24/24/1/1/48/48 and 97 bf16 GEMMs a step
     (the f32 flash kernels), ms/step and device ms beside phase 8's
     bf16 and f32 runs, the cost of the loss scaler's flag read (in
     turns against a step built with ``MXTPU_AMP_LOSS_SCALE=0``), and a
     step under an inf scale skipped with every weight and state tensor
     bit-equal; ResNet-50 NHWC (bench_resnet50's recipe, ``amp=True``):
     the same types (running statistics f32), 3 steps against the f32
     step (its ms/step and device ms printed), launches 0/0/53/53 and 53
     convolutions and 1 GEMM a step in bf16, a batch with an inf pixel
     skipped (weights and state bit-equal, the scale halved, one skipped
     step counted); (b) after the serving phase, ``quant.int_mm``
     bit-equal to the plain int32 product at every (M, K, N) the served
     ladder and the generation runner reach (padded where
     ``torch._int_mm`` refuses), then BERT-Large from its export through
     ``ModelRunner`` in f32, ``amp=True`` and ``quant=True`` ({128} x
     batch 1..32), the int8 runner calibrated with minmax and then
     entropy on seeded batches (97 keys each); every AMP and int8 bucket
     captured and held against the eager plan bit for bit; a captured
     (32, 128) forward's launches 24/1/48 and 97 contractions; the AMP
     and int8 logits' distance from f32 over the scale, printed; the
     (1, 128) bucket against the CPU's plain path within
     ``PASS_CPU_TOL``; the (32, 128) forward's device ms in the three
     types.  ResNet-50's AMP-vs-f32 gate runs at the CPU check's lr 1e-3
     (at the recipe's 0.1 three steps are chaotic: printed beside f32
     against f32 with TF32 convolutions);
 20. Transformer-big (``transformer_big(vocab_size=32768,
     max_length=256, dropout=0.1)``: 6+6 layers, 1024 units, 16 heads,
     FFN 4096) behind bench_transformer's wrapper (one (N, src + tgt)
     batch split with ``slice_axis``; adam lr 1e-4, ``cast_batch=
     False``): (a) the training row at b16 x (64 + 64), bf16 compute
     over f32 masters and then ``amp=True``: 3 warm-up steps, 3 eager
     windows of 10 steps, then 3 ``run_steps(x, y, 10,
     reuse_batch=True)`` windows (ms/step the median of each), launches
     exactly 18/18/18/2/2/30/30 of #1-#7 a step in both, tokens/s over
     src+tgt, MFU against 989 TFLOP/s (``mt_flops``; bench.py's 0.727
     GF/token beside it), one profiled step, peak memory, the losses
     finite and falling and the first 5 repeating bit for bit from the
     same seeds; (b) one f32 step (dropout 0) at b2, source 96,
     target 64 (cross-attention at Tk = 96 != Tq = 64) on the card
     against the CPU's plain path from the same weights, the loss 1e-5
     and every gradient 1e-4 of its norm; (c) ``remat=True`` against
     ``remat=False`` from the same weights and seed at b64 x (256 +
     256), bf16, dropout 0.1: 3 steps, the losses and every weight bit
     for bit, launches 36/18/18/2/2/60/30 a step under remat, both peak
     memories (the remat peak lower) and ms/step, the cells' saved
     bytes reckoned from the shapes (``mt_saved_bytes``) beside the
     measured saving; (d) the incremental call ``net(src, tgt, step,
     cache)`` in f32 (b4, source 64): a prefill of 8 target tokens and 8
     one-token steps, each against the full call on the same prefix
     within 1e-3 x max(1, |ref|), the greedy tokens equal but at a near
     tie; (e) #1-#7 at the training row's shapes (bf16; flash
     non-causal at 16 x 16 heads, T 64) against their plain versions,
     timed;
 21. ResNet from the model zoo, fed from the input pipeline
     (``pipeline_phase``): (a) bench_resnet50_pipeline's recipe: 4 x
     256 raw records of 3 x 224^2 uint8 written with the port's
     recordio, ``ImageRecordIter(raw_records=True, dtype="uint8",
     shuffle=True, rand_mirror=True, preprocess_threads=2,
     host_batches=True)`` -> ``PrefetchingIter`` -> ``DeviceFeedIter``
     feeding a ``HybridSequential`` of a uint8 normalize (a frozen
     ``inv_std`` in the compute type) and ``resnet50()`` (NCHW, bf16,
     SGD momentum, ``cast_batch=False``), per-step batches: 8 fed
     batches (two epochs) equal to a second reader's of the same seed
     bit for bit, the first 5 fed losses equal to a twin fed by a
     blocking copy (cuDNN deterministic), 53/53/0/0 BatchNorm launches
     a fed step; the fed samples/s (median of 3 windows of 10) beside
     the same step on one reused batch, the feed's ``next()`` on the
     consumer thread, the pipeline alone (batches/s, no step), one
     profiled fed step, the peak memory; (b) one bf16 step each of
     resnet18/34/101/152_v1 and resnet18-152_v2 at b32 x 224^2 (the
     batch cut from 256), resnet50_v2 also in NHWC: losses finite,
     BatchNorm launches the model's count a step forward (counted from
     the model and held to ``ZOO_BN``) and backward but V2's input
     BatchNorm; resnet18_v2 in f32 at b2 x 64^2 on the card against the
     CPU (logits 1e-4, each gradient's rms error 1e-4 of its rms); #8-
     #11 at ``ZOO_ROWS`` against their plain versions, timed; (c)
     Conv1D, Conv3D, Conv{1,2,3}DTranspose (stride 2, padding 1,
     dilation 2), 1-D and 3-D pooling and ReflectionPad2D, f32, forward
     and backward on the card against the CPU, each tensor within 1e-5
     of max(1, its rms, |want|); Embedding's ids [0, 11, 12, 25, -1,
     -13] on a CUDA tensor give NaN rows where mxtpu's do, and the CUDA
     context works after;
 22. the serving fleet (``fleet_phase``), BERT-Large f32 from its
     export, each worker a ``ModelRunner(symbol, params)`` (batch <= 8,
     the seq bucket 128, a captured CUDA graph a bucket): (c) two
     workers with a ``GenerateRunner`` each over the causal BERT-Large's
     incremental decode (2 lanes, prompt bucket 32), the second warmed
     from the first's handoff while the first decodes; the worker
     holding a greedy and a seeded top-k stream is killed after 6 of
     32 tokens, and each stream resumed on the survivor equals the same
     prompt's uninterrupted stream token for token, every index
     streamed once, no build cold; (a) three workers behind a threaded
     ``FleetRouter`` (2 ms ticks, a canary of one fixed row every 0.25
     s, held to the eager plan's logits at (1, 128) with the router's
     rtol 1e-4 / atol 1e-5, the sampler at 100 Hz and an
     ``AvailabilitySLO`` attached, as ``bench_serving_fleet`` has
     them), w0's ladder captured before traffic and w1, w2 warmed from
     its handoff; a burst of 48 prices the fleet's raw rate, then 192
     requests open-loop at half of it, w0 killed at request 64 and wR
     attached from w0's handoff at 96 (the kill waits for a batch of w0
     to have just gone in flight, so it lands mid-replay): no drop, no
     hang, w0 dead and
     every other worker healthy, one death, wR serving with no cold
     build, 24/1/48 launches of #1/#4/#6 a forward; served req/s
     through the kill, p50/p95/p99, the retries, requeues, deaths and
     steals, wR's warm seconds beside a cold runner's first-request
     capture; (b) a ``Corrupt`` worker caught by the canary before any
     client request reaches it and a ``Hang`` worker caught by the
     liveness deadline, the hung worker's requests finished on the
     healthy one; (d) an ``Autoscaler`` (min 1, max 2) drains one of two
     idle workers, then scales up under a burst of 64 with a replica
     warmed from the live donor's handoff, which builds nothing cold and
     serves its share of a tail of 8 (the scaler frozen); (e) 4 requests traced through a
     canary-free fleet, each one's spans recorded in mxtpu's order
     (submit, queue wait, pad/scatter, run, execute) and nested in
     time, a ``torch.profiler`` device capture of the window through
     ``profiler.start_jax_trace`` holding kernel events, the debug
     server's ``/metrics`` round-tripping through
     ``parse_prometheus_text``; (f) one served forward launches #1 24
     times, #4 once and #6 48 times, and so does its captured entry's
     record; last every served result of the phase is held against its
     row alone through the eager plan at (1, 128) within the canary's
     tolerance, the largest deviation printed;
 23. detection (``detection_phase``, ~2 min; whether ``cv2`` imports is
     printed): (a) the NMS kernel (``csrc/nms.cu``, no TPU kernel: mxtpu's
     sweep is a ``lax.fori_loop``) against its plain loop at n 256 (b2,
     faster_rcnn_small's pre_n), 1704 (b8, ssd_300's anchors, 400
     sweeping rows) and 6000 (b2, Proposal's default pre_n), class-aware
     and force_suppress, and at n 256 with NaN corners: keep masks bit
     for bit, one launch a call, ms (the sum of the call's two CUDA
     kernels) and CUDA kernels a call of each; #8/#9 against their plain
     versions at SSD-300's seven BatchNorm shapes (N 8, bf16), timed at
     8 x 32 x 300² over 3 copies of the inputs in turn (one copy fits
     in L2); (b) bench_ssd's recipe (``ssd_300(20)``, xavier, b8 x 3 x
     300², VOC-shaped labels, ``det_loss`` without mining, SGD lr 5e-3
     momentum 0.9 wd 5e-4, bf16 compute): 3 eager windows of 10 steps,
     then 3 ``run_steps(x, y, 10, reuse_batch=True)`` windows, launches
     exactly 14/14/0/0 of #8-#11 a step in both, samples/s, one profiled
     step, peak memory, the losses finite and falling, the first 5
     repeating bit for bit from the same seeds (cuDNN deterministic);
     (c) ssd_300 in f32 at b2 on the card against the CPU from the same
     weights, the CPU on the card's max-pool and ReLU choices: the
     forward's three outputs 1e-4 x max(1, |ref|), the loss 1e-5, each
     gradient's rms error 1e-4 of its rms (the error without the replay
     printed beside); MultiBoxTarget on both devices from the card's
     cls_preds, mining -1 and 3: cls_target and box_mask equal,
     box_target 1e-6; (d) ``SSD.detect`` at b8 after (b): rows against
     the CPU's MultiBoxDetection on the same (probs, box_preds,
     anchors), keep masks equal but where a near tie (an IoU within
     1e-6 of the threshold) explains each image's first difference,
     classes and scores equal, corners 1e-6; VOC07 mAP of both row sets
     equal; ms and NMS launches a ``detect``; (e)
     ``faster_rcnn_small(20)`` at b2 x 3 x 600²: Proposal card against
     CPU on the same (prob, rpn_reg) as (d), corners 1e-6 of the image
     side; the head on the CPU over the card's rois 1e-4; 12 RPN steps
     (test_rcnn's, adam through ``gluon.Trainer``) at 3/3 BN launches a
     step, losses finite and falling; ``detect`` with one NMS launch for
     Proposal and one an image; (f) Proposal at the reference's
     defaults on a (2, 24, 38, 38) map (pre_n 6000, post_n 300) card
     against CPU, ms a call.  The NMS launches of the main path are
     counted cell by cell before any timing loop: 2 in (d) (the card's
     MultiBoxDetection, one ``detect``), 16 in (e) (the forward, 12 RPN
     steps, ``detect``'s 1 + 2), 1 in (f).
 24. the persistent compile cache (``cache_phase``): bench_serving_
     coldstart's row in this process (bench's small BERT, its ladder
     warmed against an empty root and by a fresh runner on the
     populated root, every bucket a hit, the first request of a fresh
     runner in each mode, the ratio of the ladders' seconds), then
     fresh ``python3`` processes of this script (``--cache-child``),
     each with its own MXTPU_CACHE_DIR, on BERT-Large f32 served from
     its export at the fleet's ladder (b <= 8 x T128): (a) cold on an
     empty root: nvcc's seconds for the 10 sources, each bucket's and
     the ladder's seconds, the time from the spawn to the first served
     request, a forward's launch record and counts 24/1/48 of #1
     f32/#4/#6; (b) a fresh process on (a)'s root: no nvcc, every
     bucket "disk", no cold build, (a)'s launch record, the 16 seeded
     rows and the b8 batch bit-equal to (a)'s, the same seconds; (c) a
     copy of the root with one kernel entry and one bucket entry
     corrupted and another bucket entry truncated: each quarantined
     (never opened), the kernel rebuilt by nvcc, the two buckets cold,
     the rows bit-equal to (a)'s; (d) a threaded fleet on (a)'s root:
     w0 killed with no handoff, the autoscaler's floor repair and a
     replacement attached by hand both "disk_cache" with no cold
     build, every row served through it within the canary's tolerance
     of (a)'s; (e) causal BERT-Large (8 lanes + scratch, L 512, prompt
     bucket 32) served by a donating ``GenerateRunner`` and by one with
     ``donate=False``: 17 greedy tokens a lane equal, the logits bit for
     bit, every caller's table unchanged bit for bit, the launch
     records and a decode's counts (1/48 of #4/#6) alike, the decode
     step's ms of each and the two table copies' device ms.

Tolerances: a kernel's result r passes against the plain p when
|r - p| <= tol * max(1, |p|), tol = 1e-4 in f32 (another summation
order) and 2e-2 in bf16 (one bf16 rounding of the output); the bf16
flash gradients, whose typical size is about 0.1, are held at
|r - p| <= 2e-2 * max(min(1, rms(p)), |p|) instead, and BatchNorm's f32
dgamma and dbeta (sums over N*S elements) at 1e-4 * max(rms(p), |p|);
the served logits against the CPU, and the generation logits against
the full forward and against the CPU: 1e-3 (24 layers of f32 GEMMs in
another order); AMP and int8 logits against the CPU's plain path: 5e-2
and 1e-1 of their scale (an input that lands within an f32 rounding of
a bf16 or int8 step rounds to the other side, and 24 layers part the
two runs by about each type's own distance from f32); the AMP GEMM
against its plain version: twice the rounding bound of a K-term f32
sum, K 2^-24 (|a| @ |b|), each element; the AMP convolution 1e-5 of the
result's largest magnitude, its weight gradient 1e-3 (8e5-term sums);
the rtc softmax: p 1e-6 relative, dx 1e-6 absolute;
the symbolic resnet20 card vs CPU: outputs (probabilities) 1e-5, each
gradient's rms error 1e-4 of its rms, three step losses 1e-4 of
max(|p|, 0.01); the rtc head against SoftmaxOutput over three steps:
logits gradients 1e-6, parameters 1e-6 relative; the 2-layer BERT and the small ResNet train checks:
each gradient's rms error 1e-4 of its rms, but for ResNet's
convolution biases that feed a BatchNorm, whose gradient is zero in
exact arithmetic: each side on its own within n * 2^-24 * sum |dL/dz|
per channel (the rounding bound of an n-term f32 sum, n = N*H*W, z the
convolution's output); the loss 1e-5 and the three step
losses 1e-4 relative (ResNet's of max(|p|, 0.01)), ResNet's running
statistics 1e-5.

Kernel times are device time per call (torch.profiler: the sum of the
kernels a call launches), for the kernel, its plain version and the
library call alike; the kernel's wall time per call (CUDA events over
back-to-back calls, host launch cost included) is printed beside it.

Output: the card's name and power limit, per-kernel lines, the training
and serving numbers, a ``{"kernels": [...]}`` JSON line (flash forward,
dq and dk/dv in bf16 and f32, the bf16 rows with BERT-Large bf16
training's launches, the f32 forward with serving's and the f32
backward with BERT-Large f32 training's; an f32 row on the tensor cores
takes the smaller of its FMA and split bounds; #4 and #6 again with
``"path": "generate"``, at the decode step's shape with the generation
server's launches; #1-#7 with ``"path": "transformer"``, bf16 at the
Transformer-big step's shapes with its bf16 eager steps' launches;
#8/#9 with ``"path": "pipeline"`` at ResNet-50 NCHW's b256 shape with
the fed windows' launches, #8-#11 with ``"path": "zoo"`` at
``ZOO_ROWS`` with the zoo steps' launches, and #1, #4 and #6 in f32
with ``"path": "fleet"``, timed at the serving shapes, with the fleet
recovery run's launches; #8/#9 with ``"path": "detection"`` at
8 x 32 x 300² with SSD-300's eager steps' launches, and the NMS kernel at
SSD's detection shape with the main path's NMS launches of (d)-(f)),
and last the line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without CUDA or outside a checkout.  A full report goes to
``mxtpu_torch/_build/chip_smoke_report.json``.
"""
import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
CARD = "cuda:0"   # every tensor and entry point of the run lives here
VOCAB, UNITS, FFN, LAYERS, HEADS, MAXLEN = 30522, 1024, 4096, 24, 16, 512
B, T, D = 32, 128, UNITS // HEADS
N_REQUESTS, N_CLIENTS = 128, 4
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_WINDOWS = 3, 10, 3
CHECK_LAYERS, CHECK_B = 2, 4
GRAD_TOL, LOSS_TOL, STEP_TOL = 1e-4, 1e-5, 1e-4
# launch counter -> the CUDA kernels (profiler names) one wrapper call
# launches
KERNEL_NAMES = {"flash_attention_fwd": ("fa_fwd_f32_wgmma_kernel",
                                        "fa_fwd_wgmma_kernel"),
                "flash_attention_bwd_dq": ("fa_bwd_dq_f32_wgmma_kernel",
                                           "fa_bwd_dq_wgmma_kernel"),
                "flash_attention_bwd_dkv": ("fa_bwd_dkv_f32_wgmma_kernel",
                                            "fa_bwd_dkv_wgmma_kernel"),
                "layer_norm_fwd": ("ln_fwd_rows_kernel",
                                   "ln_fwd_wide_kernel"),
                "layer_norm_bwd": ("ln_bwd_rows_kernel",
                                   "ln_bwd_wide_kernel",
                                   "ln_bwd_finalize_kernel"),
                "fused_residual_ln_fwd": ("frln_fwd_rows_kernel",
                                          "frln_fwd_wide_kernel"),
                "fused_residual_ln_bwd": ("frln_bwd_rows_kernel",
                                          "frln_bwd_wide_kernel",
                                          "frln_bwd_finalize_kernel"),
                **{f"batch_norm_{d}": (f"bn_{d}_major_stats_kernel",
                                       f"bn_{d}_finalize_kernel",
                                       f"bn_{d}_major_apply_kernel")
                   for d in ("fwd", "bwd")},
                **{f"batch_norm_{d}": tuple(f"bn_{d}_{k}_kernel"
                                            for k in ("stats", "finalize",
                                                      "apply"))
                   for d in ("fwd_cm", "bwd_cm")},
                "conv_nhwc": ("conv_nhwc_wgmma_kernel",
                              "conv_nhwc_f32_wgmma_kernel",
                              "conv_split_f32_kernel",
                              "conv_nhwc_f32_kernel"),
                "nms": ("nms_mask_kernel", "nms_sweep_kernel")}
# the kernels that must run on the tensor cores with TMA loads (bf16,
# and f32 split into bf16 parts): the library each is built into, and
# the instructions its SASS must hold; the f32 ones (named "_f32_")
# must hold no TF32 product either
TENSOR_CORE_KERNELS = {"fa_fwd_wgmma_kernel": "flash_attention",
                       "fa_fwd_f32_wgmma_kernel": "flash_attention",
                       "fa_bwd_dq_wgmma_kernel": "flash_attention_bwd",
                       "fa_bwd_dkv_wgmma_kernel": "flash_attention_bwd",
                       "fa_bwd_dq_f32_wgmma_kernel": "flash_attention_bwd",
                       "fa_bwd_dkv_f32_wgmma_kernel": "flash_attention_bwd",
                       "conv_nhwc_wgmma_kernel": "conv_nhwc",
                       "conv_nhwc_f32_wgmma_kernel": "conv_nhwc"}
SASS_NEEDS = ("HGMMA", "UTMALDG")
# the kernels rebuilt for Hopper's memory system (16-byte vector loads,
# registers in place of shared-memory staging): no wgmma, but every
# instantiation listed by ptxas with no spill
VECTOR_KERNELS = {"ln_fwd_rows_kernel": "layer_norm",
                  "ln_fwd_wide_kernel": "layer_norm",
                  "ln_bwd_rows_kernel": "layer_norm_bwd",
                  "ln_bwd_wide_kernel": "layer_norm_bwd",
                  "ln_bwd_finalize_kernel": "layer_norm_bwd",
                  "frln_fwd_rows_kernel": "fused_residual_ln",
                  "frln_fwd_wide_kernel": "fused_residual_ln",
                  "frln_bwd_rows_kernel": "fused_residual_ln_bwd",
                  "frln_bwd_wide_kernel": "fused_residual_ln_bwd",
                  "frln_bwd_finalize_kernel": "fused_residual_ln_bwd",
                  "bn_fwd_cm_stats_kernel": "batch_norm",
                  "bn_fwd_cm_finalize_kernel": "batch_norm",
                  "bn_fwd_cm_apply_kernel": "batch_norm",
                  "bn_bwd_cm_stats_kernel": "batch_norm_bwd",
                  "bn_bwd_cm_finalize_kernel": "batch_norm_bwd",
                  "bn_bwd_cm_apply_kernel": "batch_norm_bwd",
                  "bn_fwd_major_stats_kernel": "batch_norm",
                  "bn_fwd_major_apply_kernel": "batch_norm",
                  "bn_bwd_major_stats_kernel": "batch_norm_bwd",
                  "bn_bwd_major_apply_kernel": "batch_norm_bwd"}
GEMM_WORDS = ("gemm", "cutlass", "sm90_xmma", "ampere", "nvjet", "cublas")
# cuDNN's convolution kernels (implicit GEMMs named fprop/dgrad/wgrad,
# and its layout transposes); matched before GEMM_WORDS
CONV_WORDS = ("conv", "cudnn", "fprop", "dgrad", "wgrad", "nchwtonhwc",
              "nhwctonchw")
# published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
# The dropout mask's integer work an element, read from the SASS nvcc
# gives threefry_bits (csrc/common.cuh): MASK_PROBE_SOURCE draws E keep
# bits a thread as E chains, built at E = 4 and 8, and the difference of
# the two kernels' instructions over 4 is one element's mix.  An SM
# issues one warp instruction a clock in each of its 4 sub-partitions
# (128 thread instructions a clock) to two 32-bit integer pipes of 64
# lanes an SM each: the FMA pipe takes IMAD and IMUL (IMAD.IADD,
# IMAD.MOV and IMAD.SHL are the compiler's adds, moves and shifts moved
# there), the ALU pipe ALU_OPS; an instruction of neither list (VIADD,
# ...) is counted only where it issues.  An element takes at least
# max(alu / 64, fma / 64, all / 128) clocks of an SM.
INT_PIPE_LANES = 64
ISSUE_LANES = 128
FMA_OPS = ("IMAD", "IMUL")
ALU_OPS = {"IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT", "MOV"}
MASK_PROBE_E = (4, 8)
MASK_PROBE_SOURCE = r'''
#include "common.cuh"
template <int E>
__device__ __forceinline__ void draw(uint32_t k0, uint32_t k1,
                                     uint32_t thresh, uint32_t n, int* out) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t * E >= n) return;
  int kept = 0;
#pragma unroll
  for (int j = 0; j < E; ++j)
    kept += threefry_bits(k0, k1, t * E + (uint32_t)j) < thresh;
  out[t] = kept;
}
extern "C" __global__ void mask_probe_4(uint32_t k0, uint32_t k1,
    uint32_t thresh, uint32_t n, int* out) { draw<4>(k0, k1, thresh, n, out); }
extern "C" __global__ void mask_probe_8(uint32_t k0, uint32_t k1,
    uint32_t thresh, uint32_t n, int* out) { draw<8>(k0, k1, thresh, n, out); }
'''
MASK_PROBE_SIG = "uint32_t k0, uint32_t k1, uint32_t thresh, uint32_t n, " \
    "int *out"
# SASS that neither pipe counts: control, memory, and the uniform
# datapath's per-warp instructions (opcodes from U)
SASS_NOT_INT = {"NOP", "EXIT", "BRA", "RET", "BSSY", "BSYNC", "S2R", "S2UR",
                "CS2R", "LDC", "LDG", "STG", "LDS", "STS", "BAR", "WARPSYNC"}
# set in main from the card (its SMs, nvidia-smi's clocks.max.sm) and
# the mask probe's SASS (clocks of an SM an element)
INT_PEAK = {"sms": 0, "clock_hz": 0.0, "mask_clk": 0.0}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SERVE_TOL = 1e-3


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def rel_err(got, want, floor=1.0):
    """max |got - want| / max(floor, |want|) and max |got - want|."""
    g, w = got.double(), want.double()
    d = (g - w).abs()
    return float((d / w.abs().clamp_min(floor)).max()), float(d.max())


def scale_floor(want, dtype):
    """The floor of the relative error for a bf16 gradient whose typical
    size is well under 1: its rms, so that the tolerance scales with
    the tensor (never above 1, so never looser than max(1, |p|))."""
    if dtype != "bfloat16":
        return 1.0
    return min(1.0, float(want.double().pow(2).mean().sqrt()))


def time_ms(fn, iters=50, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt):
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def device_ms(fn, iters=20, warmup=3, by_name=None):
    """Device time of one call of ``fn``: the sum of every kernel it
    launches, from torch.profiler over ``iters`` calls.  Unlike
    :func:`time_ms` it leaves out the host's launch cost, which for a
    ~20 us kernel called from Python can exceed the kernel itself.
    With ``by_name`` (a list of kernel names) it returns the device ms
    per call of each named kernel instead.  Where the profiler records
    no device time at all, the call's time (without ``by_name``) is
    read with CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # torch.profiler now and then returns a window without device
    # events, or with only a few of them (a time far under the bound);
    # every call launches at least one kernel, so a window with fewer
    # device events than calls is taken again, and of three such windows
    # the one with the most events is read.  The rtc head's ~1 us
    # kernels come short in every window: their time is then read per
    # recorded event, one kernel a call
    best = None
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evts = prof.key_averages()
        total = sum(_device_us(e) for e in evts)
        n_dev = sum(e.count for e in evts if _device_us(e) > 0)
        if best is None or n_dev > best[2]:
            best = (evts, total, n_dev)
        if total and n_dev >= iters:
            break
        print(f"torch.profiler recorded {n_dev} device events for {iters} "
              f"calls (window {attempt + 1} of 3)", file=sys.stderr,
              flush=True)
    evts, total, n_dev = best
    if not total and by_name is None:
        # CUPTI now and then records nothing in three windows running:
        # CUDA events over the same calls instead, the host's launch
        # cost included
        ms = time_ms(fn, iters, warmup)
        print(f"torch.profiler recorded no device time in 3 windows: "
              f"{ms:.4f} ms a call from CUDA events instead (host launch "
              f"included)", file=sys.stderr, flush=True)
        return ms
    if not total:
        fail("torch.profiler recorded no device time")
    per = min(n_dev, iters)
    if by_name is None:
        return total / per / 1e3
    # a named kernel runs once a call: its time is its mean over the
    # launches the profiler recorded, which a dropped event leaves true
    out = {}
    for n in by_name:
        mine = [e for e in evts if re.search(rf"\b{n}\b", e.key)]
        us, count = sum(_device_us(e) for e in mine), \
            sum(e.count for e in mine)
        if not us:
            fail(f"torch.profiler recorded no time for kernel {n}")
        out[n] = us / count / 1e3
    return out


def kernels_of(fn, iters=5):
    """The device kernels that one call of ``fn`` launches, as [name,
    device ms per call], longest first (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sorted(([e.key[:160], _device_us(e) / iters / 1e3]
                   for e in prof.key_averages() if _device_us(e) > 0),
                  key=lambda kv: -kv[1])


def family_of(key):
    """The family of a profiled device kernel: one of the ported
    kernels (whole-word match, so that no name matches inside a longer
    one), a cuDNN convolution, a GEMM, or other."""
    for fam, names in KERNEL_NAMES.items():
        if any(re.search(rf"\b{n}\b", key) for n in names):
            return fam
    low = key.lower()
    if any(w in low for w in CONV_WORDS):
        return "conv"
    return "gemm" if any(w in low for w in GEMM_WORDS) else "other"


def timed(kernel, plain, library=None, names=None):
    """The timing fields of one kernel: device ms of the kernel, its
    plain version and the library call, plus the kernel's wall ms per
    call (events, host launch cost included).  With ``names`` (the CUDA
    kernels one call launches) the kernel's ms is the sum of each named
    kernel's mean over its recorded launches, kept in ``ms_parts``: a
    window that drops some of a call's several kernels then still reads
    whole calls."""
    out = {"plain_ms": device_ms(plain),
           "library_ms": None if library is None else device_ms(library),
           "wall_ms": time_ms(kernel)}
    if names is None:
        return {"ms": device_ms(kernel), **out}
    parts = device_ms(kernel, by_name=list(names))
    return {"ms": sum(parts.values()), "ms_parts": parts, **out}


def bound(nbytes, ops, dtype, mask_elems=0):
    """The least ms the card could take: the larger of the bytes over
    3.35 TB/s, the float operations over the type's peak and the dropout
    mask's integer work over ``mask_elems`` elements (:func:`mask_ms`)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(ops / PEAK_OPS[dtype] * 1e3, mask_ms(mask_elems))
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mask_ms(elems):
    """The least ms of drawing the dropout mask of ``elems`` elements:
    the clocks of an SM an element (``INT_PEAK["mask_clk"]``, from
    :func:`mask_probe_phase`) over every SM at clocks.max.sm."""
    if not elems:
        return 0.0
    rate = INT_PEAK["sms"] * INT_PEAK["clock_hz"]
    if rate <= 0 or INT_PEAK["mask_clk"] <= 0:
        fail("the card's integer rate is unknown (INT_PEAK unset)")
    return elems * INT_PEAK["mask_clk"] / rate * 1e3


def sass_opcodes(func):
    """Count of each opcode (its first word, predicate dropped) in one
    function of ``cuobjdump -sass``."""
    ops = {}
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", func):
        op = m.group(1)
        ops[op] = ops.get(op, 0) + 1
    return ops


def mask_probe_phase(checks):
    """Build ``MASK_PROBE_SOURCE`` (nvcc -cubin, as rtc.CudaModule
    does), read one element's integer mix from its SASS (the E = 8
    kernel's count less the E = 4 kernel's, over 4) and set
    ``INT_PEAK["mask_clk"]``; then time the E = 8 kernel over BERT's
    R x C elements against that floor, which it cannot beat."""
    import shutil
    import torch
    from mxtpu_torch import rtc
    from mxtpu_torch.kernels import _build
    module = rtc.CudaModule(MASK_PROBE_SOURCE,
                            options=(f"-I{_build.CSRC}",),
                            exports=[f"mask_probe_{e}" for e in
                                     MASK_PROBE_E])
    cubin = _build.BUILD_DIR / "mask_probe.cubin"
    cubin.write_bytes(module._cubin)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(cubin)], capture_output=True,
                          text=True, timeout=300)
    funcs = {f.split("\n", 1)[0].strip(): f
             for f in re.split(r"\n\s*Function : ", sass.stdout)[1:]}
    lo, hi = (sass_opcodes(funcs.get(f"mask_probe_{e}", ""))
              for e in MASK_PROBE_E)
    per = (MASK_PROBE_E[1] - MASK_PROBE_E[0])
    mix = {op: (hi.get(op, 0) - lo.get(op, 0)) / per
           for op in sorted(set(lo) | set(hi))
           if op.split(".")[0] not in SASS_NOT_INT and op[0] != "U"
           and hi.get(op, 0) != lo.get(op, 0)}
    fma = sum(n for op, n in mix.items() if op.startswith(FMA_OPS))
    alu = sum(n for op, n in mix.items() if op.split(".")[0] in ALU_OPS)
    every = sum(mix.values())
    clk = max(alu / INT_PIPE_LANES, fma / INT_PIPE_LANES,
              every / ISSUE_LANES)
    ok = len(funcs) == len(MASK_PROBE_E) and alu > 0 and \
        all(n > 0 for n in mix.values())
    INT_PEAK["mask_clk"] = clk
    R, C = B * T, UNITS
    out = torch.empty(R * C // MASK_PROBE_E[1], dtype=torch.int32,
                      device=CARD)
    k = module.get_kernel(f"mask_probe_{MASK_PROBE_E[1]}", MASK_PROBE_SIG)
    args = [0x2545F491, 0x9E3779B9, 3865470566, R * C, out]   # keep 0.9
    probe_ms = device_ms(lambda: k.launch(
        args, CARD, (out.numel() // 256, 1, 1), (256, 1, 1)))
    floor = mask_ms(R * C)
    ok = ok and probe_ms >= floor
    print(f"check mask probe: one element's integer SASS {mix}: ALU pipe "
          f"{alu:g}, FMA pipe {fma:g}, all {every:g} -> {clk:.4f} clocks "
          f"of an SM an element (max(alu/{INT_PIPE_LANES}, "
          f"fma/{INT_PIPE_LANES}, all/{ISSUE_LANES})); R{R} x C{C} "
          f"elements: floor "
          f"{floor:.4f} ms, the probe's E={MASK_PROBE_E[1]} kernel "
          f"{probe_ms:.4f} ms {'ok' if ok else 'FAIL'}", flush=True)
    checks.rows.append({"check": "mask probe", "mix": mix, "alu": alu,
                        "fma": fma, "all": every, "clk_per_elem": clk,
                        "floor_ms": floor, "probe_ms": probe_ms, "ok": ok})
    if not ok:
        checks.failed.append(f"mask probe: SASS mix {mix} of "
                             f"{sorted(funcs)}, {probe_ms:.4f} ms against "
                             f"a {floor:.4f} ms floor "
                             f"({sass.stderr.strip()[:200]})")


# an f32 product taken on the tensor cores as six bf16 products of the
# operands' exact three-way split (the f32 flash forward and conv)
SPLIT_PRODUCTS = 6


def f32_bounds(nbytes, ops):
    """The bound of f32 work by either route, and the smaller as the
    row's: the FMA bound (CUDA cores, ``PEAK_OPS["float32"]``) and the
    split bound, max(bytes / 3.35 TB/s, 6 * ops / 989 TFLOP/s): the
    least time the card could take at f32 accuracy (no TF32)."""
    fma = bound(nbytes, ops, "float32")
    split = bound(nbytes, SPLIT_PRODUCTS * ops, "bfloat16")
    best = min(fma, split)
    return {"bound_ms": best[0], "bound_by": best[1],
            "bound_fma_ms": fma[0], "bound_split_ms": split[0]}


class Checks:
    def __init__(self):
        self.failed = []
        self.rows = []

    def close(self, name, got, want, dtype, floor=1.0):
        rel, absmax = rel_err(got, want, floor)
        ok = rel <= TOL[dtype]
        self.rows.append({"check": name, "dtype": dtype,
                          "max_rel_err": rel, "max_abs_err": absmax,
                          "tol": TOL[dtype], "floor": floor, "ok": ok})
        print(f"check {name} [{dtype}]: max_abs_err={absmax:.3e} "
              f"max_rel_err={rel:.3e} tol={TOL[dtype]} floor={floor:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failed.append(f"{name} [{dtype}]")
        return absmax


def ptxas_of(log, kern):
    """[registers, spill bytes] of each instantiation of ``kern`` in a
    ptxas ``-v`` report."""
    out = []
    for m in re.finditer(r"Function properties for (\S+)\n(.*?)\n.*?Used "
                         r"(\d+) registers", log, re.S):
        if kern in m.group(1):
            spill = sum(int(b) for b in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", m.group(2)))
            out.append([int(m.group(3)), spill])
    return out


def sass_functions(tool, src, kern):
    """The SASS of each instantiation of ``kern`` in ``src``'s library
    (``cuobjdump -sass``), and cuobjdump's errors."""
    from mxtpu_torch.kernels import _build
    sass = subprocess.run([tool, "-sass", str(_build._target(src))],
                          capture_output=True, text=True, timeout=300)
    return [f for f in re.split(r"\n\s*Function : ", sass.stdout)[1:]
            if kern in f.split("\n", 1)[0]], sass.stderr


def ptxas_check(checks, kern, src, n_funcs):
    """The ptxas report of ``src``'s library (this run's build, or the
    one kept beside a library built earlier) must list each of the
    ``n_funcs`` instantiations of ``kern`` and show no spills."""
    from mxtpu_torch.kernels import _build
    regs = ptxas_of(_build.ptxas_log(src), kern)
    ok = len(regs) == n_funcs > 0 and all(sp == 0 for _, sp in regs)
    print(f"check ptxas {kern}: [registers, spill bytes] of each "
          f"instantiation {regs or 'no ptxas report'} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    checks.rows.append({"check": f"ptxas {kern}", "regs_spills": regs,
                        "ok": ok})
    if not ok:
        checks.failed.append(f"ptxas: {kern} spills or lacks a report "
                             f"of its {n_funcs} instantiations ({regs})")


def sass_phase(checks):
    """``cuobjdump -sass`` of the built libraries: every instantiation
    of each tensor-core kernel must hold wgmma (HGMMA) and TMA loads
    (UTMALDG), and an f32 one no TF32 HGMMA (its products are bf16
    parts), so a kernel that silently lost either fails the run; the
    ptxas report of its library must list every instantiation and show
    no spills (registers printed).  The vector kernels
    (``VECTOR_KERNELS``) are held to the ptxas check alone."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for kern, src in TENSOR_CORE_KERNELS.items():
        funcs, err = sass_functions(tool, src, kern)
        counts = [{w: f.count(w) for w in SASS_NEEDS} for f in funcs]
        ok = bool(funcs) and all(all(c.values()) for c in counts)
        if "_f32_" in kern:
            for c, f in zip(counts, funcs):
                c["TF32 HGMMA"] = sum("HGMMA" in line and "TF32" in line
                                      for line in f.splitlines())
            ok = ok and not any(c["TF32 HGMMA"] for c in counts)
        print(f"check SASS {kern} ({src}): {len(funcs)} instantiations, "
              f"{counts} {'ok' if ok else 'FAIL'}", flush=True)
        checks.rows.append({"check": f"SASS {kern}", "counts": counts,
                            "ok": ok})
        if not ok:
            checks.failed.append(f"SASS of {kern} lacks "
                                 f"{'/'.join(SASS_NEEDS)} or holds a TF32 "
                                 f"product ({counts}; "
                                 f"{err.strip()[:200]})")
        ptxas_check(checks, kern, src, len(funcs))
    for kern, src in VECTOR_KERNELS.items():
        ptxas_check(checks, kern, src,
                    len(sass_functions(tool, src, kern)[0]))


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------

# bench_flash's shape at its longest T (B4 H16 D64, causal, bf16): 128
# key tiles of 32 per query tile, most of them skipped past the
# diagonal, where the T <= 128 cases reach 4; the plain version's f32
# scores take 4.3 GB
FLASH_LONG_BH, FLASH_LONG_T = 4 * HEADS, 4096

def kernel_phase(checks, gen):
    import torch
    import torch.nn.functional as F
    import importlib
    fa = importlib.import_module("mxtpu_torch.kernels.flash_attention")
    ln = importlib.import_module("mxtpu_torch.kernels.layer_norm")
    dev = torch.device(CARD)
    R, C, BH = B * T, UNITS, B * HEADS
    scale = 1.0 / D ** 0.5
    out = {}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # -- flash attention ------------------------------------------------
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        q, k, v = (randn(BH, T, D, dtype=dt) for _ in range(3))
        o, lse = fa.flash_forward(q, k, v, False, scale)
        po, plse = fa.flash_forward_reference(q, k, v, False, scale)
        torch.cuda.synchronize()
        err = checks.close("flash_attention b32 T128", o, po, name)
        checks.close("flash_attention lse b32 T128", lse, plse, "float32")
        for causal, tq, tk in ((True, 127, 127), (True, 64, 127),
                               (False, 127, 127)):
            qs, ks, vs = (randn(BH, n, D, dtype=dt) for n in (tq, tk, tk))
            co, clse = fa.flash_forward(qs, ks, vs, causal, scale)
            cpo, cplse = fa.flash_forward_reference(qs, ks, vs, causal,
                                                    scale)
            torch.cuda.synchronize()
            tag = f"flash_attention causal={causal} Tq={tq} Tk={tk}"
            checks.close(tag, co, cpo, name)
            checks.close(tag + " lse", clse, cplse, "float32")
        if dt == torch.float32:
            # the f32 kernel's other instantiation (D > 64); D = 40,
            # whose 64-column boxes TMA fills with zeros past D; D = 36,
            # which the wrapper runs on copies zero-padded to 40.  Their
            # own generator leaves the later draws from ``gen`` as they
            # were without these cases, so every other row's inputs stay
            dgen = torch.Generator(device=dev).manual_seed(SEED + 1)
            for d_, causal in ((128, False), (40, True), (36, True)):
                qs, ks, vs = (torch.randn(8 * HEADS, T, d_, generator=dgen,
                                          device=dev) for _ in range(3))
                sc = 1.0 / d_ ** 0.5
                co, clse = fa.flash_forward(qs, ks, vs, causal, sc)
                cpo, cplse = fa.flash_forward_reference(qs, ks, vs, causal,
                                                        sc)
                torch.cuda.synchronize()
                tag = f"flash_attention causal={causal} T{T} D={d_}"
                checks.close(tag, co, cpo, name)
                checks.close(tag + " lse", clse, cplse, "float32")
        q4, k4, v4 = (t.reshape(B, HEADS, T, D) for t in (q, k, v))
        nbytes = 4 * BH * T * D * q.element_size() + BH * T * 4
        ops = 4 * BH * T * T * D
        if dt == torch.float32:
            bounds = f32_bounds(nbytes, ops)
        else:
            b_ms, b_by = bound(nbytes, ops, name)
            bounds = {"bound_ms": b_ms, "bound_by": b_by}
        out[("flash_attention_fwd", name)] = {
            "max_abs_err": err,
            **timed(lambda: fa.flash_forward(q, k, v, False, scale),
                    lambda: fa.flash_forward_reference(q, k, v, False,
                                                       scale),
                    lambda: F.scaled_dot_product_attention(q4, k4, v4)),
            **bounds}
    q, k, v = (randn(FLASH_LONG_BH, FLASH_LONG_T, D, dtype=torch.bfloat16)
               for _ in range(3))
    o, lse = fa.flash_forward(q, k, v, True, scale)
    po, plse = fa.flash_forward_reference(q, k, v, True, scale)
    torch.cuda.synchronize()
    tag = f"flash_attention causal=True BH{FLASH_LONG_BH} T{FLASH_LONG_T}"
    checks.close(tag, o, po, "bfloat16")
    checks.close(tag + " lse", lse, plse, "float32")
    del q, k, v, o, lse, po, plse
    torch.cuda.empty_cache()

    # -- LayerNorm ------------------------------------------------------
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        x = randn(R, C, dtype=dt)
        g = (1.0 + 0.1 * randn(C)).to(dt)
        b = (0.1 * randn(C)).to(dt)
        y, mean, rstd = ln.layer_norm_fwd(x, g, b)
        py, pmean, prstd = ln.layer_norm_reference(x, g, b)
        torch.cuda.synchronize()
        err = checks.close("layer_norm R4096 C1024", y, py, name)
        checks.close("layer_norm mean", mean, pmean, "float32")
        checks.close("layer_norm rstd", rstd, prstd, "float32")
        nbytes = 2 * R * C * x.element_size() + 2 * C * x.element_size() \
            + 2 * R * 4
        b_ms, b_by = bound(nbytes, 8 * R * C, name)
        out[("layer_norm_fwd", name)] = {
            "max_abs_err": err,
            **timed(lambda: ln.layer_norm_fwd(x, g, b),
                    lambda: ln.layer_norm_reference(x, g, b),
                    lambda: F.layer_norm(x, (C,), g, b)),
            "bound_ms": b_ms, "bound_by": b_by}

    # -- fused residual LayerNorm ------------------------------------------
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        h, res = randn(R, C, dtype=dt), randn(R, C, dtype=dt)
        bias = (0.1 * randn(C)).to(dt)
        g = (1.0 + 0.1 * randn(C)).to(dt)
        b = (0.1 * randn(C)).to(dt)
        args = (h, bias, res, g, b, None, 0.0, 1e-5, False)
        y, mean, rstd = ln.fused_residual_ln_fwd(*args)
        py, pmean, prstd = ln.fused_residual_ln_reference(*args)
        torch.cuda.synchronize()
        err = checks.close("fused_residual_ln keep=1", y, py, name)
        checks.close("fused_residual_ln mean", mean, pmean, "float32")
        checks.close("fused_residual_ln rstd", rstd, prstd, "float32")
        key = np.array([0x2545F491, 0x9E3779B9], np.uint32)
        dargs = (h, bias, res, g, b, key, 0.1, 1e-5, True)
        dy, _, _ = ln.fused_residual_ln_fwd(*dargs)
        dpy, _, _ = ln.fused_residual_ln_reference(*dargs)
        torch.cuda.synchronize()
        checks.close("fused_residual_ln keep=0.9", dy, dpy, name)
        nbytes = 3 * R * C * h.element_size() + 3 * C * h.element_size() \
            + 2 * R * 4
        b_ms, b_by = bound(nbytes, 10 * R * C, name)
        # with dropout (training): the same bytes, and the mask's integer
        # operations
        d_ms, d_by = bound(nbytes, 10 * R * C, name, R * C)
        keep09 = device_ms(lambda: ln.fused_residual_ln_fwd(*dargs))
        out[("fused_residual_ln_fwd", name)] = {
            "max_abs_err": err,
            **timed(lambda: ln.fused_residual_ln_fwd(*args),
                    lambda: ln.fused_residual_ln_reference(*args)),
            "bound_ms": b_ms, "bound_by": b_by, "ms_keep09": keep09,
            "bound_keep09_ms": d_ms, "bound_keep09_by": d_by,
            "bound_int_ms": mask_ms(R * C)}
    out[("fused_residual_ln_fwd", "float32")]["shapes"] = \
        frln_fwd_times(ln, wide=True)

    # dropout mask, bit for bit: with h = 1, bias = res = beta = 0 and
    # gamma = 1, u is 1/keep where kept and 0 where dropped, so y > 0
    # exactly where the kernel kept an element
    ones = torch.ones(R, C, device=dev)
    zc = torch.zeros(C, device=dev)
    key = np.array([0x12345678, 0x0BADF00D], np.uint32)
    y, _, _ = ln.fused_residual_ln_fwd(ones, zc, torch.zeros_like(ones),
                                       torch.ones(C, device=dev), zc, key,
                                       0.1, 1e-5, True)
    want = ln.mask_bits(int(key[0]), int(key[1]), 0, R, C, device=dev) \
        < ln.keep_thresh(0.9)
    mismatch = int(((y > 0) != want).sum())
    kept = float(want.float().mean())
    print(f"check fused_residual_ln keep=0.9 mask: {mismatch} of {R * C} "
          f"bits differ (kept share {kept:.4f}) "
          f"{'ok' if mismatch == 0 else 'FAIL'}", flush=True)
    checks.rows.append({"check": "fused_residual_ln keep=0.9 mask bits",
                        "mismatch": mismatch, "ok": mismatch == 0})
    if mismatch:
        checks.failed.append("fused_residual_ln dropout mask")
    return out


# ----------------------------------------------------------------------
# phase 3: backward kernels against their plain versions
# ----------------------------------------------------------------------

def backward_phase(checks, gen):
    import torch
    import torch.nn.functional as F
    import importlib
    fa = importlib.import_module("mxtpu_torch.kernels.flash_attention")
    ln = importlib.import_module("mxtpu_torch.kernels.layer_norm")
    dev = torch.device(CARD)
    R, C, BH = B * T, UNITS, B * HEADS
    scale = 1.0 / D ** 0.5
    out = {}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def grads_of(fn, xs, dy):
        """AD backward only: the forward runs once, the timed call is
        torch.autograd.grad over the kept graph."""
        xs = [x.detach().requires_grad_(True) for x in xs]
        y = fn(*xs)
        return lambda: torch.autograd.grad(y, xs, dy, retain_graph=True)

    # -- flash attention dq, dk/dv --------------------------------------
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        cases = ((False, T, T), (True, 127, 127), (True, 64, 127),
                 (False, 127, 127))
        for causal, tq, tk in cases:
            q, do = (randn(BH, tq, D, dtype=dt) for _ in range(2))
            k, v = (randn(BH, tk, D, dtype=dt) for _ in range(2))
            o, lse = fa.flash_forward(q, k, v, causal, scale)
            got = fa.flash_backward(q, k, v, do, o, lse, causal, scale)
            want = fa.flash_backward_reference(q, k, v, do, o, lse,
                                               causal, scale)
            torch.cuda.synchronize()
            tag = f"flash_backward causal={causal} Tq={tq} Tk={tk}"
            errs = [checks.close(f"{tag} {g}", a, b, name,
                                 scale_floor(b, name))
                    for g, a, b in zip(("dq", "dk", "dv"), got, want)]
            if not all(torch.isfinite(t).all() for t in got):
                checks.failed.append(f"{tag} [{name}]: not finite")
            if (causal, tq, tk) == (False, T, T):
                full = (q, k, v, do, o, lse, errs)
        q, k, v, do, o, lse, errs = full
        q4, k4, v4, do4 = (t.reshape(B, HEADS, T, D) for t in (q, k, v, do))
        el = q.element_size()
        rows = 2 * BH * T * 4                       # lse and delta, f32
        per = BH * T * D * el
        wg = "_wgmma" if dt == torch.bfloat16 else "_f32_wgmma"
        dq_name, dkv_name = f"fa_bwd_dq{wg}_kernel", f"fa_bwd_dkv{wg}_kernel"
        kern = device_ms(lambda: fa.flash_backward(q, k, v, do, o, lse,
                                                   False, scale),
                         by_name=[dq_name, dkv_name])
        plain = device_ms(lambda: fa.flash_backward_reference(
            q, k, v, do, o, lse, False, scale))
        ad_plain = device_ms(grads_of(
            lambda a, b_, c: fa.attention_reference(a, b_, c),
            (q4, k4, v4), do4))
        sdpa = device_ms(grads_of(F.scaled_dot_product_attention,
                                  (q4, k4, v4), do4))
        wall = time_ms(lambda: fa.flash_backward(q, k, v, do, o, lse, False,
                                                 scale))
        # dq reads q, k, v, dO and writes dq; dk/dv reads the four and
        # writes dk, dv; both read lse and delta
        for kname, pname, nt, ops, err in (
                ("flash_attention_bwd_dq", dq_name, 5,
                 6 * BH * T * T * D, errs[0]),
                ("flash_attention_bwd_dkv", dkv_name, 6,
                 8 * BH * T * T * D, max(errs[1:]))):
            if dt == torch.float32:
                bounds = f32_bounds(nt * per + rows, ops)
            else:
                b_ms, b_by = bound(nt * per + rows, ops, name)
                bounds = {"bound_ms": b_ms, "bound_by": b_by}
            out[(kname, name)] = {
                "max_abs_err": err, "ms": kern[pname], "plain_ms": plain,
                "library_ms": sdpa, "ad_plain_ms": ad_plain,
                "wall_ms": wall, **bounds}
    # causal at bench_flash's longest T: bf16 from the shared generator
    # as before, f32 from one of its own, so that every later check's
    # inputs stay as they were without it
    lgen = torch.Generator(device=dev).manual_seed(SEED + 2)
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        q, k, v, do = (torch.randn(FLASH_LONG_BH, FLASH_LONG_T, D,
                                   generator=gen if dt == torch.bfloat16
                                   else lgen, device=dev).to(dt)
                       for _ in range(4))
        o, lse = fa.flash_forward(q, k, v, True, scale)
        got = fa.flash_backward(q, k, v, do, o, lse, True, scale)
        want = fa.flash_backward_reference(q, k, v, do, o, lse, True, scale)
        torch.cuda.synchronize()
        tag = f"flash_backward causal=True BH{FLASH_LONG_BH} T{FLASH_LONG_T}"
        for g, a, b in zip(("dq", "dk", "dv"), got, want):
            checks.close(f"{tag} {g}", a, b, name, scale_floor(b, name))
        if not all(torch.isfinite(t).all() for t in got):
            checks.failed.append(f"{tag} [{name}]: not finite")
        del want
        # where bench_flash's long-context backward spends its time
        print(f"kernels of {tag} [{name}] (device ms per call): " +
              "; ".join(f"{kn} {ms:.4f}" for kn, ms in kernels_of(
                  lambda: fa.flash_backward(q, k, v, do, o, lse, True,
                                            scale))), flush=True)
        del q, k, v, do, o, lse, got
        torch.cuda.empty_cache()

    # -- LayerNorm ------------------------------------------------------
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        x, dy = randn(R, C, dtype=dt), randn(R, C, dtype=dt)
        g = (1.0 + 0.1 * randn(C)).to(dt)
        b = (0.1 * randn(C)).to(dt)
        _, mean, rstd = ln.layer_norm_fwd(x, g, b)
        got = ln.layer_norm_bwd(x, g, mean, rstd, dy)
        want = ln.layer_norm_bwd_reference(x, g, mean, rstd, dy)
        torch.cuda.synchronize()
        errs = [checks.close(f"layer_norm_bwd R4096 C1024 {n}", a, w_, name)
                for n, a, w_ in zip(("dx", "dgamma", "dbeta"), got, want)]
        el = x.element_size()
        nbytes = 3 * R * C * el + 3 * C * el + 2 * R * 4
        b_ms, b_by = bound(nbytes, 12 * R * C, name)
        out[("layer_norm_bwd", name)] = {
            "max_abs_err": max(errs),
            **timed(lambda: ln.layer_norm_bwd(x, g, mean, rstd, dy),
                    lambda: ln.layer_norm_bwd_reference(x, g, mean, rstd,
                                                        dy),
                    grads_of(lambda a, c, d: F.layer_norm(a, (C,), c, d),
                             (x, g, b), dy)),
            "bound_ms": b_ms, "bound_by": b_by}
        print(f"kernels of layer_norm_bwd R{R} C{C} [{name}] (device ms "
              f"per call): " + "; ".join(
                  f"{kn} {ms:.4f}" for kn, ms in kernels_of(
                      lambda: ln.layer_norm_bwd(x, g, mean, rstd, dy))),
              flush=True)

    # -- fused residual LayerNorm, keep = 0.9 ----------------------------
    key = (0x2545F491, 0x9E3779B9)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        h, res, dy = (randn(R, C, dtype=dt) for _ in range(3))
        bias = (0.1 * randn(C)).to(dt)
        g = (1.0 + 0.1 * randn(C)).to(dt)
        b = (0.1 * randn(C)).to(dt)
        _, mean, rstd = ln.fused_residual_ln_fwd(h, bias, res, g, b, key,
                                                 0.1)
        args = (h, bias, res, g, key, mean, rstd, dy, 0.9)
        got = ln.fused_residual_ln_bwd(*args)
        want = ln.fused_residual_ln_bwd_reference(*args)
        torch.cuda.synchronize()
        errs = [checks.close(f"fused_residual_ln_bwd keep=0.9 {n}", a, w_,
                             name)
                for n, a, w_ in zip(("dh", "dbias", "dres", "dgamma",
                                     "dbeta"), got, want)]
        el = h.element_size()
        nbytes = 5 * R * C * el + 5 * C * el + 2 * R * 4
        b_ms, b_by = bound(nbytes, 20 * R * C, name, R * C)
        out[("fused_residual_ln_bwd", name)] = {
            "max_abs_err": max(errs),
            **timed(lambda: ln.fused_residual_ln_bwd(*args),
                    lambda: ln.fused_residual_ln_bwd_reference(*args)),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_bytes_ms": nbytes / PEAK_BYTES * 1e3,
            "bound_int_ms": mask_ms(R * C),
            # without the mask: what the mask's integer work adds
            "ms_keep1": device_ms(lambda: ln.fused_residual_ln_bwd(
                h, bias, res, g, key, mean, rstd, dy, 1.0))}
        print(f"kernels of fused_residual_ln_bwd R{R} C{C} keep=0.9 "
              f"[{name}] (device ms per call): " + "; ".join(
                  f"{kn} {ms:.4f}" for kn, ms in kernels_of(
                      lambda: ln.fused_residual_ln_bwd(*args))),
              flush=True)
        if dt == torch.float32:
            dh_zero = got[0] == 0

    # shapes the main path does not reach: other head dims (the kernels'
    # column-count instantiations; D = 42 runs the bf16 kernels on
    # copies zero-padded to 48), an explicit diagonal offset, row counts
    # off the 8-row blocks, C under 1024 (128 threads) and C past the
    # 48 KB shared-memory opt-in
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for causal, tq, tk, d, delta in ((True, 100, 100, 32, None),
                                         (False, 50, 77, 128, None),
                                         (True, 65, 65, 96, 3),
                                         (True, 40, 90, 64, -5),
                                         (True, 70, 90, 42, None)):
            q, do = (randn(8, tq, d, dtype=dt) for _ in range(2))
            k, v = (randn(8, tk, d, dtype=dt) for _ in range(2))
            sc = 1.0 / d ** 0.5
            o, lse = fa.flash_forward(q, k, v, causal, sc, delta)
            po, plse = fa.flash_forward_reference(q, k, v, causal, sc, delta)
            got = fa.flash_backward(q, k, v, do, o, lse, causal, sc, delta)
            want = fa.flash_backward_reference(q, k, v, do, o, lse, causal,
                                               sc, delta)
            torch.cuda.synchronize()
            tag = f"Tq={tq} Tk={tk} D={d} delta={delta}"
            checks.close(f"flash_attention edge causal={causal} {tag}", o,
                         po, name)
            checks.close(f"flash_attention edge causal={causal} {tag} lse",
                         lse, plse, "float32")
            for g, a, b in zip(("dq", "dk", "dv"), got, want):
                checks.close(f"flash_backward edge causal={causal} Tq={tq} "
                             f"Tk={tk} D={d} delta={delta} {g}", a, b, name,
                             scale_floor(b, name))
        for r, c in ((1001, 768), (64, 4096), (3, 8192)):
            x, dy, hh = (randn(r, c, dtype=dt) for _ in range(3))
            g = (1.0 + 0.1 * randn(c)).to(dt)
            b = (0.1 * randn(c)).to(dt)
            _, mean, rstd = ln.layer_norm_fwd(x, g, b)
            got = ln.layer_norm_bwd(x, g, mean, rstd, dy)
            want = ln.layer_norm_bwd_reference(x, g, mean, rstd, dy)
            _, fmean, frstd = ln.fused_residual_ln_fwd(hh, b, x, g, b, key,
                                                       0.1)
            args = (hh, b, x, g, key, fmean, frstd, dy, 0.9)
            fgot = ln.fused_residual_ln_bwd(*args)
            fwant = ln.fused_residual_ln_bwd_reference(*args)
            torch.cuda.synchronize()
            for g_, a, w_ in zip(("dx", "dgamma", "dbeta"), got, want):
                checks.close(f"layer_norm_bwd edge R={r} C={c} {g_}", a, w_,
                             name)
            for g_, a, w_ in zip(("dh", "dbias", "dres", "dgamma", "dbeta"),
                                 fgot, fwant):
                checks.close(f"fused_residual_ln_bwd edge R={r} C={c} {g_}",
                             a, w_, name)

    # the LayerNorm backward's scalar path: a C off the 16-byte vector,
    # and contiguous views whose data lies off a 16-byte boundary (a row
    # slice of a larger buffer at an odd C, one element into a buffer at
    # C = 1024); inputs from a generator of their own
    egen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]

        def erandn(*shape):
            return torch.randn(*shape, generator=egen, device=dev)
        for tag, r, c, off in (("C off the vector", 37, 1030, 0),
                               ("row slice", 41, 1031, 1031),
                               ("one element in", 64, 1024, 1)):
            x, dy = (erandn(r * c + off).to(dt)[off:].view(r, c)
                     for _ in range(2))
            g = (1.0 + 0.1 * erandn(c)).to(dt)
            b = (0.1 * erandn(c)).to(dt)
            _, mean, rstd = ln.layer_norm_fwd(x, g, b)
            got = ln.layer_norm_bwd(x, g, mean, rstd, dy)
            want = ln.layer_norm_bwd_reference(x, g, mean, rstd, dy)
            torch.cuda.synchronize()
            at = "16-byte aligned" if all(
                t.data_ptr() % 16 == 0 for t in (x, dy)) else "misaligned"
            for g_, a, w_ in zip(("dx", "dgamma", "dbeta"), got, want):
                checks.close(f"layer_norm_bwd edge {tag} R={r} C={c} ({at})"
                             f" {g_}", a, w_, name)

    # dh's zeros, bit for bit, against the dropped set of the forward
    # kernel (recovered from its output as in phase 2) and the bits
    ones = torch.ones(R, C, device=dev)
    zc = torch.zeros(C, device=dev)
    y, _, _ = ln.fused_residual_ln_fwd(ones, zc, torch.zeros_like(ones),
                                       torch.ones(C, device=dev), zc, key,
                                       0.1, 1e-5, True)
    fwd_dropped = y <= 0
    bits_dropped = ln.mask_bits(key[0], key[1], 0, R, C, device=dev) >= \
        ln.keep_thresh(0.9)
    mismatch = int((dh_zero != fwd_dropped).sum()) + \
        int((dh_zero != bits_dropped).sum())
    print(f"check fused_residual_ln_bwd keep=0.9 dh==0 vs the forward's "
          f"dropped set: {mismatch} of {2 * R * C} bits differ (dropped "
          f"share {float(bits_dropped.float().mean()):.4f}) "
          f"{'ok' if mismatch == 0 else 'FAIL'}", flush=True)
    checks.rows.append({"check": "fused_residual_ln_bwd dh==0 mask bits",
                        "mismatch": mismatch, "ok": mismatch == 0})
    if mismatch:
        checks.failed.append("fused_residual_ln_bwd dropout mask")
    return out


# LayerNorm off BERT's shape, forward and backward: the row kernels'
# scalar path (a C off the 16-byte vector; contiguous views off a
# 16-byte boundary), one row and an odd row count, and the wide kernels
# past C = 8192 up to mxtpu's widest (131072), with more rows than CTAs
# in the backward's grid at 32768; (tag, R, C, offset into the buffer)
LN_EDGES = (("C off the vector", 37, 1030, 0),
            ("row slice", 41, 1031, 1031),
            ("one element in", 64, 1024, 1),
            ("one row", 1, 1024, 0),
            ("odd rows", 1001, 1024, 0),
            ("wide, scalar", 64, 12257, 0),
            ("wide", 300, 32768, 0),
            ("wide", 8, 131072, 0),
            ("wide, one element in", 3, 131072, 1))


def layer_norm_edge_phase(checks):
    """:data:`LN_EDGES` against the plain version in f32 and bf16, the
    forward's y, mean and rstd and the backward's dx, dgamma and dbeta,
    from a generator of their own; the wide kernels' device ms at the
    widest C printed."""
    import torch
    import importlib
    ln = importlib.import_module("mxtpu_torch.kernels.layer_norm")
    dev = torch.device(CARD)
    egen = torch.Generator(device=dev).manual_seed(SEED + 30)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]

        def erandn(*shape):
            return torch.randn(*shape, generator=egen, device=dev)
        for tag, r, c, off in LN_EDGES:
            x, dy = ((erandn(r * c + off) * 2 + 0.5).to(dt)[off:].view(r, c)
                     for _ in range(2))
            g = (1.0 + 0.1 * erandn(c)).to(dt)
            b = (0.1 * erandn(c)).to(dt)
            y, mean, rstd = ln.layer_norm_fwd(x, g, b)
            py, pmean, prstd = ln.layer_norm_reference(x, g, b)
            got = ln.layer_norm_bwd(x, g, mean, rstd, dy)
            want = ln.layer_norm_bwd_reference(x, g, mean, rstd, dy)
            torch.cuda.synchronize()
            at = "16-byte aligned" if all(
                t.data_ptr() % 16 == 0 for t in (x, dy)) else "misaligned"
            what = f"layer_norm edge {tag} R={r} C={c} ({at})"
            checks.close(f"{what} y", y, py, name)
            checks.close(f"{what} mean", mean, pmean, "float32")
            checks.close(f"{what} rstd", rstd, prstd, "float32")
            for g_, a, w_ in zip(("dx", "dgamma", "dbeta"), got, want):
                checks.close(f"{what} {g_}", a, w_, name)
            if c == 131072 and off == 0:
                fwd = device_ms(lambda: ln.layer_norm_fwd(x, g, b))
                bwd = device_ms(lambda: ln.layer_norm_bwd(x, g, mean, rstd,
                                                          dy))
                print(f"time layer_norm wide R{r} C{c} [{name}] (device ms "
                      f"per call): fwd {fwd:.4f} bwd {bwd:.4f}", flush=True)
            del x, dy, y, got, want
    torch.cuda.empty_cache()


# the fused residual LayerNorm off BERT's shape, both directions at
# keep = 0.9: the row kernels on their scalar path (C off the 16-byte
# vector; a view one element into a buffer), each of the forward's row
# instances (R off a multiple of its row groups where it has several),
# its widest on both paths, and the wide kernels past the row kernels
# (the forward's from C = 12289, 4097 on its scalar path, the
# backward's from 4097) up to
# mxtpu's 32768 and past it, with more rows than either direction's CTAs
# at 32768 and a row's keep bits 48 KB (C = 393216) and more; (tag, R,
# C, offset into the buffer)
FRLN_EDGES = (("C off the vector", 37, 1030, 0),
              ("one element in", 64, 1024, 1),
              ("row instance", 37, 200, 0),
              ("row instance", 37, 512, 0),
              ("row instance", 37, 2048, 0),
              ("row instance", 19, 4096, 0),
              ("row instance", 19, 8192, 0),
              ("widest row instance", 300, 12256, 0),
              ("widest scalar row instance", 37, 4095, 0),
              ("wide, scalar", 37, 4097, 0),
              ("wide, scalar", 64, 12257, 0),
              ("wide, scalar", 16, 12289, 0),
              ("wide", 300, 32768, 0),
              ("wide", 8, 131072, 0),
              ("wide, 48 KB of keep bits", 2, 393216, 0),
              ("wide", 2, 400000, 0))
# the wide edges timed
FRLN_TIMED = ((300, 32768), (8, 131072))
# the edge whose dh must be 0 exactly where the forward dropped
FRLN_MASK_EDGE = (300, 32768)
# rows of the fused forward's any-R check: more than a grid of one CTA
# a row can launch (gridDim.x < 2^31); 4 GB a bf16 tensor
FRLN_ANY_R = (1 << 31) + 5
# the fused epilogue's forward timed (device ms a call) by the kernel
# phase (frln_fwd_times takes any tree's layer_norm module, so that a
# parent commit's can be timed on the same card in turns with this
# one): BERT's shape, one served request, the widest row instance of
# each path and the scalar path past it; (tag, R, C, dtype, p: 0 is
# keep = 1, whether the wide kernel is timed there too)
FRLN_FWD_TIMES = (("BERT", 4096, 1024, "float32", 0.0, False),
                  ("BERT", 4096, 1024, "bfloat16", 0.0, False),
                  ("BERT", 4096, 1024, "float32", 0.1, False),
                  ("BERT", 4096, 1024, "bfloat16", 0.1, False),
                  ("one served request", 128, 1024, "float32", 0.0, False),
                  ("widest row instance", 300, 12256, "float32", 0.1, True),
                  ("widest row instance", 300, 12256, "bfloat16", 0.1,
                   True),
                  ("widest scalar row instance", 300, 4095, "float32", 0.1,
                   True),
                  ("widest scalar row instance", 300, 4095, "bfloat16",
                   0.1, True),
                  ("scalar, wide", 300, 8193, "float32", 0.1, False),
                  ("scalar, wide", 300, 8193, "bfloat16", 0.1, False))


def frln_fwd_times(ln, wide=False):
    """Device ms a call of ``ln.fused_residual_ln_fwd`` (the public
    wrapper every tree of the port has) at :data:`FRLN_FWD_TIMES`, from
    a generator of their own, printed; at keep = 1 also the composed
    eager ``F.layer_norm(res + h + bias)``: two calls, not a library
    call, and no dropout.  With ``wide``, where a row asks for it, also
    the wide kernel on the same inputs (the wrapper with its plan made
    the wide kernel's for the call), which shows whether the row
    instance there beats the wide kernel that would take its C."""
    import torch
    import torch.nn.functional as F
    dev = torch.device(CARD)
    tgen = torch.Generator(device=dev).manual_seed(SEED + 41)
    key = (0x2545F491, 0x9E3779B9)
    out = {}
    for tag, r, c, name, p, vs_wide in FRLN_FWD_TIMES:
        dt = getattr(torch, name)
        h, res = (torch.randn(r, c, generator=tgen, device=dev).to(dt)
                  for _ in range(2))
        bias, g, b = (torch.randn(c, generator=tgen, device=dev).to(dt)
                      for _ in range(3))
        args = (h, bias, res, g, b, key, p, 1e-5, p > 0)
        row = {"ms": device_ms(lambda: ln.fused_residual_ln_fwd(*args))}
        what = f"{tag} R{r} C{c} keep={1 - p:g} [{name}]"
        extra = ""
        if p == 0:
            row["composed_ms"] = device_ms(
                lambda: F.layer_norm(res + h + bias, (c,), g, b))
            extra = f" composed eager F.layer_norm(res + h + bias) " \
                f"{row['composed_ms']:.4f} (two calls, not a library call)"
        if wide and vs_wide:
            plan_of = ln._frln_fwd_plan
            ln._frln_fwd_plan = lambda R, C, isz, al, sms: ln.LnPlan(
                ln._vec(C, isz, al), 0, 0,
                min(R, ln.FRLN_FWD_WIDE_CTAS_PER_SM * sms))
            try:
                row["wide_ms"] = device_ms(
                    lambda: ln.fused_residual_ln_fwd(*args))
            finally:
                ln._frln_fwd_plan = plan_of
            extra += f" wide kernel {row['wide_ms']:.4f}"
        print(f"time fused_residual_ln_fwd {what} (device ms per call): "
              f"kernel {row['ms']:.4f}{extra}", flush=True)
        out[what] = row
    return out


def fused_ln_edge_phase(checks):
    """:data:`FRLN_EDGES` in f32 and bf16, from a generator of their
    own: the raw forward's y, mean and rstd against the plain version,
    and the public ``fused_residual_layer_norm`` forward and backward
    (autograd) against the plain forward and backward; at
    ``FRLN_MASK_EDGE`` in f32, dh's zeros against the dropped set of the
    forward (recovered from its output) and the bits; the wide kernels'
    device ms at ``FRLN_TIMED`` printed."""
    import torch
    import importlib
    ln = importlib.import_module("mxtpu_torch.kernels.layer_norm")
    dev = torch.device(CARD)
    egen = torch.Generator(device=dev).manual_seed(SEED + 31)
    key = (0x2545F491, 0x9E3779B9)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]

        def erandn(*shape):
            return torch.randn(*shape, generator=egen, device=dev)
        for tag, r, c, off in FRLN_EDGES:
            h, res, dy = (erandn(r * c + off).to(dt)[off:].view(r, c)
                          for _ in range(3))
            bias = (0.1 * erandn(c)).to(dt)
            g = (1.0 + 0.1 * erandn(c)).to(dt)
            b = (0.1 * erandn(c)).to(dt)
            y, mean, rstd = ln.fused_residual_ln_fwd(h, bias, res, g, b, key,
                                                     0.1)
            py, pmean, prstd = ln.fused_residual_ln_reference(
                h, bias, res, g, b, key, 0.1)
            want = ln.fused_residual_ln_bwd_reference(
                h, bias, res, g, key, pmean, prstd, dy, 0.9)
            ins = [t.detach().clone().requires_grad_(True)
                   for t in (h, bias, res, g, b)]
            ya = ln.fused_residual_layer_norm(*ins, key, p=0.1)
            ya.backward(dy)
            got = [t.grad for t in (ins[0], ins[1], ins[2], ins[3], ins[4])]
            torch.cuda.synchronize()
            at = "16-byte aligned" if all(
                t.data_ptr() % 16 == 0 for t in (h, res, dy)) else \
                "misaligned"
            what = f"fused_residual_ln edge {tag} R={r} C={c} keep=0.9 " \
                f"({at})"
            checks.close(f"{what} y", y, py, name)
            checks.close(f"{what} mean", mean, pmean, "float32")
            checks.close(f"{what} rstd", rstd, prstd, "float32")
            checks.close(f"{what} public y", ya.detach(), py, name)
            # autograd's order: dh, dbias, dres, dgamma, dbeta
            for g_, a, w_ in zip(("dh", "dbias", "dres", "dgamma",
                                  "dbeta"), got, want):
                checks.close(f"{what} {g_}", a, w_, name)
            if not all(torch.isfinite(t).all() for t in (y, *got)):
                checks.failed.append(f"{what} [{name}]: not finite")
            if (r, c) == FRLN_MASK_EDGE and dt == torch.float32:
                ones = torch.ones(r, c, device=dev)
                zc = torch.zeros(c, device=dev)
                yo, _, _ = ln.fused_residual_ln_fwd(
                    ones, zc, torch.zeros_like(ones),
                    torch.ones(c, device=dev), zc, key, 0.1, 1e-5, True)
                bits_dropped = ln.mask_bits(key[0], key[1], 0, r, c,
                                            device=dev) >= \
                    ln.keep_thresh(0.9)
                dh_zero = got[0] == 0
                mismatch = int((dh_zero != (yo <= 0)).sum()) + \
                    int((dh_zero != bits_dropped).sum())
                print(f"check {what} dh==0 vs the forward's dropped set: "
                      f"{mismatch} of {2 * r * c} bits differ (dropped "
                      f"share {float(bits_dropped.float().mean()):.4f}) "
                      f"{'ok' if mismatch == 0 else 'FAIL'}", flush=True)
                checks.rows.append({"check": f"{what} dh==0 mask bits",
                                    "mismatch": mismatch,
                                    "ok": mismatch == 0})
                if mismatch:
                    checks.failed.append(f"{what}: dropout mask")
            if (r, c) in FRLN_TIMED:
                fwd = device_ms(lambda: ln.fused_residual_ln_fwd(
                    h, bias, res, g, b, key, 0.1))
                bwd = device_ms(lambda: ln.fused_residual_ln_bwd(
                    h, bias, res, g, key, mean, rstd, dy, 0.9))
                print(f"time fused_residual_ln wide R{r} C{c} keep=0.9 "
                      f"[{name}] (device ms per call): fwd {fwd:.4f} bwd "
                      f"{bwd:.4f}", flush=True)
            del h, res, dy, y, ya, got, want, ins
    torch.cuda.empty_cache()

    # any R (FRLN_ANY_R rows, at C = 1 and keep = 1 in bf16).  A row of
    # one element has u == mean and var == 0, so y is beta and mean is
    # res + (h + bias), both exactly, and rstd is 1 / sqrt(eps)
    r = FRLN_ANY_R
    h, res = (torch.randn(r, 1, generator=egen, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    bias, g, b = (torch.randn(1, generator=egen, device=dev,
                              dtype=torch.bfloat16) for _ in range(3))
    y, mean, rstd = ln.fused_residual_ln_fwd(h, bias, res, g, b, None, 0.0,
                                             1e-5, False)
    torch.cuda.synchronize()
    want_rs = 1.0 / torch.tensor(1e-5, device=dev).sqrt()
    bad, chunk = 0, 1 << 28
    for i in range(0, r, chunk):
        j = min(i + chunk, r)
        u = res[i:j, 0].float() + (h[i:j, 0].float() + bias.float())
        bad += int((y[i:j, 0] != b).sum()) + int((mean[i:j] != u).sum()) \
            + int(((rstd[i:j] - want_rs).abs() > 1e-6 * want_rs).sum())
    what = f"fused_residual_ln R={r} C=1 keep=1 (bf16)"
    print(f"check {what}: {bad} of {3 * r} values off y == beta, mean == "
          f"u, rstd == 1/sqrt(eps) {'ok' if bad == 0 else 'FAIL'}",
          flush=True)
    checks.rows.append({"check": what, "bad": bad, "ok": bad == 0})
    if bad:
        checks.failed.append(f"{what}: {bad} values off")
    del h, res, y, mean, rstd
    torch.cuda.empty_cache()


def refusal_phase(checks):
    """The raw forward wrappers keep no graph: on the card they must
    refuse inputs that require grad rather than cut autograd."""
    import torch
    import importlib
    from mxtpu_torch import MXNetError
    fa = importlib.import_module("mxtpu_torch.kernels.flash_attention")
    ln = importlib.import_module("mxtpu_torch.kernels.layer_norm")
    dev = torch.device(CARD)
    q = torch.randn(2, 8, 16, device=dev, requires_grad=True)
    x = torch.randn(4, 16, device=dev, requires_grad=True)
    g = torch.ones(16, device=dev)
    bn = importlib.import_module("mxtpu_torch.kernels.batch_norm")
    calls = {"flash_forward": lambda: fa.flash_forward(q, q, q, False, 0.25),
             "layer_norm_fwd": lambda: ln.layer_norm_fwd(x, g, g),
             "fused_residual_ln_fwd": lambda: ln.fused_residual_ln_fwd(
                 x, g, x, g, g, (1, 2), 0.1),
             "bn_fwd": lambda: bn.bn_fwd(q, g[:8], g[:8]),
             "bn_bwd": lambda: bn.bn_bwd(q, None, q, g[:8], g[:8], g[:8],
                                         g[:8]),
             "bn_fwd_cm": lambda: bn.bn_fwd_cm(x, g, g),
             "bn_bwd_cm": lambda: bn.bn_bwd_cm(x, None, x, g, g, g, g)}
    for name, call in calls.items():
        try:
            call()
        except MXNetError as e:
            ok = "require grad" in str(e)
        else:
            ok = False
        print(f"check {name} refuses inputs that require grad: "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        checks.rows.append({"check": f"{name} refuses grad", "ok": ok})
        if not ok:
            checks.failed.append(f"{name} did not refuse grad inputs")

    # the conv kernel outside its bounds: raises before any launch
    conv = importlib.import_module("mxtpu_torch.kernels.conv")
    xc = torch.randn(2, 5, 5, 16, device=dev)
    wc = torch.randn(3, 3, 16, 16, device=dev)
    launched = conv.CONV_LAUNCHES
    calls = {"inputs that require grad": (
                 lambda: conv.conv_nhwc(xc.requires_grad_(True), wc),
                 "require grad"),
             "float16": (lambda: conv.conv_nhwc(xc.detach().half(),
                                                wc.half()),
                         "float32 or bfloat16"),
             "a non-contiguous x": (
                 lambda: conv.conv_nhwc(xc.detach().transpose(1, 2), wc),
                 "contiguous")}
    for what, (call, match) in calls.items():
        try:
            call()
        except MXNetError as e:
            ok = match in str(e)
        else:
            ok = False
        print(f"check conv_nhwc refuses {what}: {'ok' if ok else 'FAIL'}",
              flush=True)
        checks.rows.append({"check": f"conv_nhwc refuses {what}",
                            "ok": ok})
        if not ok:
            checks.failed.append(f"conv_nhwc did not refuse {what}")
    if conv.CONV_LAUNCHES != launched:
        checks.failed.append("conv_nhwc launched on a refused input")
    # C = 12 and O = 4, off the kernel's multiples of 8: the wrapper
    # runs it on copies zero-padded to 16 and 8, as pallas_conv takes
    # any C and O
    xs = xc.detach()[..., :12].contiguous()
    ws = wc[:, :, :12, :4].contiguous()
    for dt, name in ((torch.float32, "float32"),
                     (torch.bfloat16, "bfloat16")):
        y = conv.conv_nhwc(xs.to(dt), ws.to(dt))
        p = conv.conv_nhwc_reference(xs.to(dt), ws.to(dt))
        torch.cuda.synchronize()
        checks.close("conv_nhwc C=12 O=4 (padded copies)", y, p, name)
        if y.shape != p.shape:
            checks.failed.append(f"conv_nhwc C=12 O=4 [{name}]: shape "
                                 f"{tuple(y.shape)}")
    if conv.CONV_LAUNCHES != launched + 2:
        checks.failed.append("conv_nhwc C=12 O=4 did not launch the "
                             "kernel")


# ----------------------------------------------------------------------
# BatchNorm kernels against their plain versions
# ----------------------------------------------------------------------

# (C, S, act, add) of ResNet-50's BatchNorms at N = 256: the stem, a
# layer1 bn_out, a downsample and a layer4 bn_out (these four timed),
# then the shapes that only probe_bn_fusion runs: its 14^2 x 1024
# stage and the bottlenecks' inner widths of its conv+BN+ReLU chain,
# and two of the zoo's: ResNet V2's input BatchNorm (C = 3 at 224^2)
# and a basic block's closing one at stage 1 (the add and ReLU)
BN_SHAPES = {"stem": (64, 12544, "relu", False),
             "layer1_out": (256, 3136, "relu", True),
             "downsample": (512, 784, "none", False),
             "layer4_out": (2048, 49, "relu", True),
             "s3_14": (1024, 196, "relu", False),
             "s1_inner": (64, 3136, "relu", False),
             "s2_inner": (128, 784, "relu", False),
             "s3_inner": (256, 196, "relu", False),
             "s4_inner": (512, 49, "relu", False),
             "v2_input": (3, 50176, "none", False),
             "basic_s1_out": (64, 3136, "relu", True)}
BN_TIMED = ("stem", "layer1_out", "downsample", "layer4_out")
BN_N = 256
# the shape whose times stand in the kernels line
BN_LINE_SHAPE = "layer1_out"
# edge shapes (N, C, S): odd S, C under and off the 32-lane tile, and
# N*S = 1
BN_EDGES = ((5, 3, 49), (7, 100, 196), (3, 37, 1), (1, 4, 1))
# channels-major edges (N, C, S): runs off 16-byte boundaries at N = 3,
# at the widths ResNet-50 gives S = 49 and 196
BN_MAJOR_EDGES = ((3, 2048, 49), (3, 512, 49), (3, 1024, 196),
                  (3, 256, 196))
# (C, S, mean, std) of train_cifar10's resnet20 BatchNorms at N = 128,
# act none, f32: its three stages; stage 0's input has conv0's
# mean^2 ~13x its variance
CIFAR_BN_N = 128
CIFAR_BN_SHAPES = ((16, 1024, 2.0, 0.55), (32, 256, 0.5, 2.0),
                   (64, 64, 0.5, 2.0))
# elementwise f32 operations per element (stats, then the apply pass)
BN_OPS = {"fwd": 7, "bwd": 14}


def bn_times(x, r, dy, g, b, act, cm, shape, rotate=1):
    """#8/#9 (or #10/#11 with ``cm``) timed at one shape (N, C, S) on
    the given view: the kernel, its plain version and cuDNN's BatchNorm
    with the add and ReLU (4-D, in the view's memory layout), forward
    and backward, beside the byte bound; keyed by kernel name.  With
    ``rotate`` > 1 every call takes the next of that many copies of the
    inputs, so a call finds none of its inputs left in L2 by the one
    before (set it where one copy's bytes fit in L2), and the kernel's
    ms is the sum of its CUDA kernels' (:func:`timed`'s ``names``)."""
    import itertools
    import torch
    import torch.nn.functional as F
    import importlib
    bn = importlib.import_module("mxtpu_torch.kernels.batch_norm")
    n, C, S = shape
    add = r is not None
    fwd = bn.bn_fwd_cm if cm else bn.bn_fwd
    bwd = bn.bn_bwd_cm if cm else bn.bn_bwd
    _, mean, var = fwd(x, g, b, r, 1e-5, act)
    rstd = torch.rsqrt(var + 1e-5)

    def lib(x_, g_, b_, r_=None):
        y_ = F.batch_norm(x_, None, None, g_, b_, True, 0.1, 1e-5)
        if r_ is not None:
            y_ = y_ + r_
        return torch.relu(y_) if act == "relu" else y_
    sets = []
    for k in range(max(1, rotate)):
        xk, rk, dyk = (None if t is None else (t if k == 0 else t.clone())
                       for t in (x, r, dy))
        x4, r4, dy4 = (None if t is None else
                       (t.reshape(n, S, 1, C).permute(0, 3, 1, 2) if cm
                        else t.reshape(n, C, S, 1)) for t in (xk, rk, dyk))
        lib_in = [t.detach().requires_grad_(True)
                  for t in (x4, g, b) + ((r4,) if add else ())]
        sets.append((xk, rk, dyk, dy4, lib_in, lib(*lib_in)))
    turn = itertools.cycle(sets)
    numel, el = n * C * S, x.element_size()
    out = {}

    def fwd_k():
        xk, rk = next(turn)[:2]
        return fwd(xk, g, b, rk, 1e-5, act)

    def fwd_p():
        xk, rk = next(turn)[:2]
        return bn.bn_act_reference(xk, g, b, 1e-5, act, rk)

    def fwd_l():
        return lib(*next(turn)[4])

    def bwd_k():
        xk, rk, dyk = next(turn)[:3]
        return bwd(xk, rk, dyk, g, b, mean, rstd, act)

    def bwd_p():
        xk, rk, dyk = next(turn)[:3]
        return bn.bn_bwd_reference(xk, rk, dyk, g, b, mean, rstd, act)

    def bwd_l():
        _, _, _, dy4, lib_in, ly = next(turn)
        return torch.autograd.grad(ly, lib_in, dy4, retain_graph=True)
    for d, kern, plain, library, nbig in (
            ("fwd", fwd_k, fwd_p, fwd_l, 2 + int(add)),  # x (r) read, y
            ("bwd", bwd_k, bwd_p, bwd_l,
             3 + 2 * int(add))):                       # x dy (r), dx (dr)
        name = f"batch_norm_{d}{'_cm' if cm else ''}"
        t = timed(kern, plain, library,
                  names=KERNEL_NAMES[name] if rotate > 1 else None)
        b_ms, b_by = bound(nbig * numel * el + 4 * C * 4, BN_OPS[d] * numel,
                           "float32")
        out[name] = {**t, "bound_ms": b_ms, "bound_by": b_by}
    return out


def bn_phase(checks, gen):
    """The four BatchNorm kernels against their plain versions on the
    card, forward (y, mean, var) and backward (dx, dr, dgamma, dbeta),
    in f32 and bf16: at ResNet-50's shapes (N = 256; ``BN_TIMED``
    timed) in both views, at edge shapes, at resnet20's (N = 128, f32,
    the symbolic path's), on a constant channel; the stem's statistics
    against an f64 plain version; a repeat bit-equal.  Returns the
    timings of ``BN_LINE_SHAPE`` keyed like the other kernels', and
    prints every timed shape's."""
    import torch
    import importlib
    bn = importlib.import_module("mxtpu_torch.kernels.batch_norm")
    dev = torch.device(CARD)
    out = {}

    def randn(*shape, dtype=torch.float32, mean=0.0, std=1.0):
        return (mean + std * torch.randn(*shape, generator=gen,
                                         device=dev)).to(dtype)

    def run(x, r, dy, g, b, act, cm, tag, name):
        """Kernel and plain version, forward then backward from the
        kernel's statistics; returns the kernel's outputs."""
        fwd = bn.bn_fwd_cm if cm else bn.bn_fwd
        bwd = bn.bn_bwd_cm if cm else bn.bn_bwd
        y, mean, var = fwd(x, g, b, r, 1e-5, act)
        py, pmean, pvar = bn.bn_act_reference(x, g, b, 1e-5, act, r)
        rstd = torch.rsqrt(var + 1e-5)
        got = bwd(x, r, dy, g, b, mean, rstd, act)
        want = bn.bn_bwd_reference(x, r, dy, g, b, mean, rstd, act)
        torch.cuda.synchronize()
        errs = [checks.close(f"{tag} y", y, py, name),
                checks.close(f"{tag} mean", mean, pmean, "float32"),
                checks.close(f"{tag} var", var, pvar, "float32")]
        for gname, a, w in zip(("dx", "dr", "dgamma", "dbeta"), got, want):
            if w is not None:
                # dgamma/dbeta: f32 sums over N*S elements of size ~1,
                # held relative to their rms
                floor = 1.0 if gname in ("dx", "dr") else \
                    max(1.0, float(w.double().pow(2).mean().sqrt()))
                errs.append(checks.close(
                    f"{tag} {gname}", a, w,
                    name if gname in ("dx", "dr") else "float32", floor))
        if not all(torch.isfinite(t).all() for t in (y, mean, var, *got)
                   if t is not None):
            checks.failed.append(f"{tag} [{name}]: not finite")
        return (y, mean, var, *got), max(errs)

    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for key, (C, S, act, add) in BN_SHAPES.items():
            x = randn(BN_N, C, S, dtype=dt, mean=0.5, std=2.0)
            r = randn(BN_N, C, S, dtype=dt) if add else None
            dy = randn(BN_N, C, S, dtype=dt)
            g = randn(C, dtype=dt, mean=1.0, std=0.2)
            b = randn(C, dtype=dt, std=0.1)
            for cm in (False, True):
                if cm:
                    # the same data channels-minor: (N*S, C)
                    xv, rv, dyv = (None if t is None else
                                   t.transpose(1, 2).contiguous()
                                   .reshape(BN_N * S, C)
                                   for t in (x, r, dy))
                else:
                    xv, rv, dyv = x, r, dy
                tag = f"bn {'cm' if cm else 'major'} {key} N{BN_N} C{C} " \
                    f"S{S} {act}{' add' if add else ''}"
                outs, err = run(xv, rv, dyv, g, b, act, cm, tag, name)
                if key == "stem" and name == "float32" and not cm:
                    # the stem's statistics against f64 sums
                    xd = xv.double()
                    m64 = xd.mean(dim=(0, 2))
                    v64 = ((xd * xd).mean(dim=(0, 2)) - m64 * m64)
                    checks.close(f"{tag} mean vs f64", outs[1], m64,
                                 "float32")
                    checks.close(f"{tag} var vs f64", outs[2], v64,
                                 "float32")
                    del xd
                if key == "layer1_out":
                    # every sum has a fixed order: a rerun is bit-equal
                    again, _ = run(xv, rv, dyv, g, b, act, cm,
                                   tag + " rerun", name)
                    same = all(torch.equal(a, b_) for a, b_ in
                               zip(outs, again) if a is not None)
                    print(f"check {tag} [{name}] repeats bit for bit: "
                          f"{'ok' if same else 'FAIL'}", flush=True)
                    checks.rows.append({"check": f"{tag} [{name}] repeat",
                                        "ok": same})
                    if not same:
                        checks.failed.append(f"{tag} [{name}] repeat")
                if key not in BN_TIMED:
                    del outs
                    continue
                for kname, t in bn_times(xv, rv, dyv, g, b, act, cm,
                                         (BN_N, C, S)).items():
                    print(f"time {kname} [{name}] {key} C{C} S{S} "
                          f"(device ms per call): kernel_ms={t['ms']:.4f} "
                          f"plain_ms={t['plain_ms']:.4f} library_ms="
                          f"{t['library_ms']:.4f} bound_ms="
                          f"{t['bound_ms']:.4f} ({t['bound_by']}); "
                          f"kernel wall_ms={t['wall_ms']:.4f}", flush=True)
                    if key == BN_LINE_SHAPE:
                        out[(kname, name)] = {"max_abs_err": err, **t,
                                              "shape": [BN_N, C, S]}
                fwd = bn.bn_fwd_cm if cm else bn.bn_fwd
                bwd = bn.bn_bwd_cm if cm else bn.bn_bwd
                mean, rstd = outs[1], torch.rsqrt(outs[2] + 1e-5)
                for d, call in (
                        ("fwd", lambda: fwd(xv, g, b, rv, 1e-5, act)),
                        ("bwd", lambda: bwd(xv, rv, dyv, g, b, mean, rstd,
                                            act))):
                    print(f"kernels of batch_norm_{d}{'_cm' if cm else ''} "
                          f"[{name}] {key} C{C} S{S} (device ms per call): "
                          + "; ".join(f"{kn} {ms:.4f}"
                                      for kn, ms in kernels_of(call)),
                          flush=True)
                del outs
            del x, r, dy
            torch.cuda.empty_cache()

        # edge shapes, and a constant channel (E[x^2] - E[x]^2 may round
        # below 0 before the clamp: var must be 0 or a rounding above)
        for (n, C, S) in BN_EDGES:
            for act, add in (("relu", True), ("none", False)):
                x = randn(n, C, S, dtype=dt, mean=0.5, std=2.0)
                if n * S > 1:
                    x[:, 0] = 0.1
                r = randn(n, C, S, dtype=dt) if add else None
                dy = randn(n, C, S, dtype=dt)
                g = randn(C, dtype=dt, mean=1.0, std=0.2)
                b = randn(C, dtype=dt, std=0.1)
                for cm in (False, True):
                    xv, rv, dyv = (None if t is None else
                                   (t.transpose(1, 2).contiguous()
                                    .reshape(n * S, C) if cm else t)
                                   for t in (x, r, dy))
                    tag = f"bn edge {'cm' if cm else 'major'} N{n} C{C} " \
                        f"S{S} {act}{' add' if add else ''}"
                    outs, _ = run(xv, rv, dyv, g, b, act, cm, tag, name)
                    var = outs[2]
                    bad = bool((var < 0).any()) or \
                        (n * S > 1 and float(var[0]) > 1e-6)
                    if bad:
                        checks.failed.append(f"{tag} [{name}]: constant "
                                             f"channel var {float(var[0])}")

        # the channels-minor backward's scalar path: contiguous views one
        # element off a 16-byte boundary, at layer1_out's C with the add
        # and ReLU (N = 1); inputs from a generator of their own
        mgen = torch.Generator(device=dev).manual_seed(SEED + 4)
        R1, C1 = 3136, 256
        x, r, dy = ((torch.randn(R1 * C1 + 1, generator=mgen, device=dev)
                     * sd + mu).to(dt)[1:].view(R1, C1)
                    for mu, sd in ((0.5, 2.0), (0.0, 1.0), (0.0, 1.0)))
        g = (1.0 + 0.2 * torch.randn(C1, generator=mgen, device=dev)).to(dt)
        b = (0.1 * torch.randn(C1, generator=mgen, device=dev)).to(dt)
        run(x, r, dy, g, b, "relu", True, f"bn edge cm misaligned R{R1} "
            f"C{C1} relu add", name)

        # the channels-major kernels: a view one element off a 16-byte
        # boundary at layer1_out's C and S (N = 1, ReLU + add: the walk
        # over single elements), and runs off word boundaries (S = 49,
        # and 196 in bf16: peeled heads and tails) at N = 3 and at
        # ResNet-50's widths there; inputs from a generator of their own
        jgen = torch.Generator(device=dev).manual_seed(SEED + 5)

        def jrandn(numel, mu=0.0, sd=1.0):
            return (torch.randn(numel, generator=jgen, device=dev) * sd
                    + mu).to(dt)
        C1, S1 = BN_SHAPES["layer1_out"][:2]
        x, r, dy = (jrandn(C1 * S1 + 1, mu, sd)[1:].view(1, C1, S1)
                    for mu, sd in ((0.5, 2.0), (0.0, 1.0), (0.0, 1.0)))
        g, b = jrandn(C1, 1.0, 0.2), jrandn(C1, 0.0, 0.1)
        run(x, r, dy, g, b, "relu", False, f"bn edge major misaligned N1 "
            f"C{C1} S{S1} relu add", name)
        for (n, C, S) in BN_MAJOR_EDGES:
            for act, add in (("relu", True), ("none", False)):
                x = jrandn(n * C * S, 0.5, 2.0).view(n, C, S)
                r = jrandn(n * C * S).view(n, C, S) if add else None
                dy = jrandn(n * C * S).view(n, C, S)
                g, b = jrandn(C, 1.0, 0.2), jrandn(C, 0.0, 0.1)
                run(x, r, dy, g, b, act, False, f"bn edge major N{n} C{C} "
                    f"S{S} {act}{' add' if add else ''}", name)

    # the symbolic path's shapes (resnet20 at the recipe's batch)
    for (C, S, mean, std) in CIFAR_BN_SHAPES:
        x = randn(CIFAR_BN_N, C, S, mean=mean, std=std)
        dy = randn(CIFAR_BN_N, C, S)
        g = randn(C, mean=1.0, std=0.2)
        b = randn(C, std=0.1)
        run(x, None, dy, g, b, "none", False,
            f"bn major resnet20 N{CIFAR_BN_N} C{C} S{S} none", "float32")
    return out


# ----------------------------------------------------------------------
# the NHWC conv kernel (#13) against its plain version
# ----------------------------------------------------------------------

# (H, C) at N = 256, 3x3, C = O: the conv probe's three shapes, then
# microbench.bench_conv's other two
CONV_N = 256
CONV_SHAPES = ((14, 256), (28, 128), (7, 512), (56, 64), (14, 512))
# the shape whose times stand in the kernels line
CONV_LINE_SHAPE = (14, 256)
# edge shapes (N, H, W, C, O, KH, KW): N = 1; H = W = 5 (no tile's
# multiple); C != O, C off the 32-channel chunk, O off the 128-wide
# tile; 1x1, 2x2 (the reference's even-kernel padding) and 5x5 kernels;
# H != W; a 257x1 kernel, past the im2col loads' 255: the scalar f32
# kernel's only shapes (bf16 refuses them)
CONV_EDGES = ((1, 14, 14, 256, 256, 3, 3), (2, 5, 5, 16, 32, 3, 3),
              (3, 7, 7, 24, 40, 1, 1), (2, 6, 6, 32, 16, 2, 2),
              (2, 9, 9, 16, 8, 5, 5), (4, 5, 5, 40, 72, 3, 3),
              (2, 5, 11, 8, 136, 3, 3), (1, 3, 3, 8, 8, 257, 1))


def conv_phase(checks, gen):
    """``conv_nhwc`` against ``conv_nhwc_reference`` on the card in f32
    and bf16, at the N = 256 shapes (timed beside the bound, the plain
    version and cuDNN, TF32 off, with the names of the kernels cuDNN
    launches) and at ``CONV_EDGES``; between them they take each of
    the bf16 kernel's three tiles (O <= 64, O % 256 == 0, other O).
    Returns the timings of ``CONV_LINE_SHAPE`` keyed like the other
    kernels'."""
    import torch
    import importlib
    from mxtpu_torch import MXNetError
    from mxtpu_torch.tools.microbench import cudnn_conv
    conv = importlib.import_module("mxtpu_torch.kernels.conv")
    dev = torch.device(CARD)
    out = {}

    # the kernel wider than the im2col loads take draws from its own
    # generator, so the other shapes' inputs stay as they were without it
    wide_gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def inputs(N, H, W, C, O, KH, KW, dt):
        g = wide_gen if max(KH, KW) > conv.MAX_KERNEL else gen
        x = torch.randn(N, H, W, C, generator=g, device=dev).to(dt)
        w = (torch.randn(KH, KW, C, O, generator=g, device=dev) /
             (KH * C ** 0.5)).to(dt)
        return x, w

    def check(x, w, tag, name):
        y = conv.conv_nhwc(x, w)
        p = conv.conv_nhwc_reference(x, w)
        torch.cuda.synchronize()
        err = checks.close(tag, y, p, name)
        if y.shape != p.shape or not bool(torch.isfinite(y).all()):
            checks.failed.append(f"{tag} [{name}]: shape {tuple(y.shape)} "
                                 f"or not finite")
        return y, err

    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        el = torch.tensor([], dtype=dt).element_size()
        for (H, C) in CONV_SHAPES:
            x, w = inputs(CONV_N, H, H, C, C, 3, 3, dt)
            tag = f"conv_nhwc N{CONV_N} {H}x{H} C{C} O{C} 3x3"
            y, err = check(x, w, tag, name)
            lib = cudnn_conv(w)
            t = timed(lambda: conv.conv_nhwc(x, w),
                      lambda: conv.conv_nhwc_reference(x, w),
                      lambda: lib(x))
            # which algorithm cuDNN took: a Winograd or FFT kernel does
            # fewer multiplies than the direct conv the bound counts
            lib_kernels = kernels_of(lambda: lib(x))
            print(f"cuDNN kernels [{name}] N{CONV_N} {H}x{H} C{C} (device "
                  f"ms per call): " + "; ".join(f"{k} {ms:.4f}"
                                                for k, ms in lib_kernels),
                  flush=True)
            nbytes = (x.numel() + w.numel() + y.numel()) * el
            ops = 2 * CONV_N * H * H * C * C * 9
            if dt == torch.float32:
                bounds = f32_bounds(nbytes, ops)
                both = (f" bound_fma_ms={bounds['bound_fma_ms']:.4f} "
                        f"bound_split_ms={bounds['bound_split_ms']:.4f}")
            else:
                b_ms, b_by = bound(nbytes, ops, name)
                bounds, both = {"bound_ms": b_ms, "bound_by": b_by}, ""
            print(f"time conv_nhwc [{name}] N{CONV_N} {H}x{H} C{C} (device "
                  f"ms per call): kernel_ms={t['ms']:.4f} plain_ms="
                  f"{t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
                  f"bound_ms={bounds['bound_ms']:.4f} "
                  f"({bounds['bound_by']}){both}; kernel "
                  f"{ops / t['ms'] / 1e9:.1f} TFLOP/s; kernel wall_ms="
                  f"{t['wall_ms']:.4f}", flush=True)
            if (H, C) == CONV_LINE_SHAPE:
                out[("conv_nhwc", name)] = {"max_abs_err": err, **t,
                                            **bounds,
                                            "shape": [CONV_N, H, H, C, C],
                                            "library_kernels": lib_kernels}
            del x, w, y, lib
        for (N, H, W, C, O, KH, KW) in CONV_EDGES:
            x, w = inputs(N, H, W, C, O, KH, KW, dt)
            tag = f"conv_nhwc edge N{N} {H}x{W} C{C} O{O} {KH}x{KW}"
            if dt == torch.bfloat16 and max(KH, KW) > conv.MAX_KERNEL:
                try:
                    conv.conv_nhwc(x, w)
                    checks.failed.append(f"{tag} [{name}]: not refused")
                except MXNetError:
                    print(f"check {tag} [{name}]: refused ok", flush=True)
                continue
            check(x, w, tag, name)
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# the port's chained-measurement tools
# ----------------------------------------------------------------------

# bench_flash's chained steps at T = 4096 (the tool's default is 8):
# each step is 4 fused passes and the plain attention's take ~20 GB
FLASH_LONG_N = 2
# kernels each tool's run must launch
TOOL_KERNELS = {"probe_conv_strategies": ("conv_nhwc",),
                "bench_flash": ("flash_attention_fwd",
                                "flash_attention_bwd_dq",
                                "flash_attention_bwd_dkv"),
                "probe_bn_fusion": ("batch_norm_fwd", "batch_norm_bwd")}


def failed_rows(rows):
    """The rows (or cells of a row) a tool printed as FAILED."""
    bad = []
    for r in rows if isinstance(rows, list) else [rows]:
        if not isinstance(r, dict):
            continue
        if r.get("status") == "FAILED":
            bad.append(r)
        bad += [c for c in r.values()
                if isinstance(c, dict) and c.get("status") == "FAILED"]
    return bad


def tools_phase(checks):
    """Each tool's ``main`` on the card, its table printed: microbench
    (matmul and conv), the conv strategy probe (cuDNN, shifted GEMM,
    kernel #13), bench_flash (T = 512 and 2048, then 4096 with
    ``FLASH_LONG_N`` steps) and probe_bn_fusion.  Launch counts are set
    to 0 before each run and read after it; an exception or a FAILED
    row fails the run.  Returns the counts and the rows by run."""
    import traceback
    import torch
    from mxtpu_torch import kernels
    from mxtpu_torch.tools import (bench_flash, microbench,
                                   probe_bn_fusion, probe_conv_strategies)
    runs = (("microbench", microbench, ["all"]),
            ("probe_conv_strategies", probe_conv_strategies, []),
            ("bench_flash", bench_flash, ["512", "2048"]),
            ("bench_flash", bench_flash, ["4096", "--n",
                                          str(FLASH_LONG_N)]),
            ("probe_bn_fusion", probe_bn_fusion, []))
    counts, tables = {}, {}
    for name, tool, argv in runs:
        key = " ".join([name, *argv])
        print(f"== tool {key} ==", flush=True)
        if name == "bench_flash" and "--n" in argv:
            print(f"(T=4096 with n={FLASH_LONG_N} chained steps, not the "
                  f"tool's 8, to keep this script's time)", flush=True)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            rows = tool.main(argv)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 — recorded, fails the run
            traceback.print_exc()
            checks.failed.append(f"tool {key}: {type(e).__name__}: {e}")
            continue
        finally:
            sys.stdout.flush()
            torch.cuda.empty_cache()
        c = kernels.launch_counts()
        counts[key], tables[key] = c, rows
        print(f"tool {key}: {time.perf_counter() - t0:.1f} s; launches "
              f"{ {k: v for k, v in c.items() if v} }", flush=True)
        for r in failed_rows(rows):
            checks.failed.append(f"tool {key}: FAILED row {r}")
        for k in TOOL_KERNELS.get(name, ()):
            if c[k] == 0:
                checks.failed.append(f"tool {key}: kernel {k} never "
                                     f"launched")
    return counts, tables


# ----------------------------------------------------------------------
# phases 4 and 5: training
# ----------------------------------------------------------------------

def mlm_loss(pred, y):
    """``bench_bert``'s loss: softmax cross entropy over the vocabulary
    at every position."""
    from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    return SoftmaxCrossEntropyLoss()(pred.reshape(-1, VOCAB),
                                     y.reshape(-1))


def fresh_names(make):
    """``make()`` with the port's gluon name counters empty, so the
    Blocks it builds carry the names a fresh process gives them (the
    names ``mxtpu_params`` writes and ``params_from_mxtpu`` matches);
    the process's counters come back afterwards."""
    from mxtpu_torch.gluon import block
    saved, block._NAME_COUNTERS = block._NAME_COUNTERS, {}
    try:
        return make()
    finally:
        block._NAME_COUNTERS = saved


def settle(net, x1):
    """Give a Block's deferred parameters their shapes: one
    predict-mode forward of the one-sample batch ``x1``, without
    grad."""
    import torch
    with torch.no_grad():
        net(x1)
    return net


def train_check_phase(checks):
    """A 2-layer full-width BERT, f32, dropout 0: one forward and
    backward, then three adam steps, on the card and on the CPU; returns
    the launch counts of the card's side (the f32 training path)."""
    from mxtpu_torch import kernels
    from mxtpu_torch.convert import params_from_mxtpu
    from mxtpu_torch.models import BERTModel
    from mxtpu_torch.parallel import build_train_step

    params = mxtpu_params(SEED + 3, CHECK_LAYERS, T)
    toks = np.random.RandomState(SEED + 4).randint(
        0, VOCAB, (CHECK_B, T)).astype(np.float32)

    def step_on(device):
        net = fresh_names(lambda: BERTModel(
            VOCAB, UNITS, FFN, CHECK_LAYERS, HEADS, max_length=T,
            dropout=0.0))
        params_from_mxtpu(params, net)
        return build_train_step(net, mlm_loss, "adam",
                                {"learning_rate": 1e-4}, cast_batch=False,
                                device=device)

    t0 = time.perf_counter()
    card, cpu = step_on(CARD), step_on("cpu")
    kernels.reset_launch_counts()   # the CPU side launches nothing
    lc, gc = card.forward_backward(toks, toks)
    lp, gp = cpu.forward_backward(toks, toks)
    worst = 0.0
    for n, a, b in zip(card.param_names, gc, gp):
        a, b = a.double().cpu(), b.double()
        rel = float((a - b).norm() / max(float(b.norm()), 1e-12))
        worst = max(worst, rel)
        if rel > GRAD_TOL:
            checks.failed.append(f"train check: grad of {n} off by {rel:.3e}")
    lrel = abs(float(lc) - float(lp)) / abs(float(lp))
    ok = worst <= GRAD_TOL and lrel <= LOSS_TOL
    print(f"check train 2-layer b{CHECK_B} T{T} f32 card vs CPU: loss "
          f"{float(lc):.6f} vs {float(lp):.6f} (rel {lrel:.3e}, tol "
          f"{LOSS_TOL}); worst gradient rel L2 {worst:.3e} over "
          f"{len(gc)} parameters (tol {GRAD_TOL}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if lrel > LOSS_TOL:
        checks.failed.append(f"train check: loss off by {lrel:.3e}")
    card, cpu = step_on(CARD), step_on("cpu")
    lcs = [float(card(toks, toks)) for _ in range(3)]
    lps = [float(cpu(toks, toks)) for _ in range(3)]
    srel = max(abs(a - b) / abs(b) for a, b in zip(lcs, lps))
    sok = srel <= STEP_TOL
    print(f"check train 2-layer three adam steps card vs CPU: {lcs} vs "
          f"{lps} (max rel {srel:.3e}, tol {STEP_TOL}) "
          f"{'ok' if sok else 'FAIL'}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    if not sok:
        checks.failed.append(f"train check: step losses off by {srel:.3e}")
    checks.rows.append({"check": "train 2-layer card vs CPU",
                        "loss_rel": lrel, "worst_grad_rel": worst,
                        "step_losses_card": lcs, "step_losses_cpu": lps,
                        "step_rel": srel, "ok": ok and sok})
    return kernels.launch_counts()


RANGES = ("forward_backward", "update", "run_steps")


def step_breakdown(step, x, y):
    """One training step, ``step(x, y)`` (or one ``run_steps`` call
    through a callable of the same form), under torch.profiler: device
    ms by family (each ported kernel, cuDNN convolutions, GEMMs, the
    optimizer, other), the host and device ms of TrainStep's
    ``record_function`` ranges, summed over their occurrences, and the
    device's idle share of the call's wall time.  The optimizer's
    device time is what the ``update`` ranges launched; it leaves
    "other"."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by = {k: 0.0 for k in (*KERNEL_NAMES, "conv", "gemm", "optimizer",
                           "other")}
    ranges = {r: {"host_ms": 0.0, "device_ms": 0.0} for r in RANGES}
    n = 0
    per_name = {}
    for evt in prof.events():
        on_device = "CPU" not in str(evt.device_type)
        if evt.name in RANGES:
            if not on_device:
                ranges[evt.name]["host_ms"] += evt.cpu_time_total / 1e3
                ranges[evt.name]["device_ms"] += \
                    evt.device_time_total / 1e3
            continue
        if on_device:
            ms = evt.device_time_total / 1e3
            by[family_of(evt.name)] += ms
            per_name[evt.name] = per_name.get(evt.name, 0.0) + ms
            n += 1
    by["optimizer"] = ranges["update"]["device_ms"]
    by["other"] = max(0.0, by["other"] - by["optimizer"])
    busy = sum(by.values())
    top = {}
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1]):
        fam = top.setdefault(family_of(name), [])
        if len(fam) < 5:
            fam.append([name[:120], ms])
    return {"device_ms_by_family": by, "device_busy_ms": busy,
            "profiled_wall_ms": wall_ms, "ranges": ranges, "kernels": n,
            "top_kernels": top,
            "device_idle_share": 1.0 - busy / wall_ms if busy else None}


def breakdown_line(tag, bd):
    return (f"{tag} step breakdown (device ms): " +
            ", ".join(f"{k} {v:.3f}" for k, v in
                      bd["device_ms_by_family"].items() if v) +
            f"; busy {bd['device_busy_ms']:.3f} of "
            f"{bd['profiled_wall_ms']:.3f} ms wall ({bd['kernels']} device "
            f"events), idle share {bd['device_idle_share']:.4f}; " +
            "; ".join(f"{k}: host {r['host_ms']:.3f} ms, device "
                      f"{r['device_ms']:.3f} ms launched from its thread"
                      for k, r in bd["ranges"].items() if r["host_ms"]))


def profiled_step(checks, tag, step, x, y):
    """:func:`step_breakdown`, with up to two more steps when the
    profiler recorded no device time or none under ``update``."""
    for _ in range(3):
        bd = step_breakdown(step, x, y)
        if bd["device_idle_share"] is not None and \
                bd["ranges"]["update"]["device_ms"]:
            break
    if bd["device_idle_share"] is None:
        checks.failed.append(f"torch.profiler recorded no device time in "
                             f"the {tag} step")
    else:
        print(breakdown_line(tag, bd), flush=True)
    return bd


def check_launches(checks, tag, counts, per_step, n_steps):
    """Every counter read after ``n_steps`` steps must be ``per_step``
    (0 where not listed) times ``n_steps``."""
    for name, got in counts.items():
        want = per_step.get(name, 0) * n_steps
        if got != want:
            checks.failed.append(f"{tag}: {name} launched {got} times in "
                                 f"{n_steps} steps, want "
                                 f"{per_step.get(name, 0)} per step")


def seeded_bert_step(compute_dtype="bfloat16", optimizer="adam",
                     params=None, amp=None):
    """BERT-Large and its train step from fixed seeds: xavier weights
    (``bench_bert``'s init) and the dropout streams, both from
    ``mxtpu_torch.random``; the deferred shapes settled before the step
    is built, so it reads ``MXTPU_BATCHED_OPT`` (and ``MXTPU_AMP``)
    then."""
    import torch
    from mxtpu_torch import random as trandom
    from mxtpu_torch.models import bert_large
    from mxtpu_torch.parallel import build_train_step
    trandom.seed(SEED)
    net = bert_large(vocab_size=VOCAB, max_length=T, dropout=0.1)
    net.initialize(init="xavier", ctx=CARD)
    settle(net, torch.zeros(1, T, device=CARD))
    return build_train_step(net, mlm_loss, optimizer,
                            params or {"learning_rate": 1e-4},
                            compute_dtype=compute_dtype, cast_batch=False,
                            amp=amp, device=CARD)


def bert_tokens(b=B, seed=SEED + 5):
    """``bench_bert``'s (b, T) token batch, on the card."""
    import torch
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, VOCAB, (b, T)).astype(np.float32)).to(CARD)


def train_phase(checks, compute_dtype="bfloat16"):
    """BERT-Large trained with the bench_bert recipe, in bf16 compute or,
    with ``compute_dtype=None`` (the API's default), in f32; returns the
    launch counts of the timed steps and the numbers."""
    import torch
    from mxtpu_torch import kernels
    prec = compute_dtype or "float32"
    tag = f"training {prec}"

    def seeded_step():
        return seeded_bert_step(compute_dtype)

    t0 = time.perf_counter()
    step = seeded_step()
    toks = bert_tokens()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(toks, toks) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # TRAIN_WINDOWS timed windows of TRAIN_STEPS steps each: the host
    # launches every kernel, so the step time varies with the host
    kernels.reset_launch_counts()
    window_ms = []
    for _ in range(TRAIN_WINDOWS):
        t0 = time.perf_counter()
        losses += [step(toks, toks) for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - t0) / TRAIN_STEPS * 1e3)
    counts = kernels.launch_counts()
    losses = [float(v) for v in losses]
    mem = step.memory_summary()
    n_steps = TRAIN_STEPS * TRAIN_WINDOWS

    ms_step = float(np.median(window_ms))
    tokens = B * T
    mm_params = LAYERS * (4 * UNITS * UNITS + 2 * UNITS * FFN) + \
        VOCAB * UNITS
    flops = 6 * mm_params * tokens + 12 * LAYERS * T * UNITS * tokens
    mfu = flops / (ms_step / 1e3) / PEAK_OPS[prec]
    breakdown = profiled_step(checks, tag, step, toks, toks)
    flash_ms = sum(v for k, v in breakdown["device_ms_by_family"].items()
                   if k.startswith("flash_attention"))

    # the same seeds again: every kernel sums in a fixed order, so the
    # first steps' losses repeat bit for bit
    del step
    torch.cuda.empty_cache()
    again = seeded_step()
    repeat = [float(again(toks, toks)) for _ in range(TRAIN_WARMUP + 2)]
    del again
    torch.cuda.empty_cache()
    same = repeat == losses[:len(repeat)]
    print(f"check {tag} repeats bit for bit from the same seeds over "
          f"{len(repeat)} steps: {'ok' if same else 'FAIL'} ({repeat})",
          flush=True)
    if not same:
        checks.failed.append(f"{tag} does not repeat from the same seeds")

    if not all(np.isfinite(losses)):
        checks.failed.append(f"{tag} losses not finite: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        checks.failed.append(f"{tag} loss did not fall: {losses}")
    check_launches(checks, tag, counts,
                   {"flash_attention_fwd": LAYERS,
                    "flash_attention_bwd_dq": LAYERS,
                    "flash_attention_bwd_dkv": LAYERS,
                    "layer_norm_fwd": 1, "layer_norm_bwd": 1,
                    "fused_residual_ln_fwd": 2 * LAYERS,
                    "fused_residual_ln_bwd": 2 * LAYERS}, n_steps)
    print(f"{tag} BERT-Large b{B} T{T} adam: losses "
          f"{[round(v, 4) for v in losses]}", flush=True)
    print(f"{tag}: {ms_step:.3f} ms/step (median of {TRAIN_WINDOWS} "
          f"windows of {TRAIN_STEPS} steps: "
          f"{', '.join(f'{w:.3f}' for w in window_ms)}), "
          f"{tokens / ms_step * 1e3:.1f} "
          f"tokens/s, MFU {mfu:.4f} of {PEAK_OPS[prec] / 1e12:.0f} "
          f"TFLOP/s {prec} ({flops / 1e12:.3f} TFLOP/step); device "
          f"{breakdown['device_busy_ms']:.3f} ms a step, flash family "
          f"{flash_ms:.3f}, idle share "
          f"{breakdown['device_idle_share'] or 0:.4f} (the profiled step); "
          f"peak memory {(mem['peak_bytes'] or 0) / 2**30:.3f} GiB; set-up "
          f"and {TRAIN_WARMUP} warm-up steps {setup_s:.1f} s", flush=True)
    print(f"{tag}: launches in {n_steps} steps {json.dumps(counts)}",
          flush=True)
    return counts, {"compute_dtype": prec, "ms_per_step": ms_step,
                    "window_ms_per_step": window_ms,
                    "tokens_per_s": tokens / ms_step * 1e3,
                    "flops_per_step": flops, "mfu": mfu,
                    "memory": mem, "losses": losses, "steps": n_steps,
                    "setup_s": setup_s, "breakdown": breakdown,
                    "repeats_bit_for_bit": same}


# ----------------------------------------------------------------------
# ResNet-50 trained
# ----------------------------------------------------------------------

RN_CHECK_LAYERS, RN_CHECK_B, RN_CHECK_HW = [1, 1, 1, 1], 4, 64
RN_CHANNELS = [64, 256, 512, 1024, 2048]
RN_B, RN_HW, RN_CLASSES = 256, 224, 1000
RN_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
# the card-vs-CPU check steps at lr 1e-3: at the recipe's 0.1 four
# images are memorized in two steps (loss 7.0, 0.76, 0.27) and
# gradients within 8e-6 of each other part the trajectories by 6e-3 at
# the third step (measured on an H100), which tests the amplification,
# not the arithmetic
RN_CHECK_SGD = {**RN_SGD, "learning_rate": 1e-3}
# a step loss near 0 (a memorized batch) is held to STEP_TOL of this
# floor: there the loss is about exp(-margin), so its relative error is
# the margin's absolute one (NHWC reads 2.7e-4 at step 3 on an H100)
RN_LOSS_FLOOR = 1e-2
RN_STATS_TOL = 1e-5
# A convolution bias that feeds a BatchNorm has a zero gradient in exact
# arithmetic (the BatchNorm subtracts the channel's mean), so what each
# side computes there is rounding noise: the bias gradient db_c is an
# n-term f32 sum, over the channel's n = N*H*W terms g of dL/dz (z the
# convolution's output), whose exact value is 0.  Each side is held on
# its own (the two sides' noise is not compared) to the worst case of
# the rounding of an n-term f32 sum taken in any order, gamma_{n-1} <
# n*u (u = 2^-24, f32's unit roundoff) of its magnitudes:
#   |db_c| <= n * u * sum |g|.
RN_BIAS_U = 2.0 ** -24
# bench.py:129, the JAX package's count of one sample's training FLOPs
RN_REF_FLOPS = 22.49e9
RN_LAUNCHES = {"NCHW": {"batch_norm_fwd": 53, "batch_norm_bwd": 53},
               "NHWC": {"batch_norm_fwd_cm": 53, "batch_norm_bwd_cm": 53}}


def rn_batch(layout, b, hw, seed):
    """``bench_resnet50``'s batch: images from ``RandomState(seed).randn``
    and integer labels in [0, 1000) as floats, drawn in that order."""
    rng = np.random.RandomState(seed)
    shape = (b, 3, hw, hw) if layout == "NCHW" else (b, hw, hw, 3)
    x = rng.randn(*shape).astype(np.float32)
    y = rng.randint(0, RN_CLASSES, (b,)).astype(np.float32)
    return x, y


def rn_loss():
    from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    return SoftmaxCrossEntropyLoss()


def bias_noise_probe(net, sums, side):
    """Hooks on every convolution of ``net`` with a bias (in ResNet V1
    each feeds a BatchNorm): at the backward, ``sums[(side, name of the
    bias)]`` gets (n, per-channel sum of |dL/dz| over its n = N*H*W
    terms), z the convolution's output."""
    from mxtpu_torch.gluon.nn import Conv2D

    def hook(mod, inp, out, name):
        ch = 1 if mod._layout == "NCHW" else 3
        dims = [d for d in range(out.ndim) if d != ch]

        def grad_hook(g):
            sums[(side, name)] = (out.numel() // out.shape[ch],
                                  g.detach().double().abs().sum(dims).cpu())
        out.register_hook(grad_hook)

    for mod in net.modules():
        if isinstance(mod, Conv2D) and mod.bias is not None:
            mod.register_forward_hook(
                lambda m, i, o, name=mod.bias.name: hook(m, i, o, name))


def resnet_check_phase(checks):
    """A full-width ResNet V1 of one bottleneck per stage, f32, b=4 at
    64x64, the same weights on the card and on the CPU, in both
    layouts: the loss, every gradient (a convolution bias that feeds a
    BatchNorm held on each side to its rounding bound, ``RN_BIAS_U``),
    three SGD-momentum steps and the running statistics after them."""
    import torch
    from mxtpu_torch import initializer
    from mxtpu_torch.convert import named_tensors
    from mxtpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1
    from mxtpu_torch.parallel import build_train_step

    for layout in ("NCHW", "NHWC"):
        t0 = time.perf_counter()
        x, y = rn_batch(layout, RN_CHECK_B, RN_CHECK_HW, SEED + 6)

        def net_on(device):
            # the same names on both sides (they key the bias probe's
            # sums) and the same Xavier weights, drawn on the CPU from
            # one torch generator in parameter order, as this check has
            # always drawn them, then moved
            net = fresh_names(lambda: ResNetV1(
                BottleneckV1, RN_CHECK_LAYERS, RN_CHANNELS,
                classes=RN_CLASSES, layout=layout))
            net.initialize(ctx="cpu")
            settle(net, torch.from_numpy(x[:1]))
            gen = torch.Generator().manual_seed(SEED + 7)
            xavier = initializer.Xavier()
            with torch.no_grad():
                for name, t in net.named_parameters():
                    xavier.init_weight(name.rsplit(".", 1)[-1], t, gen)
            return net.to(device)

        def step_on(device):
            return build_train_step(net_on(device), rn_loss(), "sgd",
                                    RN_CHECK_SGD, device=device)
        card, cpu = step_on(CARD), step_on("cpu")
        sums = {}
        bias_noise_probe(card.net, sums, "card")
        bias_noise_probe(cpu.net, sums, "CPU")
        lc, gc = card.forward_backward(x, y)
        lp, gp = cpu.forward_backward(x, y)
        worst_rel, worst_bias, n_bias = 0.0, 0.0, 0
        for n, a, b in zip(card.param_names, gc, gp):
            if ("card", n) in sums:   # a bias feeding a BatchNorm
                n_bias += 1
                for side, g in (("card", a), ("CPU", b)):
                    cnt, mags = sums[(side, n)]
                    lim = cnt * RN_BIAS_U * mags
                    ratio = float((g.double().cpu().abs() /
                                   lim.clamp_min(1e-300)).max())
                    worst_bias = max(worst_bias, ratio)
                    if ratio > 1.0:
                        checks.failed.append(
                            f"resnet check {layout}: grad of {n} on the "
                            f"{side} is {ratio:.3e} of its rounding bound")
                continue
            r = float(b.double().pow(2).mean().sqrt())
            d = float((a.double().cpu() - b.double()).pow(2).mean().sqrt())
            worst_rel = max(worst_rel, d / max(r, 1e-30))
            if d > GRAD_TOL * r:
                checks.failed.append(f"resnet check {layout}: grad of {n} "
                                     f"off by {d:.3e} (rms {r:.3e})")
        if n_bias == 0:
            checks.failed.append(f"resnet check {layout}: no convolution "
                                 f"bias feeding a BatchNorm was seen")
        lrel = abs(float(lc) - float(lp)) / abs(float(lp))
        if lrel > LOSS_TOL:
            checks.failed.append(f"resnet check {layout}: loss off by "
                                 f"{lrel:.3e}")
        card, cpu = step_on(CARD), step_on("cpu")
        lcs = [float(card(x, y)) for _ in range(3)]
        lps = [float(cpu(x, y)) for _ in range(3)]
        srel = max(abs(a - b) / max(abs(b), RN_LOSS_FLOOR)
                   for a, b in zip(lcs, lps))
        if srel > STEP_TOL:
            checks.failed.append(f"resnet check {layout}: step losses off "
                                 f"by {srel:.3e}")
        srel_stats = 0.0
        for (n, a), (_, b) in zip(named_tensors(card.net),
                                  named_tensors(cpu.net)):
            if n.endswith(("running_mean", "running_var")):
                e, _ = rel_err(a.cpu(), b)
                srel_stats = max(srel_stats, e)
        if srel_stats > RN_STATS_TOL:
            checks.failed.append(f"resnet check {layout}: running stats off "
                                 f"by {srel_stats:.3e}")
        ok = lrel <= LOSS_TOL and srel <= STEP_TOL and \
            srel_stats <= RN_STATS_TOL and \
            not any(f.startswith(f"resnet check {layout}")
                    for f in checks.failed)
        print(f"check resnet {layout} [1,1,1,1] full width b{RN_CHECK_B} "
              f"{RN_CHECK_HW}x{RN_CHECK_HW} f32 card vs CPU: loss "
              f"{float(lc):.6f} vs {float(lp):.6f} (rel {lrel:.3e}, tol "
              f"{LOSS_TOL}); gradients over {len(gc)} tensors: worst rms "
              f"error {worst_rel:.3e} of the tensor's rms (tol "
              f"{GRAD_TOL}) over the {len(gc) - n_bias} that are not a "
              f"zero-gradient bias; those {n_bias} at most "
              f"{worst_bias:.3e} of their rounding bound on either side "
              f"(tol 1); three SGD steps {lcs} vs {lps} "
              f"(max err {srel:.3e} of max(|p|, {RN_LOSS_FLOOR}), tol "
              f"{STEP_TOL}); running stats max "
              f"rel {srel_stats:.3e} (tol {RN_STATS_TOL}) "
              f"{'ok' if ok else 'FAIL'}; {time.perf_counter() - t0:.1f} s",
              flush=True)
        checks.rows.append({"check": f"resnet {layout} card vs CPU",
                            "loss_rel": lrel, "worst_grad_rel": worst_rel,
                            "worst_bias_noise": worst_bias,
                            "step_losses_card": lcs,
                            "step_losses_cpu": lps, "step_rel": srel,
                            "stats_rel": srel_stats, "ok": ok})


def model_counts(net, x1):
    """From one predict-mode forward of ``net`` on the one-sample batch
    ``x1`` (forward hooks on the port's own layers): the multiply-add
    FLOPs (2 per MAC) of its convolutions and dense layers, and the
    bytes the BatchNorm kernels must move per sample in bf16 — forward:
    x (and the residual) read, y written; backward: x, dy (and the
    residual) read, dx (and dr) written."""
    import torch
    from mxtpu_torch.gluon import nn as gnn
    c = {"flops": 0, "bn_fwd_bytes": 0, "bn_bwd_bytes": 0}

    def conv_hook(mod, inp, out):
        w = mod.weight.shape
        k = int(np.prod(w)) // w[0]          # I/groups * kh * kw
        c["flops"] += 2 * out.numel() * k

    def dense_hook(mod, inp, out):
        c["flops"] += 2 * out.numel() * mod.weight.shape[1]

    def bn_hook(mod, inp, out):
        add = int(len(inp) > 1 and inp[1] is not None)
        c["bn_fwd_bytes"] += (2 + add) * inp[0].numel() * 2
        c["bn_bwd_bytes"] += (3 + 2 * add) * inp[0].numel() * 2
    hook_of = {gnn.Conv2D: conv_hook, gnn.Dense: dense_hook,
               gnn.BatchNorm: bn_hook}
    hooks = [m.register_forward_hook(hook_of[type(m)])
             for m in net.modules() if type(m) in hook_of]
    with torch.no_grad():
        net(x1)
    for h in hooks:
        h.remove()
    return c


def resnet50_net(layout):
    """``bench_resnet50``'s model (NCHW) or the model zoo's channels-last
    one, Xavier weights from ``mxtpu_torch.random`` seed ``SEED`` on the
    card, the deferred shapes settled."""
    import torch
    from mxtpu_torch import initializer, random as trandom
    from mxtpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxtpu_torch.models import resnet50
    trandom.seed(SEED)
    net = resnet50(classes=RN_CLASSES) if layout == "NCHW" else \
        resnet50_v1(classes=RN_CLASSES, layout=layout)
    net.initialize(initializer.Xavier(), ctx=CARD)
    shape = (1, 3, RN_HW, RN_HW) if layout == "NCHW" else \
        (1, RN_HW, RN_HW, 3)
    return settle(net, torch.zeros(shape, device=CARD))


def resnet_train_phase(checks, layout):
    """ResNet-50 v1 trained with the bench_resnet50 recipe in
    ``layout``; returns the launch counts of the timed steps and the
    numbers."""
    import torch
    from mxtpu_torch import kernels
    from mxtpu_torch.parallel import build_train_step

    t0 = time.perf_counter()
    net = resnet50_net(layout)
    xn, yn = rn_batch(layout, RN_B, RN_HW, SEED)
    x = torch.from_numpy(xn).to(CARD)
    y = torch.from_numpy(yn).to(CARD)
    per_sample = model_counts(net, x[:1])
    flops = 3 * per_sample["flops"] * RN_B
    bn_bound_ms = {d: per_sample[f"bn_{d}_bytes"] * RN_B / PEAK_BYTES * 1e3
                   for d in ("fwd", "bwd")}
    step = build_train_step(net, rn_loss(), "sgd", RN_SGD,
                            compute_dtype="bfloat16", device=CARD)
    torch.cuda.reset_peak_memory_stats()
    losses = [step(x, y) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    window_ms = []
    for _ in range(TRAIN_WINDOWS):
        t1 = time.perf_counter()
        losses += [step(x, y) for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - t1) / TRAIN_STEPS * 1e3)
    counts = kernels.launch_counts()
    losses = [float(v) for v in losses]
    mem = step.memory_summary()
    n_steps = TRAIN_STEPS * TRAIN_WINDOWS
    ms_step = float(np.median(window_ms))
    mfu = flops / (ms_step / 1e3) / PEAK_OPS["bfloat16"]
    ref_mfu = RN_REF_FLOPS * RN_B / (ms_step / 1e3) / PEAK_OPS["bfloat16"]
    tag = f"resnet50 {layout}"
    if not all(np.isfinite(losses)):
        checks.failed.append(f"{tag}: losses not finite: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        checks.failed.append(f"{tag}: loss did not fall: {losses}")
    check_launches(checks, tag, counts, RN_LAUNCHES[layout], n_steps)
    print(f"{tag} b{RN_B} {RN_HW}x{RN_HW} bf16 sgd momentum: losses "
          f"{[round(v, 4) for v in losses]}", flush=True)
    print(f"{tag}: {ms_step:.3f} ms/step (median of {TRAIN_WINDOWS} "
          f"windows of {TRAIN_STEPS} steps: "
          f"{', '.join(f'{w:.3f}' for w in window_ms)}), "
          f"{RN_B / ms_step * 1e3:.1f} samples/s, MFU {mfu:.4f} of "
          f"{PEAK_OPS['bfloat16'] / 1e12:.0f} TFLOP/s bf16 "
          f"({flops / RN_B / 1e9:.3f} GFLOP per sample from the port's "
          f"conv and dense shapes, 3x forward; the reference's count "
          f"{RN_REF_FLOPS / 1e9:.2f} gives MFU {ref_mfu:.4f})"
          f"; peak memory {(mem['peak_bytes'] or 0) / 2**30:.3f} GiB; set-up "
          f"and {TRAIN_WARMUP} warm-up steps {setup_s:.1f} s", flush=True)
    print(f"{tag}: launches in {n_steps} steps {json.dumps(counts)}",
          flush=True)
    breakdown = profiled_step(checks, tag, step, x, y)
    sfx = "_cm" if layout == "NHWC" else ""
    bn_ms = {d: breakdown["device_ms_by_family"][f"batch_norm_{d}{sfx}"]
             for d in ("fwd", "bwd")}
    print(f"{tag}: BatchNorm kernels per step {bn_ms['fwd']:.3f} ms fwd, "
          f"{bn_ms['bwd']:.3f} ms bwd against byte bounds of "
          f"{bn_bound_ms['fwd']:.3f} and {bn_bound_ms['bwd']:.3f} ms "
          f"(53 BatchNorms, bf16, {PEAK_BYTES / 1e12:.2f} TB/s)", flush=True)
    for fam in ("conv", "gemm", "other"):
        print(f"{tag} top {fam} kernels (device ms): " + "; ".join(
            f"{k[:70]} {ms:.3f}"
            for k, ms in breakdown["top_kernels"].get(fam, [])[:4]),
            flush=True)
    del step, net
    torch.cuda.empty_cache()
    return counts, {"layout": layout, "ms_per_step": ms_step,
                    "window_ms_per_step": window_ms,
                    "samples_per_s": RN_B / ms_step * 1e3,
                    "flops_per_step": flops, "mfu": mfu,
                    "reference_flops_per_sample": RN_REF_FLOPS,
                    "bn_bound_ms_per_step": bn_bound_ms,
                    "memory": mem, "losses": losses, "steps": n_steps,
                    "setup_s": setup_s, "breakdown": breakdown}


# ----------------------------------------------------------------------
# bulked training: run_steps, the bucketed update and its twin
# ----------------------------------------------------------------------

GATE_STEPS = 3        # steps each twin runs before the bit-for-bit check
LAMB_STEPS = 5
BERT_LAMB = {"learning_rate": 2e-3}
BERT_LAUNCHES = {"flash_attention_fwd": LAYERS,
                 "flash_attention_bwd_dq": LAYERS,
                 "flash_attention_bwd_dkv": LAYERS,
                 "layer_norm_fwd": 1, "layer_norm_bwd": 1,
                 "fused_residual_ln_fwd": 2 * LAYERS,
                 "fused_residual_ln_bwd": 2 * LAYERS}


def build_twin(make, batched):
    """``make()`` with ``MXTPU_BATCHED_OPT`` set for the build, which is
    when TrainStep reads it: the bucketed update (mxtpu's default) or
    the per-parameter twin."""
    old = os.environ.get("MXTPU_BATCHED_OPT")
    os.environ["MXTPU_BATCHED_OPT"] = "1" if batched else "0"
    try:
        return make()
    finally:
        if old is None:
            del os.environ["MXTPU_BATCHED_OPT"]
        else:
            os.environ["MXTPU_BATCHED_OPT"] = old


def train_snapshot(step):
    """Every parameter, buffer (BatchNorm's running statistics) and
    optimizer-state leaf of ``step``, copied on the card."""
    return ([t.detach().clone() for _, t in step.net.named_parameters()] +
            [t.detach().clone() for _, t in step.net.named_buffers()] +
            [leaf.detach().clone() for st in step._canonical_state()
             for leaf in st])


def bit_equal(a, b):
    import torch
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


class deterministic_cudnn:
    """cuDNN's deterministic algorithms while a bit-for-bit gate runs:
    its default backward algorithms may sum with atomics, which part
    two identical runs (measured in PR 4's rtc-head check) and would
    test cuDNN, not the update."""

    def __enter__(self):
        import torch
        self.old = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        import torch
        torch.backends.cudnn.deterministic = self.old


def bulked_cell(checks, tag, make, micro, bulked, x, y, per_step, unit,
                units_per_step, card):
    """One model's bulked phase.  From the same seeds: the bucketed step
    runs ``GATE_STEPS`` eager steps on the microbatches ``micro``; its
    per-parameter twin does the same and must equal it bit for bit
    (losses, parameters, buffers, state); a third bucketed step runs
    ``bulked(step)`` (run_steps over the same microbatches) and must
    equal the eager steps bit for bit.  Each twin's next step is
    profiled for its ``update`` range.  Then the third step is timed as
    bench.py's ``_measure`` times mxtpu: ``run_steps(x, y, TRAIN_STEPS,
    reuse_batch=True)`` after a warm-up call, median of
    ``TRAIN_WINDOWS`` windows, each ended by a host read of its last
    loss and each after a window of as many eager steps on the same
    step object (timed too); launches per step inside run_steps must be
    ``per_step``; one call is profiled."""
    import torch
    from mxtpu_torch import kernels
    t0 = time.perf_counter()
    out = {}
    with deterministic_cudnn():
        step = build_twin(make, True)
        eager = [float(step(xb, yb)) for xb, yb in micro]
        ref = train_snapshot(step)
    n_params, n_buckets = len(step._params), len(step._groups)
    bd_b = profiled_step(checks, f"{tag} bucketed", step, *micro[0])
    del step
    torch.cuda.empty_cache()
    with deterministic_cudnn():
        step = build_twin(make, False)
        per = [float(step(xb, yb)) for xb, yb in micro]
        same_twin = per == eager and bit_equal(train_snapshot(step), ref)
    bd_p = profiled_step(checks, f"{tag} per-parameter", step, *micro[0])
    del step
    torch.cuda.empty_cache()
    with deterministic_cudnn():
        step = build_twin(make, True)
        got = bulked(step)
        same_bulk = got == eager and bit_equal(train_snapshot(step), ref)
    del ref
    torch.cuda.empty_cache()
    upd = {"bucketed": bd_b["ranges"]["update"]["device_ms"],
           "per_parameter": bd_p["ranges"]["update"]["device_ms"]}
    print(f"check {tag}: {GATE_STEPS} steps from the same seeds, "
          f"bucketed ({n_buckets} buckets of {n_params} parameters) vs "
          f"per-parameter update: losses {eager} vs {per}, every "
          f"parameter, buffer and state leaf bit for bit "
          f"{'ok' if same_twin else 'FAIL'}; run_steps vs the eager "
          f"steps: {got} bit for bit {'ok' if same_bulk else 'FAIL'}",
          flush=True)
    if not same_twin:
        checks.failed.append(f"{tag}: the bucketed update differs from "
                             f"the per-parameter one")
    if not same_bulk:
        checks.failed.append(f"{tag}: run_steps differs from eager steps")
    print(f"{tag} update range, device ms a step: bucketed "
          f"{upd['bucketed']:.3f}, per-parameter {upd['per_parameter']:.3f}"
          f" ({card})", flush=True)

    warm = step.run_steps(x, y, TRAIN_WARMUP, reuse_batch=True)
    losses = [float(v) for v in warm]
    torch.cuda.reset_peak_memory_stats()
    # bulked windows, each after an eager window of as many steps on the
    # same step object, so the two see the same host and allocator
    counts = {}
    window_ms, eager_ms = [], []
    for _ in range(TRAIN_WINDOWS):
        t1 = time.perf_counter()
        eager = [step(x, y) for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t1) / TRAIN_STEPS * 1e3)
        losses += [float(v) for v in eager]
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        last = step.run_steps(x, y, TRAIN_STEPS, reuse_batch=True)
        float(last[-1])
        window_ms.append((time.perf_counter() - t1) / TRAIN_STEPS * 1e3)
        for k, v in kernels.launch_counts().items():
            counts[k] = counts.get(k, 0) + v
        losses += [float(v) for v in last]
    mem = step.memory_summary()
    n_steps = TRAIN_STEPS * TRAIN_WINDOWS
    check_launches(checks, f"{tag} run_steps", counts, per_step, n_steps)
    if not all(np.isfinite(losses)):
        checks.failed.append(f"{tag} run_steps losses not finite: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        checks.failed.append(f"{tag} run_steps loss did not fall: {losses}")
    ms_step = float(np.median(window_ms))
    for _ in range(3):
        bd = step_breakdown(
            lambda a, b: step.run_steps(a, b, TRAIN_STEPS, reuse_batch=True),
            x, y)
        if bd["device_idle_share"] is not None:
            print(breakdown_line(f"{tag} run_steps({TRAIN_STEPS}) call", bd),
                  flush=True)
            break
    else:
        checks.failed.append(f"torch.profiler recorded no device time in "
                             f"the {tag} run_steps call")
    busy = bd["device_busy_ms"] / TRAIN_STEPS
    print(f"{tag} bulked: {ms_step:.3f} ms/step (median of {TRAIN_WINDOWS}"
          f" windows of run_steps(x, y, {TRAIN_STEPS}, reuse_batch=True): "
          f"{', '.join(f'{w:.3f}' for w in window_ms)}; eager windows "
          f"before each: {', '.join(f'{w:.3f}' for w in eager_ms)}), "
          f"{units_per_step / ms_step * 1e3:.1f} {unit}/s; one profiled "
          f"call: device busy {busy:.3f} ms a step, idle share "
          f"{bd['device_idle_share'] or 0:.4f}, update range "
          f"{bd['ranges']['update']['device_ms'] / TRAIN_STEPS:.3f} ms a "
          f"step on the device; peak memory "
          f"{(mem['peak_bytes'] or 0) / 2**30:.3f} GiB; launches in "
          f"{n_steps} steps {json.dumps(counts)}; "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
    out.update({"ms_per_step": ms_step, "window_ms_per_step": window_ms,
                "eager_window_ms_per_step": eager_ms,
                f"{unit}_per_s": units_per_step / ms_step * 1e3,
                "device_busy_ms_per_step": busy,
                "device_idle_share": bd["device_idle_share"],
                "memory": mem, "losses": losses, "launches": counts,
                "update_device_ms_per_step": upd, "buckets": n_buckets,
                "parameters": n_params, "breakdown": bd,
                "twin_breakdowns": {"bucketed": bd_b, "per_parameter": bd_p},
                "bucketed_equals_per_parameter": same_twin,
                "run_steps_equals_eager": same_bulk, "card": card})
    del step
    torch.cuda.empty_cache()
    return counts, out


def bulked_train_phase(checks, card):
    """BERT-Large bf16 (adam) and ResNet-50 NHWC (SGD momentum) on the
    bucketed update and through ``run_steps``, each beside its
    per-parameter twin (:func:`bulked_cell`); BERT's ``run_steps`` gate
    is three ``run_steps(x, y, 1)`` calls (adam's bias correction is
    sampled once a call), ResNet's one ``run_steps(x, y, 3)`` over three
    microbatches (constant lr); then a LAMB BERT-Large bf16 run of
    ``LAMB_STEPS`` steps, its losses finite and falling."""
    import torch
    results, counts = {}, {}
    toks = bert_tokens()
    counts["bert"], results["bert"] = bulked_cell(
        checks, "bulked BERT-Large bf16 adam", seeded_bert_step,
        [(toks, toks)] * GATE_STEPS,
        lambda st: [float(st.run_steps(toks, toks, 1)[0])
                    for _ in range(GATE_STEPS)],
        toks, toks, BERT_LAUNCHES, "tokens", B * T, card)

    xn, yn = rn_batch("NHWC", RN_B * GATE_STEPS, RN_HW, SEED)
    x3, y3 = torch.from_numpy(xn).to(CARD), torch.from_numpy(yn).to(CARD)
    micro = [(x3[i * RN_B:(i + 1) * RN_B], y3[i * RN_B:(i + 1) * RN_B])
             for i in range(GATE_STEPS)]

    def resnet_step():
        from mxtpu_torch.parallel import build_train_step
        return build_train_step(resnet50_net("NHWC"), rn_loss(), "sgd",
                                RN_SGD, compute_dtype="bfloat16",
                                device=CARD)
    counts["resnet"], results["resnet"] = bulked_cell(
        checks, "bulked resnet50 NHWC sgd momentum", resnet_step, micro,
        lambda st: st.run_steps(x3, y3, GATE_STEPS).tolist(),
        *micro[0], RN_LAUNCHES["NHWC"], "samples", RN_B, card)
    del x3, y3, micro
    torch.cuda.empty_cache()

    step = seeded_bert_step(optimizer="lamb", params=BERT_LAMB)
    lamb = step.run_steps(toks, toks, LAMB_STEPS, reuse_batch=True).tolist()
    ok = bool(np.isfinite(lamb).all()) and np.mean(lamb[-3:]) < lamb[0]
    print(f"check LAMB BERT-Large bf16 (lr {BERT_LAMB['learning_rate']}, "
          f"{len(step._groups)} buckets), run_steps({LAMB_STEPS}) losses "
          f"{lamb}: finite and falling {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        checks.failed.append(f"LAMB BERT-Large losses not finite and "
                             f"falling: {lamb}")
    results["lamb_losses"] = lamb
    del step
    torch.cuda.empty_cache()
    return counts, results


# ----------------------------------------------------------------------
# the Gluon loop: initialize, hybridize, Trainer, record, backward, step
# ----------------------------------------------------------------------

GLUON_STEPS = 3       # counted and timed steps, after one warm-up step
GLUON_BERT_ADAM = {"learning_rate": 1e-4}
GLUON_RN_B = 64
RN_NHWC_LAUNCHES = RN_LAUNCHES["NHWC"]


def gluon_bert_model(dropout):
    """``bert_large`` at bench_bert's T, named as a fresh process names
    it."""
    from mxtpu_torch.models import bert_large
    return fresh_names(lambda: bert_large(vocab_size=VOCAB, max_length=T,
                                          dropout=dropout))


def gluon_resnet_model():
    from mxtpu_torch.gluon.model_zoo.vision import resnet50_v1
    return fresh_names(lambda: resnet50_v1(classes=RN_CLASSES,
                                           layout="NHWC"))


def gluon_loop(net, make_loss, opt, kw, per_loss):
    """mxtpu's Gluon loop on ``net`` (initialized): ``hybridize()``, a
    ``gluon.Trainer`` over ``collect_params()``, and a step function
    ``step(x, y)`` of NDArrays that records the forward and the loss,
    runs ``loss.backward()`` and ``trainer.step(n)``, ``n`` the number
    of entries of the loss vector (``per_loss`` of the batch); the
    forward and backward run in a ``forward_backward`` profiler range,
    the Trainer's update in its own ``update`` range."""
    import torch
    from mxtpu_torch import autograd, gluon
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), opt, dict(kw))
    L = make_loss()

    def step(x, y):
        with torch.profiler.record_function("forward_backward"):
            with autograd.record():
                loss = L(*per_loss(net(x), y))
            loss.backward()
        t0 = time.perf_counter()
        trainer.step(loss.shape[0])
        # the host time of the Trainer's call (its launches; the device
        # runs behind)
        step.update_host_ms = (time.perf_counter() - t0) * 1e3
        return loss
    return trainer, step


def bert_mlm(out, y):
    # bench_bert's shapes: one loss entry a token
    return out.reshape((-1, VOCAB)), y.reshape((-1,))


def timed_steps(step, x, y, n):
    """``n`` steps, synchronized at the end: (losses, ms a step)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(x, y) for _ in range(n)]
    torch.cuda.synchronize()
    return losses, (time.perf_counter() - t0) / n * 1e3


def as_mean(loss):
    """The f32 mean of a loss vector (an NDArray or a tensor), as
    ``TrainStep`` reduces it."""
    t = getattr(loss, "_data", loss)
    return float(t.detach().float().mean())


def gluon_cell(checks, tag, net, make_loss, opt, kw, per_loss, x, y,
               launches, twin):
    """One Gluon configuration: a warm-up step (it also fills the
    deferred shapes), ``GLUON_STEPS`` counted and timed steps whose
    launches must be exactly ``launches`` a step and whose losses must
    be finite, one profiled step, and ``twin()``'s TrainStep on the
    same configuration timed beside it in this process."""
    import torch
    from mxtpu_torch import kernels
    t0 = time.perf_counter()
    trainer, step = gluon_loop(net, make_loss, opt, kw, per_loss)
    first = as_mean(step(x, y))
    setup_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    losses, ms = timed_steps(step, x, y, GLUON_STEPS)
    update_host_ms = step.update_host_ms
    counts = kernels.launch_counts()
    losses = [first] + [as_mean(v) for v in losses]
    check_launches(checks, tag, counts, launches, GLUON_STEPS)
    if not np.isfinite(losses).all():
        checks.failed.append(f"{tag}: losses not finite: {losses}")
    n_params = len(trainer._params)
    bd = profiled_step(checks, tag, step, x, y)
    del trainer, step
    torch.cuda.empty_cache()
    tstep, tx, ty = twin()
    tstep(tx, ty)
    _, t_ms = timed_steps(tstep, tx, ty, GLUON_STEPS)
    tbd = profiled_step(checks, f"{tag} TrainStep", tstep, tx, ty)
    del tstep
    torch.cuda.empty_cache()
    upd = bd["ranges"]["update"]
    print(f"{tag}: gluon loop {ms:.3f} ms/step eager (mean of "
          f"{GLUON_STEPS}), device {bd['device_busy_ms']:.3f} ms a step, "
          f"idle share {bd['device_idle_share'] or 0:.4f}; Trainer update "
          f"of {n_params} parameters one at a time: host "
          f"{upd['host_ms']:.3f} ms in the profiled step "
          f"({update_host_ms:.3f} ms in the last timed one), device "
          f"{upd['device_ms']:.3f} ms; TrainStep beside it: {t_ms:.3f} "
          f"ms/step eager, device {tbd['device_busy_ms']:.3f} ms, update "
          f"host {tbd['ranges']['update']['host_ms']:.3f} ms device "
          f"{tbd['ranges']['update']['device_ms']:.3f} ms; losses "
          f"{[round(v, 5) for v in losses]}; launches in {GLUON_STEPS} "
          f"steps {json.dumps(counts)}; set-up and first step "
          f"{setup_s:.1f} s", flush=True)
    return counts, {"ms_per_step": ms, "device_ms": bd["device_busy_ms"],
                    "idle_share": bd["device_idle_share"],
                    "update_host_ms": upd["host_ms"],
                    "update_host_ms_unprofiled": update_host_ms,
                    "update_device_ms": upd["device_ms"],
                    "params": n_params, "losses": losses,
                    "breakdown": bd, "train_step_ms_per_step": t_ms,
                    "train_step_device_ms": tbd["device_busy_ms"],
                    "train_step_breakdown": tbd}


def gluon_gate(checks, tag, make, init, opt, kw, per_loss, x, y):
    """The Gluon step against ``TrainStep``: two nets with the same
    weights (f32, dropout 0), one Gluon step on one, one
    ``MXTPU_BATCHED_OPT=0`` TrainStep step on the other, on the same
    batch.  The losses and every weight must be equal bit for bit.

    Why, from the two paths' arithmetic: both compute the same f32 loss
    from the same forward (the same kernels on the same inputs).  The
    gradients differ by an exact power of two only, the sum-loss
    gradient times rescale_grad = 1/n against the mean-loss gradient
    (n = 4096 tokens or 64 images; scaling by 2^-k commutes with every
    rounding of the linear backward), and the update ops get the same
    f32 lr and wd.  Every backward on the path sums in a fixed order:
    the port's kernels, cuBLAS, cuDNN made deterministic here, and the
    embedding's backward (an accumulating index_put, which sorts its
    indices on the card).  So no slack is reasoned from rounding, and a
    Trainer step that leaves the weights unchanged (apart by lr under
    adam), flips the gradient's sign or misses a multiplier fails."""
    import torch
    from mxtpu_torch import random as trandom
    from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxtpu_torch.parallel import build_train_step
    trandom.seed(SEED + 12)
    a = make()
    a.initialize(init, ctx=CARD)
    settle(a, x[:1]._data)
    b = make()
    for pa, pb in zip(a.collect_params().values(),
                      b.collect_params().values()):
        pb.set_data(pa.data())
    _, gstep = gluon_loop(a, SoftmaxCrossEntropyLoss, opt, kw, per_loss)
    ce = SoftmaxCrossEntropyLoss()

    def loss_fn(pred, yy):
        return ce(*per_loss(pred, yy))
    with deterministic_cudnn():
        gl = as_mean(gstep(x, y))
        tstep = build_twin(lambda: build_train_step(
            b, loss_fn, opt, dict(kw), cast_batch=False, device=CARD),
            False)
        tl = float(tstep(x._data, y._data))
    worst, n_diff, n_all, ok = 0.0, 0, 0, gl == tl
    for (n, pa), pb in zip(a.collect_params().items(),
                           b.collect_params().values()):
        wa, wb = pa.data()._data.detach(), pb.data()._data.detach()
        d = (wa.double() - wb.double()).abs()
        worst = max(worst, float(d.max()))
        n_diff += int((d > 0).sum())
        n_all += d.numel()
        if wa.dtype != wb.dtype or not torch.equal(wa, wb):
            ok = False
            checks.failed.append(f"{tag}: {n} off its TrainStep twin by "
                                 f"up to {float(d.max()):.3e} (must be "
                                 f"bit for bit)")
    if gl != tl:
        checks.failed.append(f"{tag}: Gluon loss {gl!r} != TrainStep's "
                             f"{tl!r}")
    print(f"check {tag}: Gluon step vs TrainStep (f32, dropout 0, "
          f"per-parameter update): loss {gl!r} vs {tl!r}; weights: "
          f"{n_diff} of {n_all} elements differ (must be 0), by up to "
          f"{worst:.3e} {'ok' if ok else 'FAIL'}",
          flush=True)
    del a, b, gstep, tstep
    torch.cuda.empty_cache()
    return {"loss_gluon": gl, "loss_train_step": tl,
            "elements_differing": n_diff, "elements": n_all,
            "worst_abs_diff": worst, "ok": ok}


def gluon_train_phase(checks, card):
    """mxtpu's Gluon loop through the port's public API at full width:
    BERT-Large (b32 x T128, adam lr 1e-4, the MLM loss shaped as
    bench_bert shapes it) in f32 with dropout 0.1 and cast to bf16 with
    ``multi_precision=True``, and ResNet-50 v1 NHWC (b64 x 224^2, SGD
    momentum 0.9, lr 0.1, wd 1e-4, f32), each with its launch gate,
    ms/step beside TrainStep's and the Trainer update's host and device
    time; the Gluon step against TrainStep on each model; and the
    weights ``save_parameters`` wrote, loaded into a fresh
    ``bert_large()``, giving the f32 net's logits bit for bit."""
    import torch
    from mxtpu_torch import initializer, nd, random as trandom
    from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxtpu_torch.parallel import build_train_step
    counts, results = {}, {}
    toks = bert_tokens()
    x, y = nd.NDArray(toks), nd.NDArray(toks)

    def bert_twin(compute_dtype):
        def twin():
            return seeded_bert_step(compute_dtype), toks, toks
        return twin

    for prec in ("float32", "bfloat16"):
        tag = f"gluon BERT-Large {prec}"
        trandom.seed(SEED + 10)
        net = gluon_bert_model(0.1)
        net.initialize(init="xavier", ctx=CARD)
        kw = dict(GLUON_BERT_ADAM)
        if prec == "bfloat16":
            settle(net, toks[:1])
            net.cast("bfloat16")
            kw["multi_precision"] = True
        counts[tag], results[tag] = gluon_cell(
            checks, tag, net, SoftmaxCrossEntropyLoss, "adam", kw,
            bert_mlm, x, y, BERT_LAUNCHES,
            bert_twin(None if prec == "float32" else "bfloat16"))
        if prec == "float32":
            out_dir = ROOT / "mxtpu_torch" / "_build"
            out_dir.mkdir(exist_ok=True)
            path = str(out_dir / "gluon_bert.params")
            t0 = time.perf_counter()
            net.save_parameters(path)
            fresh = gluon_bert_model(0.1)
            fresh.load_parameters(path, ctx=CARD)
            os.remove(path)
            with torch.no_grad():
                same = torch.equal(net(toks), fresh(toks))
            print(f"check {tag}: save_parameters -> a fresh bert_large()'s "
                  f"load_parameters gives the logits bit for bit: "
                  f"{'ok' if same else 'FAIL'} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            if not same:
                checks.failed.append(f"{tag}: reloaded weights give other "
                                     f"logits")
            results[tag]["reload_bit_equal"] = same
            del fresh
        del net
        torch.cuda.empty_cache()

    xn, yn = rn_batch("NHWC", GLUON_RN_B, RN_HW, SEED + 13)
    rx, ry = torch.from_numpy(xn).to(CARD), torch.from_numpy(yn).to(CARD)

    def rn_twin():
        trandom.seed(SEED + 10)
        net = gluon_resnet_model()
        net.initialize(initializer.Xavier(), ctx=CARD)
        settle(net, rx[:1])
        return build_train_step(net, rn_loss(), "sgd", RN_SGD,
                                device=CARD), rx, ry
    tag = "gluon resnet50 NHWC float32"
    trandom.seed(SEED + 10)
    net = gluon_resnet_model()
    net.initialize(initializer.Xavier(), ctx=CARD)
    counts[tag], results[tag] = gluon_cell(
        checks, tag, net, SoftmaxCrossEntropyLoss, "sgd", RN_SGD,
        lambda o, l: (o, l), nd.NDArray(rx), nd.NDArray(ry),
        RN_NHWC_LAUNCHES, rn_twin)
    del net
    torch.cuda.empty_cache()

    results["gate bert"] = gluon_gate(
        checks, "gluon gate BERT-Large", lambda: gluon_bert_model(0.0),
        "xavier", "adam", GLUON_BERT_ADAM, bert_mlm, x, y)
    results["gate resnet"] = gluon_gate(
        checks, "gluon gate resnet50 NHWC", gluon_resnet_model,
        initializer.Xavier(), "sgd", RN_SGD, lambda o, l: (o, l),
        nd.NDArray(rx), nd.NDArray(ry))
    return counts, results


# ----------------------------------------------------------------------
# rtc: user kernels compiled at run time, and a CustomOp softmax head
# ----------------------------------------------------------------------

# User code, as MXNet's example/numpy-ops/custom_softmax_rtc.py writes
# its head: kernels kept as CUDA C++ source, compiled by
# mxtpu_torch.rtc.CudaModule and launched from a CustomOp.  Each kernel
# has its plain PyTorch version beside it (RTC_PLAIN).
RTC_SOURCE = r"""
// y = 2x (the JAX package's PallasKernel test body)
extern "C" __global__ void double_kernel(const float *x, float *y,
                                         long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x)
    y[i] = 2.0f * x[i];
}

// the max (max = 1) or the sum (max = 0) of v over a warp
__device__ float warp_reduce(float v, bool max) {
  for (int o = 16; o > 0; o >>= 1) {
    float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = max ? fmaxf(v, w) : v + w;
  }
  return v;
}

// the same over the block, in f32; blockDim.x is a multiple of 32, at
// most 1024
__device__ float block_reduce(float v, bool max) {
  __shared__ float part[32];
  v = warp_reduce(v, max);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  int warps = blockDim.x >> 5;
  v = lane < warps ? part[lane] : (max ? -INFINITY : 0.0f);
  v = warp_reduce(v, max);
  __syncthreads();  // part[] is reused by the next call
  return v;
}

// p = softmax(x) over each row of a (rows, cols) f32 array, x read once
// from device memory (the launch geometry is rtc_softmax_geometry's):
//  * cols <= SM_WARP_COLS: a warp a row, blockDim.x / 32 rows a CTA;
//    lane l keeps x[l + 32 k] in registers between the warp's max and
//    its sum of exp(x - max), then writes p;
//  * wider, one CTA a row: its 16-byte aligned body as float4s, thread t
//    holding float4s t + k * blockDim.x (k < SM_VEC), in registers, the
//    elements before the first 16-byte boundary (the peel, 0-3: a row of
//    30522 floats starts 8 bytes off one in every other row) and the
//    last 0-3 after the body each held by one of threads 0-3; block
//    reductions for the max and the sum, then 16-byte stores (p's rows
//    must sit as x's do against 16 bytes);
//  * a row past SM_VEC * 4 * blockDim.x floats, or p aligned unlike x:
//    three passes over x (the max, the sum, the write), right for any
//    cols.
#define SM_WARP_COLS 1024
#define SM_VEC 8
extern "C" __global__ void __launch_bounds__(1024)
softmax_fwd(const float *x, float *p, int rows, int cols) {
  if (cols <= SM_WARP_COLS) {
    const int lane = threadIdx.x & 31;
    const long long row =
        (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (row >= rows) return;  // the whole warp: no block barrier here
    const float *xr = x + row * cols;
    float *pr = p + row * cols;
    float v[32];
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (32 * k >= cols) break;
      const int j = lane + 32 * k;
      v[k] = j < cols ? xr[j] : -INFINITY;
      m = fmaxf(m, v[k]);
    }
    m = warp_reduce(m, true);
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (32 * k >= cols) break;  // the same for the whole warp
      if (lane + 32 * k < cols) {
        v[k] = expf(v[k] - m);
        s += v[k];
      }
    }
    s = warp_reduce(s, false);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (32 * k >= cols) break;
      const int j = lane + 32 * k;
      if (j < cols) pr[j] = v[k] / s;
    }
    return;
  }
  const long long row = blockIdx.x;
  if (row >= rows) return;  // the whole block
  const float *xr = x + row * cols;
  float *pr = p + row * cols;
  const int t = threadIdx.x, nt = blockDim.x;
  const int h = (int)(((16 - ((unsigned long long)xr & 15)) & 15) >> 2);
  const int hp = (int)(((16 - ((unsigned long long)pr & 15)) & 15) >> 2);
  const int nv = (cols - h) >> 2, tl = cols - h - 4 * nv;
  if (h == hp && nv <= SM_VEC * nt) {
    const float4 *x4 = reinterpret_cast<const float4 *>(xr + h);
    float4 q[SM_VEC];
    const float pe = t < h ? xr[t] : -INFINITY;
    const float te = t < tl ? xr[h + 4 * nv + t] : -INFINITY;
    float m = fmaxf(pe, te);
#pragma unroll
    for (int k = 0; k < SM_VEC; ++k) {
      const int i = t + k * nt;
      q[k] = i < nv ? x4[i]
                    : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      m = fmaxf(m, fmaxf(fmaxf(q[k].x, q[k].y), fmaxf(q[k].z, q[k].w)));
    }
    m = block_reduce(m, true);
    const float ep = t < h ? expf(pe - m) : 0.0f;
    const float et = t < tl ? expf(te - m) : 0.0f;
    float s = ep + et;
#pragma unroll
    for (int k = 0; k < SM_VEC; ++k) {
      if (t + k * nt < nv) {
        q[k] = make_float4(expf(q[k].x - m), expf(q[k].y - m),
                           expf(q[k].z - m), expf(q[k].w - m));
        s += (q[k].x + q[k].y) + (q[k].z + q[k].w);
      }
    }
    s = block_reduce(s, false);
    float4 *p4 = reinterpret_cast<float4 *>(pr + h);
    if (t < h) pr[t] = ep / s;
    if (t < tl) pr[h + 4 * nv + t] = et / s;
#pragma unroll
    for (int k = 0; k < SM_VEC; ++k) {
      const int i = t + k * nt;
      if (i < nv)
        p4[i] = make_float4(q[k].x / s, q[k].y / s, q[k].z / s, q[k].w / s);
    }
    return;
  }
  float m = -INFINITY;
  for (int j = t; j < cols; j += nt) m = fmaxf(m, xr[j]);
  m = block_reduce(m, true);
  float s = 0.0f;
  for (int j = t; j < cols; j += nt) s += expf(xr[j] - m);
  s = block_reduce(s, false);
  for (int j = t; j < cols; j += nt) pr[j] = expf(xr[j] - m) / s;
}

// dx = p - onehot(label): SoftmaxOutput's backward with grad_scale 1
// and normalization "null"; the label is a float per row
extern "C" __global__ void softmax_bwd(const float *p, const float *label,
                                       float *dx, int rows, int cols) {
  long long n = (long long)rows * cols;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    int r = (int)(i / cols), c = (int)(i - (long long)r * cols);
    dx[i] = p[i] - (c == (int)label[r] ? 1.0f : 0.0f);
  }
}
"""
RTC_SIGNATURES = {
    "double_kernel": "const float *x, float *y, long long n",
    "softmax_fwd": "const float *x, float *p, int rows, int cols",
    "softmax_bwd": "const float *p, const float *label, float *dx, "
                   "int rows, int cols"}
# the (rows, cols) the main path gives the head (the batch and the
# classes) and a real softmax width on this card (BERT-Large's MLM
# logits at b32 x T128)
RTC_SHAPES = {"head": (128, 10), "mlm": (4096, 30522)}
# softmax_fwd's geometry (its SM_WARP_COLS and SM_VEC): a warp a row up
# to RTC_WARP_COLS columns, RTC_WARP_ROWS rows a CTA; past it a CTA of
# RTC_ROW_THREADS a row, each thread holding RTC_VEC float4s of it
RTC_WARP_COLS, RTC_WARP_ROWS, RTC_VEC, RTC_ROW_THREADS = 1024, 8, 8, 1024
# an odd width past the vector path's multiple of 4, on the row path
RTC_ODD = (33, 30521)
RTC_P_TOL, RTC_DX_TOL = 1e-6, 1e-6
ELEMENTWISE_BLOCKS = 1056   # 8 CTAs per SM of 132, grid-stride loops


def rtc_plain(name, *args):
    """The plain PyTorch version of each user kernel."""
    import torch
    import torch.nn.functional as F
    if name == "double_kernel":
        return 2 * args[0]
    if name == "softmax_fwd":
        return torch.softmax(args[0], -1)
    p, label = args
    return p - F.one_hot(label.long(), p.shape[-1]).to(p.dtype)


_RTC = {}


def rtc_kernels():
    """The user kernels, compiled once per process: name -> CudaKernel,
    plus the build seconds under ``"build_s"``."""
    if not _RTC:
        from mxtpu_torch import rtc
        t0 = time.perf_counter()
        module = rtc.CudaModule(RTC_SOURCE, exports=list(RTC_SIGNATURES))
        _RTC["build_s"] = time.perf_counter() - t0
        _RTC["nvcc_s"] = module.build_seconds
        for name, sig in RTC_SIGNATURES.items():
            _RTC[name] = module.get_kernel(name, sig)
    return _RTC


def rtc_softmax_geometry(rows, cols):
    """softmax_fwd's (grid, block): RTC_WARP_ROWS rows a CTA of warps up
    to RTC_WARP_COLS columns, a CTA of RTC_ROW_THREADS a row past it."""
    if cols <= RTC_WARP_COLS:
        return (-(-rows // RTC_WARP_ROWS), 1, 1), (32 * RTC_WARP_ROWS, 1, 1)
    return (rows, 1, 1), (RTC_ROW_THREADS, 1, 1)


def rtc_launch(name, out, *args):
    """Launch user kernel ``name`` writing ``out`` (NDArrays on the
    card): the softmax at :func:`rtc_softmax_geometry`, a grid-stride
    grid for the elementwise kernels."""
    k = rtc_kernels()[name]
    ctx = out.context
    if name == "softmax_fwd":
        rows, cols = out.shape
        k.launch([args[0], out, rows, cols], ctx,
                 *rtc_softmax_geometry(rows, cols))
    elif name == "softmax_bwd":
        rows, cols = out.shape
        blocks = min(ELEMENTWISE_BLOCKS, -(-rows * cols // 256))
        k.launch([args[0], args[1], out, rows, cols], ctx, (blocks, 1, 1),
                 (256, 1, 1))
    else:
        n = out.size
        k.launch([args[0], out, n], ctx,
                 (min(ELEMENTWISE_BLOCKS, -(-n // 256)), 1, 1), (256, 1, 1))
    return out


def register_softmax_rtc():
    """Register the CustomOp ``softmax_rtc``: a softmax output layer
    whose forward and backward launch the rtc kernels for arrays on the
    card and run their plain versions for arrays on the CPU.  Its
    backward is ``p - onehot(label)`` and ignores the incoming gradient,
    as SoftmaxOutput's does."""
    from mxtpu_torch import MXNetError, operator
    from mxtpu_torch.ndarray import NDArray
    try:
        return operator.get_custom_op("softmax_rtc")
    except MXNetError:
        pass   # not registered yet

    def run(name, like, *ins):
        if like.context.type == "cuda":
            import torch
            out = NDArray(torch.empty_like(like.data))
            return rtc_launch(name, out, *ins)
        return NDArray(rtc_plain(name, *[a.data for a in ins]))

    class SoftmaxRtc(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        run("softmax_fwd", in_data[0], in_data[0]))

        def backward(self, req, out_grad, in_data, out_data, in_grad,
                     aux):
            self.assign(in_grad[0], req[0],
                        run("softmax_bwd", out_data[0], out_data[0],
                            in_data[1]))
            self.assign(in_grad[1], req[1], 0 * in_data[1])

    @operator.register("softmax_rtc")
    class SoftmaxRtcProp(operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return SoftmaxRtc()
    return SoftmaxRtcProp


def host_us(fn, n=2000):
    """Host microseconds per call of ``fn`` (no sync inside the loop)."""
    import torch
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def rtc_phase(checks):
    """The user kernels through CudaModule: build, exactness of y = 2x,
    the softmax kernels against their plain versions at the head's and
    an MLM-width shape, device times beside the bound, the plain version
    and the library call, the host cost of one launch, and the
    refusals.  Returns the kernels line's timing rows."""
    import torch
    import torch.nn.functional as F
    from mxtpu_torch import MXNetError, rtc
    from mxtpu_torch.ndarray import NDArray
    ks = rtc_kernels()
    print(f"rtc: CudaModule of {len(RTC_SIGNATURES)} kernels built in "
          f"{ks['build_s']:.2f} s (nvcc {ks['nvcc_s']:.2f} s)", flush=True)
    gen = torch.Generator(device=CARD).manual_seed(SEED + 20)
    for shape in ((8, 128), (4096, 4096)):
        x = torch.randn(shape, device=CARD, generator=gen)
        y = rtc_launch("double_kernel", NDArray(torch.empty_like(x)),
                       NDArray(x)).data
        torch.cuda.synchronize()
        ok = torch.equal(y, rtc_plain("double_kernel", x))
        print(f"check rtc double_kernel {shape}: exact "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        checks.rows.append({"check": f"rtc double_kernel {shape}",
                            "ok": ok})
        if not ok:
            checks.failed.append(f"rtc double_kernel {shape} not exact")
    timings = {}
    # the odd width from a generator of its own, after the timed shapes,
    # so theirs draw what they drew before it
    ogen = torch.Generator(device=CARD).manual_seed(SEED + 21)
    for tag, (rows, cols) in (*RTC_SHAPES.items(), ("odd", RTC_ODD)):
        x = torch.randn(rows, cols, device=CARD,
                        generator=ogen if tag == "odd" else gen) * 4
        label = torch.randint(0, cols, (rows,), device=CARD,
                              generator=ogen if tag == "odd" else gen
                              ).float()
        xn, ln = NDArray(x), NDArray(label)
        p = NDArray(torch.empty_like(x))
        dx = NDArray(torch.empty_like(x))
        rtc_launch("softmax_fwd", p, xn)
        rtc_launch("softmax_bwd", dx, p, ln)
        torch.cuda.synchronize()
        pw = rtc_plain("softmax_fwd", x)
        dw = rtc_plain("softmax_bwd", pw, label)
        prel, pabs = rel_err(p.data, pw, floor=1e-30)
        # dx from the same p the kernel read, so the check is the
        # backward's own arithmetic
        dabs = float((dx.data - rtc_plain("softmax_bwd", p.data, label))
                     .abs().max())
        dabs_e2e = float((dx.data - dw).abs().max())
        ok = prel <= RTC_P_TOL and dabs <= RTC_DX_TOL and \
            dabs_e2e <= RTC_DX_TOL
        print(f"check rtc softmax {tag} ({rows}, {cols}) f32: p max rel "
              f"{prel:.3e} (abs {pabs:.3e}, tol {RTC_P_TOL} rel); dx max "
              f"abs {dabs:.3e} from the kernel's p, {dabs_e2e:.3e} from "
              f"torch.softmax's (tol {RTC_DX_TOL}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        checks.rows.append({"check": f"rtc softmax {tag}", "p_rel": prel,
                            "dx_abs": dabs, "dx_abs_e2e": dabs_e2e,
                            "ok": ok})
        if not ok:
            checks.failed.append(f"rtc softmax {tag} off: p {prel:.3e}, "
                                 f"dx {dabs:.3e}/{dabs_e2e:.3e}")
        if tag == "odd":
            continue
        xg = x.clone().requires_grad_(True)
        lg = label.long()

        def ce_backward():
            xg.grad = None
            F.cross_entropy(xg, lg, reduction="sum").backward()
        n = rows * cols * 4
        fb, fby = bound(2 * n, 4 * rows * cols, "float32")
        bb, bby = bound(2 * n + rows * 4, rows * cols, "float32")
        timings[("rtc_softmax_fwd", tag)] = {
            **timed(lambda: rtc_launch("softmax_fwd", p, xn),
                    lambda: rtc_plain("softmax_fwd", x),
                    lambda: torch.softmax(x, -1)),
            "bound_ms": fb, "bound_by": fby, "max_abs_err": pabs}
        timings[("rtc_softmax_bwd", tag)] = {
            **timed(lambda: rtc_launch("softmax_bwd", dx, p, ln),
                    lambda: rtc_plain("softmax_bwd", pw, label),
                    ce_backward),
            "bound_ms": bb, "bound_by": bby, "max_abs_err": dabs}
    x = torch.randn(*RTC_SHAPES["head"], device=CARD, generator=gen)
    xn, p = NDArray(x), NDArray(torch.empty_like(x))
    k = ks["softmax_fwd"]
    rows, cols = RTC_SHAPES["head"]
    grid, block = rtc_softmax_geometry(rows, cols)
    launch_us = host_us(lambda: k.launch([xn, p, rows, cols], CARD, grid,
                                         block))
    softmax_us = host_us(lambda: torch.softmax(x, -1))
    print(f"rtc: host cost per call at {RTC_SHAPES['head']}: "
          f"CudaKernel.launch {launch_us:.2f} us, torch.softmax "
          f"{softmax_us:.2f} us", flush=True)
    # refusals: each must raise MXNetError
    refusals = {
        "a float64 array for float *": lambda: k.launch(
            [NDArray(x.double()), p, rows, cols], CARD, grid, block),
        "an array on the CPU": lambda: k.launch(
            [NDArray(x.cpu()), p, rows, cols], CARD, grid, block),
        "a CPU ctx": lambda: k.launch([xn, p, rows, cols], "cpu", grid,
                                      block),
        "a float for int cols": lambda: k.launch([xn, p, rows, 10.0], CARD,
                                                 grid, block),
        "a bool for int cols": lambda: k.launch([xn, p, rows, True], CARD,
                                                grid, block),
        "a non-contiguous array": lambda: k.launch(
            [NDArray(x.t()), p, rows, cols], CARD, grid, block),
        "an NDArray's place taken by a list": lambda: k.launch(
            [[1.0], p, rows, cols], CARD, grid, block),
        "zero grid dims": lambda: k.launch([xn, p, rows, cols], CARD,
                                           (0, 1, 1), block),
        "a float block dim": lambda: k.launch([xn, p, rows, cols], CARD,
                                              grid, (32.0, 1, 1)),
        "too few arguments": lambda: k.launch([xn, p, rows], CARD, grid,
                                              block),
        "a source that does not compile": lambda: rtc.CudaModule(
            'extern "C" __global__ void broken(float *x) { x[0] = y; }'),
        "an export that is not in the source": lambda: rtc.CudaModule(
            RTC_SOURCE, exports=["softmax_fwd", "no_such_kernel"]),
    }
    for what, call in refusals.items():
        try:
            call()
        except MXNetError:
            ok = True
        else:
            ok = False
        print(f"check rtc refuses {what}: {'ok' if ok else 'FAIL'}",
              flush=True)
        checks.rows.append({"check": f"rtc refuses {what}", "ok": ok})
        if not ok:
            checks.failed.append(f"rtc did not refuse {what}")
    torch.cuda.synchronize()
    for (name, tag), r in timings.items():
        print(f"time {name} {tag} [float32] (device ms per call): "
              f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} bound_ms="
              f"{r['bound_ms']:.4f} ({r['bound_by']}); kernel wall_ms="
              f"{r['wall_ms']:.4f}", flush=True)
    return timings, {"build_s": ks["build_s"], "nvcc_s": ks["nvcc_s"],
                     "launch_host_us": launch_us,
                     "softmax_host_us": softmax_us}


# ----------------------------------------------------------------------
# the symbolic API: train_cifar10's resnet20 through Module.fit
# ----------------------------------------------------------------------

CIFAR_B, CIFAR_CLASSES, CIFAR_LAYERS, CIFAR_SYNTH = 128, 10, 20, 2048
# train_cifar10's defaults through common_fit.fit
CIFAR_SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4,
             "rescale_grad": 1.0 / CIFAR_B}
SYM_CHECK_B = 16
# the check steps at lr 1e-3, as the ResNet check does
SYM_CHECK_SGD = {**CIFAR_SGD, "learning_rate": 1e-3,
                 "rescale_grad": 1.0 / SYM_CHECK_B}
SYM_OUT_TOL, SYM_RTC_TOL = 1e-5, 1e-6
# ReLU inputs per million whose sign may differ between the card and
# the CPU (rounding within 1e-7 of 0; an H100 run measured 2 of 3.0 M)
MAX_FLIPS_PER_M = 5
SYM_WINDOW = 4   # batches per timing window (batches 2-13 of 14)
SYM_LAUNCHES = {"batch_norm_fwd": 19, "batch_norm_bwd": 19}
RTC_LAUNCHES = {"softmax_fwd": 1, "softmax_bwd": 1}


def residual_unit(mx, data, num_filter, stride, dim_match, name):
    """examples/train_cifar10.py's residual_unit, as written there."""
    bn1 = mx.sym.BatchNorm(data, fix_gamma=False, name=name + "_bn1")
    act1 = mx.sym.Activation(bn1, act_type="relu")
    conv1 = mx.sym.Convolution(act1, num_filter=num_filter,
                               kernel=(3, 3), stride=(stride, stride),
                               pad=(1, 1), no_bias=True,
                               name=name + "_conv1")
    bn2 = mx.sym.BatchNorm(conv1, fix_gamma=False, name=name + "_bn2")
    act2 = mx.sym.Activation(bn2, act_type="relu")
    conv2 = mx.sym.Convolution(act2, num_filter=num_filter,
                               kernel=(3, 3), stride=(1, 1),
                               pad=(1, 1), no_bias=True,
                               name=name + "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = mx.sym.Convolution(act1, num_filter=num_filter,
                                      kernel=(1, 1),
                                      stride=(stride, stride),
                                      no_bias=True, name=name + "_sc")
    return conv2 + shortcut


def resnet_cifar(mx, num_classes=10, num_layers=20, head=True):
    """examples/train_cifar10.py's resnet_cifar; ``head=False`` ends at
    ``fc`` (the logits), for the rtc head."""
    n = (num_layers - 2) // 6
    data = mx.sym.Variable("data")
    body = mx.sym.Convolution(data, num_filter=16, kernel=(3, 3),
                              stride=(1, 1), pad=(1, 1), no_bias=True,
                              name="conv0")
    for stage, filters in enumerate((16, 32, 64)):
        for unit in range(n):
            stride = 2 if stage > 0 and unit == 0 else 1
            body = residual_unit(mx, body, filters, stride,
                                 dim_match=(stage == 0 or unit > 0),
                                 name=f"stage{stage}_unit{unit}")
    bn = mx.sym.BatchNorm(body, fix_gamma=False, name="bn_final")
    act = mx.sym.Activation(bn, act_type="relu")
    pool = mx.sym.Pooling(act, global_pool=True, pool_type="avg",
                          kernel=(8, 8))
    flat = mx.sym.Flatten(pool)
    fc = mx.sym.FullyConnected(flat, num_hidden=num_classes, name="fc")
    return mx.sym.SoftmaxOutput(fc, name="softmax") if head else fc


def load_cifar(mx, batch_size, n_synth=CIFAR_SYNTH, seed=SEED):
    """train_cifar10.load_cifar's synthetic fallback (numpy seed 0),
    with the train iterator shuffling from RandomState(seed)."""
    rng = np.random.RandomState(0)
    X = rng.rand(n_synth, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 2, n_synth).astype(np.float32)
    X[:, 0] += y[:, None, None] * 0.3
    split = int(0.9 * len(X))
    train = mx.io.NDArrayIter(X[:split], y[:split], batch_size=batch_size,
                              shuffle=True, last_batch_handle="discard",
                              rng=np.random.RandomState(seed))
    val = mx.io.NDArrayIter(X[split:], y[split:], batch_size=batch_size,
                            last_batch_handle="discard")
    return train, val


def ce_loss(probs, label):
    """Mean cross entropy of softmax probabilities (host numpy)."""
    p = probs[np.arange(len(label)), label.astype(int)]
    return float(-np.mean(np.log(np.maximum(p, 1e-30))))


def rtc_head_step(mx, mod, batch):
    """One step of the rtc head on a Module ending at the logits:
    forward, the softmax_rtc CustomOp under autograd.record, its
    backward into the logits, the explicit-cotangent backward through
    the Module, the update.  Returns (probabilities, logits gradient)."""
    mod.forward(batch, is_train=True)
    logits = mod.get_outputs()[0]
    label = batch.label[0].as_in_context(logits.context)
    logits.attach_grad()
    with mx.autograd.record():
        p = mx.operator.Custom(logits, label, op_type="softmax_rtc")
    p.backward()
    mod.backward(out_grads=[logits.grad])
    mod.update()
    return p, logits.grad


def params_rel(a, b):
    """The largest over tensors of max |a - b| / max |b|."""
    worst = 0.0
    for n in b:
        d = float((a[n].data.double() - b[n].data.double().to(
            a[n].data.device)).abs().max())
        worst = max(worst, d / max(float(b[n].data.abs().max()), 1e-30))
    return worst


def relu_inputs(mx, sym, m):
    """Module ``m``'s inputs to each ReLU of resnet20 (every BatchNorm's
    output 0) at its last bound batch, by BatchNorm name, on the
    CPU."""
    ints = sym.get_internals()
    names = [n for n in ints.list_outputs() if n.endswith("_output0")]
    group = mx.sym.Group([ints[n] for n in names])
    ex = group.bind(ctx=m.context, grad_req="null", args={
        k: m._exec.arg_dict[k] for k in group.list_arguments()},
        aux_states={k: m._exec.aux_dict[k]
                    for k in group.list_auxiliary_states()})
    return {n[:-len("_output0")]: o.data.cpu()
            for n, o in zip(names, ex.forward())}


def relu_flips(a, b):
    """Elements where two runs' ReLU inputs differ in sign: where
    rounding alone routes a gradient differently."""
    return int(sum(int(((a[n] > 0) != (b[n] > 0)).sum()) for n in a))


def masked_twin(mx, sym, relu_in):
    """``sym`` with each ReLU of a BatchNorm output replaced by a
    product with a mask variable ``<bn>_relu_mask``, and the masks
    ``relu_in > 0``: a twin whose gradients follow the given ReLU masks
    exactly, whatever the signs it computes itself."""
    graph = json.loads(sym.tojson())
    nodes, masks = graph["nodes"], {}
    for node in list(nodes):
        src = nodes[node["inputs"][0][0]] if node["inputs"] else None
        if node["op"] == "Activation" and src is not None and \
                src["name"] in relu_in:
            mid = len(nodes)
            name = f"{src['name']}_relu_mask"
            nodes.append({"op": "null", "name": name, "inputs": [],
                          "attrs": {"__shape__": str(tuple(
                              relu_in[src["name"]].shape))}})
            graph["arg_nodes"].append(mid)
            node["op"], node["attrs"] = "broadcast_mul", {}
            node["inputs"] = [node["inputs"][0], [mid, 0, 0]]
            masks[name] = (relu_in[src["name"]] > 0).float()
    return mx.sym.fromjson(json.dumps(graph)), masks


def symbolic_check_phase(checks):
    """resnet20 at full width, b16, through the symbolic API: the card's
    Module against the same Module on the CPU from equal parameters
    (outputs, every gradient, three SGD steps), the rtc head against
    SoftmaxOutput on the card over three steps, and a checkpoint round
    trip that must predict bit for bit."""
    import torch
    import mxtpu_torch as mx
    register_softmax_rtc()
    t0 = time.perf_counter()
    sym = resnet_cifar(mx, CIFAR_CLASSES, CIFAR_LAYERS)
    rng = np.random.RandomState(SEED + 30)
    X = rng.rand(3 * SYM_CHECK_B, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, CIFAR_CLASSES, 3 * SYM_CHECK_B).astype(np.float32)
    shapes = ([("data", (SYM_CHECK_B, 3, 32, 32))],
              [("softmax_label", (SYM_CHECK_B,))])

    def batch(i):
        s = slice(i * SYM_CHECK_B, (i + 1) * SYM_CHECK_B)
        return mx.io.DataBatch([mx.nd.array(X[s], ctx="cpu")],
                               [mx.nd.array(y[s], ctx="cpu")])

    def module(ctx, s=sym, params=None):
        labels = [n for n in ("softmax_label",) if n in s.list_arguments()]
        m = mx.mod.Module(s, context=ctx, label_names=labels)
        m.bind(*shapes)
        if params is None:
            mx.random.seed(SEED + 31)
            m.init_params(mx.init.Xavier())
        else:
            m.set_params(*params)
        m.init_optimizer(optimizer="sgd", optimizer_params=SYM_CHECK_SGD)
        return m
    cpu = module("cpu")
    params = cpu.get_params()
    card = module(CARD, params=params)
    out_err = 0.0
    for is_train in (False, True):
        for m in (card, cpu):
            m.forward(batch(0), is_train=is_train)
        out_err = max(out_err, float((card.get_outputs()[0].data.cpu() -
                                      cpu.get_outputs()[0].data).abs()
                                     .max()))
    for m in (card, cpu):
        m.backward()
    errs, sq_d, sq_r = [], 0.0, 0.0
    for n in cpu._param_names:
        a = card._exec.grad_dict[n].data.double().cpu()
        b = cpu._exec.grad_dict[n].data.double()
        r = float(b.pow(2).mean().sqrt())
        d = float((a - b).pow(2).mean().sqrt())
        errs.append((d / max(r, 1e-30), n, r))
        sq_d += float((a - b).pow(2).sum())
        sq_r += float(b.pow(2).sum())
    global_grad = (sq_d / sq_r) ** 0.5
    card_relu = relu_inputs(mx, sym, card)
    flips = relu_flips(card_relu, relu_inputs(mx, sym, cpu))
    # the gradients are held against a CPU run whose ReLUs take the
    # card's masks: an input within rounding of 0 may take either sign
    # on either side (f32 sums in another order), and one such flip
    # moves a BatchNorm's gradients by percents
    twin, masks = masked_twin(mx, sym, card_relu)
    tm = mx.mod.Module(twin, context="cpu", fixed_param_names=list(masks))
    tm.bind(*shapes)
    tm.set_params({**params[0], **{k: mx.nd.NDArray(v) for k, v in
                                   masks.items()}}, params[1])
    tm.forward_backward(batch(0))
    worst_grad = 0.0
    for n in cpu._param_names:
        a = card._exec.grad_dict[n].data.double().cpu()
        b = tm._exec.grad_dict[n].data.double()
        r = float(b.pow(2).mean().sqrt())
        d = float((a - b).pow(2).mean().sqrt())
        worst_grad = max(worst_grad, d / max(r, 1e-30))
    print(f"symbolic resnet20 card vs CPU gradients: against the CPU's "
          f"own masks the worst tensors "
          f"{[(n, round(e, 8)) for e, n, _ in sorted(errs)[-3:]]} and all "
          f"together {global_grad:.3e} of their rms; against the CPU with "
          f"the card's masks the worst {worst_grad:.3e}", flush=True)
    losses = {"card": [], "cpu": []}
    for tag, m in (("card", module(CARD, params=params)),
                   ("cpu", module("cpu", params=params))):
        for i in range(3):
            m.forward_backward(batch(i))
            losses[tag].append(ce_loss(m.get_outputs()[0].asnumpy(),
                                       y[i * SYM_CHECK_B:
                                         (i + 1) * SYM_CHECK_B]))
            m.update()
    step_err = max(abs(a - b) / max(abs(b), RN_LOSS_FLOOR)
                   for a, b in zip(losses["card"], losses["cpu"]))
    n_relu = sum(v.numel() for v in masks.values())
    max_flips = MAX_FLIPS_PER_M * n_relu / 1e6
    ok = out_err <= SYM_OUT_TOL and worst_grad <= GRAD_TOL and \
        step_err <= STEP_TOL and flips <= max_flips
    print(f"check symbolic resnet20 b{SYM_CHECK_B} f32 card vs CPU: "
          f"outputs max abs {out_err:.3e} (tol {SYM_OUT_TOL}); ReLU "
          f"inputs of different sign {flips} of {n_relu} (tol "
          f"{MAX_FLIPS_PER_M} per million, {max_flips:.1f}); gradients "
          f"over {len(cpu._param_names)} tensors (the CPU with the card's "
          f"ReLU masks) worst rms error {worst_grad:.3e} of the tensor's "
          f"rms (tol {GRAD_TOL}); three "
          f"SGD steps (lr {SYM_CHECK_SGD['learning_rate']}) losses "
          f"{losses['card']} vs {losses['cpu']} (max err {step_err:.3e} of "
          f"max(|p|, {RN_LOSS_FLOOR}), tol {STEP_TOL}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    checks.rows.append({"check": "symbolic resnet20 card vs CPU",
                        "out_abs": out_err, "worst_grad_rel": worst_grad,
                        "relu_flips": flips,
                        "worst_grad_rel_own_masks": max(errs)[0],
                        "step_losses_card": losses["card"],
                        "step_losses_cpu": losses["cpu"],
                        "step_rel": step_err, "ok": ok})
    if not ok:
        checks.failed.append(f"symbolic card vs CPU: outputs {out_err:.3e}"
                             f", ReLU sign flips {flips} of {n_relu}, "
                             f"grads {worst_grad:.3e}, steps "
                             f"{step_err:.3e}")

    # the rtc head against SoftmaxOutput, on the card, from equal params,
    # with cuDNN's deterministic algorithms: its default ones may sum in
    # another order from run to run, which alone moves the parameters
    # by up to 2.4e-3 (relative, a BatchNorm beta near 0) in three steps
    # (16 ReLU inputs change sign; measured on an H100), so only the
    # heads differ
    torch.backends.cudnn.deterministic = True
    so = module(CARD, params=params)
    head = module(CARD, s=sym.get_internals()["fc_output"], params=params)
    g_err = 0.0
    for i in range(3):
        b = batch(i)
        so.forward_backward(b)
        p_so = so.get_outputs()[0].data
        so.update()
        p_rtc, g_rtc = rtc_head_step(mx, head, b)
        lab = b.label[0].data.to(CARD)
        g_err = max(g_err, float((g_rtc.data - rtc_plain(
            "softmax_bwd", p_so, lab)).abs().max()))
    torch.backends.cudnn.deterministic = False
    p_err = params_rel(head.get_params()[0], so.get_params()[0])
    ok = g_err <= SYM_RTC_TOL and p_err <= SYM_RTC_TOL
    print(f"check symbolic rtc head vs SoftmaxOutput on the card, three "
          f"steps (cuDNN deterministic): logits gradient max abs "
          f"{g_err:.3e}, parameters max rel {p_err:.3e} (tol "
          f"{SYM_RTC_TOL}) {'ok' if ok else 'FAIL'}", flush=True)
    checks.rows.append({"check": "symbolic rtc head vs SoftmaxOutput",
                        "logits_grad_abs": g_err, "params_rel": p_err,
                        "ok": ok})
    if not ok:
        checks.failed.append(f"rtc head vs SoftmaxOutput: grad {g_err:.3e}"
                             f", params {p_err:.3e}")

    # checkpoint round trip: save, load, predict bit for bit
    out_dir = ROOT / "mxtpu_torch" / "_build" / "chip_smoke_ckpt"
    out_dir.mkdir(parents=True, exist_ok=True)
    prefix = str(out_dir / "resnet20")
    so.save_checkpoint(prefix, 1)
    s2, a2, x2 = mx.model.load_checkpoint(prefix, 1, ctx=CARD)
    re = mx.mod.Module(s2, context=CARD)
    re.bind(*shapes, for_training=False)
    re.set_params(a2, x2)
    it = mx.io.NDArrayIter(X, y, batch_size=SYM_CHECK_B)
    same = torch.equal(re.predict(it).data, so.predict(it).data) and \
        s2.tojson() == sym.tojson()
    print(f"check symbolic checkpoint round trip predicts bit for bit: "
          f"{'ok' if same else 'FAIL'}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    checks.rows.append({"check": "symbolic checkpoint round trip",
                        "ok": same})
    if not same:
        checks.failed.append("symbolic checkpoint round trip differs")


def symbolic_train_phase(checks):
    """train_cifar10's recipe on the card: resnet20 through Module.fit
    for one epoch (14 batches of 128) with common_fit's arguments, then
    score; then the same epoch with the rtc head from the same
    parameters and batch order.  Returns the launch counts of both
    epochs and the numbers."""
    import torch
    from torch.profiler import record_function
    import mxtpu_torch as mx
    from mxtpu_torch import kernels, rtc
    register_softmax_rtc()
    rtc_kernels()
    t0 = time.perf_counter()
    sym = resnet_cifar(mx, CIFAR_CLASSES, CIFAR_LAYERS)
    train, val = load_cifar(mx, CIFAR_B)
    n_batches = len(train)
    mod = mx.mod.Module(sym, data_names=["data"],
                        label_names=["softmax_label"])
    shapes = (train.provide_data, train.provide_label)
    # the initial parameters, shared with the rtc-head epoch
    init = mx.mod.Module(sym)
    init.bind(*shapes)
    mx.random.seed(SEED)
    init.init_params(mx.init.Xavier())
    arg0, aux0 = init.get_params()
    del init
    speed = mx.callback.Speedometer(CIFAR_B, 20)
    window_speed = mx.callback.Speedometer(CIFAR_B, SYM_WINDOW)
    marks = []   # per batch: host clock, loss, launch counts

    def mark(param):
        m = param.locals["self"]
        lab = param.locals["data_batch"].label[0].asnumpy()
        marks.append((time.perf_counter(),
                      ce_loss(m.get_outputs()[0].asnumpy(), lab),
                      kernels.launch_counts(), rtc.launch_counts()))
    prefix = str(ROOT / "mxtpu_torch" / "_build" / "chip_smoke_ckpt" /
                 "cifar")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    rtc.reset_launch_counts()
    t_fit = time.perf_counter()
    marks.append((t_fit, None, kernels.launch_counts(), rtc.launch_counts()))
    mod.fit(train, eval_data=val, eval_metric=mx.metric.Accuracy(),
            optimizer="sgd", optimizer_params=CIFAR_SGD,
            initializer=mx.init.Xavier(), arg_params=arg0,
            aux_params=aux0, begin_epoch=0, num_epoch=1, kvstore="local",
            batch_end_callback=[speed, window_speed, mark],
            epoch_end_callback=[mx.callback.do_checkpoint(prefix)])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    fit_counts = kernels.launch_counts()
    fit_rtc = rtc.launch_counts()
    mem_peak = torch.cuda.max_memory_allocated()
    score = mod.score(val, mx.metric.Accuracy())
    times = [m[0] for m in marks]
    batch_ms = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
    windows = [batch_ms[i:i + SYM_WINDOW]
               for i in range(2, n_batches - SYM_WINDOW + 1, SYM_WINDOW)]
    window_ms = [float(np.mean(w)) for w in windows]
    ms_batch = float(np.median(window_ms))
    losses = [m[1] for m in marks[1:]]
    # launches per batch, from consecutive marks
    for i, (a, b) in enumerate(zip(marks, marks[1:])):
        got = {k: b[2][k] - a[2][k] for k in b[2]}
        want = {k: SYM_LAUNCHES.get(k, 0) for k in got}
        if got != want or any(b[3][k] - a[3].get(k, 0) for k in b[3]):
            checks.failed.append(f"resnet20 fit batch {i}: launches {got}, "
                                 f"rtc {b[3]}, want {want}")
            break
    aux_ok = all(float(v.data.abs().max()) == 0.0 if n.endswith("mean")
                 else bool((v.data == 1).all())
                 for n, v in mod.get_params()[1].items())
    if not aux_ok:
        checks.failed.append("resnet20 fit wrote the BatchNorm moving "
                             "statistics")
    if not all(np.isfinite(losses)):
        checks.failed.append(f"resnet20 fit losses not finite: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        checks.failed.append(f"resnet20 fit loss did not fall: {losses}")
    sp = [h[2] for h in window_speed.history]
    print(f"resnet20 Module.fit b{CIFAR_B} f32 sgd (lr 0.01, momentum "
          f"0.9, wd 1e-4), one epoch of {n_batches} batches: {fit_s:.2f} s; "
          f"{ms_batch:.3f} ms/batch (median of {len(window_ms)} windows of "
          f"{SYM_WINDOW} batches: {', '.join(f'{w:.3f}' for w in window_ms)}"
          f"), {CIFAR_B / ms_batch * 1e3:.1f} samples/s; Speedometer("
          f"{CIFAR_B}, {SYM_WINDOW}) samples/s {[round(v, 1) for v in sp]} "
          f"(the recipe's Speedometer({CIFAR_B}, 20) logs "
          f"{len(speed.history)} times in {n_batches} batches); peak memory "
          f"{mem_peak / 2**30:.3f} GiB; validation {score}; BN moving stats "
          f"as initialized {'ok' if aux_ok else 'FAIL'}", flush=True)
    print(f"resnet20 fit losses per batch {[round(v, 5) for v in losses]}; "
          f"accuracy per window "
          f"{[[round(v, 4) for _, v in h[3]] for h in window_speed.history]}",
          flush=True)
    print(f"resnet20 fit: launches in {n_batches} batches and 1 validation "
          f"batch {json.dumps(fit_counts)}", flush=True)

    # one profiled batch: forward_backward and update in their ranges
    train.reset()
    batch = next(iter(train))

    def step(_x, _y):
        with record_function("forward_backward"):
            mod.forward_backward(batch)
        with record_function("update"):
            mod.update()
    breakdown = profiled_step(checks, "resnet20 Module", step, None, None)

    # the rtc head: the same epoch from the same parameters and order,
    # held against the SoftmaxOutput epoch run again; both with cuDNN's
    # deterministic algorithms, since its default ones alone part two
    # runs of the same epoch by 1.6e-4 (relative loss, measured on an
    # H100; printed below as the fit run's spread)
    torch.backends.cudnn.deterministic = True

    def epoch(m, step):
        it, _ = load_cifar(mx, CIFAR_B)
        it.reset()   # fit resets its iterator before the epoch
        for b in it:
            yield b, step(m, b)

    def so_step(m, b):
        m.forward_backward(b)
        p = m.get_outputs()[0]
        m.update()
        return p

    again = mx.mod.Module(sym)
    again.bind(*shapes)
    again.set_params(arg0, aux0)
    again.init_optimizer(optimizer="sgd", optimizer_params=CIFAR_SGD)
    rerun = [ce_loss(p.asnumpy(), b.label[0].asnumpy())
             for b, p in epoch(again, so_step)]
    head = mx.mod.Module(sym.get_internals()["fc_output"],
                         data_names=["data"], label_names=[])
    head.bind(*shapes)
    head.set_params(arg0, aux0)
    head.init_optimizer(optimizer="sgd", optimizer_params=CIFAR_SGD)
    kernels.reset_launch_counts()
    rtc.reset_launch_counts()
    rtc_losses, rtc_times = [], [time.perf_counter()]
    before = (kernels.launch_counts(), rtc.launch_counts())
    for i, (b, (p, _)) in enumerate(epoch(
            head, lambda m, b: rtc_head_step(mx, m, b))):
        rtc_losses.append(ce_loss(p.asnumpy(), b.label[0].asnumpy()))
        rtc_times.append(time.perf_counter())
        now = (kernels.launch_counts(), rtc.launch_counts())
        got = {k: v - before[0][k] for k, v in now[0].items()}
        got_rtc = {k: v - before[1].get(k, 0) for k, v in now[1].items()}
        if got != {k: SYM_LAUNCHES.get(k, 0) for k in got} or \
                got_rtc != {k: RTC_LAUNCHES.get(k, 0) for k in got_rtc}:
            checks.failed.append(f"rtc head batch {i}: launches {got}, "
                                 f"rtc {got_rtc}")
        before = now
    torch.cuda.synchronize()
    rtc_counts = kernels.launch_counts()
    rtc_rtc = rtc.launch_counts()
    torch.backends.cudnn.deterministic = False
    rtc_ms = [(b - a) * 1e3 for a, b in zip(rtc_times, rtc_times[1:])]
    traj = max(abs(a - b) / max(abs(b), RN_LOSS_FLOOR)
               for a, b in zip(rtc_losses, rerun))
    spread = max(abs(a - b) / max(abs(b), RN_LOSS_FLOOR)
                 for a, b in zip(rerun, losses))
    if traj > STEP_TOL:
        checks.failed.append(f"rtc head losses off the SoftmaxOutput run by "
                             f"{traj:.3e}")
    print(f"resnet20 rtc head epoch (cuDNN deterministic): losses "
          f"{[round(v, 5) for v in rtc_losses]} against the SoftmaxOutput "
          f"epoch's {[round(v, 5) for v in rerun]}: max err {traj:.3e} of "
          f"max(|p|, {RN_LOSS_FLOOR}) (tol {STEP_TOL}) "
          f"{'ok' if traj <= STEP_TOL else 'FAIL'} (the fit run against "
          f"the SoftmaxOutput epoch: {spread:.3e}); median "
          f"{float(np.median(rtc_ms[2:])):.3f} ms/batch; launches "
          f"{json.dumps(rtc_counts)}, rtc {json.dumps(rtc_rtc)}", flush=True)
    return fit_counts, rtc_rtc, {
        "batches": n_batches, "fit_s": fit_s, "ms_per_batch": ms_batch,
        "window_ms_per_batch": window_ms,
        "samples_per_s": CIFAR_B / ms_batch * 1e3,
        "speedometer_samples_per_s": sp, "peak_bytes": mem_peak,
        "losses": losses, "validation": score, "breakdown": breakdown,
        "rtc_head": {"losses": rtc_losses, "ms_per_batch": rtc_ms,
                     "softmax_output_losses": rerun,
                     "max_loss_err": traj, "fit_spread": spread,
                     "launches": rtc_counts, "rtc_launches": rtc_rtc}}


# ----------------------------------------------------------------------
# phases 6 and 7: BERT-Large served
# ----------------------------------------------------------------------

def mxtpu_params(seed, layers=LAYERS, maxlen=MAXLEN):
    """Random full-width BERT weights (``layers`` encoder layers, a
    position table of ``maxlen``) named and ordered as mxtpu's
    ``collect_params()`` (and an exported ``.params`` file) has them."""
    rng = np.random.default_rng(seed)
    out = {}

    def w(name, shape, kind):
        if kind == "gamma":
            a = 1.0 + 0.05 * rng.standard_normal(shape, dtype=np.float32)
        elif kind == "bias":
            a = 0.02 * rng.standard_normal(shape, dtype=np.float32)
        else:
            a = 0.02 * rng.standard_normal(shape, dtype=np.float32)
        out[name] = a.astype(np.float32)

    w("bertmodel0_pos_embed", (maxlen, UNITS), "weight")
    w("embedding0_weight", (VOCAB, UNITS), "weight")
    w("embedding1_weight", (2, UNITS), "weight")
    w("layernorm0_gamma", (UNITS,), "gamma")
    w("layernorm0_beta", (UNITS,), "bias")
    for i in range(layers):
        d, f = 4 * i, 2 * i
        w(f"dense{d}_weight", (3 * UNITS, UNITS), "weight")
        w(f"dense{d}_bias", (3 * UNITS,), "bias")
        w(f"dense{d + 1}_weight", (UNITS, UNITS), "weight")
        w(f"dense{d + 2}_weight", (FFN, UNITS), "weight")
        w(f"dense{d + 2}_bias", (FFN,), "bias")
        w(f"dense{d + 3}_weight", (UNITS, FFN), "weight")
        for j in (f, f + 1):
            w(f"fusedresiduallayernorm{j}_bias", (UNITS,), "bias")
            w(f"fusedresiduallayernorm{j}_gamma", (UNITS,), "gamma")
            w(f"fusedresiduallayernorm{j}_beta", (UNITS,), "bias")
    w(f"dense{4 * layers}_weight", (VOCAB, UNITS), "weight")
    w(f"dense{4 * layers}_bias", (VOCAB,), "bias")
    return out


@contextlib.contextmanager
def eager_plan(runner):
    """Inside it, ``runner``'s buckets run as the graph plan eagerly (its
    private ``_eager_entry``), never as the captured graphs: the figure
    each captured one is printed beside."""
    runner._entry = runner._eager_entry
    try:
        yield runner
    finally:
        del runner._entry


def forward_breakdown(runner, tag):
    """One forward of the (32, 128) bucket: its time on the device
    (events over back-to-back calls), the host ms to issue it, a served
    batch's wall ms through ``infer`` (pad, upload, forward, logits to
    the host), the copy of its logits to the host, and device time by
    kernel family and the idle share from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    bucket = (B, T)
    rng = np.random.RandomState(SEED + 2)
    rows = [{"data": rng.randint(0, VOCAB, T).astype(np.float32)}
            for _ in range(B)]
    vals = runner._pad_stack(rows, bucket)
    fwd_ms = time_ms(lambda: runner.run_raw(vals, bucket), iters=10,
                     warmup=2)
    issue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run_raw(vals, bucket)
        issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    batch = {"data": np.stack([r["data"] for r in rows])}
    served = []
    for _ in range(3):
        t0 = time.perf_counter()
        runner.infer(batch)
        served.append((time.perf_counter() - t0) * 1e3)
    (logits,) = runner.run_raw(vals, bucket)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits.cpu().numpy()
    d2h_ms = (time.perf_counter() - t0) * 1e3
    del logits
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run_raw(vals, bucket)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by = {k: 0.0 for k in ("flash_attention_fwd", "layer_norm_fwd",
                           "fused_residual_ln_fwd", "gemm", "other")}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us:
            fam = family_of(evt.key)
            by[fam] = by.get(fam, 0.0) + us / 1e3
    busy = sum(by.values())
    out = {"forward_ms": fwd_ms, "issue_host_ms": pct(issue, 0.5),
           "served_batch_ms": pct(served, 0.5),
           "logits_to_host_ms": d2h_ms, "profiled_wall_ms": wall_ms,
           "device_ms_by_family": by, "device_busy_ms": busy,
           "device_idle_share": (1.0 - busy / wall_ms) if busy else None}
    print(f"forward (32, 128), {tag}: {fwd_ms:.3f} ms a forward (events, "
          f"back to back); host {out['issue_host_ms']:.3f} ms to issue it "
          f"(p50 of 5); a served batch through infer() "
          f"{out['served_batch_ms']:.3f} ms wall (p50 of 3); logits to "
          f"host {d2h_ms:.3f} ms; profiled: " +
          (", ".join(f"{k} {v:.3f} ms" for k, v in by.items())
           + f" busy in {wall_ms:.3f} ms wall; idle share "
           f"{out['device_idle_share']:.4f}"
           if busy else "no device time recorded (not measured)"),
          flush=True)
    return out


def serve_export(params, path):
    """BERT-Large built by the port, carrying the seeded weights, and
    exported as a Gluon user deploys it (``net.export``): the
    ``-symbol.json`` graph and the ``.params`` file."""
    from mxtpu_torch.convert import params_from_mxtpu
    from mxtpu_torch.models import bert_large
    return params_from_mxtpu(params, fresh_names(bert_large)).export(path)


def peak_gb():
    import torch
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def reset_peak():
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def ladder_memory(runner, tag, run_eager, warm_up):
    """Peak device memory over one call of every bucket of the ladder:
    the eager plan's (``run_eager()``), then the captured ladder's
    warm-up (``warm_up()``: its graphs' shared pool, the static
    buffers, the weights); what stays allocated and reserved after the
    warm-up.  Prints the number of entries and each one's capture
    seconds."""
    import torch
    reset_peak()
    run_eager()
    eager = peak_gb()
    reset_peak()
    warm = warm_up()
    out = {"eager_peak_gb": eager, "captured_peak_gb": peak_gb(),
           "captured_allocated_gb": torch.cuda.memory_allocated() / 1e9,
           "captured_reserved_gb": torch.cuda.memory_reserved() / 1e9,
           "capture_s": {str(k): v for k, v in warm.items()}}
    print(f"{tag}: {runner.num_compiled()} entries captured in "
          f"{sum(warm.values()):.2f} s (" + ", ".join(
              f"{k} {v:.3f}" for k, v in warm.items()) +
          f" s); peak device memory over the ladder: eager plan "
          f"{eager:.3f} GB, captured warm-up {out['captured_peak_gb']:.3f}"
          f" GB; after it {out['captured_allocated_gb']:.3f} GB allocated,"
          f" {out['captured_reserved_gb']:.3f} GB reserved", flush=True)
    return warm, out


def serve_memory(runner):
    def run_eager():
        for bucket in runner.buckets():
            e = runner._eager_entry(bucket)
            with e.lock:
                e.run(runner._example(bucket))
    return ladder_memory(runner, "serving", run_eager, runner.warmup)


def serve_entry_gate(checks, runner):
    """Each captured bucket against the eager plan on the card, one
    batch of every bucket: bit for bit, or (where cuBLAS took another
    algorithm under capture) within the served-logits tolerance, the
    largest difference printed."""
    import torch
    rng = np.random.RandomState(SEED + 3)
    apart, worst_abs, worst_rel = [], 0.0, 0.0
    for bucket in runner.buckets():
        b, s = bucket
        vals = runner._pad_stack(
            [{"data": rng.randint(0, VOCAB, s).astype(np.float32)}
             for _ in range(b)], bucket)
        (got,) = runner.run_raw(vals, bucket)
        eager = runner._eager_entry(bucket)
        with eager.lock:
            (want,) = eager.run(vals)
        if not torch.equal(got, want):
            rel, absmax = rel_err(got, want)
            apart.append(list(bucket))
            worst_abs, worst_rel = max(worst_abs, absmax), max(worst_rel,
                                                               rel)
        del got, want
    ok = worst_rel <= SERVE_TOL
    print(f"check serving: each of {len(runner.buckets())} captured "
          f"buckets vs the eager plan on the card, one batch each: "
          f"{len(runner.buckets()) - len(apart)} bit for bit" +
          (f"; {apart} apart by at most max_abs_err={worst_abs:.3e} "
           f"max_rel_err={worst_rel:.3e} tol={SERVE_TOL}" if apart else "")
          + f" {'ok' if ok else 'FAIL'}", flush=True)
    checks.rows.append({"check": "served buckets captured vs eager",
                        "apart": apart, "max_abs_err": worst_abs,
                        "max_rel_err": worst_rel, "tol": SERVE_TOL,
                        "ok": ok})
    if not ok:
        checks.failed.append("serving: a captured bucket differs from the "
                             "eager plan")


def guard_gate(checks):
    """``MXTPU_GUARDS=2`` on the card: a runner built under it captures,
    replays and serves a toy graph (``data * w``) exactly; inside the
    guards' scope a host read raises; past its ladder plus 4 builds the
    runner raises ``RecompileChurn``."""
    import torch
    from mxtpu_torch import guards
    from mxtpu_torch import symbol as sym
    from mxtpu_torch.serving import ModelRunner
    os.environ["MXTPU_GUARDS"] = "2"
    try:
        w = np.arange(1, 4, dtype=np.float32)
        r = ModelRunner(sym.var("data") * sym.var("w"), {"w": w},
                        {"data": (3,)}, max_batch_size=4)
        r.warmup()
        x = np.random.RandomState(SEED).randn(3, 3).astype(np.float32)
        (out,) = r.infer({"data": x})
        served = np.array_equal(out, x * w)
        try:
            with guards.no_implicit_transfers(device=torch.device(CARD)):
                torch.ones(1, device=CARD).item()
            sync_raises = False
        except RuntimeError:
            sync_raises = True
        try:
            r.warmup([(b, None) for b in range(5, 10)])
            churn = False
        except guards.RecompileChurn:
            churn = True
    finally:
        os.environ.pop("MXTPU_GUARDS", None)
    ok = served and sync_raises and churn
    print(f"check guards (MXTPU_GUARDS=2): a guarded runner serves its "
          f"captured ladder exactly {served}; a host read inside the scope "
          f"raises {sync_raises}; the 8th build of a 3-bucket ladder raises "
          f"RecompileChurn {churn} {'ok' if ok else 'FAIL'}", flush=True)
    checks.rows.append({"check": "guards on the card", "served": served,
                        "sync_raises": sync_raises, "churn": churn,
                        "ok": ok})
    if not ok:
        checks.failed.append("guards: MXTPU_GUARDS=2 did not hold on the "
                             "card")


SERVE_PER_FWD = {"flash_attention_fwd": LAYERS, "layer_norm_fwd": 1,
                 "fused_residual_ln_fwd": 2 * LAYERS}


def serve_burst(checks, runner, tag, toks, check_toks=None):
    """The 128-request burst from 4 client threads through
    InferenceServer: every result of the right shape and finite, 0
    requeues and failures, launches exactly 24/1/48 a forward and 0
    elsewhere.  With ``check_toks``, one batch of them through the same
    server after the burst (the CPU gate's input)."""
    from mxtpu_torch import kernels
    from mxtpu_torch.serving import InferenceServer
    results = [None] * N_REQUESTS
    errors = []
    server = InferenceServer(log_every_s=1e9)
    server.register("bert", runner)

    def client(idx):
        # a burst: every request of this client in flight at once, so
        # the batcher fills the b=32 buckets
        try:
            reqs = [(i, server.submit("bert", {"data": toks[i]},
                                      timeout_s=300.0)) for i in idx]
            for i, req in reqs:
                results[i] = req.result(timeout=360.0)[0]
        except Exception as e:  # noqa: BLE001 — reported as a failure
            errors.append(repr(e))

    threads = [threading.Thread(target=client,
                                args=(range(c, N_REQUESTS, N_CLIENTS),))
               for c in range(N_CLIENTS)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    served = None
    if check_toks is not None:
        check_reqs = [server.submit("bert", {"data": x}, timeout_s=300.0)
                      for x in check_toks]
        served = [r.result(timeout=360.0)[0] for r in check_reqs]
    server.close()
    snap = server.stats("bert")
    ep_err = server._endpoint("bert", None).last_error

    if any(t.is_alive() for t in threads):
        checks.failed.append(f"serving ({tag}): client threads did not "
                             f"finish")
    if errors:
        checks.failed.append(f"serving ({tag}): request errors: "
                             f"{errors[:3]}")
    bad = [i for i, r in enumerate(results)
           if r is None or r.shape != (len(toks[i]), VOCAB)
           or not np.isfinite(r).all()]
    if bad:
        checks.failed.append(f"serving ({tag}): {len(bad)} served results "
                             f"missing, of the wrong shape or not finite")
    requeues = snap["extras"].get("requeues", 0)
    if requeues:
        checks.failed.append(f"serving ({tag}): {requeues} requeues (last "
                             f"batch error: {ep_err!r})")
    print(f"kernels: launches in the serving run ({tag}) over "
          f"{N_REQUESTS} requests: {json.dumps(counts)}", flush=True)
    n_fwd = counts["layer_norm_fwd"]
    for name, got in counts.items():
        want = SERVE_PER_FWD.get(name, 0) * n_fwd
        if name in SERVE_PER_FWD and got == 0:
            checks.failed.append(f"kernel {name} never launched on the "
                                 f"main path ({tag})")
        elif got != want:
            checks.failed.append(f"serving ({tag}): {name} launched {got} "
                                 f"times in {n_fwd} forwards, want "
                                 f"{SERVE_PER_FWD.get(name, 0)} each")
    # one forward per batch: at least N/32 batches, at most N
    if not -(-N_REQUESTS // 32) <= n_fwd <= N_REQUESTS:
        checks.failed.append(f"serving ({tag}): {n_fwd} forwards for "
                             f"{N_REQUESTS} requests")
    rps = N_REQUESTS / wall
    lat = snap["latency_ms"]
    print(f"serving ({tag}): {N_REQUESTS} requests from {N_CLIENTS} "
          f"threads in {wall:.3f} s = {rps:.2f} req/s; latency p50 "
          f"{lat['p50']} ms p99 {lat['p99']} ms; {n_fwd} forwards, mean "
          f"batch {snap['mean_batch_size']}, fill "
          f"{snap['batch_fill_rate']}, requeues {requeues}", flush=True)
    return counts, served, {
        "wall_s": wall, "req_per_s": rps, "p50_ms": lat["p50"],
        "p99_ms": lat["p99"], "batches": snap["batches"],
        "mean_batch_size": snap["mean_batch_size"],
        "batch_fill_rate": snap["batch_fill_rate"], "requeues": requeues}


def serve_phase(checks, params):
    """BERT-Large f32 built by the port, exported, and served from the
    export through ``ModelRunner.from_export`` ({64, 128} x batch
    1..32, one captured CUDA graph a bucket), each measurement beside
    the eager plan's on the same card."""
    import tempfile
    import torch
    from mxtpu_torch.serving import ModelRunner

    spec = dict(input_specs={"data": (None,)})
    with tempfile.TemporaryDirectory(dir=ROOT / "mxtpu_torch" / "_build",
                                     prefix="serve_") as tmp:
        t0 = time.perf_counter()
        files = serve_export(params, os.path.join(tmp, "bert"))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        runner = ModelRunner.from_export(*files, seq_buckets=[64, 128],
                                         max_batch_size=32, **spec)
        load_s = time.perf_counter() - t0
        # the same export on the CPU, plain path
        cpu_runner = ModelRunner.from_export(*files, seq_buckets=[128],
                                             max_batch_size=8,
                                             device="cpu", **spec)
    print(f"serving: BERT-Large exported in {export_s:.1f} s; weights "
          f"{runner.weight_bytes() / 2**30:.3f} GiB loaded from the export "
          f"in {load_s:.1f} s", flush=True)
    ptrs = [w.data_ptr() for w in runner.weight_buffers()]
    warm, memory = serve_memory(runner)
    if [w.data_ptr() for w in runner.weight_buffers()] != ptrs:
        checks.failed.append("serving: the warm-up moved the weights")
    serve_entry_gate(checks, runner)
    guard_gate(checks)

    rng = np.random.RandomState(SEED + 1)
    lens = [int(n) for n in rng.randint(16, 129, N_REQUESTS)]
    toks = [rng.randint(0, VOCAB, n).astype(np.float32) for n in lens]
    # phase 14 input: one batch of 8 x 128 through the server
    check_toks = [rng.randint(0, VOCAB, T).astype(np.float32)
                  for _ in range(8)]
    counts, served, burst = serve_burst(checks, runner, "captured", toks,
                                        check_toks)
    with eager_plan(runner):
        _, _, eager_burst = serve_burst(checks, runner, "eager plan", toks)
    breakdown = forward_breakdown(runner, "captured")
    with eager_plan(runner):
        eager_breakdown = forward_breakdown(runner, "eager plan")

    (want,) = cpu_runner.infer({"data": np.stack(check_toks)})
    got = torch.from_numpy(np.stack(served))
    rel, absmax = rel_err(got, torch.from_numpy(want))
    ok = rel <= SERVE_TOL
    print(f"check served 8x128 logits vs CPU plain path: "
          f"max_abs_err={absmax:.3e} max_rel_err={rel:.3e} "
          f"tol={SERVE_TOL} {'ok' if ok else 'FAIL'}", flush=True)
    checks.rows.append({"check": "served 8x128 vs CPU", "max_abs_err":
                        absmax, "max_rel_err": rel, "tol": SERVE_TOL,
                        "ok": ok})
    if not ok:
        checks.failed.append("served logits differ from the CPU path")
    return counts, {"requests": N_REQUESTS, "clients": N_CLIENTS,
                    **burst, "eager_plan": eager_burst,
                    "export_s": export_s, "load_s": load_s,
                    "num_compiled": runner.num_compiled(),
                    "warmup_s": sum(warm.values()), "memory": memory,
                    "served_vs_cpu_max_abs_err": absmax,
                    "forward_b32_t128": breakdown,
                    "forward_b32_t128_eager_plan": eager_breakdown}


# ----------------------------------------------------------------------
# phase 18: generation serving (the incremental decode, GenerateRunner,
# GenerateBatcher, the server's generator endpoints)
# ----------------------------------------------------------------------

GEN_LANES, GEN_BUCKETS = 8, (32, 128)
GEN_PROMPT, GEN_DECODE = 100, 16           # gate 1
GEN_CPU_B, GEN_CPU_S, GEN_CPU_STEPS = 2, 32, 4   # gate 2
GEN_REQUESTS, GEN_CLIENTS = 32, 4          # gate 4
GEN_MAX_TOKENS, GEN_TOPK = 24, 8
GEN_PROMPT_LENS = (8, 300)
GEN_SAT_PROMPT, GEN_SAT_RUNS = 64, 2       # saturation and naive runs
GEN_LAUNCHES = {"layer_norm_fwd": 1, "fused_residual_ln_fwd": 2 * LAYERS}
# a decode step's device time by family: the op whose range launched it
GEN_OP_FAMILY = {"FullyConnected": "gemm",
                 "cached_attention": "cached_attention",
                 "kv_cache_write": "kv_copies", "stack": "kv_copies",
                 "LayerNorm": "layer_norm_fwd",
                 "FusedResidualLayerNorm": "fused_residual_ln_fwd"}


def gen_bert():
    """mxtpu's generation model (``BERTModel(..., causal=True)``) at
    BERT-Large's widths."""
    from mxtpu_torch.models import BERTModel
    return BERTModel(VOCAB, UNITS, FFN, LAYERS, HEADS, max_length=MAXLEN,
                     dropout=0.0, use_token_type=False, causal=True)


def gen_export(path):
    """The generation model with weights from the port's initializers
    (``mxtpu_torch.random.seed(SEED)``), its incremental call traced
    once and exported to ``path``."""
    from mxtpu_torch import nd
    from mxtpu_torch import random as trandom
    trandom.seed(SEED)
    net = fresh_names(gen_bert)
    net.initialize(ctx=CARD)
    net(nd.array(np.ones((1, 3), np.float32), ctx=CARD),
        nd.zeros((1,), ctx=CARD), nd.zeros(net.kv_cache_spec(1), ctx=CARD))
    return net, net.export(path)


def full_logits(net, seq):
    """The full causal forward (flash #1) over ``seq``: (len, V) on the
    host."""
    import torch
    with torch.no_grad():
        x = torch.tensor(np.asarray(seq, np.float32)[None], device=CARD)
        return net(x)[0].cpu()


def near_tie(row, a, b):
    """Whether tokens ``a`` and ``b`` are within SERVE_TOL of each other
    in the logits ``row``: a greedy pick between them may go either way
    in another f32 summation order."""
    row = np.asarray(row, np.float64)
    return abs(row[a] - row[b]) <= SERVE_TOL * max(1.0, abs(row[a]),
                                                   abs(row[b]))


def same_greedy(net, prompt, got, want):
    """Two greedy streams of one prompt agree, or first differ at a
    near tie of the full forward's logits there (after which they
    continue from different tokens).  Returns (ok, index of the first
    difference or None)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            row = full_logits(net, list(prompt) + list(want[:i]))[-1]
            return near_tie(row.numpy(), a, b), i
    return len(got) == len(want), None


def gen_incremental_gate(checks, net, runner, kv):
    """Gates 1 and 3: one lane of table ``kv`` (zeroed) prefilled with a
    100-token prompt, then 16 decode steps; each step's logits against
    the full causal forward's at the same position, the greedy tokens
    where the top-2 gap exceeds the tolerance, and each call's launches
    exactly 1 LayerNorm (#4), 48 fused epilogues (#6) and no flash
    kernel."""
    import torch
    from mxtpu_torch import kernels
    rng = np.random.RandomState(SEED + 20)
    prompt = [int(t) for t in rng.randint(0, VOCAB, GEN_PROMPT)]
    kv.zero_()
    s = runner.prompt_bucket_for(GEN_PROMPT)
    tok = np.zeros((1, s), np.float32)
    tok[0, :GEN_PROMPT] = prompt
    kernels.reset_launch_counts()
    logits, kv = runner.prefill(tok, np.zeros(1, np.float32),
                                np.zeros(1, np.float32), kv)
    check_launches(checks, "generate prefill", kernels.launch_counts(),
                   GEN_LAUNCHES, 1)
    inc = [logits[0, GEN_PROMPT - 1]]
    seq = list(prompt)
    slots = runner.max_lanes + 1
    for i in range(GEN_DECODE):
        seq.append(int(np.argmax(inc[-1])))
        dt = np.zeros((slots, 1), np.float32)
        ds = np.zeros(slots, np.float32)
        dt[0, 0], ds[0] = seq[-1], len(seq) - 1
        kernels.reset_launch_counts()
        logits, kv = runner.decode(dt, ds, kv)
        check_launches(checks, f"generate decode step {i}",
                       kernels.launch_counts(), GEN_LAUNCHES, 1)
        inc.append(logits[0, 0])
    ref = full_logits(net, seq)[GEN_PROMPT - 1:]
    got = torch.from_numpy(np.stack(inc))
    rel, absmax = rel_err(got, ref)
    flips, ties = 0, 0
    for i in range(GEN_DECODE):
        want = int(ref[i].argmax())
        if seq[GEN_PROMPT + i] != want:
            if near_tie(ref[i].numpy(), seq[GEN_PROMPT + i], want):
                ties += 1
            else:
                flips += 1
    ok = rel <= SERVE_TOL and flips == 0
    print(f"check generate: {GEN_DECODE} decode steps after a "
          f"{GEN_PROMPT}-token prefill vs the full causal forward: "
          f"max_abs_err={absmax:.3e} max_rel_err={rel:.3e} "
          f"tol={SERVE_TOL}; greedy tokens differing beyond a near tie "
          f"{flips}, at a near tie {ties} {'ok' if ok else 'FAIL'}",
          flush=True)
    checks.rows.append({"check": "generate incremental vs full forward",
                        "max_abs_err": absmax, "max_rel_err": rel,
                        "tol": SERVE_TOL, "flips": flips, "ties": ties,
                        "ok": ok})
    if not ok:
        checks.failed.append("generate: incremental logits or greedy "
                             "tokens differ from the full forward")
    return absmax


def gen_cpu_gate(checks, runner, files, kv):
    """Gate 2: one prefill (b=2, s=32) and 4 decode steps on the card
    (table ``kv``, zeroed) against the same runner built on the CPU
    (the plain versions)."""
    import torch
    from mxtpu_torch.serving import GenerateRunner
    cpu = GenerateRunner.from_export(*files, runner.kv_spec,
                                     prompt_buckets=GEN_BUCKETS,
                                     device="cpu")
    rng = np.random.RandomState(SEED + 21)
    toks = rng.randint(0, VOCAB, (GEN_CPU_B, GEN_CPU_S)).astype(np.float32)
    lanes = np.arange(GEN_CPU_B, dtype=np.float32)
    step = np.zeros(GEN_CPU_B, np.float32)
    lg, kg = runner.prefill(toks, step, lanes, kv.zero_())
    lc, kc = cpu.prefill(toks, step, lanes, cpu.new_cache())
    errs = [rel_err(torch.from_numpy(lg), torch.from_numpy(lc))]
    slots = runner.max_lanes + 1
    for i in range(GEN_CPU_STEPS):
        dt = np.zeros((slots, 1), np.float32)
        ds = np.zeros(slots, np.float32)
        last = lg[:, -1] if i == 0 else lg[:, 0]
        for b in range(GEN_CPU_B):
            dt[b, 0], ds[b] = int(np.argmax(last[b])), GEN_CPU_S + i
        lg, kg = runner.decode(dt, ds, kg)
        lc, kc = cpu.decode(dt, ds, kc)
        errs.append(rel_err(torch.from_numpy(lg), torch.from_numpy(lc)))
    errs.append(rel_err(kg[:, :, :GEN_CPU_B].cpu(), kc[:, :, :GEN_CPU_B]))
    rel = max(e[0] for e in errs)
    absmax = max(e[1] for e in errs)
    ok = rel <= SERVE_TOL
    print(f"check generate card vs CPU: prefill b{GEN_CPU_B} s{GEN_CPU_S} "
          f"and {GEN_CPU_STEPS} decode steps, logits and the lanes' KV: "
          f"max_abs_err={absmax:.3e} max_rel_err={rel:.3e} "
          f"tol={SERVE_TOL} {'ok' if ok else 'FAIL'}", flush=True)
    checks.rows.append({"check": "generate card vs CPU", "max_abs_err":
                        absmax, "max_rel_err": rel, "tol": SERVE_TOL,
                        "ok": ok})
    if not ok:
        checks.failed.append("generate: the card's logits differ from "
                             "the CPU runner's")
    del cpu, kc
    return absmax


def pct(vals, q):
    """bench.py's nearest-rank percentile (q in [0, 1])."""
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))] \
        if vals else None


def gen_saturation(runner, tag):
    """``bench.py``'s ``serving_generate`` measurement at full width:
    8 greedy requests of 64 tokens, 24 new tokens each, through one
    batcher stepped until drained (tokens/s, and TTFT and per-token
    gaps at the stream callback), twice, each batcher warmed on its own
    table before its requests; then its naive denominator, the same
    continuation of the first prompt by a full prefill over the growing
    sequence per token.  A decode step's wall ms and the host ms of its
    runner call (the replay or the eager plan, and the logits' copy)."""
    from mxtpu_torch.serving import GenerateBatcher
    rng = np.random.RandomState(SEED + 22)
    prompts = [[int(t) for t in rng.randint(1, VOCAB, GEN_SAT_PROMPT)]
               for _ in range(runner.max_lanes)]
    calls = []
    decode = runner.decode

    def decode_timed(*a):
        t0 = time.perf_counter()
        out = decode(*a)
        calls.append(time.perf_counter() - t0)
        return out

    rates, ttfts, gaps, step_ms, call_ms = [], [], [], [], []
    runner.decode = decode_timed
    try:
        for _ in range(GEN_SAT_RUNS):
            batcher = GenerateBatcher(runner)
            batcher.warmup()
            marks = [[] for _ in prompts]
            t_submit = time.perf_counter()
            reqs = [batcher.submit(p, max_tokens=GEN_MAX_TOKENS,
                                   on_token=lambda t, i, m=m:
                                   m.append(time.perf_counter()))
                    for p, m in zip(prompts, marks)]
            while not batcher.drain():
                del calls[:]
                t0 = time.perf_counter()
                out = batcher.step()
                if not out["admitted"]:
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    call_ms.append(sum(calls) * 1e3)
            elapsed = time.perf_counter() - t_submit
            batcher.close()
            rates.append(sum(len(r.result(0)) for r in reqs) / elapsed)
            ttfts += [(m[0] - t_submit) * 1e3 for m in marks if m]
            gaps += [(b - a) * 1e3 for m in marks
                     for a, b in zip(m, m[1:])]
    finally:
        del runner.decode
    kv = runner.new_cache()
    seq = list(prompts[0])
    b = runner.batch_rung_for(1)
    t0 = time.perf_counter()
    while len(seq) - GEN_SAT_PROMPT < GEN_MAX_TOKENS:
        s = runner.prompt_bucket_for(len(seq))
        tok = np.zeros((b, s), np.float32)
        tok[0, :len(seq)] = seq
        logits, kv = runner.prefill(
            tok, np.zeros(b, np.float32),
            np.full(b, runner.scratch_slot, np.float32), kv)
        seq.append(int(np.argmax(logits[0, len(seq) - 1])))
    naive = GEN_MAX_TOKENS / (time.perf_counter() - t0)
    out = {"tok_per_s": rates, "best_tok_per_s": max(rates),
           "ttft_ms": {"p50": pct(ttfts, 0.5), "p95": pct(ttfts, 0.95)},
           "per_token_ms": {"p50": pct(gaps, 0.5),
                            "p95": pct(gaps, 0.95)},
           "naive_reprefill_tok_per_s": naive,
           "kv_vs_naive": max(rates) / naive,
           "decode_step_wall_ms": {"p50": pct(step_ms, 0.5),
                                   "p95": pct(step_ms, 0.95)},
           "decode_call_host_ms": {"p50": pct(call_ms, 0.5),
                                   "p95": pct(call_ms, 0.95)}}
    print(f"generate saturation, {tag} ({runner.max_lanes} lanes, "
          f"{GEN_SAT_PROMPT}-token prompts, {GEN_MAX_TOKENS} tokens "
          f"each): decode tokens/s {', '.join(f'{r:.2f}' for r in rates)}"
          f"; TTFT p50 {out['ttft_ms']['p50']:.3f} ms p95 "
          f"{out['ttft_ms']['p95']:.3f} ms; per-token p50 "
          f"{out['per_token_ms']['p50']:.3f} ms p95 "
          f"{out['per_token_ms']['p95']:.3f} ms (stream callback); naive "
          f"re-prefill {naive:.2f} tokens/s, ratio "
          f"{out['kv_vs_naive']:.3f}; a decode step {pct(step_ms, 0.5):.3f}"
          f" ms wall (p50), of it {pct(call_ms, 0.5):.3f} ms in the "
          f"runner's decode call", flush=True)
    return out


def gen_decode_breakdown(checks, runner, tag, replayed=True):
    """One decode step with every lane active under torch.profiler: its
    device busy time, wall time and idle share.  Under the eager plan
    each device kernel is also charged to the op whose
    ``record_function`` range launched it (the profiler links a kernel
    to the innermost op around its launch; the walk goes up to the
    nearest range): GEMMs are the FullyConnected ranges', KV copies
    kv_cache_write's and stack's plus the kernels outside the graph
    (the donation's copy of the new table over the old), copies to and
    from the host by name, other the rest of the graph.  A range's own
    span on the device timeline is left out; its ``device_time_total``,
    which holds that span, is printed beside the kernels' sum.  A
    replayed graph runs no op, so its kernels are not linked."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from mxtpu_torch.ops.registry import get_op
    slots = runner.max_lanes + 1
    rng = np.random.RandomState(SEED + 23)
    dt = rng.randint(0, VOCAB, (slots, 1)).astype(np.float32)
    ds = np.full(slots, GEN_SAT_PROMPT + 5, np.float32)
    ds[-1] = 0
    kv = runner.new_cache()
    runner.warmup([("decode", (slots,))], kv=kv)
    runner.decode(dt, ds, kv)
    saved = {}
    for name in () if replayed else GEN_OP_FAMILY:
        op = get_op(name)
        saved[name] = op.fn

        def ranged(*a, _fn=op.fn, _tag=f"gen_op:{name}", **k):
            with record_function(_tag):
                return _fn(*a, **k)
        op.fn = ranged
    orig = runner._eval_incremental

    def eval_ranged(*a):
        with record_function("gen:eval"):
            return orig(*a)
    runner._eval_incremental = eval_ranged

    def family(evt):
        while evt is not None:
            if evt.name.startswith("gen_op:"):
                return GEN_OP_FAMILY[evt.name[7:]]
            if evt.name == "gen:eval":
                return "other"
            evt = evt.cpu_parent
        return "kv_copies"    # outside the graph: the donation's copy

    try:
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                runner.decode(dt, ds, kv)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            by = {k: 0.0 for k in ("gemm", "cached_attention", "kv_copies",
                                   "layer_norm_fwd",
                                   "fused_residual_ln_fwd", "host_copies",
                                   "other")}
            busy = eval_total = eval_host = 0.0
            n = 0
            for evt in prof.events():
                if "CPU" not in str(evt.device_type):
                    if not evt.name.startswith(("gen:", "gen_op:")):
                        busy += evt.device_time_total / 1e3
                    continue
                if evt.name == "gen:eval":
                    eval_total += evt.device_time_total / 1e3
                    eval_host += evt.cpu_time_total / 1e3
                if replayed:
                    continue
                fam = None
                for k in evt.kernels:
                    if k.name.startswith(("gen:", "gen_op:")):
                        continue      # a range's span, not a kernel
                    fam = fam or family(evt)
                    ms = k.duration / 1e3
                    n += 1
                    by["host_copies" if "memcpy" in k.name.lower()
                       else fam] += ms
            if busy:
                break
    finally:
        for name, fn in saved.items():
            get_op(name).fn = fn
        runner._eval_incremental = orig
    if not busy:
        checks.failed.append(f"torch.profiler recorded no device time in "
                             f"the decode step ({tag})")
        return {}
    linked = sum(by.values())
    out = {"device_ms_by_family": by, "device_busy_ms": busy,
           "linked_ms": linked, "kernels": n, "profiled_wall_ms": wall,
           "eval_host_ms": eval_host,
           "eval_range_device_time_total_ms": eval_total,
           "device_idle_share": 1.0 - busy / wall}
    print(f"generate decode step breakdown, {tag} (device ms, 9 slots, 8 "
          f"lanes at position {GEN_SAT_PROMPT + 5}): " +
          (", ".join(f"{k} {v:.3f}" for k, v in by.items()) +
           f"; {n} kernels linked to their ops, {linked:.3f} ms, of "
           if n else "kernels of the replayed graph not linked to ops; ")
          + f"{busy:.3f} ms busy on the device in {wall:.3f} ms wall, idle "
          f"share {out['device_idle_share']:.4f}" +
          (f"; host in the graph plan {eval_host:.3f} ms (profiled); the "
           f"eval range's device_time_total {eval_total:.3f} ms"
           if n else ""), flush=True)
    return out


def gen_memory(runner, table):
    """:func:`ladder_memory` of the generation ladder on ``table``,
    eager and then captured."""
    def run_eager():
        for bucket in runner.buckets():
            e = runner._eager_entry(bucket, table)
            with e.lock:
                e.run(runner._entry_inputs(bucket), (table,))
    return ladder_memory(runner, "generate", run_eager,
                         lambda: runner.warmup(kv=table))


def gen_entry_gate(checks, runner):
    """Each captured entry against the eager plan on the card, one call
    of every bucket from the same random table: logits and table bit
    for bit (or within the tolerance, printed).  Then a decode on a
    second table: captured anew on it, the first table untouched, the
    same logits; the first table keeps its graphs (4 more steps on it
    build nothing and return it).  (``donate=False``, refused on the
    card until phase 24, is gated there.)"""
    import torch
    from mxtpu_torch.serving.entry import tensor_key
    g = torch.Generator(device=CARD).manual_seed(SEED + 26)
    base = torch.randn(runner._kv_shape, generator=g, device=CARD)
    kv_c, kv_e = torch.empty_like(base), torch.empty_like(base)
    rng = np.random.RandomState(SEED + 26)
    apart, worst_abs, worst_rel = [], 0.0, 0.0
    for kind, shp in runner.buckets():
        if kind == "prefill":
            b, s = shp
            args = (rng.randint(0, VOCAB, (b, s)).astype(np.float32),
                    rng.randint(0, MAXLEN - s, b).astype(np.float32),
                    rng.permutation(runner.max_lanes)[:b].astype(
                        np.float32))
            call = runner.prefill
        else:
            args = (rng.randint(0, VOCAB, (shp[0], 1)).astype(np.float32),
                    rng.randint(0, MAXLEN, shp[0]).astype(np.float32))
            call = runner.decode
        kv_c.copy_(base)
        kv_e.copy_(base)
        got, _ = call(*args, kv_c)
        with eager_plan(runner):
            want, _ = call(*args, kv_e)
        for a, b in ((torch.from_numpy(got), torch.from_numpy(want)),
                     (kv_c, kv_e)):
            if not torch.equal(a, b):
                rel, absmax = rel_err(a, b)
                apart.append(f"{kind} {shp}")
                worst_abs = max(worst_abs, absmax)
                worst_rel = max(worst_rel, rel)
    del base, kv_e
    dec = ("decode", (runner.max_lanes + 1,))
    args = (rng.randint(0, VOCAB, (dec[1][0], 1)).astype(np.float32),
            np.zeros(dec[1][0], np.float32))
    kv_c.zero_()
    first, _ = runner.decode(*args, kv_c)
    entry = runner._tables[tensor_key(kv_c)][dec]
    kept = kv_c.clone()
    other = runner._zeros()
    second, out = runner.decode(*args, other)
    anew = runner._tables[tensor_key(other)][dec] is not entry
    untouched = torch.equal(kv_c, kept)
    same = np.array_equal(first, second) and torch.equal(out, kept)
    n_built, secs = runner.num_compiled(), dict(runner.compile_seconds)
    backs = [runner.decode(*args, kv_c)[1] for _ in range(4)]
    kept_graphs = (runner._tables[tensor_key(kv_c)][dec] is entry
                   and all(b is kv_c for b in backs)
                   and runner.num_compiled() == n_built
                   and runner.compile_seconds == secs)
    ok = worst_rel <= SERVE_TOL and anew and untouched and same \
        and out is other and kept_graphs
    print(f"check generate: each of {len(runner.buckets())} captured "
          f"entries vs the eager plan on the card (logits and table): "
          f"{len(runner.buckets()) - len(set(apart))} bit for bit" +
          (f"; {sorted(set(apart))} apart by at most "
           f"max_abs_err={worst_abs:.3e} max_rel_err={worst_rel:.3e} "
           f"tol={SERVE_TOL}" if apart else "") +
          f"; a decode on another table captured anew {anew}, the first "
          f"table untouched {untouched}, the same logits and table "
          f"{same}; 4 more steps on the first table built nothing "
          f"{kept_graphs} {'ok' if ok else 'FAIL'}", flush=True)
    checks.rows.append({"check": "generate entries captured vs eager",
                        "apart": sorted(set(apart)),
                        "max_abs_err": worst_abs, "max_rel_err": worst_rel,
                        "tol": SERVE_TOL, "another_table_anew": anew,
                        "first_table_untouched": untouched,
                        "same_result": same,
                        "first_table_kept_graphs": kept_graphs,
                        "ok": ok})
    if not ok:
        checks.failed.append("generate: a captured entry differs from the "
                             "eager plan, wrote a table it was not "
                             "passed, or was built again on its own "
                             "table")


def gen_alone(runner, prompt, kw):
    """One request run alone through a fresh GenerateBatcher."""
    from mxtpu_torch.serving import GenerateBatcher
    b = GenerateBatcher(runner)
    r = b.submit(prompt, **kw)
    while not r.done():
        b.step()
    b.close()
    return r.result(0)


def gen_server_gate(checks, net, runner):
    """Gate 4: InferenceServer.register_generator serves 32 requests from
    4 client threads (prompts 8-300 tokens, those past 128 prefilled in
    chunks; half greedy, half top-k 8 with their own seeds); every
    stream complete, none hanging; each greedy stream against the same
    request run alone.  Its launches are the kernels line's."""
    from mxtpu_torch import kernels
    from mxtpu_torch.serving import InferenceServer
    rng = np.random.RandomState(SEED + 24)
    lens = [int(n) for n in rng.randint(GEN_PROMPT_LENS[0],
                                        GEN_PROMPT_LENS[1] + 1,
                                        GEN_REQUESTS)]
    prompts = [[int(t) for t in rng.randint(0, VOCAB, n)] for n in lens]
    kws = [dict(max_tokens=GEN_MAX_TOKENS) if i % 2 == 0 else
           dict(max_tokens=GEN_MAX_TOKENS, top_k=GEN_TOPK, seed=1000 + i)
           for i in range(GEN_REQUESTS)]
    streams = [[] for _ in prompts]
    results = [None] * GEN_REQUESTS
    errors = []
    server = InferenceServer(log_every_s=1e9)
    # warmup=True: the ladder is captured on the endpoint's table
    server.register_generator("gen", runner, warmup=True)

    def client(idx):
        try:
            reqs = [(i, server.submit_generate(
                "gen", prompts[i], timeout_s=600.0,
                on_token=lambda t, j, g=streams[i]: g.append((j, t)),
                **kws[i])) for i in idx]
            for i, req in reqs:
                results[i] = (req.result(timeout=660.0), req.finish_reason)
        except Exception as e:  # noqa: BLE001 — reported as a failure
            errors.append(repr(e))

    threads = [threading.Thread(target=client,
                                args=(range(c, GEN_REQUESTS,
                                            GEN_CLIENTS),))
               for c in range(GEN_CLIENTS)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    ep = server._gen_endpoint("gen", None)
    steps, joins = ep.batcher.steps, ep.batcher.joins
    server.close()
    snap = server.stats("gen")
    if any(t.is_alive() for t in threads):
        checks.failed.append("generate: client threads did not finish")
    if errors:
        checks.failed.append(f"generate: request errors: {errors[:3]}")
    bad = [i for i, r in enumerate(results)
           if r is None or len(r[0]) != GEN_MAX_TOKENS
           or r[1] != "length" or [j for j, _ in streams[i]] !=
           list(range(GEN_MAX_TOKENS)) or [t for _, t in streams[i]] !=
           r[0]]
    if bad:
        checks.failed.append(f"generate: {len(bad)} streams incomplete, "
                             f"of the wrong length or finish reason")
    failures = snap["extras"].get("step_failures", 0)
    if failures:
        checks.failed.append(f"generate: {failures} failed steps (last "
                             f"error {ep.last_error!r})")
    n_calls = counts["layer_norm_fwd"]
    for name, got in counts.items():
        want = GEN_LAUNCHES.get(name, 0) * n_calls
        if got != want:
            checks.failed.append(f"generate serving: {name} launched {got}"
                                 f" times in {n_calls} runner calls, want "
                                 f"{GEN_LAUNCHES.get(name, 0)} a call")
    if n_calls == 0:
        checks.failed.append("generate serving launched no kernel")
    tokens = GEN_REQUESTS * GEN_MAX_TOKENS
    gen = snap.get("generate", {})
    print(f"generate serving: {GEN_REQUESTS} requests (prompts "
          f"{min(lens)}-{max(lens)} tokens, {GEN_MAX_TOKENS} new tokens "
          f"each) from {GEN_CLIENTS} threads in {wall:.3f} s = "
          f"{tokens / wall:.2f} tokens/s; {steps} decode steps, {joins} "
          f"joins, {n_calls} runner calls; server stats TTFT p50 "
          f"{gen.get('ttft_ms', {}).get('p50')} ms p95 "
          f"{gen.get('ttft_ms', {}).get('p95')} ms, per-token p50 "
          f"{gen.get('token_ms', {}).get('p50')} ms p95 "
          f"{gen.get('token_ms', {}).get('p95')} ms; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}",
          flush=True)

    # each greedy stream against the same request alone
    ties, diverged = 0, []
    for i in range(0, GEN_REQUESTS, 2):
        if results[i] is None:
            continue
        alone = gen_alone(runner, prompts[i], kws[i])
        ok, at = same_greedy(net, prompts[i], results[i][0], alone)
        if not ok:
            diverged.append(i)
        elif at is not None:
            ties += 1
    ok = not diverged
    print(f"check generate: {GEN_REQUESTS // 2} greedy served streams vs "
          f"each request alone: {len(diverged)} differ beyond a near tie,"
          f" {ties} part at a near tie {'ok' if ok else 'FAIL'}",
          flush=True)
    checks.rows.append({"check": "generate served vs alone",
                        "diverged": diverged, "ties": ties, "ok": ok})
    if not ok:
        checks.failed.append(f"generate: served greedy streams {diverged} "
                             f"differ from the request alone")
    return counts, {"requests": GEN_REQUESTS, "clients": GEN_CLIENTS,
                    "wall_s": wall, "tok_per_s": tokens / wall,
                    "decode_steps": steps, "joins": joins,
                    "runner_calls": n_calls, "server_stats": gen,
                    "near_ties": ties}


def gen_replay_gate(checks, net, runner):
    """Gate 5: 8 requests (4 greedy, 4 top-k) in a batcher closed after
    a third of their tokens (8 steps at 24 tokens); each resubmitted
    from its ``partial_state()`` as a ``prefix`` in a new batcher
    continues at the exact next index with no token twice, and its
    greedy tokens match the run never closed."""
    from mxtpu_torch.serving import GenerateBatcher, WorkerLost
    rng = np.random.RandomState(SEED + 25)
    prompts = [[int(t) for t in rng.randint(0, VOCAB, n)]
               for n in rng.randint(8, 129, runner.max_lanes)]
    kws = [dict(max_tokens=GEN_MAX_TOKENS) if i % 2 == 0 else
           dict(max_tokens=GEN_MAX_TOKENS, top_k=GEN_TOPK, seed=2000 + i)
           for i in range(len(prompts))]

    def start():
        b = GenerateBatcher(runner)
        streams = [[] for _ in prompts]
        reqs = [b.submit(p, on_token=lambda t, j, g=g: g.append((j, t)),
                         **k) for p, k, g in zip(prompts, kws, streams)]
        return b, reqs, streams

    b, reqs, _ = start()
    while not b.drain():
        b.step()
    full = [r.result(0) for r in reqs]
    b, reqs, streams = start()
    close_after = GEN_MAX_TOKENS // 3
    for _ in range(close_after):
        b.step()
    b.close()
    b2 = GenerateBatcher(runner)
    resumed, bad = [], []
    for i, r in enumerate(reqs):
        try:
            r.result(0)
            bad.append(i)            # nothing should finish by then
            continue
        except WorkerLost as e:
            p = e.partial
        resumed.append((i, b2.submit(
            p["prompt"], prefix=p["tokens"],
            on_token=lambda t, j, g=streams[i]: g.append((j, t)),
            **kws[i])))
    while not b2.drain():
        b2.step()
    ties = 0
    for i, r in resumed:
        got = r.result(0)
        if [j for j, _ in streams[i]] != list(range(GEN_MAX_TOKENS)) or \
                [t for _, t in streams[i]] != got:
            bad.append(i)
        elif kws[i].get("top_k", 1) <= 1:
            ok, at = same_greedy(net, prompts[i], got, full[i])
            if not ok:
                bad.append(i)
            elif at is not None:
                ties += 1
    ok = not bad
    print(f"check generate replay: {len(resumed)} streams closed after "
          f"{close_after} steps and resumed from partial_state(): "
          f"{len(bad)} with a missing, repeated or (greedy) wrong token, "
          f"{ties} greedy part at a near tie {'ok' if ok else 'FAIL'}",
          flush=True)
    checks.rows.append({"check": "generate replay", "bad": bad,
                        "ties": ties, "ok": ok})
    if not ok:
        checks.failed.append(f"generate: replayed streams {bad} wrong")


def gen_kernel_rows(checks, gen):
    """#4 and #6 at the decode step's shape (9 slots x C = 1024, f32,
    keep 1) against their plain versions, timed beside the library
    call (LayerNorm) and the byte bound: the kernels line's rows for
    the generation path."""
    import torch
    import torch.nn.functional as F
    import importlib
    ln = importlib.import_module("mxtpu_torch.kernels.layer_norm")
    R, C = GEN_LANES + 1, UNITS
    dev = torch.device(CARD)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    x, g, b = randn(R, C), 1.0 + 0.1 * randn(C), 0.1 * randn(C)
    y, _, _ = ln.layer_norm_fwd(x, g, b)
    py, _, _ = ln.layer_norm_reference(x, g, b)
    torch.cuda.synchronize()
    out = {}
    err = checks.close(f"layer_norm R{R} C{C} (decode step)", y, py,
                       "float32")
    nbytes = 2 * R * C * 4 + 2 * C * 4 + 2 * R * 4
    b_ms, b_by = bound(nbytes, 8 * R * C, "float32")
    out["layer_norm_fwd"] = {
        "max_abs_err": err,
        **timed(lambda: ln.layer_norm_fwd(x, g, b),
                lambda: ln.layer_norm_reference(x, g, b),
                lambda: F.layer_norm(x, (C,), g, b)),
        "bound_ms": b_ms, "bound_by": b_by}
    h, res, bias = randn(R, C), randn(R, C), 0.1 * randn(C)
    args = (h, bias, res, g, b, None, 0.0, 1e-5, False)
    y, _, _ = ln.fused_residual_ln_fwd(*args)
    py, _, _ = ln.fused_residual_ln_reference(*args)
    torch.cuda.synchronize()
    err = checks.close(f"fused_residual_ln R{R} C{C} keep=1 (decode step)",
                       y, py, "float32")
    nbytes = 3 * R * C * 4 + 3 * C * 4 + 2 * R * 4
    b_ms, b_by = bound(nbytes, 10 * R * C, "float32")
    out["fused_residual_ln_fwd"] = {
        "max_abs_err": err,
        **timed(lambda: ln.fused_residual_ln_fwd(*args),
                lambda: ln.fused_residual_ln_reference(*args)),
        "bound_ms": b_ms, "bound_by": b_by}
    for name, r in out.items():
        lib = "null" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f}"
        print(f"time {name} [float32, R{R} x C{C}, the decode step] "
              f"(device ms per call): kernel_ms={r['ms']:.6f} "
              f"plain_ms={r['plain_ms']:.6f} library_ms={lib} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}); kernel "
              f"wall_ms={r['wall_ms']:.6f}", flush=True)
    return out


def generate_phase(checks, gen, scales):
    """Phase 18 (see the module's docstring), with phase 19's
    generation under AMP and int8 (``scales``: the serving phase's
    entropy thresholds)."""
    import tempfile
    import torch
    from mxtpu_torch.serving import GenerateRunner
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "mxtpu_torch" / "_build",
                                     prefix="gen_") as tmp:
        t0 = time.perf_counter()
        net, files = gen_export(os.path.join(tmp, "genbert"))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        runner = GenerateRunner.from_export(
            *files, net.kv_cache_spec(GEN_LANES, MAXLEN),
            prompt_buckets=GEN_BUCKETS)
        load_s = time.perf_counter() - t0
        table = runner.new_cache()
        warm, memory = gen_memory(runner, table)
        kv_gb = float(np.prod(runner._kv_shape)) * 4 / 1e9
        print(f"generate: BERT-Large causal (f32) exported in "
              f"{export_s:.1f} s, GenerateRunner.from_export "
              f"{load_s:.1f} s ({runner.weight_bytes() / 1e9:.3f} GB of "
              f"weights, a {kv_gb:.3f} GB KV table of "
              f"{GEN_LANES} lanes + scratch x L {MAXLEN}); warmup of "
              f"{len(warm)} buckets {sum(warm.values()):.1f} s", flush=True)
        marks = [time.perf_counter()]
        secs = {"setup": marks[0] - t_phase}

        def lap(tag):
            marks.append(time.perf_counter())
            secs[tag] = marks[-1] - marks[-2]

        inc_err = gen_incremental_gate(checks, net, runner, table)
        lap("incremental")
        cpu_err = gen_cpu_gate(checks, runner, files, table)
        lap("cpu")
        passes = gen_pass_gate(checks, files, runner.kv_spec, scales)
        lap("amp and int8")
    gen_entry_gate(checks, runner)
    lap("entries")
    sat = gen_saturation(runner, "captured")
    with eager_plan(runner):
        sat_eager = gen_saturation(runner, "eager plan")
    lap("saturation")
    breakdown = gen_decode_breakdown(checks, runner, "captured")
    with eager_plan(runner):
        breakdown_eager = gen_decode_breakdown(checks, runner,
                                               "eager plan", False)
    lap("breakdown")
    counts, served = gen_server_gate(checks, net, runner)
    lap("server")
    gen_replay_gate(checks, net, runner)
    lap("replay")
    rows = gen_kernel_rows(checks, gen)
    lap("kernels")
    phase_s = time.perf_counter() - t_phase
    print(f"generate: phase {phase_s:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()) + ")", flush=True)
    return counts, rows, {"export_s": export_s, "load_s": load_s,
                          "warmup_s": sum(warm.values()),
                          "num_compiled": runner.num_compiled(),
                          "memory": memory, "kv_table_gb": kv_gb,
                          "weight_gb": runner.weight_bytes() / 1e9,
                          "incremental_vs_full_max_abs_err": inc_err,
                          "card_vs_cpu_max_abs_err": cpu_err,
                          "saturation": sat,
                          "saturation_eager_plan": sat_eager,
                          "decode_breakdown": breakdown,
                          "decode_breakdown_eager_plan": breakdown_eager,
                          "serving": served, "phase_s": phase_s,
                          "amp_int8": passes, "phase_split_s": secs}


# ----------------------------------------------------------------------
# phase 19: AMP training and AMP / int8 serving (mxtpu_torch.amp,
# mxtpu_torch.quant)
# ----------------------------------------------------------------------

AMP_PARITY = {"rtol": 3e-2, "atol": 1e-2}   # tests/test_amp.py's AMP vs f32
# the card's contraction routes against their plain versions: the same
# exact products of bf16 operands, f32 sums in another order.  A GEMM's
# element is held to twice the rounding bound of a K-term f32 sum,
# K * 2^-24 * sum_k |a_ik b_kj|; a convolution to 1e-5 of the result's
# largest magnitude, its weight gradient (N * OH * OW terms, 8e5 at
# ResNet's 3x3, with cancellation) to 1e-3
ROUTE_TOL, ROUTE_DW_TOL = 1e-5, 1e-3
# BERT's GEMMs a training step, (M, K, N) of the forward x @ w^T
AMP_GEMMS = {"qkv": (B * T, UNITS, 3 * UNITS), "proj": (B * T, UNITS, UNITS),
             "ffn1": (B * T, UNITS, FFN), "ffn2": (B * T, FFN, UNITS),
             "head": (B * T, UNITS, VOCAB)}
# one ResNet-50 NHWC convolution of each kind at b256: x, w (OHWI),
# stride, pad
AMP_CONVS = {"7x7/2": ((RN_B, RN_HW, RN_HW, 3), (64, 7, 7, 3), 2, 3),
             "3x3": ((RN_B, 56, 56, 64), (64, 3, 3, 64), 1, 1),
             "1x1/2": ((RN_B, 14, 14, 1024), (2048, 1, 1, 1024), 2, 0)}
AMP_DOTS_BERT = 4 * LAYERS + 1       # FullyConnected a forward
AMP_CONVS_RN, AMP_DOTS_RN = 53, 1
SKIP_TURNS = 2                        # (scaler, none, none, scaler) turns
# logits, card vs the CPU's plain path, of their scale: AMP and int8
# round a few inputs a layer to the other side of a bf16 or int8 step
# where the f32 sums before them differ in the last bit, and over 24
# layers the two runs part by about each type's own distance from f32
# (served BERT-Large: AMP 0.015, int8 0.05 of the scale)
PASS_CPU_TOL = {"amp": 5e-2, "int8": 1e-1}
QS_SEQ, QS_MAX_B = 128, 32
QS_CALIB_B, QS_CALIB_N = 4, 2         # seeded calibration batches
QS_CPU_BUCKET = (1, QS_SEQ)


def pass_counts():
    """The AMP and int8 contraction counts (forward GEMMs, forward
    convolutions, int8 products) since the last reset."""
    from mxtpu_torch import amp, quant
    return {"amp_dot": amp.DOT_LAUNCHES, "amp_conv": amp.CONV_LAUNCHES,
            "int8_gemm": quant.INT8_GEMMS}


def reset_pass_counts():
    from mxtpu_torch import amp, quant
    amp.DOT_LAUNCHES = amp.CONV_LAUNCHES = quant.INT8_GEMMS = 0


def check_pass_counts(checks, tag, per_step, n):
    got = pass_counts()
    want = {k: per_step.get(k, 0) * n for k in got}
    if got != want:
        checks.failed.append(f"{tag}: AMP/int8 contractions {got} in {n} "
                             f"calls, want {want}")
    return got


def snapshot_trained(step):
    """The trainable parameters and every optimizer-state leaf of
    ``step``, copied (the running statistics, which a skipped step's
    forward still moves, as mxtpu's do, left out)."""
    return ([p.detach().clone() for p in step._params] +
            [leaf.detach().clone() for st in step._canonical_state()
             for leaf in st])


def amp_dtypes_ok(step):
    """Trainable parameters bf16 (f32 only for aux-named ones), the
    running statistics f32, every float state leaf f32."""
    import torch
    from mxtpu_torch.symbol import _is_aux_name
    ok = all(p.dtype == (torch.float32 if _is_aux_name(n)
                         else torch.bfloat16)
             for n, p in zip(step.param_names, step._params))
    ok &= all(p.data().dtype == np.float32
              for p in step.net.collect_params().values()
              if _is_aux_name(p.name))
    ok &= all(leaf.dtype == torch.float32
              for st in step._canonical_state() for leaf in st
              if leaf.is_floating_point())
    return bool(ok)


def route_rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def contraction_route_phase(checks, gen):
    """The AMP contraction routes against their plain versions on the
    card: the f32-output GEMM at BERT's five forward shapes and the two
    backward ones of each, and the GEMM-over-patches convolution,
    forward and backward, at one ResNet-50 NHWC convolution of each
    kind; each timed beside its plain version, its bound (bytes or bf16
    tensor-core operations) and a library call with a bf16 output."""
    import torch
    import torch.nn.functional as F
    from mxtpu_torch import amp
    dev = torch.device(CARD)
    rows = {}

    def randn(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=gen, device=dev)).bfloat16()

    worst = 0.0
    for name, (m, k, n) in AMP_GEMMS.items():
        x, w, g = randn(m, k), randn(n, k, s=0.02), randn(m, n)
        for kind, (a, b) in (("fwd", (x, w.t())), ("dx", (g, w)),
                             ("dw", (g.t(), x))):
            got, want = amp.gemm(a, b), amp.gemm_plain(a, b)
            # of the bound 2 * K * 2^-24 * (|a| @ |b|), elementwise
            lim = amp.gemm_plain(a.abs(), b.abs()) * (2 * a.shape[1]
                                                     * 2.0 ** -24)
            frac = float(((got - want).abs() / lim.clamp_min(1e-30)).max())
            worst = max(worst, frac)
            if frac > 1.0:
                checks.failed.append(f"amp GEMM route {name} {kind}: "
                                     f"{frac:.3f} of its sum bound")
            del got, want, lim
        a, b = x, w.t()
        mm, kk, nn_ = a.shape[0], a.shape[1], b.shape[1]
        b_ms, b_by = bound(2 * (mm * kk + kk * nn_) + 4 * mm * nn_,
                           2 * mm * kk * nn_, "bfloat16")
        rows[f"gemm {name}"] = {
            "ms": device_ms(lambda: amp.gemm(a, b)),
            "plain_ms": device_ms(lambda: amp.gemm_plain(a, b)),
            "library_bf16_out_ms": device_ms(lambda: a @ b),
            "bound_ms": b_ms, "bound_by": b_by}
        del x, w, g, a, b
    print(f"check amp GEMM route (bf16 x bf16 -> f32, torch.mm out_dtype) "
          f"vs its plain f32 product at BERT's 5 shapes x fwd/dx/dw: the "
          f"largest difference {worst:.4f} of the f32 sum bound 2 K 2^-24 "
          f"(|a| @ |b|) {'ok' if worst <= 1.0 else 'FAIL'}", flush=True)
    for name, (xs, ws, st, pd) in AMP_CONVS.items():
        x, w = randn(*xs), randn(*ws, s=0.05)
        geom = (ws[1:3], (st, st), (pd, pd), (1, 1), 1, "NHWC")
        y = amp._conv_gemm(x, w, geom)
        ry = route_rel(y, amp.conv_plain(x, w, geom))
        g = randn(*y.shape)
        (dx, dw), (px, pw) = (amp._conv_gemm_bwd(x, w, g, geom),
                              amp.conv_bwd_plain(x, w, g, geom))
        rx, rw = route_rel(dx, px), route_rel(dw, pw)
        ok = ry <= ROUTE_TOL and rx <= ROUTE_TOL and rw <= ROUTE_DW_TOL
        print(f"check amp conv route {name} NHWC {xs} (GEMM over the "
              f"patches) vs the plain f32 convolution: y {ry:.3e}, dx "
              f"{rx:.3e} (tol {ROUTE_TOL}), dw {rw:.3e} (tol "
              f"{ROUTE_DW_TOL}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            checks.failed.append(f"amp conv route {name} differs from its "
                                 f"plain version")
        del y, dx, dw, px, pw
        oh = (xs[1] + 2 * pd - ws[1]) // st + 1
        ops = 2 * xs[0] * oh * oh * ws[0] * ws[1] * ws[2] * ws[3]
        nbytes = 2 * (x.numel() + w.numel()) + 4 * xs[0] * oh * oh * ws[0]
        b_ms, b_by = bound(nbytes, ops, "bfloat16")
        xc, wc = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2)
        rows[f"conv {name}"] = {
            "ms": device_ms(lambda: amp._conv_gemm(x, w, geom)),
            "bwd_ms": device_ms(lambda: amp._conv_gemm_bwd(x, w, g, geom)),
            "plain_ms": device_ms(lambda: amp.conv_plain(x, w, geom)),
            "library_bf16_out_ms": device_ms(
                lambda: F.conv2d(xc, wc, None, st, pd)),
            "bound_ms": b_ms, "bound_by": b_by}
        del x, w, g, xc, wc
        torch.cuda.empty_cache()
    for name, r in rows.items():
        print(f"time amp route {name} (device ms): route_ms={r['ms']:.4f}" +
              (f" bwd_ms={r['bwd_ms']:.4f}" if "bwd_ms" in r else "") +
              f" plain_ms={r['plain_ms']:.4f} library_bf16_out_ms="
              f"{r['library_bf16_out_ms']:.4f} bound_ms={r['bound_ms']:.4f}"
              f" ({r['bound_by']})", flush=True)
    return rows


def amp_bert_cell(checks, training, training_f32):
    """BERT-Large under AMP with bench_bert's recipe: the storage types,
    3 steps against the f32 step from the same seeds, ``MXTPU_AMP=0``
    bit-equal to ``amp=None``, launches and contractions per step
    exact, ms/step and one profiled step beside the bf16 and f32 runs
    of this call, the skip's cost (the step with the scaler against one
    built with ``MXTPU_AMP_LOSS_SCALE=0``, in turns) and a step under an
    inf scale: skipped and counted, every weight and state tensor
    unchanged."""
    import torch
    from mxtpu_torch import kernels
    toks = bert_tokens()
    t0 = time.perf_counter()
    # each step runs right after its build, which reseeds the dropout
    # stream: the three see the same masks
    step = seeded_bert_step(None, amp=True)
    types_ok = amp_dtypes_ok(step)
    amp_l = [float(step(toks, toks)) for _ in range(GATE_STEPS)]
    f32 = seeded_bert_step(None)
    f32_l = [float(f32(toks, toks)) for _ in range(GATE_STEPS)]
    os.environ["MXTPU_AMP"] = "0"
    try:
        killed = seeded_bert_step(None, amp=True)
    finally:
        del os.environ["MXTPU_AMP"]
    killed_l = [float(killed(toks, toks)) for _ in range(GATE_STEPS)]
    parity = bool(np.allclose(amp_l, f32_l, **AMP_PARITY))
    kill_ok = killed_l == f32_l and \
        bit_equal(train_snapshot(killed), train_snapshot(f32)) and \
        killed.amp_stats() is None
    del f32, killed
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0

    kernels.reset_launch_counts()
    reset_pass_counts()
    window_ms, losses = [], list(amp_l)
    for _ in range(TRAIN_WINDOWS):
        t1 = time.perf_counter()
        losses += [step(toks, toks) for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - t1) / TRAIN_STEPS * 1e3)
    n = TRAIN_STEPS * TRAIN_WINDOWS
    counts = kernels.launch_counts()
    check_launches(checks, "training amp", counts, BERT_LAUNCHES, n)
    passes = check_pass_counts(checks, "training amp",
                               {"amp_dot": AMP_DOTS_BERT}, n)
    losses = [float(v) for v in losses]
    ms_step = float(np.median(window_ms))
    breakdown = profiled_step(checks, "training amp", step, toks, toks)
    stats = step.amp_stats()

    # the skip's cost: the same step built without a scaler reads no
    # flag back; windows in turns, scaler first
    os.environ["MXTPU_AMP_LOSS_SCALE"] = "0"
    try:
        plain = seeded_bert_step(None, amp=True)
    finally:
        del os.environ["MXTPU_AMP_LOSS_SCALE"]
    turns = {"scaler": [], "no scaler": []}
    for tag, st in (("scaler", step), ("no scaler", plain),
                    ("no scaler", plain), ("scaler", step)) * SKIP_TURNS:
        st(toks, toks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            st(toks, toks)
        torch.cuda.synchronize()
        turns[tag].append((time.perf_counter() - t1) / TRAIN_STEPS * 1e3)
    plain_bd = step_breakdown(plain, toks, toks)
    del plain
    torch.cuda.empty_cache()
    skip_ms = float(np.mean(turns["scaler"]) - np.mean(turns["no scaler"]))

    # a non-finite step: the scale set to inf, so every scaled gradient
    # is inf or nan (the token batch cannot carry one; ResNet's does)
    before = snapshot_trained(step)
    st = step._amp_state
    step._amp_state = (torch.full_like(st[0], float("inf")), st[1], st[2])
    skipped_before = stats["skipped_steps"]
    step(toks, toks)
    after = step.amp_stats()
    skip_ok = bit_equal(before, snapshot_trained(step)) and \
        after["skipped_steps"] == skipped_before + 1 and \
        after["good_steps"] == 0
    del before
    ok = types_ok and parity and kill_ok and skip_ok and \
        all(np.isfinite(losses)) and np.mean(losses[-3:]) < losses[0]
    bf16, f32m = training, training_f32
    print(f"check training amp BERT-Large: parameters bf16, masters and "
          f"state f32 {types_ok}; {GATE_STEPS} steps {amp_l} vs f32 "
          f"{f32_l} within rtol {AMP_PARITY['rtol']} atol "
          f"{AMP_PARITY['atol']} {parity}; MXTPU_AMP=0 bit-equal to "
          f"amp=None (losses, weights, state) {kill_ok}; a step under "
          f"an inf scale skipped, weights and state bit-equal, counted "
          f"{skip_ok} {'ok' if ok else 'FAIL'}", flush=True)
    print(f"training amp BERT-Large b{B} T{T} adam: losses "
          f"{[round(v, 4) for v in losses]}; scaler {stats}", flush=True)
    print(f"training BERT-Large ms/step (median of {TRAIN_WINDOWS} windows "
          f"of {TRAIN_STEPS}) and device ms a step (profiled): amp "
          f"{ms_step:.3f} / {breakdown['device_busy_ms']:.3f} (idle "
          f"{breakdown['device_idle_share'] or 0:.4f}), bf16 compute "
          f"{bf16['ms_per_step']:.3f} / "
          f"{bf16['breakdown']['device_busy_ms']:.3f}, f32 "
          f"{f32m['ms_per_step']:.3f} / "
          f"{f32m['breakdown']['device_busy_ms']:.3f}", flush=True)
    print(f"training amp: the skip's flag read costs {skip_ms:.3f} ms a "
          f"step (windows of {TRAIN_STEPS} in turns: scaler "
          f"{[round(v, 3) for v in turns['scaler']]}, no scaler "
          f"{[round(v, 3) for v in turns['no scaler']]}); no-scaler "
          f"device {plain_bd['device_busy_ms']:.3f} ms; set-up and gates "
          f"{setup_s:.1f} s; launches in {n} steps {json.dumps(counts)}, "
          f"contractions {passes}", flush=True)
    if not ok:
        checks.failed.append("training amp (BERT-Large): a gate failed")
    del step
    torch.cuda.empty_cache()
    return counts, {"ms_per_step": ms_step, "window_ms_per_step": window_ms,
                    "tokens_per_s": B * T / ms_step * 1e3,
                    "losses": losses, "f32_losses": f32_l,
                    "breakdown": breakdown, "scaler": stats,
                    "skip_cost_ms": skip_ms, "skip_turns_ms": turns,
                    "no_scaler_device_ms": plain_bd["device_busy_ms"],
                    "types_ok": types_ok, "parity": parity,
                    "kill_switch_bit_equal": kill_ok, "skip_ok": skip_ok}


def amp_resnet_cell(checks, resnet_bf16):
    """ResNet-50 v1 NHWC under AMP with bench_resnet50's recipe: the
    storage types, 3 steps against the f32 step from the same seeds
    (the f32 steps timed, one profiled), launches and contractions per
    step exact, ms/step and one profiled step, and a batch with an inf
    pixel: skipped, weights and state unchanged, the scale halved."""
    import torch
    from mxtpu_torch import kernels
    from mxtpu_torch.parallel import build_train_step
    xn, yn = rn_batch("NHWC", RN_B, RN_HW, SEED)
    x, y = torch.from_numpy(xn).to(CARD), torch.from_numpy(yn).to(CARD)
    t0 = time.perf_counter()

    def losses_of(opt, **kw):
        st = build_train_step(resnet50_net("NHWC"), rn_loss(), "sgd", opt,
                              device=CARD, **kw)
        return st, [float(st(x, y)) for _ in range(GATE_STEPS)]

    # the gate at the card-vs-CPU check's lr 1e-3: at the recipe's 0.1
    # the three steps are chaotic (printed below: f32 against f32 with
    # TF32 convolutions parts there too)
    chk, chk_amp = losses_of(RN_CHECK_SGD, amp=True)
    types_ok = amp_dtypes_ok(chk)
    del chk
    chk, chk_f32 = losses_of(RN_CHECK_SGD)
    del chk
    parity = bool(np.allclose(chk_amp, chk_f32, **AMP_PARITY))
    step, amp_l = losses_of(RN_SGD, amp=True)
    f32 = build_train_step(resnet50_net("NHWC"), rn_loss(), "sgd", RN_SGD,
                           device=CARD)
    f32_l = []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(GATE_STEPS):
        f32_l.append(float(f32(x, y)))
    f32_ms = (time.perf_counter() - t1) / GATE_STEPS * 1e3
    f32_bd = step_breakdown(f32, x, y)
    del f32
    old_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32, tf32_l = losses_of(RN_SGD)
    finally:
        torch.backends.cudnn.allow_tf32 = old_tf32
    del tf32
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0

    kernels.reset_launch_counts()
    reset_pass_counts()
    window_ms, losses = [], list(amp_l)
    for _ in range(TRAIN_WINDOWS):
        t1 = time.perf_counter()
        losses += [step(x, y) for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - t1) / TRAIN_STEPS * 1e3)
    n = TRAIN_STEPS * TRAIN_WINDOWS
    counts = kernels.launch_counts()
    check_launches(checks, "resnet50 NHWC amp", counts, RN_LAUNCHES["NHWC"],
                   n)
    passes = check_pass_counts(checks, "resnet50 NHWC amp",
                               {"amp_conv": AMP_CONVS_RN,
                                "amp_dot": AMP_DOTS_RN}, n)
    losses = [float(v) for v in losses]
    ms_step = float(np.median(window_ms))
    breakdown = profiled_step(checks, "resnet50 NHWC amp", step, x, y)

    stats = step.amp_stats()
    before = snapshot_trained(step)
    bad = x.clone()
    bad[0, 0, 0, 0] = float("inf")
    step(bad, y)
    after = step.amp_stats()
    skip_ok = bit_equal(before, snapshot_trained(step)) and \
        after["loss_scale"] == stats["loss_scale"] / 2 and \
        after["skipped_steps"] == stats["skipped_steps"] + 1
    del before, bad
    ok = types_ok and parity and skip_ok and all(np.isfinite(losses)) \
        and np.mean(losses[-3:]) < losses[0]
    print(f"check resnet50 NHWC amp: parameters bf16 (running statistics "
          f"f32), masters and state f32 {types_ok}; {GATE_STEPS} steps at "
          f"lr {RN_CHECK_SGD['learning_rate']} {chk_amp} vs f32 {chk_f32} "
          f"within rtol {AMP_PARITY['rtol']} atol {AMP_PARITY['atol']} "
          f"{parity}; a batch with an inf pixel skipped, weights and state "
          f"bit-equal, scale halved {skip_ok} {'ok' if ok else 'FAIL'}; at "
          f"the recipe's lr {RN_SGD['learning_rate']} (no gate): amp "
          f"{amp_l}, f32 {f32_l}, f32 with TF32 convolutions {tf32_l}",
          flush=True)
    print(f"resnet50 NHWC amp b{RN_B} {RN_HW}x{RN_HW} sgd momentum: losses "
          f"{[round(v, 4) for v in losses]}; scaler {step.amp_stats()}",
          flush=True)
    print(f"resnet50 NHWC ms/step and device ms a step (profiled): amp "
          f"{ms_step:.3f} (median of {TRAIN_WINDOWS} windows of "
          f"{TRAIN_STEPS}) / {breakdown['device_busy_ms']:.3f} (idle "
          f"{breakdown['device_idle_share'] or 0:.4f}), bf16 compute "
          f"{resnet_bf16['ms_per_step']:.3f} / "
          f"{resnet_bf16['breakdown']['device_busy_ms']:.3f}, f32 "
          f"{f32_ms:.3f} (mean of {GATE_STEPS}, the first included) / "
          f"{f32_bd['device_busy_ms']:.3f}; set-up and gates {setup_s:.1f}"
          f" s; launches in {n} steps {json.dumps(counts)}, contractions "
          f"{passes}", flush=True)
    for fam in ("gemm", "other"):
        print(f"resnet50 NHWC amp top {fam} kernels (device ms): " +
              "; ".join(f"{k[:70]} {v:.3f}" for k, v in
                        breakdown["top_kernels"].get(fam, [])[:4]),
              flush=True)
    if not ok:
        checks.failed.append("resnet50 NHWC amp: a gate failed")
    del step
    torch.cuda.empty_cache()
    return counts, {"ms_per_step": ms_step, "window_ms_per_step": window_ms,
                    "samples_per_s": RN_B / ms_step * 1e3,
                    "losses": losses, "f32_losses": f32_l,
                    "tf32_losses": tf32_l, "check_losses": {
                        "amp": chk_amp, "f32": chk_f32},
                    "f32_ms_per_step": f32_ms,
                    "f32_device_ms": f32_bd["device_busy_ms"],
                    "breakdown": breakdown, "types_ok": types_ok,
                    "parity": parity, "skip_ok": skip_ok}


def amp_train_phase(checks, gen, training, training_f32, resnet):
    """Phase 19a (see the module's docstring)."""
    import torch
    t0 = time.perf_counter()
    routes = contraction_route_phase(checks, gen)
    bert_counts, bert = amp_bert_cell(checks, training, training_f32)
    rn_counts, rn = amp_resnet_cell(checks, resnet["NHWC"])
    torch.cuda.empty_cache()
    print(f"amp training: phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"bert": bert_counts, "resnet": rn_counts}, \
        {"routes": routes, "bert": bert, "resnet50_nhwc": rn}


def qs_batches(n, b, seed):
    rng = np.random.RandomState(seed)
    return [{"data": rng.randint(0, VOCAB, (b, QS_SEQ)).astype(np.float32)}
            for _ in range(n)]


def int_mm_shapes(checks, gen):
    """``quant.int_mm`` against the plain int32 product, bit for bit, at
    every (M, K, N) the served ladder and the generation runner reach
    (M = rows of a bucket; the 9-row decode step and BERT's 30522-wide
    head among them, padded for ``torch._int_mm``)."""
    import torch
    from mxtpu_torch import quant
    ms = sorted({b * QS_SEQ for b in (1, 2, 4, 8, 16, 32)} |
                {GEN_LANES + 1} | {b * s for s in GEN_BUCKETS
                                   for b in (1, 2, 4, 8)})
    kn = [(k, n) for _, k, n in AMP_GEMMS.values()]
    apart = []
    for m in ms:
        for k, n in kn:
            a = torch.randint(-127, 128, (m, k), generator=gen,
                              device=CARD, dtype=torch.int8)
            w = torch.randint(-127, 128, (n, k), generator=gen,
                              device=CARD, dtype=torch.int8)
            if not torch.equal(quant.int_mm(a, w),
                               quant.int_mm_plain(a, w)):
                apart.append((m, k, n))
    # the int8 convolution (channels-first: the product over the patches)
    # at ResNet-50's 7x7/2 stem and a 3x3, b8
    for xs, ws, st, pd in (((8, 3, RN_HW, RN_HW), (64, 3, 7, 7), 2, 3),
                           ((8, 64, 56, 56), (64, 64, 3, 3), 1, 1)):
        qx = torch.randint(-127, 128, xs, generator=gen, device=CARD,
                           dtype=torch.int8)
        qw = torch.randint(-127, 128, ws, generator=gen, device=CARD,
                           dtype=torch.int8)
        args = (ws[2:], (st, st), (pd, pd), (1, 1), 1)
        if not torch.equal(quant.int_conv(qx, qw, *args),
                           quant.int_conv_plain(qx, qw, *args)):
            apart.append(("conv", xs, ws))
    ok = not apart
    print(f"check int8 GEMM (torch._int_mm, padded where it refuses) vs the "
          f"plain int32 product at {len(ms) * len(kn)} shapes (M in {ms}, "
          f"(K, N) in {kn}) and the int8 convolution at ResNet-50's 7x7/2 "
          f"and a 3x3 (b8, NCHW): bit for bit "
          f"{'ok' if ok else f'FAIL at {apart}'}", flush=True)
    if not ok:
        checks.failed.append(f"int8 GEMM differs from the plain product at "
                             f"{apart}")


def pass_entry_gate(checks, runner, tag):
    """Each captured bucket against the eager plan on the card, one
    random batch a bucket: bit for bit."""
    import torch
    rng = np.random.RandomState(SEED + 40)
    apart = []
    for bucket in runner.buckets():
        b, s = bucket
        vals = runner._pad_stack(
            [{"data": rng.randint(0, VOCAB, s).astype(np.float32)}
             for _ in range(b)], bucket)
        (got,) = runner.run_raw(vals, bucket)
        eager = runner._eager_entry(bucket)
        with eager.lock:
            (want,) = eager.run(vals)
        if not torch.equal(got, want):
            apart.append(list(bucket))
    ok = not apart
    print(f"check serving {tag}: each of {len(runner.buckets())} captured "
          f"buckets vs the eager plan: bit for bit "
          f"{'ok' if ok else f'FAIL at {apart}'}", flush=True)
    if not ok:
        checks.failed.append(f"serving {tag}: captured buckets {apart} "
                             f"differ from the eager plan")


def pass_forward_counts(checks, runner, tag, passes):
    """One captured (32, 128) forward: the kernels of SERVE_PER_FWD and
    ``passes`` contractions, exactly."""
    from mxtpu_torch import kernels
    rng = np.random.RandomState(SEED + 41)
    bucket = (QS_MAX_B, QS_SEQ)
    vals = runner._pad_stack(
        [{"data": rng.randint(0, VOCAB, QS_SEQ).astype(np.float32)}
         for _ in range(QS_MAX_B)], bucket)
    kernels.reset_launch_counts()
    reset_pass_counts()
    runner.run_raw(vals, bucket)
    counts = kernels.launch_counts()
    check_launches(checks, f"serving {tag}", counts, SERVE_PER_FWD, 1)
    got = check_pass_counts(checks, f"serving {tag}", passes, 1)
    print(f"serving {tag}: a captured (32, 128) forward launched "
          f"{json.dumps(counts)}, contractions {got}", flush=True)
    return counts


def quant_serve_phase(checks, params, gen):
    """Phase 19b (see the module's docstring); returns the entropy
    thresholds for the generation phase."""
    import tempfile
    import torch
    from mxtpu_torch.serving import ModelRunner
    t_phase = time.perf_counter()
    int_mm_shapes(checks, gen)
    spec = dict(input_specs={"data": (None,)}, seq_buckets=[QS_SEQ],
                max_batch_size=QS_MAX_B)
    with tempfile.TemporaryDirectory(dir=ROOT / "mxtpu_torch" / "_build",
                                     prefix="qserve_") as tmp:
        files = serve_export(params, os.path.join(tmp, "bert"))
        f32 = ModelRunner.from_export(*files, device=CARD, **spec)
        ampr = ModelRunner.from_export(*files, device=CARD, amp=True, **spec)
        q8 = ModelRunner.from_export(*files, device=CARD, quant=True, **spec)
        cpu = {k: ModelRunner.from_export(*files, device="cpu", **kw,
                                          **{**spec, "seq_buckets":
                                             [QS_CPU_BUCKET[1]],
                                             "max_batch_size":
                                             QS_CPU_BUCKET[0]})
               for k, kw in (("amp", {"amp": True}),
                             ("int8", {"quant": True}))}
    batches = qs_batches(QS_CALIB_N, QS_CALIB_B, SEED + 42)
    t0 = time.perf_counter()
    mm = q8.calibrate(batches, mode="minmax")
    mm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scales = q8.calibrate(batches, mode="entropy")
    en_s = time.perf_counter() - t0
    keys_ok = len(mm) == len(scales) == AMP_DOTS_BERT and \
        sorted(mm) == sorted(scales)
    print(f"quant: calibrated on {QS_CALIB_N} seeded ({QS_CALIB_B}, "
          f"{QS_SEQ}) batches: minmax {len(mm)} keys in {mm_s:.1f} s, "
          f"entropy {len(scales)} keys in {en_s:.1f} s (thresholds "
          f"{min(scales.values()):.4g}..{max(scales.values()):.4g}) "
          f"{'ok' if keys_ok else 'FAIL'}", flush=True)
    if not keys_ok:
        checks.failed.append(f"quant: calibration keyed {len(mm)} / "
                             f"{len(scales)} contractions, want "
                             f"{AMP_DOTS_BERT}")
    warm = {}
    for tag, r in (("f32", f32), ("amp", ampr), ("int8", q8)):
        w = r.warmup()
        warm[tag] = sum(w.values())
        print(f"serving {tag}: {r.num_compiled()} buckets captured in "
              f"{warm[tag]:.2f} s; weights {r.weight_bytes() / 1e9:.3f} GB",
              flush=True)
    pass_entry_gate(checks, ampr, "amp")
    pass_entry_gate(checks, q8, "int8")
    counts = {"amp": pass_forward_counts(checks, ampr, "amp",
                                         {"amp_dot": AMP_DOTS_BERT}),
              "int8": pass_forward_counts(checks, q8, "int8",
                                          {"int8_gemm": AMP_DOTS_BERT})}

    # the logits of one (32, 128) batch in the three types
    rng = np.random.RandomState(SEED + 43)
    bucket = (QS_MAX_B, QS_SEQ)
    vals = f32._pad_stack([{"data": rng.randint(0, VOCAB, QS_SEQ)
                            .astype(np.float32)} for _ in range(QS_MAX_B)],
                          bucket)
    (lf,) = f32.run_raw(vals, bucket)
    scale = float(lf.abs().max())
    delta = {}
    for tag, r in (("amp", ampr), ("int8", q8)):
        (lg,) = r.run_raw(vals, bucket)
        delta[tag] = float((lg - lf).abs().max()) / max(1.0, scale)
        del lg
    del lf
    print(f"serving BERT-Large (32, 128): logits vs f32, max |delta| / "
          f"max(1, scale {scale:.4f}): amp {delta['amp']:.5f}, int8 "
          f"{delta['int8']:.5f} (mxtpu gates int8 at 0.10 at its 2-layer "
          f"fixture only)", flush=True)

    # one small bucket against the CPU's plain path (the same thresholds)
    cpu["int8"]._quant_scales = dict(scales)
    toks = np.random.RandomState(SEED + 44).randint(
        0, VOCAB, QS_CPU_BUCKET).astype(np.float32)
    cpu_err = {}
    for tag, r in (("amp", ampr), ("int8", q8)):
        (got,) = r.infer({"data": toks})
        (want,) = cpu[tag].infer({"data": toks})
        cpu_err[tag] = float(np.abs(got - want).max()) / \
            max(1.0, float(np.abs(want).max()))
    cpu_ok = all(v <= PASS_CPU_TOL[k] for k, v in cpu_err.items())
    print(f"check serving card vs CPU plain path at {QS_CPU_BUCKET}: "
          f"max |delta| / max(1, scale): amp {cpu_err['amp']:.3e}, int8 "
          f"{cpu_err['int8']:.3e} tol {PASS_CPU_TOL} "
          f"{'ok' if cpu_ok else 'FAIL'}", flush=True)
    if not cpu_ok:
        checks.failed.append("serving amp/int8: the card differs from the "
                             "CPU's plain path")
    del cpu
    breakdown = {tag: forward_breakdown(r, f"captured {tag}")
                 for tag, r in (("f32", f32), ("amp", ampr), ("int8", q8))}
    del f32, ampr, q8
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"quant/amp serving: phase {phase_s:.1f} s", flush=True)
    return scales, counts, {
        "calibrate_s": {"minmax": mm_s, "entropy": en_s},
        "keys": len(scales), "warmup_s": warm,
        "logit_delta_over_scale": delta, "scale": scale,
        "card_vs_cpu": cpu_err, "forward_b32_t128": breakdown,
        "phase_s": phase_s}


def gen_pass_gate(checks, files, kv_spec, scales):
    """Generation under AMP and int8 (the entropy thresholds of the
    serving phase): each runner's ladder captured on its own table, each
    entry against the eager plan bit for bit, a decode call's launches
    (1/48/0) and contractions (97) exact, a prefill and two decode steps
    against the same runner on the CPU, and a decode step's wall ms."""
    import torch
    from mxtpu_torch import kernels
    from mxtpu_torch.serving import GenerateRunner
    out = {}
    for tag, kw, passes in (("amp", {"amp": True},
                             {"amp_dot": AMP_DOTS_BERT}),
                            ("int8", {"quant": True, "quant_scales": scales},
                             {"int8_gemm": AMP_DOTS_BERT})):
        r = GenerateRunner.from_export(*files, kv_spec, device=CARD,
                                       prompt_buckets=GEN_BUCKETS, **kw)
        table = r.new_cache()
        warm = r.warmup(kv=table)
        g = torch.Generator(device=CARD).manual_seed(SEED + 45)
        base = torch.randn(r._kv_shape, generator=g, device=CARD)
        kv_e = torch.empty_like(base)
        rng = np.random.RandomState(SEED + 45)
        apart = []
        for kind, shp in r.buckets():
            if kind == "prefill":
                b, s = shp
                args = (rng.randint(0, VOCAB, (b, s)).astype(np.float32),
                        rng.randint(0, MAXLEN - s, b).astype(np.float32),
                        rng.permutation(r.max_lanes)[:b].astype(np.float32))
                call = r.prefill
            else:
                args = (rng.randint(0, VOCAB, (shp[0], 1))
                        .astype(np.float32),
                        rng.randint(0, MAXLEN, shp[0]).astype(np.float32))
                call = r.decode
            table.copy_(base)
            kv_e.copy_(base)
            got, _ = call(*args, table)
            with eager_plan(r):
                want, _ = call(*args, kv_e)
            if not (np.array_equal(got, want) and torch.equal(table, kv_e)):
                apart.append(f"{kind} {shp}")
        del base, kv_e
        slots = r.max_lanes + 1
        dt = rng.randint(0, VOCAB, (slots, 1)).astype(np.float32)
        ds = np.arange(slots, dtype=np.float32)
        kernels.reset_launch_counts()
        reset_pass_counts()
        r.decode(dt, ds, table)
        check_launches(checks, f"generate {tag} decode",
                       kernels.launch_counts(), GEN_LAUNCHES, 1)
        got_passes = check_pass_counts(checks, f"generate {tag} decode",
                                       passes, 1)
        walls = []
        for _ in range(GEN_DECODE):
            t0 = time.perf_counter()
            r.decode(dt, ds, table)
            walls.append((time.perf_counter() - t0) * 1e3)
        # the CPU's plain path: a prefill (2, 32) and two decode steps
        cpu = GenerateRunner.from_export(*files, kv_spec,
                                         prompt_buckets=GEN_BUCKETS,
                                         device="cpu", **kw)
        toks = rng.randint(0, VOCAB, (GEN_CPU_B, GEN_CPU_S)).astype(
            np.float32)
        lanes = np.arange(GEN_CPU_B, dtype=np.float32)
        step = np.zeros(GEN_CPU_B, np.float32)
        lg, kg = r.prefill(toks, step, lanes, table.zero_())
        lc, kc = cpu.prefill(toks, step, lanes, cpu.new_cache())
        errs = [(lg, lc)]
        for i in range(2):
            d_t = np.zeros((slots, 1), np.float32)
            d_s = np.zeros(slots, np.float32)
            last = lg[:, -1] if i == 0 else lg[:, 0]
            for bb in range(GEN_CPU_B):
                d_t[bb, 0], d_s[bb] = int(np.argmax(last[bb])), GEN_CPU_S + i
            lg, kg = r.decode(d_t, d_s, kg)
            lc, kc = cpu.decode(d_t, d_s, kc)
            errs.append((lg, lc))
        cpu_err = max(float(np.abs(a - b).max()) /
                      max(1.0, float(np.abs(b).max())) for a, b in errs)
        ok = not apart and cpu_err <= PASS_CPU_TOL[tag]
        print(f"check generate {tag}: {len(r.buckets())} entries captured in "
              f"{sum(warm.values()):.2f} s, each vs the eager plan (logits "
              f"and table) bit for bit "
              f"{'yes' if not apart else f'no: {apart}'}; card vs CPU "
              f"(prefill b{GEN_CPU_B} s{GEN_CPU_S}, 2 decode steps) max "
              f"|delta| / max(1, scale) {cpu_err:.3e} tol "
              f"{PASS_CPU_TOL[tag]}; a "
              f"captured decode step {pct(walls, 0.5):.3f} ms wall (p50 of "
              f"{GEN_DECODE}, logits to the host included); contractions "
              f"a decode call {got_passes} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            checks.failed.append(f"generate {tag}: an entry differs from "
                                 f"the eager plan or the card from the CPU")
        out[tag] = {"capture_s": sum(warm.values()), "apart": apart,
                    "card_vs_cpu": cpu_err,
                    "decode_wall_ms_p50": pct(walls, 0.5)}
        del r, cpu, table, kg, kc
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# phase 20: Transformer-big, mxtpu's seq2seq model (bench_transformer)
# ----------------------------------------------------------------------

MT_VOCAB, MT_MAXLEN, MT_LAYERS = 32768, 256, 6
MT_B, MT_SRC, MT_TGT = 16, 64, 64         # bench_transformer's batch
MT_WARMUP, MT_STEPS, MT_WINDOWS, MT_REPEAT = 3, 10, 3, 5
MT_CHECK = (2, 96, 64)    # card vs CPU: cross-attention at Tk 96 != Tq 64
MT_REMAT = (64, 256, 256)
MT_REMAT_STEPS = 3
MT_DEC_B, MT_DEC_SRC, MT_PREFILL, MT_DECODE = 4, 64, 8, 8
# bench.py's FLOPs a (src + tgt) token for the transformer rows
BENCH_MT_FLOPS = 0.727e9
# a training step: #1 in 6 encoder, 6 causal decoder and 6 cross
# attentions, their dq and dk/dv; #4/#5 on the source and on the target
# (the shared embed_ln); #6/#7 three a decoder and two an encoder layer
MT_LAUNCHES = {"flash_attention_fwd": 3 * MT_LAYERS,
               "flash_attention_bwd_dq": 3 * MT_LAYERS,
               "flash_attention_bwd_dkv": 3 * MT_LAYERS,
               "layer_norm_fwd": 2, "layer_norm_bwd": 2,
               "fused_residual_ln_fwd": 5 * MT_LAYERS,
               "fused_residual_ln_bwd": 5 * MT_LAYERS}
# every cell rematerialized: the cells' forward kernels run again in the
# backward; the embedding is outside any cell
MT_REMAT_LAUNCHES = {**MT_LAUNCHES,
                     "flash_attention_fwd": 6 * MT_LAYERS,
                     "fused_residual_ln_fwd": 10 * MT_LAYERS}


def mt_wrap(split, **kw):
    """bench_transformer's model: ``transformer_big(vocab_size=32768,
    max_length=256, **kw)`` behind a block that takes one (N, src +
    tgt) batch array and splits it with ``slice_axis``."""
    from mxtpu_torch.gluon.block import HybridBlock
    from mxtpu_torch.models import transformer_big

    class MTWrap(HybridBlock):
        def __init__(self):
            super().__init__()
            self.model = transformer_big(vocab_size=MT_VOCAB,
                                         max_length=MT_MAXLEN, **kw)

        def hybrid_forward(self, F, x):
            src = F.slice_axis(x, axis=1, begin=0, end=split)
            tgt = F.slice_axis(x, axis=1, begin=split, end=None)
            return self.model(src, tgt)
    return MTWrap()


def mt_loss(pred, y):
    """bench_transformer's loss: softmax cross entropy over the
    vocabulary at every target position."""
    from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    return SoftmaxCrossEntropyLoss()(pred.reshape(-1, MT_VOCAB),
                                     y.reshape(-1))


def mt_batch(b, ts, tt, seed=SEED + 20, device=None):
    """bench_transformer's batch: (b, ts + tt) source|target ids and (b,
    tt) labels from a numpy seed, on ``device`` (default the card)."""
    import torch
    device = device or CARD
    rng = np.random.RandomState(seed)
    x = rng.randint(0, MT_VOCAB, (b, ts + tt)).astype(np.float32)
    y = rng.randint(0, MT_VOCAB, (b, tt)).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def seeded_mt_step(ts, tt, compute_dtype="bfloat16", amp=None,
                   dropout=0.1, remat=False):
    """Transformer-big and bench_transformer's train step (adam lr 1e-4,
    ``cast_batch=False``) from fixed seeds: xavier weights and the
    dropout streams from ``mxtpu_torch.random``, the deferred shapes
    settled before the step is built."""
    import torch
    from mxtpu_torch import random as trandom
    from mxtpu_torch.parallel import build_train_step
    trandom.seed(SEED)
    net = mt_wrap(ts, dropout=dropout, remat=remat)
    net.initialize(init="xavier", ctx=CARD)
    settle(net, torch.zeros(1, ts + tt, device=CARD))
    return build_train_step(net, mt_loss, "adam", {"learning_rate": 1e-4},
                            compute_dtype=compute_dtype, cast_batch=False,
                            amp=amp, device=CARD)


def mt_flops(b, ts, tt):
    """Training FLOPs of one step: 6 x the multiply-adds of the dense
    products a token goes through (the encoder's on the source; the
    decoder's self-attention, cross-attention queries and FFN and the
    output projection on the target; the cross-attention's keys and
    values on the source, through the full 3u-wide qkv GEMM as mxtpu
    computes it), plus attention: 12 Tq Tk u a layer and sequence
    (forward and backward), the causal self-attention's half."""
    u, f, L = UNITS, FFN, MT_LAYERS
    enc = (4 * u * u + 2 * u * f) * ts
    dec = (4 * u * u + 4 * u * u + 2 * u * f) * tt + 3 * u * u * ts
    dense = L * (enc + dec) + MT_VOCAB * u * tt
    attn = 12 * L * u * (ts * ts + tt * tt / 2 + tt * ts)
    return b * (6 * dense + attn)


def mt_saved_bytes(b, ts, tt, el=2):
    """The bytes the encoder and decoder cells save for their backward
    and remat drops (each cell's input is kept either way), reckoned
    from the shapes before the run: per token and layer, in elements of
    the compute type, an encoder cell's q, k, v (3u), O (u), the output
    projection's input (u), the two epilogues' h (2u), the first
    epilogue's output (u) and the FFN's two hidden tensors (2F); a
    decoder cell's self-attention (q, k, v, O, projection input, h,
    output: 7u) and cross-attention (q, O, projection input, h, output:
    5u on the target, k and v 2u on the source), the FFN's 2F and its
    h; in f32, each attention's lse (one a head) and each epilogue's
    mean and rstd."""
    u, f, h = UNITS, FFN, HEADS
    enc = ts * ((8 * u + 2 * f) * el + h * 4 + 2 * 2 * 4)
    dec = tt * ((13 * u + 2 * f) * el + 2 * h * 4 + 3 * 2 * 4) + \
        ts * 2 * u * el
    return b * MT_LAYERS * (enc + dec)


def mt_window(step, x, y, bulked):
    """One timed window of MT_STEPS steps (eager) or one run_steps call,
    ended by a host read of its last loss: (ms per step, the losses)."""
    import torch
    t0 = time.perf_counter()
    if bulked:
        losses = list(step.run_steps(x, y, MT_STEPS, reuse_batch=True))
    else:
        losses = [step(x, y) for _ in range(MT_STEPS)]
    float(losses[-1])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / MT_STEPS * 1e3, losses


def mt_train_cell(checks, tag, make):
    """bench_transformer's row: warm-up, MT_WINDOWS eager windows, then
    MT_WINDOWS run_steps(x, y, 10, reuse_batch=True) windows (ms/step
    the median of each), exact launches in both, one profiled step,
    peak memory, MFU; the losses finite and falling and the first
    MT_REPEAT repeating bit for bit from the same seeds."""
    import torch
    from mxtpu_torch import kernels
    gc.collect()    # a Block and its Parameters form reference cycles
    reset_peak()
    # what earlier phases still hold, left out of the row's peak
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    step = make()
    x, y = mt_batch(MT_B, MT_SRC, MT_TGT)
    losses = [step(x, y) for _ in range(MT_WARMUP)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n = MT_STEPS * MT_WINDOWS
    ms = {}
    for mode in ("eager", "run_steps"):
        kernels.reset_launch_counts()
        windows = []
        for _ in range(MT_WINDOWS):
            w, ls = mt_window(step, x, y, mode == "run_steps")
            windows.append(w)
            losses += ls
        counts = kernels.launch_counts()
        check_launches(checks, f"{tag} {mode}", counts, MT_LAUNCHES, n)
        ms[mode] = (float(np.median(windows)), windows)
        if mode == "eager":
            eager_counts = counts
    mem = {**step.memory_summary(), "held_before_bytes": held}
    bd = profiled_step(checks, tag, step, x, y)
    losses = [float(v) for v in losses]
    del step
    torch.cuda.empty_cache()
    again = make()
    rep = [float(again(x, y)) for _ in range(MT_REPEAT)]
    del again
    torch.cuda.empty_cache()
    same = rep == losses[:MT_REPEAT]
    print(f"check {tag} repeats bit for bit from the same seeds over "
          f"{MT_REPEAT} steps: {'ok' if same else 'FAIL'} ({rep})",
          flush=True)
    if not same:
        checks.failed.append(f"{tag} does not repeat from the same seeds")
    if not all(np.isfinite(losses)):
        checks.failed.append(f"{tag} losses not finite: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        checks.failed.append(f"{tag} loss did not fall: {losses}")
    tokens = MT_B * (MT_SRC + MT_TGT)
    flops = mt_flops(MT_B, MT_SRC, MT_TGT)
    rows = {}
    for mode, (m, windows) in ms.items():
        mfu = flops / (m / 1e3) / PEAK_OPS["bfloat16"]
        bench_mfu = BENCH_MT_FLOPS * tokens / (m / 1e3) / \
            PEAK_OPS["bfloat16"]
        rows[mode] = {"ms_per_step": m, "window_ms_per_step": windows,
                      "tokens_per_s": tokens / m * 1e3, "mfu": mfu,
                      "mfu_bench_flops": bench_mfu}
        print(f"{tag} {mode}: {m:.3f} ms/step (median of {MT_WINDOWS} "
              f"windows of {MT_STEPS}: "
              f"{', '.join(f'{w:.3f}' for w in windows)}), "
              f"{tokens / m * 1e3:.1f} tokens/s over src+tgt, MFU "
              f"{mfu:.4f} of 989 TFLOP/s ({flops / tokens / 1e9:.4f} "
              f"GF/token counted; at bench.py's "
              f"{BENCH_MT_FLOPS / 1e9:.3f} GF/token {bench_mfu:.4f})",
              flush=True)
    print(f"{tag}: device {bd['device_busy_ms']:.3f} ms a step, idle "
          f"share {bd['device_idle_share'] or 0:.4f} (the profiled step); "
          f"peak memory {((mem['peak_bytes'] or 0) - held) / 2**30:.3f} "
          f"GiB over the {held / 2**30:.3f} GiB earlier phases held; set-up "
          f"and {MT_WARMUP} warm-up steps {setup_s:.1f} s; losses "
          f"{[round(v, 4) for v in losses[:6]]} ... {losses[-1]:.4f}",
          flush=True)
    print(f"{tag}: launches in {n} eager steps {json.dumps(eager_counts)}",
          flush=True)
    return eager_counts, {**rows, "flops_per_step": flops,
                          "tokens_per_step": tokens, "memory": mem,
                          "breakdown": bd, "losses": losses,
                          "setup_s": setup_s, "repeats_bit_for_bit": same}


def mt_cpu_check(checks):
    """One f32 step of the full-width model (dropout 0) at source 96,
    target 64, so that cross-attention runs at Tk = 96 != Tq = 64: the
    loss and every parameter's gradient on the card against the CPU's
    plain path from the same weights."""
    import torch
    from mxtpu_torch import random as trandom
    from mxtpu_torch.convert import params_from_mxtpu, params_to_mxtpu
    from mxtpu_torch.parallel import build_train_step
    b, ts, tt = MT_CHECK
    t0 = time.perf_counter()
    trandom.seed(SEED + 7)
    card = fresh_names(lambda: mt_wrap(ts, dropout=0.0))
    card.initialize(init="xavier", ctx=CARD)
    settle(card, torch.zeros(1, ts + tt, device=CARD))
    cpu = params_from_mxtpu(params_to_mxtpu(card),
                            fresh_names(lambda: mt_wrap(ts, dropout=0.0)))
    steps = [build_train_step(net, mt_loss, "adam", {"learning_rate": 1e-4},
                              cast_batch=False, device=dev)
             for net, dev in ((card, CARD), (cpu, "cpu"))]
    x, y = mt_batch(b, ts, tt, seed=SEED + 21, device="cpu")
    (lc, gc), (lp, gp) = (s.forward_backward(x, y) for s in steps)
    worst = 0.0
    for n, a, p in zip(steps[0].param_names, gc, gp):
        a, p = a.double().cpu(), p.double()
        rel = float((a - p).norm() / max(float(p.norm()), 1e-12))
        worst = max(worst, rel)
        if rel > GRAD_TOL:
            checks.failed.append(f"transformer check: grad of {n} off by "
                                 f"{rel:.3e}")
    lrel = abs(float(lc) - float(lp)) / abs(float(lp))
    ok = worst <= GRAD_TOL and lrel <= LOSS_TOL
    print(f"check transformer_big b{b} src{ts} tgt{tt} f32 card vs CPU: "
          f"loss {float(lc):.6f} vs {float(lp):.6f} (rel {lrel:.3e}, tol "
          f"{LOSS_TOL}); worst gradient rel L2 {worst:.3e} over {len(gc)} "
          f"parameters (tol {GRAD_TOL}) {'ok' if ok else 'FAIL'}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if lrel > LOSS_TOL:
        checks.failed.append(f"transformer check: loss off by {lrel:.3e}")
    checks.rows.append({"check": "transformer_big Tq != Tk card vs CPU",
                        "loss_rel": lrel, "worst_grad_rel": worst,
                        "ok": ok})
    del steps, card, cpu, gc, gp
    torch.cuda.empty_cache()
    return {"loss_rel": lrel, "worst_grad_rel": worst, "ok": ok}


def mt_remat_cell(checks):
    """remat=True against remat=False from the same weights and seed at
    b64 x (256 + 256), bf16, dropout 0.1: 3 steps, the losses and every
    weight bit for bit, exact launches of each, both peak memories and
    ms/step; the remat peak must be lower."""
    import torch
    from mxtpu_torch import kernels
    b, ts, tt = MT_REMAT
    reckoned = mt_saved_bytes(b, ts, tt)
    print(f"transformer remat b{b} src{ts} tgt{tt} bf16: the cells save "
          f"{reckoned / 2**30:.3f} GiB for their backward (reckoned from "
          f"the shapes)", flush=True)
    x, y = mt_batch(b, ts, tt, seed=SEED + 22)
    got = {}
    for remat in (False, True):
        gc.collect()    # the last step's Blocks, in reference cycles
        reset_peak()
        held = torch.cuda.memory_allocated()
        step = seeded_mt_step(ts, tt, remat=remat)
        kernels.reset_launch_counts()
        losses, times = [], []
        for _ in range(MT_REMAT_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step(x, y)))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = kernels.launch_counts()
        check_launches(checks, f"transformer remat={remat}", counts,
                       MT_REMAT_LAUNCHES if remat else MT_LAUNCHES,
                       MT_REMAT_STEPS)
        got[remat] = {"losses": losses, "ms_per_step": times,
                      "peak_bytes": torch.cuda.max_memory_allocated() - held,
                      "held_before_bytes": held,
                      "weights": [p.detach().cpu()
                                  for p in step.net.parameters()],
                      "launches": counts}
        del step
        torch.cuda.empty_cache()
    plain, rem = got[False], got[True]
    same = plain["losses"] == rem["losses"] and all(
        torch.equal(a, b_) for a, b_ in zip(plain["weights"],
                                            rem["weights"]))
    saved = plain["peak_bytes"] - rem["peak_bytes"]
    print(f"check transformer remat vs plain, {MT_REMAT_STEPS} steps: "
          f"losses {rem['losses']} vs {plain['losses']}, every weight "
          f"{'bit for bit ok' if same else 'FAIL'}; peak "
          f"{rem['peak_bytes'] / 2**30:.3f} vs "
          f"{plain['peak_bytes'] / 2**30:.3f} GiB (remat saves "
          f"{saved / 2**30:.3f} GiB; each over what was held before it, "
          f"{rem['held_before_bytes'] / 2**30:.3f} and "
          f"{plain['held_before_bytes'] / 2**30:.3f} GiB; reckoned "
          f"{reckoned / 2**30:.3f}); ms/step "
          f"{[round(t, 3) for t in rem['ms_per_step']]} vs "
          f"{[round(t, 3) for t in plain['ms_per_step']]}", flush=True)
    if not same:
        checks.failed.append("transformer remat is not bit-equal to the "
                             "plain step")
    if saved <= 0:
        checks.failed.append("transformer remat does not lower the peak "
                             "memory")
    for r in got.values():
        del r["weights"]
    return {"plain": plain, "remat": rem, "bit_equal": same,
            "saved_bytes": saved, "reckoned_bytes": reckoned}


def mt_decode_check(checks):
    """The incremental call ``net(src, tgt, step, cache)`` in f32, not
    training: a prefill of MT_PREFILL target tokens, then MT_DECODE
    one-token steps, each against the full call ``net(src, tgt)`` on the
    same prefix (within SERVE_TOL x max(1, |ref|)), the greedy tokens
    equal but at a near tie; the decode continues from the full call's
    tokens."""
    import torch
    from mxtpu_torch import random as trandom
    from mxtpu_torch.models import transformer_big
    trandom.seed(SEED + 9)
    net = transformer_big(vocab_size=MT_VOCAB, max_length=MT_MAXLEN,
                          dropout=0.1)
    net.initialize(init="xavier", ctx=CARD)
    rng = np.random.RandomState(SEED + 23)
    src = torch.tensor(rng.randint(0, MT_VOCAB, (MT_DEC_B, MT_DEC_SRC)),
                       dtype=torch.float32, device=CARD)
    toks = torch.tensor(rng.randint(0, MT_VOCAB, (MT_DEC_B, MT_PREFILL)),
                        dtype=torch.float32, device=CARD)
    cache = torch.zeros(net.kv_cache_spec(MT_DEC_B), device=CARD)
    worst, flips, ties = 0.0, 0, 0
    t0 = time.perf_counter()
    with torch.no_grad():
        inc, cache = net(src, toks, torch.zeros(MT_DEC_B, device=CARD),
                         cache)
        full = net(src, toks)
        worst = float(((inc - full).abs() /
                       full.abs().clamp_min(1.0)).max())
        inc = inc[:, -1]
        for i in range(MT_DECODE):
            full = net(src, toks)[:, -1]
            if i:
                worst = max(worst, float(((inc - full).abs() /
                                          full.abs().clamp_min(1.0)).max()))
            got, want = inc.argmax(-1), full.argmax(-1)
            for lane in torch.nonzero(got != want).flatten().tolist():
                row = full[lane].cpu().numpy()
                if near_tie(row, int(got[lane]), int(want[lane])):
                    ties += 1
                else:
                    flips += 1
            nxt = want.float()[:, None]
            toks = torch.cat([toks, nxt], 1)
            step = torch.full((MT_DEC_B,), float(toks.shape[1] - 1),
                              device=CARD)
            inc, cache = net(src, nxt, step, cache)
            inc = inc[:, 0]
    ok = worst <= SERVE_TOL and flips == 0
    print(f"check transformer_big incremental decode f32 b{MT_DEC_B} "
          f"src{MT_DEC_SRC}: prefill {MT_PREFILL} then {MT_DECODE} steps "
          f"vs the full call, max err {worst:.3e} of max(1, |ref|) (tol "
          f"{SERVE_TOL}), greedy flips {flips} (near ties {ties}) "
          f"{'ok' if ok else 'FAIL'}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    if not ok:
        checks.failed.append("transformer incremental decode vs the full "
                             "call")
    checks.rows.append({"check": "transformer_big incremental decode",
                        "max_err": worst, "flips": flips, "ties": ties,
                        "ok": ok})
    del net, cache
    torch.cuda.empty_cache()
    return {"max_err": worst, "flips": flips, "near_ties": ties}


def mt_kernel_rows(checks, gen):
    """#1-#7 at the training row's shapes in bf16 (16 heads x b16, T 64,
    D 64, non-causal as the cross-attention runs it; R = b16 x 64 rows
    of C = 1024; the fused epilogue at keep 0.9) against their plain
    versions, timed beside the library call and the bound: the kernels
    line's rows for the transformer path."""
    import torch
    import torch.nn.functional as F
    import importlib
    fa = importlib.import_module("mxtpu_torch.kernels.flash_attention")
    ln = importlib.import_module("mxtpu_torch.kernels.layer_norm")
    dev, bf = torch.device(CARD), torch.bfloat16
    BH, Tm, R, C = MT_B * HEADS, MT_TGT, MT_B * MT_TGT, UNITS
    scale = 1.0 / D ** 0.5
    out = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    def grads_of(fn, xs, dy):
        xs = [x.detach().requires_grad_(True) for x in xs]
        y = fn(*xs)
        return lambda: torch.autograd.grad(y, xs, dy, retain_graph=True)

    q, k, v, do = (randn(BH, Tm, D) for _ in range(4))
    q4, k4, v4, do4 = (t.reshape(MT_B, HEADS, Tm, D) for t in (q, k, v, do))
    o, lse = fa.flash_forward(q, k, v, False, scale)
    po, _ = fa.flash_forward_reference(q, k, v, False, scale)
    got = fa.flash_backward(q, k, v, do, o, lse, False, scale)
    want = fa.flash_backward_reference(q, k, v, do, o, lse, False, scale)
    torch.cuda.synchronize()
    tag = f"transformer flash BH{BH} T{Tm}"
    err = checks.close(tag, o, po, "bfloat16")
    errs = [checks.close(f"{tag} {g}", a, w, "bfloat16",
                         scale_floor(w, "bfloat16"))
            for g, a, w in zip(("dq", "dk", "dv"), got, want)]
    per, rows = BH * Tm * D * 2, BH * Tm * 4
    b_ms, b_by = bound(4 * per + rows, 4 * BH * Tm * Tm * D, "bfloat16")
    out["flash_attention_fwd"] = {
        "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
        **timed(lambda: fa.flash_forward(q, k, v, False, scale),
                lambda: fa.flash_forward_reference(q, k, v, False, scale),
                lambda: F.scaled_dot_product_attention(q4, k4, v4))}
    names = ["fa_bwd_dq_wgmma_kernel", "fa_bwd_dkv_wgmma_kernel"]
    kern = device_ms(lambda: fa.flash_backward(q, k, v, do, o, lse, False,
                                               scale), by_name=names)
    plain = device_ms(lambda: fa.flash_backward_reference(
        q, k, v, do, o, lse, False, scale))
    sdpa = device_ms(grads_of(F.scaled_dot_product_attention,
                              (q4, k4, v4), do4))
    wall = time_ms(lambda: fa.flash_backward(q, k, v, do, o, lse, False,
                                             scale))
    for kname, pname, nt, ops, e in (
            ("flash_attention_bwd_dq", names[0], 5, 6 * BH * Tm * Tm * D,
             errs[0]),
            ("flash_attention_bwd_dkv", names[1], 6, 8 * BH * Tm * Tm * D,
             max(errs[1:]))):
        b_ms, b_by = bound(nt * per + 2 * rows, ops, "bfloat16")
        out[kname] = {"max_abs_err": e, "ms": kern[pname],
                      "plain_ms": plain, "library_ms": sdpa,
                      "wall_ms": wall, "bound_ms": b_ms, "bound_by": b_by}

    x, dy = randn(R, C), randn(R, C)
    g, b = (1.0 + 0.1 * randn(C)).to(bf), (0.1 * randn(C)).to(bf)
    y_, mean, rstd = ln.layer_norm_fwd(x, g, b)
    py, _, _ = ln.layer_norm_reference(x, g, b)
    lgot = ln.layer_norm_bwd(x, g, mean, rstd, dy)
    lwant = ln.layer_norm_bwd_reference(x, g, mean, rstd, dy)
    torch.cuda.synchronize()
    err = checks.close(f"transformer layer_norm R{R} C{C}", y_, py,
                       "bfloat16")
    berr = max(checks.close(f"transformer layer_norm_bwd R{R} {n}", a, w,
                            "bfloat16")
               for n, a, w in zip(("dx", "dgamma", "dbeta"), lgot, lwant))
    b_ms, b_by = bound(2 * R * C * 2 + 2 * C * 2 + 2 * R * 4, 8 * R * C,
                       "bfloat16")
    out["layer_norm_fwd"] = {
        "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
        **timed(lambda: ln.layer_norm_fwd(x, g, b),
                lambda: ln.layer_norm_reference(x, g, b),
                lambda: F.layer_norm(x, (C,), g, b))}
    b_ms, b_by = bound(3 * R * C * 2 + 3 * C * 2 + 2 * R * 4, 12 * R * C,
                       "bfloat16")
    out["layer_norm_bwd"] = {
        "max_abs_err": berr, "bound_ms": b_ms, "bound_by": b_by,
        **timed(lambda: ln.layer_norm_bwd(x, g, mean, rstd, dy),
                lambda: ln.layer_norm_bwd_reference(x, g, mean, rstd, dy),
                grads_of(lambda a, c, d: F.layer_norm(a, (C,), c, d),
                         (x, g, b), dy))}

    h, res = randn(R, C), randn(R, C)
    bias = (0.1 * randn(C)).to(bf)
    key = (0x2545F491, 0x9E3779B9)
    fargs = (h, bias, res, g, b, np.array(key, np.uint32), 0.1, 1e-5, True)
    fy, fmean, frstd = ln.fused_residual_ln_fwd(*fargs)
    fpy, _, _ = ln.fused_residual_ln_reference(*fargs)
    bargs = (h, bias, res, g, key, fmean, frstd, dy, 0.9)
    fgot = ln.fused_residual_ln_bwd(*bargs)
    fwant = ln.fused_residual_ln_bwd_reference(*bargs)
    torch.cuda.synchronize()
    err = checks.close(f"transformer fused_residual_ln R{R} keep=0.9", fy,
                       fpy, "bfloat16")
    berr = max(checks.close(f"transformer fused_residual_ln_bwd R{R} "
                            f"keep=0.9 {n}", a, w, "bfloat16")
               for n, a, w in zip(("dh", "dbias", "dres", "dgamma",
                                   "dbeta"), fgot, fwant))
    b_ms, b_by = bound(3 * R * C * 2 + 3 * C * 2 + 2 * R * 4, 10 * R * C,
                       "bfloat16", R * C)
    out["fused_residual_ln_fwd"] = {
        "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
        **timed(lambda: ln.fused_residual_ln_fwd(*fargs),
                lambda: ln.fused_residual_ln_reference(*fargs))}
    b_ms, b_by = bound(5 * R * C * 2 + 5 * C * 2 + 2 * R * 4, 20 * R * C,
                       "bfloat16", R * C)
    out["fused_residual_ln_bwd"] = {
        "max_abs_err": berr, "bound_ms": b_ms, "bound_by": b_by,
        **timed(lambda: ln.fused_residual_ln_bwd(*bargs),
                lambda: ln.fused_residual_ln_bwd_reference(*bargs))}
    for name, r in out.items():
        lib = "null" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f}"
        print(f"time {name} [bfloat16, the transformer step's shape] "
              f"(device ms per call): kernel_ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={lib} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}); kernel "
              f"wall_ms={r['wall_ms']:.4f}", flush=True)
    return out


def transformer_phase(checks, gen):
    """Phase 20 (see the module's docstring): returns the launches of the
    bf16 row's eager steps, the kernel rows at its shapes and the
    numbers."""
    t0 = time.perf_counter()
    counts, bf16 = mt_train_cell(checks, "transformer bf16",
                                 lambda: seeded_mt_step(MT_SRC, MT_TGT))
    _, amp = mt_train_cell(
        checks, "transformer amp",
        lambda: seeded_mt_step(MT_SRC, MT_TGT, compute_dtype=None,
                               amp=True))
    check = mt_cpu_check(checks)
    remat = mt_remat_cell(checks)
    decode = mt_decode_check(checks)
    rows = mt_kernel_rows(checks, gen)
    print(f"transformer phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return counts, rows, {"bf16": bf16, "amp": amp, "cpu_check": check,
                          "remat": remat, "decode": decode}


# ----------------------------------------------------------------------
# phase 21: ResNet fed from the input pipeline, the model zoo at full
# width, the N-D and transposed convolution layers
# ----------------------------------------------------------------------

# bench_resnet50_pipeline's recipe (bench.py:262-394): 4 x 256 raw
# records of 3 x 224^2 uint8, shuffled and mirrored, ResNet-50 NCHW
PIPE_B, PIPE_HW, PIPE_EPOCH = 256, 224, 4
PIPE_MEAN, PIPE_INV_STD = 114.8, 1.0 / 57.7
PIPE_GATE_STEPS = 5          # fed losses against the blocking twin's
PIPE_BATCH_GATE = 2 * PIPE_EPOCH   # fed batches against a second reader
PIPE_ALONE = 12              # batches drawn with no step
# the zoo: one bf16 step each at b32 x 224^2 (the batch cut from 256)
ZOO_B = 32
ZOO_MODELS = ("resnet18_v1", "resnet34_v1", "resnet101_v1",
              "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
              "resnet101_v2", "resnet152_v2")
# BatchNorm layers a model holds (counted in the script from the model,
# held to these): V1 one per convolution, V2 two or three a block plus
# the input's, the stem's and the closing one
ZOO_BN = {"resnet18_v1": 20, "resnet34_v1": 36, "resnet101_v1": 104,
          "resnet152_v1": 155, "resnet18_v2": 19, "resnet34_v2": 35,
          "resnet50_v2": 51, "resnet101_v2": 102, "resnet152_v2": 153}
# resnet18_v2 f32 card vs CPU (resnet_check_phase's bar)
ZOO_CHECK_B, ZOO_CHECK_HW = 2, 64
# (N, C, S, act, add) of the zoo rows of the kernels line: a basic
# block's closing BatchNorm at stage 1 (#8/#9, resnet18_v1) and a V2
# bottleneck's first at stage 1 (#10/#11, resnet50_v2 NHWC), at b32
ZOO_ROWS = {"major": (ZOO_B, 64, 3136, "relu", True),
            "cm": (ZOO_B, 256, 3136, "relu", False)}
LAYER_TOL = 1e-5
# (class, kwargs, input shape) of the new layers held card vs CPU
T2 = {"strides": 2, "padding": 1, "dilation": 2}
NEW_LAYERS = (
    ("Conv1D", dict(channels=16, kernel_size=3, **T2), (4, 8, 64)),
    ("Conv3D", dict(channels=16, kernel_size=3, **T2), (2, 8, 12, 12, 12)),
    ("Conv1DTranspose", dict(channels=16, kernel_size=3, **T2), (4, 8, 32)),
    ("Conv2DTranspose", dict(channels=16, kernel_size=3, **T2),
     (2, 8, 16, 16)),
    ("Conv3DTranspose", dict(channels=8, kernel_size=3, **T2),
     (2, 8, 6, 6, 6)),
    ("MaxPool1D", dict(pool_size=3, strides=2, padding=1), (4, 8, 64)),
    ("AvgPool1D", dict(pool_size=3, strides=2, padding=1,
                       count_include_pad=False), (4, 8, 64)),
    ("MaxPool3D", dict(pool_size=3, strides=2, padding=1),
     (2, 8, 12, 12, 12)),
    ("AvgPool3D", dict(pool_size=3, strides=2, padding=1),
     (2, 8, 12, 12, 12)),
    ("GlobalAvgPool3D", dict(), (2, 8, 12, 12, 12)),
    ("ReflectionPad2D", dict(padding=(1, 2, 3, 0)), (2, 8, 16, 16)))


def pipeline_records(prefix):
    """bench.py:300-314's dataset, written with the port's recordio:
    4 x 256 raw records, an image refreshed every 61 and rolled."""
    from mxtpu_torch import recordio as rio
    rng = np.random.RandomState(0)
    rec = rio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    base = None
    for i in range(PIPE_EPOCH * PIPE_B):
        if i % 61 == 0:
            base = (rng.rand(3, PIPE_HW, PIPE_HW) * 255).astype(np.uint8)
        rec.write_idx(i, rio.pack(
            rio.IRHeader(0, float(i % 1000), i, 0),
            np.roll(base, i % PIPE_HW, axis=2).tobytes()))
    rec.close()


def pipeline_reader(prefix):
    """bench_resnet50_pipeline's ImageRecordIter (seed 0): whole raw
    batches, shuffled, mirrored, uint8, numpy out."""
    from mxtpu_torch.io import ImageRecordIter
    return ImageRecordIter(prefix + ".rec", (3, PIPE_HW, PIPE_HW), PIPE_B,
                           path_imgidx=prefix + ".idx", shuffle=True,
                           rand_mirror=True, raw_records=True,
                           dtype="uint8", preprocess_threads=2,
                           host_batches=True)


def endless(it):
    """Batches of ``it`` across epochs (reset at each end), as
    bench.py's ``batches()``."""
    while True:
        try:
            yield it.next()
        except StopIteration:
            it.reset()


def pipeline_net():
    """bench.py's ``_DeviceNormalize`` (uint8 to (x - 114.8) * inv_std,
    inv_std a frozen parameter that takes the compute type) before
    ``resnet50()`` (NCHW), Xavier weights from ``mxtpu_torch.random``
    seed ``SEED`` on the card, the shapes settled."""
    import torch
    from mxtpu_torch import initializer, random as trandom
    from mxtpu_torch.gluon import HybridBlock, nn
    from mxtpu_torch.models import resnet50

    class DeviceNormalize(HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.inv_std = self.params.get(
                "inv_std", shape=(1,),
                init=initializer.Constant(PIPE_INV_STD), grad_req="null")

        def hybrid_forward(self, F, x, inv_std):
            dt = str(inv_std.dtype).replace("torch.", "")
            return (F.cast(x, dtype=dt) - PIPE_MEAN) * inv_std

    trandom.seed(SEED)
    net = nn.HybridSequential(prefix="pipe_")
    net.add(DeviceNormalize(), resnet50(classes=RN_CLASSES))
    net.initialize(initializer.Xavier(), ctx=CARD)
    return settle(net, torch.zeros((1, 3, PIPE_HW, PIPE_HW),
                                   dtype=torch.uint8, device=CARD))


def pipeline_step():
    from mxtpu_torch.parallel import build_train_step
    return build_train_step(pipeline_net(), rn_loss(), "sgd", RN_SGD,
                            compute_dtype="bfloat16", cast_batch=False,
                            device=CARD)


def fed_windows(step, next_batch, n_windows, n_steps):
    """``n_windows`` windows of ``n_steps`` steps on the batches
    ``next_batch()`` hands over, each ended by a host read of its last
    loss: ms per step of each window and the host ms spent in
    ``next_batch`` a step."""
    ms, feed_ms = [], 0.0
    for _ in range(n_windows):
        t0 = time.perf_counter()
        for _ in range(n_steps):
            t1 = time.perf_counter()
            x, y = next_batch()
            feed_ms += (time.perf_counter() - t1) * 1e3
            loss = step(x, y)
        float(loss)
        ms.append((time.perf_counter() - t0) / n_steps * 1e3)
    return ms, feed_ms / (n_windows * n_steps)


def pipeline_cell(checks, prefix):
    """(a): the pipeline's gates and numbers; returns the BatchNorm
    launches of the fed windows and the numbers."""
    import torch
    from mxtpu_torch import kernels
    from mxtpu_torch.io import DeviceFeedIter, PrefetchingIter
    tag = "pipeline resnet50 NCHW"

    # the fed batches against a second reader of the same seed, read
    # synchronously; the first PIPE_GATE_STEPS of them also train a
    # step each, against a twin fed by a blocking copy
    with deterministic_cudnn():
        fed_step, twin = pipeline_step(), pipeline_step()
        feed = DeviceFeedIter(PrefetchingIter(pipeline_reader(prefix)),
                              ctx=CARD)
        fed, sync = endless(feed), endless(pipeline_reader(prefix))
        same_batches, fed_losses, twin_losses = 0, [], []
        for i in range(PIPE_BATCH_GATE):
            b, s = next(fed), next(sync)
            xs = torch.from_numpy(s.data[0]).to(CARD)
            ys = torch.from_numpy(s.label[0]).to(CARD)
            same = torch.equal(b.data[0].data, xs) and \
                torch.equal(b.label[0].data, ys) and b.pad == s.pad
            same_batches += int(same)
            if i < PIPE_GATE_STEPS:
                fed_losses.append(fed_step(b.data[0], b.label[0]))
                twin_losses.append(twin(xs, ys))
        fed_losses = [float(v) for v in fed_losses]
        twin_losses = [float(v) for v in twin_losses]
        feed.close()
        feed.data_iter.close()
    loss_gate = fed_losses == twin_losses and all(np.isfinite(fed_losses))
    print(f"check {tag}: {same_batches} of {PIPE_BATCH_GATE} fed batches "
          f"equal a synchronous reader's bit for bit (pixels after the "
          f"mirror, labels, pads): "
          f"{'ok' if same_batches == PIPE_BATCH_GATE else 'FAIL'}; the "
          f"first {PIPE_GATE_STEPS} fed losses {fed_losses} vs the "
          f"blocking twin's {twin_losses} (cuDNN deterministic) bit for "
          f"bit: {'ok' if loss_gate else 'FAIL'}", flush=True)
    checks.rows.append({"check": f"{tag} fed batches and losses",
                        "same_batches": same_batches,
                        "fed_losses": fed_losses,
                        "twin_losses": twin_losses,
                        "ok": same_batches == PIPE_BATCH_GATE and loss_gate})
    if same_batches != PIPE_BATCH_GATE:
        checks.failed.append(f"{tag}: {PIPE_BATCH_GATE - same_batches} fed "
                             f"batches differ from the synchronous reader's")
    if not loss_gate:
        checks.failed.append(f"{tag}: fed losses {fed_losses} != the "
                             f"blocking twin's {twin_losses}")
    del twin
    torch.cuda.empty_cache()

    # the timed windows: fed (a fresh feed from the same seed), then the
    # same step on one reused batch
    step = fed_step
    per_sample = model_counts(step.net, torch.zeros(
        (1, 3, PIPE_HW, PIPE_HW), dtype=torch.uint8, device=CARD))
    flops = 3 * per_sample["flops"] * PIPE_B
    feed = DeviceFeedIter(PrefetchingIter(pipeline_reader(prefix)), ctx=CARD)
    fed = endless(feed)

    def next_fed():
        b = next(fed)
        return b.data[0], b.label[0]
    for _ in range(TRAIN_WARMUP):
        step(*next_fed())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    fed_ms, feed_ms = fed_windows(step, next_fed, TRAIN_WINDOWS,
                                  TRAIN_STEPS)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_launches(checks, tag, counts, RN_LAUNCHES["NCHW"],
                   TRAIN_WINDOWS * TRAIN_STEPS)
    xr, yr = next_fed()
    reused_ms, _ = fed_windows(step, lambda: (xr, yr), TRAIN_WINDOWS,
                               TRAIN_STEPS)
    breakdown = profiled_step(checks, f"{tag} fed",
                              lambda _x, _y: step(*next_fed()), None, None)
    # the pipeline alone: batches handed over with no step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PIPE_ALONE):
        b = next(fed)
    torch.cuda.synchronize()
    alone = PIPE_ALONE / (time.perf_counter() - t0)
    feed.close()
    feed.data_iter.close()
    fed_rate = PIPE_B / float(np.median(fed_ms)) * 1e3
    reused_rate = PIPE_B / float(np.median(reused_ms)) * 1e3
    mfu = flops / (float(np.median(fed_ms)) / 1e3) / PEAK_OPS["bfloat16"]
    print(f"{tag} b{PIPE_B} {PIPE_HW}x{PIPE_HW} bf16 sgd momentum, "
          f"ImageRecordIter(raw, uint8, shuffle, mirror, 2 threads) -> "
          f"PrefetchingIter -> DeviceFeedIter: fed {fed_rate:.1f} "
          f"samples/s ({np.median(fed_ms):.3f} ms/step, median of "
          f"{TRAIN_WINDOWS} windows of {TRAIN_STEPS}: "
          f"{', '.join(f'{w:.3f}' for w in fed_ms)}; MFU {mfu:.4f}), "
          f"the same step on one reused batch {reused_rate:.1f} samples/s "
          f"({np.median(reused_ms):.3f} ms/step: "
          f"{', '.join(f'{w:.3f}' for w in reused_ms)}), fed/reused "
          f"{fed_rate / reused_rate:.4f}; the feed's next() "
          f"{feed_ms:.3f} ms a step on the consumer thread; the pipeline "
          f"alone {alone:.2f} batches/s ({alone * PIPE_B:.1f} samples/s); "
          f"peak memory {peak / 2**30:.3f} GiB", flush=True)
    print(f"{tag}: launches in {TRAIN_WINDOWS * TRAIN_STEPS} fed steps "
          f"{json.dumps(counts)}", flush=True)
    del step, feed, fed
    torch.cuda.empty_cache()
    return counts, {"fed_samples_per_s": fed_rate,
                    "reused_samples_per_s": reused_rate,
                    "fed_over_reused": fed_rate / reused_rate,
                    "fed_window_ms": fed_ms, "reused_window_ms": reused_ms,
                    "feed_next_ms_per_step": feed_ms,
                    "pipeline_alone_batches_per_s": alone,
                    "peak_bytes": peak, "mfu": mfu,
                    "gate_losses": fed_losses, "breakdown": breakdown}


def zoo_net(name, layout, b1_shape):
    """A zoo model on the card, Xavier weights from
    ``mxtpu_torch.random`` seed ``SEED``, the shapes settled."""
    import torch
    from mxtpu_torch import initializer, random as trandom
    from mxtpu_torch.gluon.model_zoo import vision
    trandom.seed(SEED)
    net = fresh_names(lambda: getattr(vision, name)(classes=RN_CLASSES,
                                                    layout=layout))
    net.initialize(initializer.Xavier(), ctx=CARD)
    return settle(net, torch.zeros(b1_shape, device=CARD))


def zoo_cell(checks):
    """(b): one bf16 step (after one warm-up) of each zoo model at
    b32 x 224^2, resnet50_v2 also in NHWC; BatchNorm launches exactly
    the model's count a step forward, and backward but for V2's input
    BatchNorm; then resnet18_v2 in f32 on the card against the CPU."""
    import torch
    from mxtpu_torch import kernels
    from mxtpu_torch.gluon import nn as gnn
    from mxtpu_torch.parallel import build_train_step
    totals = {}
    rows = {}
    for name, layout in [(m, "NCHW") for m in ZOO_MODELS] + \
            [("resnet50_v2", "NHWC")]:
        t0 = time.perf_counter()
        tag = f"zoo {name} {layout}"
        x, y = rn_batch(layout, ZOO_B, RN_HW, SEED + 21)
        x, y = torch.from_numpy(x).to(CARD), torch.from_numpy(y).to(CARD)
        net = zoo_net(name, layout, (1,) + tuple(x.shape[1:]))
        n_bn = sum(isinstance(m, gnn.BatchNorm) for m in net.modules())
        if n_bn != ZOO_BN[name]:
            checks.failed.append(f"{tag}: {n_bn} BatchNorms, want "
                                 f"{ZOO_BN[name]}")
        step = build_train_step(net, rn_loss(), "sgd", RN_SGD,
                                compute_dtype="bfloat16", device=CARD)
        first = float(step(x, y))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        loss = float(step(x, y))
        ms = (time.perf_counter() - t1) * 1e3
        counts = kernels.launch_counts()
        sfx = "_cm" if layout == "NHWC" else ""
        # V2's input BatchNorm (no scale, no shift, on the batch) has
        # nothing to differentiate: it runs no backward
        n_bwd = n_bn - int(name.endswith("_v2"))
        check_launches(checks, tag, counts,
                       {f"batch_norm_fwd{sfx}": n_bn,
                        f"batch_norm_bwd{sfx}": n_bwd}, 1)
        if not (np.isfinite(first) and np.isfinite(loss)):
            checks.failed.append(f"{tag}: losses {first}, {loss}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        print(f"{tag} b{ZOO_B} {RN_HW}x{RN_HW} bf16: {n_bn} BatchNorms, "
              f"losses {first:.4f} {loss:.4f}, one step {ms:.3f} ms "
              f"(wall, host read of the loss), launches "
              f"{json.dumps({k: v for k, v in counts.items() if v})}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rows[f"{name} {layout}"] = {"bn": n_bn, "losses": [first, loss],
                                    "step_ms": ms, "launches": counts}
        del step, net
        torch.cuda.empty_cache()
    rows["resnet18_v2 f32 card vs CPU"] = zoo_cpu_check(checks)
    return totals, rows


def zoo_cpu_check(checks):
    """resnet18_v2, f32, b2 x 64^2, the same weights on the card and on
    the CPU: the logits 1e-4 and every gradient's rms error 1e-4 of its
    rms."""
    import torch
    from mxtpu_torch import autograd, initializer
    from mxtpu_torch.gluon.model_zoo import vision
    from mxtpu_torch.parallel import build_train_step
    x, y = rn_batch("NCHW", ZOO_CHECK_B, ZOO_CHECK_HW, SEED + 22)

    def net_on(device):
        net = fresh_names(lambda: vision.resnet18_v2(classes=RN_CLASSES))
        net.initialize(ctx="cpu")
        settle(net, torch.from_numpy(x[:1]))
        gen = torch.Generator().manual_seed(SEED + 23)
        xavier = initializer.Xavier()
        with torch.no_grad():
            for n, t in net.named_parameters():
                if t.requires_grad:
                    xavier.init_weight(n.rsplit(".", 1)[-1], t, gen)
        return net.to(device)
    card, cpu = (build_train_step(net_on(d), rn_loss(), "sgd", RN_SGD,
                                  device=d) for d in (CARD, "cpu"))
    with autograd.train_mode(), torch.no_grad():
        lc = card.net(torch.from_numpy(x).to(CARD))
        lp = cpu.net(torch.from_numpy(x))
    l_err, _ = rel_err(lc.cpu(), lp)
    _, gc = card.forward_backward(x, y)
    _, gp = cpu.forward_backward(x, y)
    worst = 0.0
    for n, a, b in zip(card.param_names, gc, gp):
        r = float(b.double().pow(2).mean().sqrt())
        d = float((a.double().cpu() - b.double()).pow(2).mean().sqrt())
        worst = max(worst, d / max(r, 1e-30))
    ok = l_err <= GRAD_TOL and worst <= GRAD_TOL
    print(f"check zoo resnet18_v2 f32 b{ZOO_CHECK_B} {ZOO_CHECK_HW}x"
          f"{ZOO_CHECK_HW} card vs CPU: logits max rel err {l_err:.3e} "
          f"(tol {GRAD_TOL}), gradients over {len(gc)} tensors worst rms "
          f"error {worst:.3e} of the tensor's rms (tol {GRAD_TOL}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        checks.failed.append(f"zoo resnet18_v2 card vs CPU: logits "
                             f"{l_err:.3e}, gradients {worst:.3e}")
    return {"logits_rel": l_err, "worst_grad_rel": worst, "ok": ok}


def zoo_kernel_rows(checks, gen):
    """#8-#11 at the zoo rows' shapes (``ZOO_ROWS``, bf16) against their
    plain versions, timed (:func:`bn_times`): the kernels line's
    ``"path": "zoo"`` rows."""
    import torch
    import importlib
    bn = importlib.import_module("mxtpu_torch.kernels.batch_norm")
    dev, bf = torch.device(CARD), torch.bfloat16
    out = {}
    for view, (n, C, S, act, add) in ZOO_ROWS.items():
        cm = view == "cm"

        def randn(*shape, mean=0.0, std=1.0):
            return (mean + std * torch.randn(*shape, generator=gen,
                                             device=dev)).to(bf)
        x = randn(n, C, S, mean=0.5, std=2.0)
        r = randn(n, C, S) if add else None
        dy = randn(n, C, S)
        g, b = randn(C, mean=1.0, std=0.2), randn(C, std=0.1)
        if cm:
            x, r, dy = (None if t is None else
                        t.transpose(1, 2).contiguous().reshape(n * S, C)
                        for t in (x, r, dy))
        fwd = bn.bn_fwd_cm if cm else bn.bn_fwd
        bwd = bn.bn_bwd_cm if cm else bn.bn_bwd
        y, mean, var = fwd(x, g, b, r, 1e-5, act)
        py, _, _ = bn.bn_act_reference(x, g, b, 1e-5, act, r)
        rstd = torch.rsqrt(var + 1e-5)
        got = bwd(x, r, dy, g, b, mean, rstd, act)
        want = bn.bn_bwd_reference(x, r, dy, g, b, mean, rstd, act)
        tag = f"zoo bn {view} N{n} C{C} S{S} {act}{' add' if add else ''}"
        errs = {"fwd": checks.close(f"{tag} y", y, py, "bfloat16"),
                "bwd": checks.close(f"{tag} dx", got[0], want[0],
                                    "bfloat16")}
        for kname, t in bn_times(x, r, dy, g, b, act, cm,
                                 (n, C, S)).items():
            print(f"time {kname} [bfloat16] zoo N{n} C{C} S{S} (device ms "
                  f"per call): kernel_ms={t['ms']:.4f} plain_ms="
                  f"{t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
                  f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})",
                  flush=True)
            out[kname] = {"max_abs_err": errs[kname.split("_")[2]], **t,
                          "shape": [n, C, S]}
        del x, r, dy
        torch.cuda.empty_cache()
    return out


def layers_cell(checks):
    """(c): the new layers, f32 (TF32 off), forward and backward on the
    card against the CPU from the same weights and inputs, each tensor
    within 1e-5 of max(1, its rms, |want|); then ROADMAP queue 3 item
    23's Embedding ids on the card (NaN rows, no device assert) and the
    CUDA context still working after it."""
    import torch
    from mxtpu_torch import autograd, initializer, nd, random as trandom
    from mxtpu_torch.gluon import nn
    worst = 0.0
    for name, kw, shape in NEW_LAYERS:
        trandom.seed(SEED)
        net = fresh_names(lambda: getattr(nn, name)(**kw))
        net.initialize(initializer.Xavier(), ctx="cpu")
        rng = np.random.RandomState(SEED + 24)
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        settle(net, x[:1])
        res = {}
        for dev in ("cpu", CARD):
            net = net.to(dev)
            xs = x.to(dev).requires_grad_(True)
            ps = [p for p in net.parameters() if p.requires_grad]
            with autograd.record():
                yv = net(xs)
            head = torch.from_numpy(np.random.RandomState(SEED + 25).randn(
                *yv.shape).astype(np.float32)).to(dev)
            grads = torch.autograd.grad(yv, [xs] + ps, head)
            res[dev] = [yv.detach().cpu()] + [g.cpu() for g in grads]
        # a weight gradient sums ~2000 products a tap: each tensor is
        # held to its own scale, max(1, rms, |want|)
        errs = [rel_err(a, b, max(1.0, float(b.double().pow(2).mean()
                                             .sqrt())))[0]
                for a, b in zip(res[CARD], res["cpu"])]
        err = max(errs)
        worst = max(worst, err)
        ok = err <= LAYER_TOL
        print(f"check layer {name} {kw} {shape} card vs CPU f32: output and "
              f"{len(errs) - 1} gradients max rel err {err:.3e} (tol "
              f"{LAYER_TOL}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            checks.failed.append(f"layer {name} card vs CPU {err:.3e}")
    w = nd.array(np.arange(24, dtype=np.float32).reshape(12, 2), ctx=CARD)
    ids = nd.array(np.array([0, 11, 12, 25, -1, -13], np.float32), ctx=CARD)
    rows = nd.Embedding(ids, w, input_dim=12, output_dim=2).asnumpy()
    torch.cuda.synchronize()
    alive = float(torch.ones(8, device=CARD).sum()) == 8.0
    want_nan = np.array([False, False, True, True, False, True])
    ok = bool((np.isnan(rows).all(1) == want_nan).all()) and \
        rows[4].tolist() == [22.0, 23.0] and alive
    print(f"check Embedding ids [0, 11, 12, 25, -1, -13] on the card: NaN "
          f"rows {np.isnan(rows).all(1).astype(int).tolist()}, row -1 = "
          f"{rows[4].tolist()}, the CUDA context usable after it: {alive} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        checks.failed.append("Embedding ids outside [0, V) on the card")
    return {"worst_rel": worst, "embedding_ok": ok}


def pipeline_phase(checks, gen):
    """Phase 21 (see the module's docstring): returns the BatchNorm
    launches of the fed windows and of the zoo steps, the zoo rows of
    the kernels line and the numbers."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rec_") as d:
        prefix = os.path.join(d, "synth")
        pipeline_records(prefix)
        print(f"pipeline dataset: {PIPE_EPOCH * PIPE_B} raw records of "
              f"3x{PIPE_HW}x{PIPE_HW} uint8 written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        pipe_counts, pipe = pipeline_cell(checks, prefix)
    zoo_counts, zoo = zoo_cell(checks)
    rows = zoo_kernel_rows(checks, gen)
    layers = layers_cell(checks)
    print(f"pipeline phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return pipe_counts, zoo_counts, rows, {"pipeline": pipe, "zoo": zoo,
                                           "layers": layers}


# ----------------------------------------------------------------------
# phase 22: the serving fleet (FleetRouter / FleetWorker, health checks,
# scripted faults, the control plane, obs and the profiler)
# ----------------------------------------------------------------------

FLEET_B, FLEET_T = 8, 128              # max_batch_size, the seq bucket
FLEET_RAW = 48                         # the burst that prices the fleet
FLEET_ROWS = 64                        # distinct token rows
FLEET_N, FLEET_KILL, FLEET_ATTACH = 192, 64, 96
FLEET_FAULT_N, FLEET_BURST_N, FLEET_TAIL, FLEET_TRACED = 16, 72, 8, 4
FLEET_RTOL, FLEET_ATOL = 1e-4, 1e-5    # the router's canary compare
FLEET_TIMEOUT_S = 30.0
FLEET_GEN_LANES, FLEET_GEN_BUCKET = 2, 32
FLEET_GEN_PROMPT, FLEET_GEN_TOKENS, FLEET_GEN_KILL_AT = 20, 32, 6
FLEET_GEN_TOPK = 8
FLEET_SPANS = ("fleet/submit", "fleet/queue_wait", "serving/pad_scatter",
               "serving/execute", "fleet/execute")


def fleet_router(canary, expect, **kw):
    """A threaded router as ``bench_serving_fleet`` builds one: a 2 ms
    ticker, a canary every 0.25 s with a 2 s deadline."""
    from mxtpu_torch.serving import FleetRouter
    kw.setdefault("tick_s", 0.002)
    return FleetRouter(threaded=True, canary=canary, canary_expect=expect,
                       canary_seq_len=None if canary is None else FLEET_T,
                       canary_interval_s=0.25, canary_timeout_s=2.0, **kw)


def fleet_worker(runner, name, **kw):
    from mxtpu_torch.serving import FleetWorker
    return FleetWorker(runner, name, max_queue_delay_us=2000.0, **kw)


def fleet_wait(pred, timeout_s, poll_s=0.002):
    t_end = time.perf_counter() + timeout_s
    while time.perf_counter() < t_end:
        if pred():
            return True
        time.sleep(poll_s)
    return pred()


def fleet_collect(reqs, idx, results):
    """Wait for each request; its outcome goes to ``results`` as (row
    index, logits or None, the error's class name or None).  Returns
    (drops, hangs): terminal errors inside the deadline, and waits that
    outlived it."""
    from mxtpu_torch.serving import RequestTimeout
    drops = hangs = 0
    for i, r in zip(idx, reqs):
        try:
            results.append((i, r.result(timeout=FLEET_TIMEOUT_S + 5.0)[0],
                            None))
        except RequestTimeout as e:
            results.append((i, None, type(e).__name__))
            hangs += 1
        except Exception as e:  # noqa: BLE001 — a drop, counted
            results.append((i, None, type(e).__name__))
            drops += 1
    return drops, hangs


def fleet_eager_rows(runner, rows):
    """Each row alone through the eager plan at bucket (1, FLEET_T): the
    logits a served request is held against (trimmed to its length)."""
    bucket = (1, FLEET_T)
    e = runner._eager_entry(bucket)
    for x in rows:
        vals = runner._pad_stack([{"data": x}], bucket)
        with e.lock:
            (o,) = e.run(vals)
        yield o[0, :len(x)].cpu().numpy()


def fleet_counts(entry):
    """An entry's captured launches by kernel name (what each replay of
    it adds to the counts)."""
    from mxtpu_torch import kernels
    names = {v: k for k, v in kernels._modules().items()}
    return {names[k]: n for k, n in entry.launches.items() if k in names}


def fleet_recovery(checks, runners, cold, canary, expect, rows, results):
    """(a): three workers, a kill of w0 at request FLEET_KILL and wR
    attached from w0's handoff at FLEET_ATTACH, open-loop traffic at half
    the fleet's measured raw rate.  ``cold`` is a runner that serves one
    request before anything is built (its bucket captured on the request
    path).  Returns the launches and the numbers."""
    from mxtpu_torch import kernels, obs
    t0 = time.perf_counter()
    cold.infer({"data": rows[0][None]})
    cold_first_s = time.perf_counter() - t0
    cold_capture_s = cold.compile_seconds[(1, FLEET_T)]
    cold_cold = cold.cold_compiles()
    t0 = time.perf_counter()
    warm0 = runners["w0"].warmup()
    w0_warm_s = time.perf_counter() - t0
    router = fleet_router(canary, expect)
    eng = obs.slo_engine([obs.AvailabilitySLO("fleet_avail",
                                              objective=0.999)],
                         obs.sampler(period_us=10_000.0))
    router.attach_slo(eng)
    workers = {n: fleet_worker(r, n) for n, r in runners.items()}
    with router:
        router.add_worker(workers["w0"])
        handoff = workers["w0"].handoff()
        for n in ("w1", "w2"):
            router.add_worker(workers[n], warm_from=handoff)
        kernels.reset_launch_counts()
        # the fleet's raw rate: a burst of FLEET_RAW at once
        t0 = time.perf_counter()
        raw = [router.submit({"data": rows[i]}, seq_len=len(rows[i]),
                             timeout_s=FLEET_TIMEOUT_S)
               for i in range(FLEET_RAW)]
        d0, h0 = fleet_collect(raw, range(FLEET_RAW), results)
        raw_rps = FLEET_RAW / (time.perf_counter() - t0)
        offered = 0.5 * raw_rps
        interval = 1.0 / offered
        reqs, idx = [], []
        wr_warm_s = None
        t_start = time.perf_counter()
        for k in range(FLEET_N):
            lag = t_start + k * interval - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
            if k == FLEET_KILL:
                # preemption while w0 replays a batch: its in-flight
                # requests are stolen while its thread is mid-replay
                busy = fleet_wait(lambda: (workers["w0"].inflight_age(
                    time.monotonic()) or 1.0) < 0.002, 2.0, 0.0001)
                router.kill("w0")
            if k == FLEET_ATTACH:
                t0 = time.perf_counter()
                router.add_worker(workers["wR"], warm_from=handoff)
                wr_warm_s = time.perf_counter() - t0
                wr_cold0 = runners["wR"].cold_compiles()
            i = FLEET_RAW + k
            idx.append(i)
            reqs.append(router.submit({"data": rows[i]},
                                      seq_len=len(rows[i]),
                                      timeout_s=FLEET_TIMEOUT_S))
        drops, hangs = fleet_collect(reqs, idx, results)
        served_rps = (FLEET_N - drops - hangs) / (time.perf_counter()
                                                  - t_start)
        counts = kernels.launch_counts()
        snap = router.fleet_stats()
        states = router.workers()
        postmortem = router.postmortem("w0")
    steals = sum(1 for r in reqs + raw if r.requeues)
    on_wr = sum(1 for r in reqs if r.tried and r.tried[-1] == "wR")
    ex = snap["extras"]
    healthy_dead = [n for n, s in states.items()
                    if n != "w0" and s != "healthy"]
    n_fwd = counts["layer_norm_fwd"]
    bad_counts = {k: v for k, v in counts.items()
                  if v != SERVE_PER_FWD.get(k, 0) * n_fwd}
    lat = snap["latency_ms"]
    wr_cold = runners["wR"].cold_compiles()
    ok = (drops + d0 == 0 and hangs + h0 == 0 and states["w0"] == "dead"
          and not healthy_dead and wr_cold == 0 and wr_cold0 == 0
          and ex.get("deaths", 0) == 1 and n_fwd > 0 and not bad_counts
          and on_wr > 0 and ex.get("wrong_results", 0) == 0)
    print(f"fleet (a): BERT-Large f32 x 3 workers (b<={FLEET_B}, T "
          f"{FLEET_T}), raw burst of {FLEET_RAW} {raw_rps:.2f} req/s; "
          f"{FLEET_N} requests open-loop at {offered:.2f} req/s, w0 "
          f"killed at {FLEET_KILL}, wR attached from its handoff at "
          f"{FLEET_ATTACH} (w0 mid-batch at the kill: {busy}): served "
          f"{served_rps:.2f} req/s through the "
          f"kill, latency p50 {lat['p50']} p95 {lat['p95']} p99 "
          f"{lat['p99']} ms; drops {drops + d0}, hangs {hangs + h0}; "
          f"retries {ex.get('retries', 0)}, requeues "
          f"{ex.get('requeues', 0)}, deaths {ex.get('deaths', 0)}, "
          f"steals {steals}, canary wrong results "
          f"{ex.get('wrong_results', 0)}; workers {states}; {on_wr} "
          f"requests finished on wR", flush=True)
    print(f"fleet (a): w0's ladder of {len(warm0)} buckets captured in "
          f"{w0_warm_s:.3f} s (" + ", ".join(
              f"{k} {v:.3f}" for k, v in warm0.items()) +
          f" s); wR warmed from the handoff in {wr_warm_s:.3f} s, "
          f"{runners['wR'].num_compiled()} entries, cold builds "
          f"{wr_cold0} at attach and {wr_cold} after the traffic; a cold "
          f"runner's first request {cold_first_s:.3f} s wall, its bucket "
          f"captured on the request path in {cold_capture_s:.3f} s "
          f"({cold_cold} cold build); launches {json.dumps(counts)} over "
          f"{n_fwd} forwards {'ok' if ok else 'FAIL'}", flush=True)
    checks.rows.append({"check": "fleet recovery", "drops": drops + d0,
                        "hangs": hangs + h0, "states": states,
                        "wR_cold_compiles": wr_cold, "launches": counts,
                        "ok": ok})
    if not ok:
        checks.failed.append(
            f"fleet (a): drops {drops + d0}, hangs {hangs + h0}, states "
            f"{states}, wR cold builds {wr_cold0}/{wr_cold}, deaths "
            f"{ex.get('deaths', 0)}, wrong canaries "
            f"{ex.get('wrong_results', 0)}, {on_wr} on wR, launches off "
            f"24/1/48 a forward: {bad_counts}")
    return counts, {
        "raw_rps": raw_rps, "offered_rps": offered,
        "served_rps": served_rps, "p50_ms": lat["p50"],
        "p95_ms": lat["p95"], "p99_ms": lat["p99"],
        "drops": drops + d0, "hangs": hangs + h0,
        "retries": ex.get("retries", 0), "requeues": ex.get("requeues", 0),
        "deaths": ex.get("deaths", 0), "steals": steals,
        "finished_on_wR": on_wr, "states": states, "busy_at_kill": busy,
        "w0_capture_s": {str(k): v for k, v in warm0.items()},
        "wR_warm_s": wr_warm_s, "wR_cold_compiles": wr_cold,
        "cold_first_request_s": cold_first_s,
        "cold_capture_s": cold_capture_s, "forwards": n_fwd,
        "slo": snap.get("slo"),
        "w0_postmortem": [e["kind"] for e in
                          postmortem["flight"]["events"]]}


def fleet_faults(checks, runners, canary, expect, rows, results, base):
    """(b): a Corrupt worker caught by the canary and a Hang worker by
    the liveness deadline, each beside a healthy one; every client
    request completes on a worker that serves it right."""
    from mxtpu_torch.serving import Corrupt, FaultPlan, Hang
    router = fleet_router(canary, expect)
    ok_w = fleet_worker(runners["w1"], "ok")
    bad = fleet_worker(runners["w2"], "corrupt",
                       faults=FaultPlan(Corrupt(from_batch=0)))
    hung = fleet_worker(runners["wR"], "hung",
                        faults=FaultPlan(Hang(at_batch=1)))
    t0 = time.perf_counter()
    with router:
        router.add_worker(ok_w)
        router.add_worker(bad)
        # the corrupt worker's first canary verdict takes it out of
        # rotation before any client request reaches it
        suspect = fleet_wait(
            lambda: router.workers()["corrupt"] != "healthy", 10.0)
        router.add_worker(hung)
        # a first wave, then a second once the hung worker has hung (its
        # second dispatch, a batch or a canary): the second wave queues
        # behind the hung batch until liveness reaps the worker
        half = FLEET_FAULT_N // 2
        idx = list(range(base, base + FLEET_FAULT_N))
        reqs = [router.submit({"data": rows[i]}, seq_len=len(rows[i]),
                              timeout_s=FLEET_TIMEOUT_S) for i in idx[:half]]
        drops, hangs = fleet_collect(reqs, idx[:half], results)
        stuck = fleet_wait(lambda: hung._stuck, 10.0)
        wave = [router.submit({"data": rows[i]}, seq_len=len(rows[i]),
                              timeout_s=FLEET_TIMEOUT_S) for i in idx[half:]]
        d2, h2 = fleet_collect(wave, idx[half:], results)
        reqs += wave
        drops, hangs = drops + d2, hangs + h2
        dead = fleet_wait(lambda: router.workers()["corrupt"] == "dead"
                          and router.workers()["hung"] == "dead", 20.0)
        snap = router.fleet_stats()
        states = router.workers()
        reasons = {n: w["reason"] for n, w in snap["workers"].items()}
    secs = time.perf_counter() - t0
    # the hung worker may finish a batch before the one that hangs;
    # the requests it held when it died were stolen
    stolen = [r for r in reqs if r.requeues and "hung" in r.tried[:-1]]
    moved = all(r.tried[-1] == "ok" for r in stolen)
    on_bad = sum(1 for r in reqs if "corrupt" in r.tried)
    ex = snap["extras"]
    ok = (suspect and stuck and dead and drops == 0 and hangs == 0
          and states["ok"] == "healthy" and "CORRUPT" in reasons["corrupt"]
          and reasons["hung"].startswith("hang") and stolen and moved
          and on_bad == 0 and ex.get("wrong_results", 0) >= 1)
    print(f"fleet (b): a Corrupt worker caught by the canary ("
          f"{reasons['corrupt']!r}, {ex.get('wrong_results', 0)} wrong "
          f"canary results, {on_bad} client requests sent to it), a Hang "
          f"worker caught by liveness ({reasons['hung']!r}); "
          f"{len(stolen)} requests stolen from the hung worker, all "
          f"finished on 'ok' {moved}; drops {drops}, hangs {hangs}; "
          f"states {states}; {secs:.1f} s {'ok' if ok else 'FAIL'}",
          flush=True)
    checks.rows.append({"check": "fleet faults", "states": states,
                        "reasons": reasons, "stolen": len(stolen),
                        "ok": ok})
    if not ok:
        checks.failed.append(f"fleet (b): states {states}, reasons "
                             f"{reasons}, stolen {len(stolen)} moved "
                             f"{moved}, drops {drops}, hangs {hangs}")
    return {"reasons": reasons, "states": states, "stolen": len(stolen),
            "wrong_canaries": ex.get("wrong_results", 0), "seconds": secs}


def fleet_generate(checks, gen_files, kv_spec):
    """(c): two workers with a GenerateRunner each over BERT-Large's
    incremental decode; the worker that holds a greedy and a seeded
    top-k stream is killed mid-generation, and each resumed stream must
    equal the same prompt's uninterrupted stream, token for token."""
    from mxtpu_torch import symbol as sym_mod
    from mxtpu_torch.ndarray import load_params
    from mxtpu_torch.serving import FleetWorker, GenerateRunner
    gsym, gw = sym_mod.load(gen_files[0]), load_params(gen_files[1])

    def worker(name):
        return FleetWorker(None, name, gen_runner=GenerateRunner(
            gsym, gw, kv_spec, prompt_buckets=(FLEET_GEN_BUCKET,),
            device=CARD))

    rng = np.random.RandomState(SEED + 31)
    prompts = [[int(t) for t in rng.randint(0, VOCAB, FLEET_GEN_PROMPT)]
               for _ in range(2)]
    kws = [dict(max_tokens=FLEET_GEN_TOKENS),
           dict(max_tokens=FLEET_GEN_TOKENS, top_k=FLEET_GEN_TOPK,
                seed=SEED + 32)]
    t0 = time.perf_counter()
    g0 = worker("g0")
    warm = g0.generator.warmup()
    g0_warm_s = time.perf_counter() - t0
    # the survivor's decode plane warmed from g0's handoff before the
    # streams start (attaching it with warm_from then builds nothing)
    g1 = worker("g1")
    t0 = time.perf_counter()
    g1.generator.warm_from(g0.handoff()["generate"])
    g1_warm_s = time.perf_counter() - t0
    router = fleet_router(None, None)
    with router:
        router.add_worker(g0)
        streamed = [[], []]
        freqs = [router.submit_generate(
            p, timeout_s=FLEET_TIMEOUT_S,
            on_token=lambda t, i, s=s: s.append((i, t)), **k)
            for p, k, s in zip(prompts, kws, streamed)]
        router.add_worker(g1, warm_from=g0.handoff())
        mid = fleet_wait(lambda: min(len(s) for s in streamed)
                         >= FLEET_GEN_KILL_AT, 30.0, 0.0005)
        at_kill = [len(s) for s in streamed]
        router.kill("g0")
        got, errs = [], []
        for f in freqs:
            try:
                got.append(f.result(timeout=FLEET_TIMEOUT_S + 5.0))
            except Exception as e:  # noqa: BLE001 — reported
                got.append(None)
                errs.append(repr(e))
        # the same prompts uninterrupted, on the survivor
        alone = [router.submit_generate(p, timeout_s=FLEET_TIMEOUT_S, **k)
                 for p, k in zip(prompts, kws)]
        want = [a.result(timeout=FLEET_TIMEOUT_S + 5.0) for a in alone]
    cold = g1.generator.runner.cold_compiles()
    same = [g == w for g, w in zip(got, want)]
    once = [[i for i, _ in s] == list(range(FLEET_GEN_TOKENS))
            and [t for _, t in s] == g for s, g in zip(streamed, got)]
    anomalies = [f.anomalies() for f in freqs]
    ok = (mid and not errs and all(same) and all(once)
          and max(at_kill) < FLEET_GEN_TOKENS
          and all(f.requeues == 1 and f.tried == ["g0", "g1"]
                  for f in freqs)
          and all(a == {"duplicate_tokens": 0, "wrong_tokens": 0}
                  for a in anomalies) and cold == 0)
    print(f"fleet (c): generation on 2 workers (BERT-Large causal f32, "
          f"{FLEET_GEN_LANES} lanes, prompt bucket {FLEET_GEN_BUCKET}); "
          f"g0's ladder of {len(warm)} entries captured in {g0_warm_s:.3f}"
          f" s, g1 warmed from its handoff in {g1_warm_s:.3f} s (cold "
          f"builds {cold}); g0 killed with the greedy and the top-k "
          f"stream at {at_kill} of {FLEET_GEN_TOKENS} tokens; resumed on "
          f"g1: equal to the uninterrupted streams {same}, every index "
          f"once {once}, anomalies {anomalies}, tried "
          f"{[f.tried for f in freqs]} {'ok' if ok else 'FAIL'}",
          flush=True)
    checks.rows.append({"check": "fleet generation", "same": same,
                        "once": once, "at_kill": at_kill, "ok": ok})
    if not ok:
        checks.failed.append(f"fleet (c): resumed streams equal {same}, "
                             f"once {once}, at kill {at_kill}, errors "
                             f"{errs[:2]}, g1 cold builds {cold}")
    return {"at_kill": at_kill, "same": same, "g0_warm_s": g0_warm_s,
            "g1_warm_s": g1_warm_s, "g1_cold_compiles": cold}


def fleet_control(checks, runners, replica, canary, expect, rows, results,
                  base):
    """(d): an Autoscaler (min 1, max 2) on two workers drains one when
    idle, then scales up under a burst with a replica warmed from the
    handoff; the replica builds nothing cold."""
    from mxtpu_torch.serving import Autoscaler
    router = fleet_router(canary, expect)
    made = []

    def make_worker(name):
        made.append(fleet_worker(replica, name))
        return made[-1]

    scaler = Autoscaler(router, make_worker, min_workers=1, max_workers=2,
                        up_depth=4.0, down_depth=0.5, breach_ticks=3,
                        cooldown_s=0.5)
    t0 = time.perf_counter()
    with router:
        for n in ("w1", "w2"):
            router.add_worker(fleet_worker(runners[n], f"a{n[1]}"))
        router.add_controller(scaler.tick)
        down = fleet_wait(lambda: scaler.snapshot()["scale_downs"] == 1
                          and "dead" in router.workers().values(), 10.0)
        time.sleep(scaler.cooldown_s + 0.1)   # the burst meets no cooldown
        idx = list(range(base, base + FLEET_BURST_N))
        reqs = [router.submit({"data": rows[i]}, seq_len=len(rows[i]),
                              timeout_s=FLEET_TIMEOUT_S)
                for i in idx[:-FLEET_TAIL]]
        drops, hangs = fleet_collect(reqs, idx[:-FLEET_TAIL], results)
        # the replica attaches once its ladder is warm from the handoff
        up = fleet_wait(lambda: bool(made)
                        and made[0].name in router.workers(), 20.0)
        # freeze the scaler, then a tail the two workers share
        scaler.cooldown_s = float("inf")
        tail = [router.submit({"data": rows[i]}, seq_len=len(rows[i]),
                              timeout_s=FLEET_TIMEOUT_S)
                for i in idx[-FLEET_TAIL:]]
        d2, h2 = fleet_collect(tail, idx[-FLEET_TAIL:], results)
        reqs += tail
        drops, hangs = drops + d2, hangs + h2
        snap = scaler.snapshot()
        events = scaler.recorder.events()
        states = router.workers()
    secs = time.perf_counter() - t0
    ups = [e for e in events if e["kind"] == "scale_up"]
    cold = replica.cold_compiles()
    on_new = sum(1 for r in reqs if made and made[0].name in r.tried)
    ok = (down and up and snap["scale_ups"] == 1 and len(made) == 1
          and cold == 0
          and replica.num_compiled() > 0 and on_new > 0 and drops == 0
          and hangs == 0)
    print(f"fleet (d): autoscaler min 1 max 2: scale-down (drain) when "
          f"idle {down}; a burst of {FLEET_BURST_N - FLEET_TAIL} scaled "
          f"up "
          f"{snap['scale_ups']} time(s), the replica warmed from "
          f"{[e.get('donor') for e in ups]}'s handoff, "
          f"{replica.num_compiled()} entries, cold builds {cold}; the "
          f"replica served {on_new} of the burst and a tail of "
          f"{FLEET_TAIL}; drops {drops}, hangs {hangs}; states "
          f"{states}; {secs:.1f} s {'ok' if ok else 'FAIL'}", flush=True)
    checks.rows.append({"check": "fleet control plane", "scaler": snap,
                        "replica_cold_compiles": cold, "ok": ok})
    if not ok:
        checks.failed.append(f"fleet (d): scaler {snap}, replica cold "
                             f"builds {cold}, served {on_new}, drops "
                             f"{drops}, hangs {hangs}")
    return {"scaler": snap, "decisions": events,
            "replica_cold_compiles": cold, "served_on_replica": on_new,
            "seconds": secs}


def fleet_observe(checks, runners, rows, results, base):
    """(e) and (f): FLEET_TRACED requests traced through a canary-free
    fleet (each request's spans in mxtpu's order, a device capture of
    the same window through ``profiler.start_jax_trace``), ``/metrics``
    of the debug server round-tripped through ``parse_prometheus_text``,
    and one served forward's launches."""
    import urllib.request
    from mxtpu_torch import kernels, obs, profiler
    from mxtpu_torch.obs.metrics import (parse_prometheus_text,
                                         samples_from_snapshot)
    out_dir = ROOT / "mxtpu_torch" / "_build"
    router = fleet_router(None, None)
    with router:
        router.add_worker(fleet_worker(runners["w1"], "t0"))
        # one served forward, alone on the card
        kernels.reset_launch_counts()
        r = router.submit({"data": rows[base]}, seq_len=len(rows[base]),
                          timeout_s=FLEET_TIMEOUT_S)
        fleet_collect([r], [base], results)
        one = {k: v for k, v in kernels.launch_counts().items() if v}
        captured = fleet_counts(runners["w1"]._entries[(1, FLEET_T)])
        profiler.dumps(reset=True)
        profiler.set_config(filename=str(out_dir / "fleet_trace.json"))
        profiler.set_state("run")
        profiler.start_jax_trace(str(out_dir / "fleet_device_trace"))
        idx = list(range(base + 1, base + 1 + FLEET_TRACED))
        reqs = [router.submit({"data": rows[i]}, seq_len=len(rows[i]),
                              timeout_s=FLEET_TIMEOUT_S) for i in idx]
        fleet_collect(reqs, idx, results)
        device_path = profiler.stop_jax_trace()
        profiler.set_state("stop")
        profiler.dump()
        events = profiler.events()
    bad_order = []
    for r in reqs:
        # this request's spans in the order they were recorded
        mine = [e for e in events if e.get("args") and (
            e["args"].get("trace_id") == r.trace_id
            or r.trace_id in e["args"].get("trace_ids", ()))]
        names = [e["name"] for e in mine if e["name"] in FLEET_SPANS]
        by = {e["name"]: e for e in mine}
        ordered = names == list(FLEET_SPANS)
        if ordered:
            sub, qw, pad, run, ex = (by[n] for n in FLEET_SPANS)
            eps = 1.0   # us: the spans' clocks are read apart
            ordered = (sub["ts"] <= qw["ts"] + eps
                       and qw["ts"] + qw["dur"] <= ex["ts"] + eps
                       and ex["ts"] <= pad["ts"] + eps
                       and pad["ts"] + pad["dur"] <= run["ts"] + eps
                       and run["ts"] + run["dur"]
                       <= ex["ts"] + ex["dur"] + eps)
        if not ordered:
            bad_order.append(names)
    dev = json.loads(Path(device_path).read_text())
    n_kern = sum(1 for e in dev.get("traceEvents", [])
                 if e.get("cat") == "kernel")
    srv = obs.debug_server(port=0, router=router)
    try:
        def fetch(path):
            with urllib.request.urlopen(srv.url + path, timeout=10) as f:
                return f.read().decode()
        text = fetch("/metrics")
        snap = obs.snapshot()
        health = json.loads(fetch("/healthz"))
        statusz = json.loads(fetch("/statusz"))
    finally:
        srv.close()
    round_trip = parse_prometheus_text(text) == samples_from_snapshot(snap)
    want = {"flash_attention_fwd": LAYERS, "layer_norm_fwd": 1,
            "fused_residual_ln_fwd": 2 * LAYERS}
    ok = (not bad_order and n_kern > 0 and round_trip
          and one == want and captured == want
          and "workers" in statusz and health["status"] in ("ok",
                                                            "degraded"))
    print(f"fleet (e): {FLEET_TRACED} traced requests, spans in mxtpu's "
          f"order (submit, queue wait, pad/scatter, run, execute) "
          f"{not bad_order}; the device capture of the window "
          f"(start_jax_trace) holds {n_kern} kernel events; /metrics "
          f"({len(text)} bytes) round-trips through parse_prometheus_text "
          f"{round_trip}; /healthz {health['status']}; (f) one served "
          f"forward launched {json.dumps(one)}, its captured entry records"
          f" {json.dumps(captured)} {'ok' if ok else 'FAIL'}", flush=True)
    checks.rows.append({"check": "fleet obs", "bad_order": bad_order,
                        "device_kernel_events": n_kern,
                        "metrics_round_trip": round_trip,
                        "one_forward": one, "ok": ok})
    if not ok:
        checks.failed.append(f"fleet (e/f): span order {bad_order[:2]}, "
                             f"device kernels {n_kern}, round trip "
                             f"{round_trip}, one forward {one}, entry "
                             f"{captured}")
    return one, {"device_kernel_events": n_kern, "metrics_bytes": len(text),
                 "one_forward": one}


def fleet_phase(checks, params):
    """Phase 22 (see the module's docstring): returns the fleet run's
    launches, one served forward's, and the numbers."""
    import tempfile
    import torch
    from mxtpu_torch import symbol as sym_mod
    from mxtpu_torch.ndarray import load_params
    from mxtpu_torch.serving import ModelRunner
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "mxtpu_torch" / "_build",
                                     prefix="fleet_") as tmp:
        files = serve_export(params, os.path.join(tmp, "bert"))
        symbol, weights = sym_mod.load(files[0]), load_params(files[1])
        gnet, gen_files = gen_export(os.path.join(tmp, "genbert"))
        kv_spec = gnet.kv_cache_spec(FLEET_GEN_LANES, MAXLEN)
        del gnet
        gen = fleet_generate(checks, gen_files, kv_spec)
    gc.collect()
    torch.cuda.empty_cache()
    secs = {"generation": time.perf_counter() - t_phase}

    def make_runner():
        return ModelRunner(symbol, weights, {"data": (None,)},
                           seq_buckets=[FLEET_T], max_batch_size=FLEET_B,
                           device=CARD)

    rng = np.random.RandomState(SEED + 30)
    n_rows = FLEET_RAW + FLEET_N + FLEET_FAULT_N + FLEET_BURST_N + 1 + \
        FLEET_TRACED
    # FLEET_ROWS distinct token rows, request i carrying row i % FLEET_ROWS
    # (each row's eager reference is computed once)
    pool = [rng.randint(0, VOCAB, n).astype(np.float32)
            for n in rng.randint(FLEET_T // 2, FLEET_T + 1, FLEET_ROWS)]
    rows = [pool[i % FLEET_ROWS] for i in range(n_rows)]
    canary_row = rng.randint(0, VOCAB, FLEET_T).astype(np.float32)
    canary = {"data": canary_row}
    results = []
    t0 = time.perf_counter()
    runners = {n: make_runner() for n in ("w0", "w1", "w2", "wR")}
    # the canary's expected logits: the eager plan at its bucket
    (expect,) = list(fleet_eager_rows(runners["w0"], [canary_row]))
    counts, recovery = fleet_recovery(checks, runners, make_runner(),
                                      canary, [expect], rows, results)
    secs["recovery"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    base = FLEET_RAW + FLEET_N
    faults = fleet_faults(checks, runners, canary, [expect], rows, results,
                          base)
    secs["faults"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    replica = make_runner()
    control = fleet_control(checks, runners, replica, canary, [expect],
                            rows, results, base + FLEET_FAULT_N)
    secs["control"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    one, observe = fleet_observe(checks, runners, rows, results,
                                 base + FLEET_FAULT_N + FLEET_BURST_N)
    secs["observe"] = time.perf_counter() - t0
    # every served result against its row alone through the eager plan
    t0 = time.perf_counter()
    by_row = {}
    for i, got, err in results:
        by_row.setdefault(i % FLEET_ROWS, []).append((got, err))
    wrong, missing, worst_abs, worst_ratio = 0, 0, 0.0, 0.0
    order = sorted(by_row)
    for i, want in zip(order, fleet_eager_rows(runners["w0"],
                                               [pool[i] for i in order])):
        for got, err in by_row[i]:
            if got is None:
                missing += 1
                continue
            diff = np.abs(got.astype(np.float64) - want)
            lim = FLEET_ATOL + FLEET_RTOL * np.abs(want.astype(np.float64))
            worst_abs = max(worst_abs, float(diff.max()))
            worst_ratio = max(worst_ratio, float((diff / lim).max()))
            if got.shape != want.shape or not np.all(diff <= lim):
                wrong += 1
    secs["check"] = time.perf_counter() - t0
    ok = wrong == 0 and missing == 0 and len(results) == n_rows
    print(f"check fleet results: {len(results)} served requests (every "
          f"cell) against each row alone through the eager plan at (1, "
          f"{FLEET_T}): {wrong} outside the canary's tolerance (rtol "
          f"{FLEET_RTOL}, atol {FLEET_ATOL}), {missing} without a result; "
          f"largest deviation {worst_abs:.3e} abs, {worst_ratio:.4f} of the "
          f"tolerance {'ok' if ok else 'FAIL'}", flush=True)
    checks.rows.append({"check": "fleet results vs eager", "wrong": wrong,
                        "missing": missing, "max_abs_err": worst_abs,
                        "tol_ratio": worst_ratio, "ok": ok})
    if not ok:
        checks.failed.append(f"fleet: {wrong} wrong and {missing} missing "
                             f"results of {len(results)}")
    del runners, replica, results
    gc.collect()
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"fleet: phase {phase_s:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()) + ")", flush=True)
    return counts, one, {"recovery": recovery, "faults": faults,
                         "generation": gen, "control": control,
                         "observe": observe, "max_abs_err": worst_abs,
                         "tol_ratio": worst_ratio, "phase_s": phase_s,
                         "phase_split_s": secs}


# ----------------------------------------------------------------------
# phase 23: detection (the MultiBox, Proposal, ROI and box-NMS ops on
# the greedy-suppression kernel; SSD-300 and Faster R-CNN)
# ----------------------------------------------------------------------

DET_B, DET_HW, DET_CLASSES = 8, 300, 20       # bench_ssd's batch
DET_SGD = {"learning_rate": 5e-3, "momentum": 0.9, "wd": 5e-4}
DET_WARMUP, DET_STEPS, DET_WINDOWS, DET_REPEAT = 3, 10, 3, 5
DET_LAUNCHES = {"batch_norm_fwd": 14, "batch_norm_bwd": 14}
# SSD-300's BatchNorm (C, S): the body's 4 blocks, the 3 extra scales
DET_BN = ((32, 300 ** 2), (64, 150 ** 2), (128, 75 ** 2), (256, 37 ** 2),
          (256, 18 ** 2), (128, 9 ** 2), (128, 4 ** 2))
# the timed shape's copies of x and dy (46 MB each in bf16, under the
# H100's 50 MB of L2): each call reads the copies the one before did not
DET_BN_ROTATE = 3
DET_CHECK_B = 2                               # the card-vs-CPU step
DET_TOL = 1e-5        # the loss: x max(1, |ref|)
# the forward's outputs, x max(1, |ref|): 14 f32 convolutions, each
# followed by a training-mode BatchNorm whose one-pass variance E[x^2] -
# E[x]^2 (mxtpu's formula) rounds apart by ~1e-6 of itself between the
# devices' summation orders; measured 4.3-4.6e-5 on an H100
DET_FWD_TOL = 1e-4
DET_TARGET_TOL = 1e-6  # MultiBoxTarget's box_target: x max(1, |ref|)
DET_ROW_TOL = 1e-6    # detection rows' and rois' coordinates
NEAR_TIE = 1e-6       # an IoU this close to the threshold may flip
# (batch, n, n_iter, pixel IoU, what the size is)
NMS_CASES = ((2, 256, 256, True, "faster_rcnn_small's pre_n"),
             (8, 1704, 400, False, "ssd_300's anchors, nms_topk 400"),
             (2, 6000, 6000, True, "Proposal's rpn_pre_nms_top_n"))
NMS_LINE_CASE = 1     # the kernels line's NMS row: SSD's detection
RCNN_B, RCNN_HW, RCNN_STEPS, RCNN_OBJ = 2, 600, 12, 32
RCNN_LAUNCHES = {"batch_norm_fwd": 3, "batch_norm_bwd": 3}
RCNN_HEAD_TOL = 1e-4
PROP_SHAPE = (2, 24, 38, 38)   # Proposal at the reference's defaults


def det_labels(rng, b, classes):
    """bench_ssd's VOC-shaped labels (``bench.py:509-518``): (b, 3, 5)
    rows [cls, x0, y0, x1, y1], 1 + i % 3 objects, -1 padding."""
    labels = np.full((b, 3, 5), -1.0, np.float32)
    for i in range(b):
        for o in range(1 + i % 3):
            x0, y0 = rng.uniform(0, 0.6, 2)
            labels[i, o] = [rng.randint(classes), x0, y0,
                            x0 + rng.uniform(0.2, 0.4),
                            y0 + rng.uniform(0.2, 0.4)]
    return labels


def det_batch(b, seed=0):
    """bench_ssd's batch: x ~ randn(b, 3, 300, 300), then the labels,
    from one ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 3, DET_HW, DET_HW).astype(np.float32)
    return x, det_labels(rng, b, DET_CLASSES)


def det_loss_fn():
    """bench_ssd's ``det_loss`` (``bench.py:496-499``) over the step's
    tensors: MultiBoxTarget (no mining), SSDLoss, the mean."""
    from mxtpu_torch.gluon.block import F
    from mxtpu_torch.models import SSDLoss
    loss_fn = SSDLoss()

    def det_loss(pred, labels):
        anchors, cls_preds, box_preds = pred
        bt, bm, ct = F.MultiBoxTarget(anchors, labels, cls_preds)
        return loss_fn(cls_preds, box_preds, ct, bt, bm).mean()
    return det_loss


def seeded_ssd(device=None):
    """``ssd_300(20)`` with xavier weights from ``mxtpu_torch.random``'s
    seed, its shapes settled on one image (on the card by default)."""
    import torch
    from mxtpu_torch import random as trandom
    from mxtpu_torch.models import ssd_300
    device = device or CARD
    trandom.seed(SEED)
    net = fresh_names(lambda: ssd_300(num_classes=DET_CLASSES))
    net.initialize(init="xavier", ctx=device)
    settle(net, torch.zeros(1, 3, DET_HW, DET_HW, device=device))
    return net


def seeded_ssd_step(compute_dtype="bfloat16"):
    """bench_ssd's step: SGD momentum, ``compute_dtype`` (bf16, mxtpu's
    ``MXTPU_BENCH_DTYPE`` default), the batch cast, the labels not."""
    from mxtpu_torch.parallel import build_train_step
    return build_train_step(seeded_ssd(), det_loss_fn(), "sgd", DET_SGD,
                            compute_dtype=compute_dtype, device=CARD)


@contextlib.contextmanager
def nms_record():
    """Record every ``nms_keep`` call the detection rules make (their
    inputs and the keep mask), for the near-tie rule."""
    from mxtpu_torch.ndarray import detection_impl as di
    from mxtpu_torch.ndarray import contrib as dc
    orig, calls = di.nms_keep, []

    def rec(boxes, keep0, thr, n_iter, ids=None, pixel=False):
        keep = orig(boxes, keep0, thr, n_iter, ids=ids, pixel=pixel)
        calls.append({"boxes": boxes.detach().cpu(),
                      "keep0": keep0.cpu(), "thr": thr, "n_iter": n_iter,
                      "ids": None if ids is None else ids.cpu(),
                      "pixel": pixel, "keep": keep.cpu()})
        return keep
    di.nms_keep = dc.nms_keep = rec
    try:
        yield calls
    finally:
        di.nms_keep = dc.nms_keep = orig


def near_tie_rows(call):
    """(B, n) bool: rows that a live earlier sweeping row overlaps with
    an IoU within ``NEAR_TIE`` of the threshold (same class where the
    call masks by class)."""
    import torch
    from mxtpu_torch.kernels.nms import pair_iou
    iou = pair_iou(call["boxes"], call["pixel"])
    n = iou.shape[-1]
    near = (iou - float(np.float32(call["thr"]))).abs() <= NEAR_TIE
    if call["ids"] is not None:
        ids = call["ids"]
        near &= ids[..., :, None] == ids[..., None, :]
    i = torch.arange(n)
    near &= (i[None, :] > i[:, None]) & (i[:, None] < call["n_iter"])
    near &= call["keep"][..., :, None]
    return near.any(-2)


def keep_agreement(card, cpu):
    """Compare the card's and the CPU's recorded sweeps call by call:
    (rows that differ, near-tie rows, every image's first differing row
    a near-tie row)."""
    differ = near = 0
    explained = True
    for a, b in zip(card, cpu):
        d = a["keep"] != b["keep"]
        nt = near_tie_rows(b) | near_tie_rows(a)
        differ += int(d.sum())
        near += int(nt.sum())
        for img in range(d.shape[0]):
            idx = d[img].nonzero()
            if len(idx) and not bool(nt[img, int(idx[0])]):
                explained = False
    return differ, near, explained and len(card) == len(cpu)


def count_device_kernels(fn, windows=3):
    """CUDA kernels one call of ``fn`` launches (torch.profiler; the most
    of ``windows`` windows, as a window now and then drops events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = 0
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        best = max(best, sum(e.count for e in prof.key_averages()
                             if _device_us(e) > 0))
    return best


def nms_inputs(b, n, pixel, seed):
    """Seeded score-ordered boxes (pixel boxes in a 600² image, else
    normalized), class ids among 20 and ~90 % of keep0 set."""
    import torch
    rng = np.random.RandomState(seed)
    scale = 600.0 if pixel else 1.0
    xy = rng.uniform(0, scale, (b, n, 2)).astype(np.float32)
    wh = rng.uniform(0, 0.2 * scale, (b, n, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1)).to(CARD)
    ids = torch.from_numpy(rng.randint(0, DET_CLASSES, (b, n))
                           .astype(np.float32)).to(CARD)
    keep0 = torch.from_numpy(rng.rand(b, n) > 0.1).to(CARD)
    return boxes, ids, keep0


def nms_cell(checks):
    """(a): the NMS kernel against its plain loop at ``NMS_CASES``,
    class-aware and force_suppress: keep masks bit-equal, one launch a
    call; class-aware, ms a call of each and the CUDA kernels each
    launches (the plain loop, thousands of launches a call, timed over
    one call), and the bound (the IoU pairs' operations against the
    boxes' bytes)."""
    import importlib
    from mxtpu_torch import kernels
    nms = importlib.import_module("mxtpu_torch.kernels.nms")
    rows = []
    for k, (b, n, n_iter, pixel, what) in enumerate(NMS_CASES):
        boxes, ids, keep0 = nms_inputs(b, n, pixel, SEED + 230 + k)
        for mode, cls in (("class-aware", ids), ("force_suppress", None)):
            thr = 0.7 if pixel else 0.5
            kernels.reset_launch_counts()
            got = nms.nms_keep(boxes, keep0, thr, n_iter, ids=cls,
                               pixel=pixel)
            one = kernels.launch_counts()["nms"]
            want = nms.nms_keep_reference(boxes, keep0, thr, n_iter,
                                          ids=cls, pixel=pixel)
            same = bool((got == want).all())
            ok = same and one == 1
            tag = f"nms b{b} n{n} n_iter{n_iter} {mode}"
            print(f"check {tag} ({what}): keep mask kernel == plain loop "
                  f"bit for bit {same}, kept {int(got.sum())} of {b * n}, "
                  f"{one} launch a call {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                checks.failed.append(f"{tag}: equal {same}, launches {one}")
            if cls is None:
                continue

            def kern():
                return nms.nms_keep(boxes, keep0, thr, n_iter, ids=cls,
                                    pixel=pixel)

            def plain():
                return nms.nms_keep_reference(boxes, keep0, thr, n_iter,
                                              ids=cls, pixel=pixel)
            # one call is two kernels: each one's mean over its
            # recorded launches, so a window that drops some still
            # reads whole calls
            parts = device_ms(kern, by_name=list(KERNEL_NAMES["nms"]))
            ms = sum(parts.values())
            plain_ms = device_ms(plain, iters=1, warmup=0)
            wall = time_ms(kern, iters=20, warmup=3)
            plain_wall = time_ms(plain, iters=1, warmup=0)
            k_kernels = count_device_kernels(kern)
            p_kernels = count_device_kernels(plain, windows=1)
            pairs = sum(n - 1 - i for i in range(n_iter)) * b
            nbytes = b * n * (16 + (4 if cls is not None else 0) + 2)
            b_ms, b_by = bound(nbytes, 14 * pairs, "float32")
            print(f"time nms [float32] {tag} (device ms per call): "
                  f"kernel_ms={ms:.4f} (" + ", ".join(
                      f"{k} {v:.4f}" for k, v in parts.items()) +
                  f") plain_ms={plain_ms:.4f} "
                  f"library_ms=null bound_ms={b_ms:.6f} ({b_by}); wall ms "
                  f"a call kernel {wall:.4f} plain {plain_wall:.4f}; CUDA "
                  f"kernels a call: kernel {k_kernels}, plain loop "
                  f"{p_kernels}", flush=True)
            rows.append({"b": b, "n": n, "n_iter": n_iter, "mode": mode,
                         "what": what, "equal": same, "launches": one,
                         "ms": ms, "ms_parts": parts,
                         "plain_ms": plain_ms, "wall_ms": wall,
                         "plain_wall_ms": plain_wall, "library_ms": None,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "max_abs_err": 0.0 if same else 1.0,
                         "cuda_kernels": k_kernels,
                         "plain_cuda_kernels": p_kernels})
    # NaN corners: the kernel's minima and maxima pass NaN on as the
    # plain version's do, so a NaN IoU suppresses nothing on both
    b, n, n_iter, pixel, _ = NMS_CASES[0]
    boxes, ids, keep0 = nms_inputs(b, n, pixel, SEED + 239)
    boxes[:, 5::17, 0] = float("nan")
    boxes[:, 11::29, 3] = float("nan")
    for mode, cls in (("class-aware", ids), ("force_suppress", None)):
        got = nms.nms_keep(boxes, keep0, 0.7, n_iter, ids=cls, pixel=pixel)
        want = nms.nms_keep_reference(boxes, keep0, 0.7, n_iter, ids=cls,
                                      pixel=pixel)
        same = bool((got == want).all())
        print(f"check nms b{b} n{n} {mode} with NaN corners: keep mask "
              f"kernel == plain loop bit for bit {same} "
              f"{'ok' if same else 'FAIL'}", flush=True)
        if not same:
            checks.failed.append(f"nms with NaN corners {mode}")
    return rows


def det_bn_cell(checks, gen):
    """#8/#9 against their plain versions at each of SSD-300's seven
    BatchNorm shapes (N = 8, bf16, no add, no ReLU: the block's
    Activation follows), forward and backward; the largest, 8 x 32 x
    300², timed over ``DET_BN_ROTATE`` copies of its inputs (so no call
    finds them in L2) as the sum of each call's CUDA kernels: the
    kernels line's ``"path": "detection"`` rows."""
    import torch
    import importlib
    bn = importlib.import_module("mxtpu_torch.kernels.batch_norm")
    dev, bf = torch.device(CARD), torch.bfloat16
    out = {}
    for C, S in DET_BN:
        def randn(*shape, mean=0.0, std=1.0):
            return (mean + std * torch.randn(*shape, generator=gen,
                                             device=dev)).to(bf)
        x = randn(DET_B, C, S, mean=0.5, std=2.0)
        dy = randn(DET_B, C, S)
        g, b = randn(C, mean=1.0, std=0.2), randn(C, std=0.1)
        y, mean, var = bn.bn_fwd(x, g, b, None, 1e-5, "none")
        py, _, _ = bn.bn_act_reference(x, g, b, 1e-5, "none", None)
        rstd = torch.rsqrt(var + 1e-5)
        got = bn.bn_bwd(x, None, dy, g, b, mean, rstd, "none")
        want = bn.bn_bwd_reference(x, None, dy, g, b, mean, rstd, "none")
        tag = f"ssd bn N{DET_B} C{C} S{S}"
        errs = {"fwd": checks.close(f"{tag} y", y, py, "bfloat16"),
                "bwd": checks.close(f"{tag} dx", got[0], want[0],
                                    "bfloat16")}
        if (C, S) == DET_BN[0]:
            for kname, t in bn_times(x, None, dy, g, b, "none", False,
                                     (DET_B, C, S),
                                     rotate=DET_BN_ROTATE).items():
                parts = ", ".join(f"{k} {v:.4f}"
                                  for k, v in t["ms_parts"].items())
                print(f"time {kname} [bfloat16] ssd N{DET_B} C{C} S{S} "
                      f"(device ms per call, {DET_BN_ROTATE} input copies "
                      f"in turn): kernel_ms={t['ms']:.4f} ({parts}) "
                      f"plain_ms={t['plain_ms']:.4f} library_ms="
                      f"{t['library_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
                      f"({t['bound_by']})", flush=True)
                out[kname] = {"max_abs_err": errs[kname.split("_")[2]],
                              **t, "shape": [DET_B, C, S]}
        del x, dy
        torch.cuda.empty_cache()
    return out


def det_window(step, x, y, bulked):
    """One timed window of DET_STEPS steps (eager) or one run_steps
    call, ended by a host read of its last loss."""
    import torch
    t0 = time.perf_counter()
    if bulked:
        losses = list(step.run_steps(x, y, DET_STEPS, reuse_batch=True))
    else:
        losses = [step(x, y) for _ in range(DET_STEPS)]
    float(losses[-1])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / DET_STEPS * 1e3, losses


def ssd_train_cell(checks):
    """(b): bench_ssd's recipe on ssd_300 at b8 x 3 x 300², bf16:
    eager windows then run_steps windows (launches 14/14/0/0 a step in
    both), samples/s, one profiled step, peak memory; the losses finite
    and falling; the first DET_REPEAT losses of two steps built from the
    same seed bit for bit (cuDNN deterministic).  Returns the counts,
    the numbers, the trained step (for (d)) and the batch."""
    import torch
    from mxtpu_torch import kernels
    gc.collect()
    reset_peak()
    held = torch.cuda.memory_allocated()
    x, labels = det_batch(DET_B)
    xd, yd = torch.from_numpy(x).to(CARD), torch.from_numpy(labels).to(CARD)
    with deterministic_cudnn():
        reps = []
        for _ in range(2):
            s = seeded_ssd_step()
            reps.append([float(s(xd, yd)) for _ in range(DET_REPEAT)])
            del s
            torch.cuda.empty_cache()
    same = reps[0] == reps[1]
    print(f"check ssd_300 bf16 b{DET_B} repeats bit for bit from the same "
          f"seeds over {DET_REPEAT} steps (cuDNN deterministic): "
          f"{'ok' if same else 'FAIL'} ({reps[0]} / {reps[1]})", flush=True)
    if not same:
        checks.failed.append("ssd_300 does not repeat from the same seeds")
    t0 = time.perf_counter()
    step = seeded_ssd_step()
    losses = [step(xd, yd) for _ in range(DET_WARMUP)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n = DET_STEPS * DET_WINDOWS
    ms = {}
    for mode in ("eager", "run_steps"):
        kernels.reset_launch_counts()
        windows = []
        for _ in range(DET_WINDOWS):
            w, ls = det_window(step, xd, yd, mode == "run_steps")
            windows.append(w)
            losses += ls
        counts = kernels.launch_counts()
        check_launches(checks, f"ssd_300 {mode}", counts, DET_LAUNCHES, n)
        ms[mode] = (float(np.median(windows)), windows)
        if mode == "eager":
            eager_counts = counts
    mem = {**step.memory_summary(), "held_before_bytes": held}
    bd = profiled_step(checks, "ssd_300 bf16", step, xd, yd)
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        checks.failed.append(f"ssd_300 losses not finite: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        checks.failed.append(f"ssd_300 loss did not fall: {losses}")
    rows = {}
    for mode, (m, windows) in ms.items():
        rows[mode] = {"ms_per_step": m, "window_ms_per_step": windows,
                      "samples_per_s": DET_B / m * 1e3}
        print(f"ssd_300 bf16 b{DET_B} {mode}: {m:.3f} ms/step (median of "
              f"{DET_WINDOWS} windows of {DET_STEPS}: "
              f"{', '.join(f'{w:.3f}' for w in windows)}), "
              f"{DET_B / m * 1e3:.2f} samples/s", flush=True)
    print(f"ssd_300 bf16: device {bd['device_busy_ms']:.3f} ms a step, idle "
          f"share {bd['device_idle_share'] or 0:.4f} (the profiled step); "
          f"peak memory {((mem['peak_bytes'] or 0) - held) / 2**30:.3f} GiB "
          f"over the {held / 2**30:.3f} GiB earlier phases held; set-up and "
          f"{DET_WARMUP} warm-up steps {setup_s:.1f} s; losses "
          f"{[round(v, 4) for v in losses[:6]]} ... {losses[-1]:.4f}",
          flush=True)
    print(f"ssd_300: launches in {n} eager steps {json.dumps(eager_counts)}",
          flush=True)
    return eager_counts, {**rows, "memory": mem, "breakdown": bd,
                          "losses": losses, "setup_s": setup_s,
                          "repeats_bit_for_bit": same}, step, (x, labels)


@contextlib.contextmanager
def pool_relu_decisions(net, replay=None):
    """The card's discrete choices, or their replay on the CPU.  With
    ``replay`` None, record each ``MaxPool2D``'s argmax and each ReLU
    ``Activation``'s mask of ``net`` (a dict by block name, yielded);
    given such a dict, make ``net``'s pools gather at the recorded
    argmax and its ReLUs multiply by the recorded mask.  A pool window
    whose two largest values lie within a rounding of each other (or a
    ReLU input within one of 0) decides otherwise on the two devices
    and sends the whole gradient elsewhere: replayed, the CPU follows
    the card's routes, and the two gradients differ by their
    arithmetic alone.  SSD's pools are 2x2 with stride 2; the global
    max pool is not replayed."""
    import torch
    import torch.nn.functional as F
    rec = {} if replay is None else replay
    hooks = []

    def pool(mod, inp, out):
        x = inp[0]
        if replay is None:
            _, idx = F.max_pool2d(x.detach(), 2, 2, return_indices=True)
            if not torch.equal(x.detach().flatten(2).gather(
                    2, idx.flatten(2)).view_as(out), out.detach()):
                raise AssertionError(f"{mod.name}: argmax misread")
            rec[mod.name] = idx.cpu()
            return None
        idx = rec[mod.name].to(x.device)
        return x.flatten(2).gather(2, idx.flatten(2)).view_as(idx)

    def relu(mod, inp, out):
        x = inp[0]
        if replay is None:
            rec[mod.name] = (x.detach() > 0).cpu()
            return None
        return x * rec[mod.name].to(x.device)
    for m in net.modules():
        kind = type(m).__name__
        if kind == "MaxPool2D":
            hooks.append(m.register_forward_hook(pool))
        elif kind == "Activation" and getattr(m, "_act_type", "relu") \
                == "relu":
            hooks.append(m.register_forward_hook(relu))
    try:
        yield rec
    finally:
        for h in hooks:
            h.remove()


def ssd_cpu_check(checks):
    """(c): ssd_300 in f32 at b2 x 300² on the card against the CPU from
    the same weights, the CPU following the card's pool and ReLU
    choices (:func:`pool_relu_decisions`; the gradients without the
    replay are printed beside): the training-mode forward's three
    outputs, one step's loss and every gradient; then MultiBoxTarget
    on both devices from the same inputs (the card's cls_preds,
    copied), mining -1 and 3."""
    import torch
    from mxtpu_torch import autograd
    from mxtpu_torch.convert import params_from_mxtpu, params_to_mxtpu
    from mxtpu_torch.gluon.block import F
    from mxtpu_torch.models import ssd_300
    from mxtpu_torch.parallel import build_train_step
    t0 = time.perf_counter()
    x, labels = det_batch(DET_CHECK_B, seed=SEED + 23)

    def pair():
        card = seeded_ssd()
        return card, params_from_mxtpu(params_to_mxtpu(card), fresh_names(
            lambda: ssd_300(num_classes=DET_CLASSES)))
    card, cpu = pair()
    outs = {}
    with pool_relu_decisions(card) as rec:
        with torch.no_grad(), autograd.train_mode():
            outs[CARD] = [o.cpu() for o in card(torch.from_numpy(x).to(CARD))]
    with pool_relu_decisions(cpu, rec):
        with torch.no_grad(), autograd.train_mode():
            outs["cpu"] = [o for o in cpu(torch.from_numpy(x))]
    fwd = max(rel_err(a, b)[0] for a, b in zip(outs[CARD], outs["cpu"]))

    def grads(replay):
        card, cpu = pair()
        steps = [build_train_step(net, det_loss_fn(), "sgd", DET_SGD,
                                  device=dev)
                 for net, dev in ((card, CARD), (cpu, "cpu"))]
        if not replay:
            return steps[0].param_names, [s.forward_backward(x, labels)
                                          for s in steps]
        with pool_relu_decisions(card) as rec:
            lg_card = steps[0].forward_backward(x, labels)
        with pool_relu_decisions(cpu, rec):
            lg_cpu = steps[1].forward_backward(x, labels)
        return steps[0].param_names, [lg_card, lg_cpu]

    def rms(t):
        return float(t.pow(2).mean().sqrt())
    worst = {}
    for replay in (False, True):
        names, ((lc, gc_), (lp, gp)) = grads(replay)
        errs = [(rms(a.double().cpu() - p.double()) /
                 max(rms(p.double()), 1e-30), n)
                for n, a, p in zip(names, gc_, gp)]
        worst[replay] = max(errs)
        if replay:
            for err, n in errs:
                if err > GRAD_TOL:
                    checks.failed.append(f"ssd check: grad of {n} off by "
                                         f"{err:.3e} of its rms")
            lrel = abs(float(lc) - float(lp)) / max(1.0, abs(float(lp)))
            loss = (float(lc), float(lp))
    ok = fwd <= DET_FWD_TOL and lrel <= DET_TOL and \
        worst[True][0] <= GRAD_TOL
    print(f"check ssd_300 b{DET_CHECK_B} f32 card vs CPU (the CPU on the "
          f"card's pool and ReLU choices): forward outputs max rel err "
          f"{fwd:.3e} (tol {DET_FWD_TOL} x max(1, |ref|)); loss "
          f"{loss[0]:.6f} vs {loss[1]:.6f} (err {lrel:.3e}, tol {DET_TOL}); "
          f"worst gradient rms err {worst[True][0]:.3e} of its rms "
          f"({worst[True][1]}) over {len(names)} parameters (tol "
          f"{GRAD_TOL}) {'ok' if ok else 'FAIL'}; without the replay "
          f"{worst[False][0]:.3e} ({worst[False][1]})", flush=True)
    if fwd > DET_FWD_TOL or lrel > DET_TOL:
        checks.failed.append(f"ssd check: forward {fwd:.3e}, loss "
                             f"{lrel:.3e}")
    anchors, cls_preds = outs[CARD][0], outs[CARD][1]
    for ratio in (-1.0, 3.0):
        tgt = {dev: [t.cpu() for t in F.MultiBoxTarget(
            anchors.to(dev), torch.from_numpy(labels).to(dev),
            cls_preds.to(dev), negative_mining_ratio=ratio)]
            for dev in (CARD, "cpu")}
        (bt, bm, ct), (pbt, pbm, pct_) = tgt[CARD], tgt["cpu"]
        terr = rel_err(bt, pbt)[0]
        eq = bool(torch.equal(ct, pct_)) and bool(torch.equal(bm, pbm))
        tok = eq and terr <= DET_TARGET_TOL
        ok = ok and tok
        print(f"check MultiBoxTarget mining {ratio} card vs CPU (the card's "
              f"cls_preds): cls_target and box_mask equal {eq}, box_target "
              f"max rel err {terr:.3e} (tol {DET_TARGET_TOL} x max(1, "
              f"|ref|)); positives {int(bm.sum()) // 4}, ignored "
              f"{int((ct < 0).sum())} {'ok' if tok else 'FAIL'}", flush=True)
        if not tok:
            checks.failed.append(f"MultiBoxTarget mining {ratio} card vs CPU")
    print(f"ssd card vs CPU: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return {"forward_rel": fwd, "loss_err": lrel,
            "worst_grad_rms_of_rms": worst[True][0],
            "worst_grad_rms_of_rms_unreplayed": worst[False][0], "ok": ok}


def rows_agree(checks, tag, card_rows, cpu_rows, card_calls, cpu_calls):
    """Detection rows of the card against the CPU's on the same inputs:
    every sweep's keep mask equal but where a near tie explains the
    first difference; where both keep a row, its class and score equal
    and its corners within DET_ROW_TOL."""
    import torch
    differ, near, explained = keep_agreement(card_calls, cpu_calls)
    both = (card_rows[..., 0] >= 0) & (cpu_rows[..., 0] >= 0)
    same_id = bool(torch.equal(card_rows[..., :2][both],
                               cpu_rows[..., :2][both]))
    coord = float((card_rows[..., 2:][both] -
                   cpu_rows[..., 2:][both]).abs().max()) if both.any() \
        else 0.0
    ok = explained and same_id and coord <= DET_ROW_TOL and \
        (differ == 0 or near > 0)
    print(f"check {tag} card vs CPU on the same inputs: {differ} kept rows "
          f"differ ({near} rows decided by an IoU within {NEAR_TIE} of the "
          f"threshold; each first difference such a row: {explained}); "
          f"classes and scores of rows both keep equal {same_id}, corners "
          f"max abs err {coord:.3e} (tol {DET_ROW_TOL}); "
          f"{int(both.sum())} rows kept on both {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        checks.failed.append(f"{tag} card vs CPU")
    return {"rows_differ": differ, "near_tie_rows": near,
            "explained": explained, "coord_err": coord, "ok": ok}


def ssd_detect_cell(checks, step, batch):
    """(d): ``SSD.detect`` at b8 after (b)'s steps: the card's rows
    against the CPU's MultiBoxDetection on the same (probs, box_preds,
    anchors); VOC07 mAP of both row sets against the batch's labels
    equal; ms and NMS launches a detect call."""
    import torch
    from mxtpu_torch import kernels, nd
    from mxtpu_torch.metric import VOC07MApMetric
    net = step.net
    x, labels = batch
    xn = nd.array(x, ctx=CARD)
    anchors, cls_preds, box_preds = net(xn)
    probs = nd.softmax(cls_preds, axis=1)
    kernels.reset_launch_counts()
    with nms_record() as card_calls:
        rows_card = nd.MultiBoxDetection(probs, box_preds, anchors,
                                         nms_topk=400).data.cpu()
    main = kernels.launch_counts()["nms"]
    cpu = [nd.array(t.asnumpy(), ctx="cpu")
           for t in (probs, box_preds, anchors)]
    with nms_record() as cpu_calls:
        rows_cpu = nd.MultiBoxDetection(*cpu, nms_topk=400).data.cpu()
    res = rows_agree(checks, f"ssd_300 detect b{DET_B}", rows_card,
                     rows_cpu, card_calls, cpu_calls)
    maps = []
    for rows in (rows_card, rows_cpu):
        m = VOC07MApMetric()
        m.update([labels], [rows.numpy()])
        maps.append(m.get()[1])
    same_map = maps[0] == maps[1] or (np.isnan(maps[0]) and
                                      np.isnan(maps[1]))
    print(f"check VOC07MApMetric of the card's rows == of the CPU's: "
          f"{maps[0]!r} vs {maps[1]!r} {'ok' if same_map else 'FAIL'}",
          flush=True)
    if not same_map:
        checks.failed.append("VOC07 mAP of the card's rows != the CPU's")
    kernels.reset_launch_counts()
    net.detect(xn)
    main += kernels.launch_counts()["nms"]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    calls = 5
    for _ in range(calls):
        out = net.detect(xn)
    out.asnumpy()
    detect_ms = (time.perf_counter() - t0) / calls * 1e3
    per = kernels.launch_counts()["nms"] / calls
    ok = per == 1 and main == 2 and \
        tuple(out.shape) == (DET_B, anchors.shape[1], 6)
    print(f"ssd_300 detect b{DET_B}: {detect_ms:.3f} ms a call (host clock "
          f"over {calls}, ended by a copy), {per:g} NMS launch a call; "
          f"{main} NMS launches on the main path (MultiBoxDetection, one "
          f"detect), "
          f"rows {tuple(out.shape)}, kept {int((rows_card[..., 0] >= 0).sum())}"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        checks.failed.append(f"ssd detect: {per} NMS launches a call, "
                             f"{main} on the main path")
    return {**res, "map_card": maps[0], "map_cpu": maps[1],
            "detect_ms": detect_ms, "nms_per_detect": per,
            "nms_main": main}


def rcnn_scene(b, size, obj):
    """test_rcnn's RPN scene at ``size``: dim noise with one bright
    square of ``obj`` pixels an image, its box the label (class 0)."""
    rng = np.random.RandomState(SEED + 26)
    x = rng.rand(b, 3, size, size).astype(np.float32) * 0.1
    labels = np.zeros((b, 1, 5), np.float32)
    for i in range(b):
        x0 = size // 8 + (size // 4) * i
        x[i, :, x0:x0 + obj, x0:x0 + obj] = 1.0
        labels[i, 0] = [0, x0 / size, x0 / size, (x0 + obj) / size,
                        (x0 + obj) / size]
    return x, labels


def rcnn_cell(checks):
    """(e): faster_rcnn_small(20) at b2 x 3 x 600², im_info [600, 600,
    1]: the card's Proposal against the CPU's on the same (prob,
    rpn_reg); the head on the CPU over the card's rois within
    RCNN_HEAD_TOL; 12 RPN steps (test_rcnn's, adam through
    gluon.Trainer) with 3/3 BN launches a step, losses finite and
    falling; then ``detect``."""
    import torch
    from mxtpu_torch import autograd, kernels, nd
    from mxtpu_torch import random as trandom
    from mxtpu_torch.convert import params_from_mxtpu, params_to_mxtpu
    from mxtpu_torch.gluon import Trainer
    from mxtpu_torch.models import faster_rcnn_small, rpn_anchors
    t0 = time.perf_counter()
    x, labels = rcnn_scene(RCNN_B, RCNN_HW, RCNN_OBJ)
    info = np.array([[RCNN_HW, RCNN_HW, 1.0]] * RCNN_B, np.float32)
    trandom.seed(SEED)
    net = fresh_names(lambda: faster_rcnn_small(num_classes=DET_CLASSES))
    net.initialize(init="xavier", ctx=CARD)
    xn, infon = nd.array(x, ctx=CARD), nd.array(info, ctx=CARD)
    kernels.reset_launch_counts()
    with torch.no_grad():
        full = net(xn, infon)
    fwd_nms = kernels.launch_counts()["nms"]
    cpu_net = params_from_mxtpu(params_to_mxtpu(net), fresh_names(
        lambda: faster_rcnn_small(num_classes=DET_CLASSES)))
    # the forward's stages on the card, so the CPU gets Proposal's and
    # the head's exact inputs
    A = net._A
    with torch.no_grad():
        feat = net.body(xn)
        rpn_raw, rpn_reg = net.rpn(feat)
        bg = nd.slice_axis(rpn_raw, axis=1, begin=0, end=A)
        fg = nd.slice_axis(rpn_raw, axis=1, begin=A, end=2 * A)
        m = nd.maximum(bg, fg)
        eb, ef = nd.exp(bg - m), nd.exp(fg - m)
        prob = nd.concat(eb / (eb + ef), ef / (eb + ef), dim=1)
        kw = dict(scales=net._scales, ratios=net._ratios,
                  feature_stride=net._stride,
                  rpn_pre_nms_top_n=4 * net._post_nms,
                  rpn_post_nms_top_n=net._post_nms, threshold=0.7,
                  rpn_min_size=net._stride, output_score=True)
        with nms_record() as card_calls:
            rois, scores = nd.Proposal(prob, rpn_reg, infon, **kw)
        with nms_record() as cpu_calls:
            crois, cscores = nd.Proposal(
                *(nd.array(t.asnumpy(), ctx="cpu")
                  for t in (prob, rpn_reg, infon)), **kw)
    same_full = bool(torch.equal(full[0].data, rois.data))
    prop = proposal_agree(checks, f"faster_rcnn_small Proposal b{RCNN_B} "
                          f"(pre_n {4 * net._post_nms})", rois, scores,
                          crois, cscores, card_calls, cpu_calls, RCNN_HW)
    with torch.no_grad():
        cfeat = nd.array(feat.asnumpy(), ctx="cpu")
        pooled = nd.ROIPooling(cfeat, nd.array(rois.asnumpy(), ctx="cpu"),
                               pooled_size=net._pooled,
                               spatial_scale=1.0 / net._stride)
        h = cpu_net.head(nd.Flatten(pooled))
        want = (cpu_net.cls_head(h), cpu_net.reg_head(h))
    head = max(rel_err(a.data.cpu(), b.data)[0]
               for a, b in zip(full[1:3], want))
    ok = head <= RCNN_HEAD_TOL and same_full
    print(f"check faster_rcnn_small head card vs CPU on the card's rois: "
          f"cls_scores and bbox_deltas max rel err {head:.3e} (tol "
          f"{RCNN_HEAD_TOL} x max(1, |ref|)); the forward's rois == the "
          f"staged Proposal's {same_full} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        checks.failed.append(f"faster_rcnn head {head:.3e}, rois "
                             f"{same_full}")
    # test_rcnn's RPN training, on the card
    labels_n = nd.array(labels, ctx=CARD)
    fh = RCNN_HW // net._stride
    anchors = rpn_anchors(fh, fh, net._stride, net._scales, net._ratios,
                          RCNN_HW, ctx=CARD)
    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": 3e-3})
    losses = []
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    for _ in range(RCNN_STEPS):
        with autograd.record():
            _, _, _, raw, _ = net(xn, infon)
            bgl = nd.transpose(nd.slice_axis(raw, axis=1, begin=0, end=A),
                               axes=(0, 2, 3, 1)).reshape((RCNN_B, -1))
            fgl = nd.transpose(nd.slice_axis(raw, axis=1, begin=A,
                                             end=2 * A),
                               axes=(0, 2, 3, 1)).reshape((RCNN_B, -1))
            logits = nd.stack(bgl, fgl, axis=1)
            bt, bm, ct = nd.MultiBoxTarget(anchors, labels_n, logits,
                                           overlap_threshold=0.3,
                                           negative_mining_ratio=3.0)
            loss = nd.mean(-nd.pick(nd.log_softmax(logits, axis=1), ct,
                                    axis=1))
        loss.backward()
        trainer.step(batch_size=RCNN_B)
        losses.append(float(loss.asscalar()))
    step_ms = (time.perf_counter() - t1) / RCNN_STEPS * 1e3
    counts = kernels.launch_counts()
    check_launches(checks, "faster_rcnn RPN steps",
                   {k: v for k, v in counts.items() if k != "nms"},
                   RCNN_LAUNCHES, RCNN_STEPS)
    fell = all(np.isfinite(losses)) and np.mean(losses[-3:]) < losses[0]
    if counts["nms"] != RCNN_STEPS or fwd_nms != 1:
        checks.failed.append(f"faster_rcnn NMS launches: forward {fwd_nms}"
                             f", {RCNN_STEPS} steps {counts['nms']}")
    print(f"faster_rcnn_small RPN b{RCNN_B} x {RCNN_HW}²: {RCNN_STEPS} "
          f"adam steps {step_ms:.2f} ms a step (host clock), losses "
          f"{[round(v, 4) for v in losses]} {'ok' if fell else 'FAIL'}; "
          f"launches {json.dumps(counts)}", flush=True)
    if not fell:
        checks.failed.append(f"faster_rcnn RPN losses {losses}")
    kernels.reset_launch_counts()
    det = net.detect(xn, infon, score_threshold=0.01)
    nms_calls = kernels.launch_counts()["nms"]
    dok = det.shape == (RCNN_B, net._post_nms * DET_CLASSES, 6) and \
        bool(np.isfinite(det).all()) and nms_calls == 1 + RCNN_B
    print(f"faster_rcnn_small detect: rows {det.shape}, kept "
          f"{int((det[..., 0] >= 0).sum())}, NMS launches {nms_calls} (one "
          f"Proposal, one box_nms an image) {'ok' if dok else 'FAIL'}; "
          f"the cell {time.perf_counter() - t0:.1f} s", flush=True)
    if not dok:
        checks.failed.append("faster_rcnn detect")
    del net, cpu_net, trainer
    torch.cuda.empty_cache()
    return counts, {"proposal": prop, "head_rel": head,
                    "rpn_losses": losses, "rpn_step_ms": step_ms,
                    "detect_nms_launches": nms_calls,
                    "nms_main": fwd_nms + counts["nms"] + nms_calls}


def proposal_agree(checks, tag, rois, scores, crois, cscores, card_calls,
                   cpu_calls, side):
    """Proposal's rois and scores on the card against the CPU's on the
    same inputs: the sweeps' keep masks as :func:`rows_agree` holds
    them; with equal masks the scores equal and the corners within
    DET_ROW_TOL of the image's larger ``side`` (a corner is a difference
    of numbers up to the image's size, so it carries their rounding:
    ~10 float32 ulps at 600 pixels)."""
    import torch
    differ, near, explained = keep_agreement(card_calls, cpu_calls)
    r, cr = rois.data.cpu(), crois.data
    s, cs = scores.data.cpu(), cscores.data
    coord = float((r - cr).abs().max()) / side
    same_s = bool(torch.equal(s, cs))
    ok = explained and (differ > 0 or (same_s and coord <= DET_ROW_TOL))
    print(f"check {tag} card vs CPU on the same inputs: {differ} kept rows "
          f"differ ({near} rows decided by an IoU within {NEAR_TIE} of the "
          f"threshold; each first difference such a row: {explained}); "
          f"scores equal {same_s}, rois max abs err {coord:.3e} of the "
          f"image side {side} (tol {DET_ROW_TOL}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        checks.failed.append(f"{tag} card vs CPU")
    return {"rows_differ": differ, "near_tie_rows": near,
            "explained": explained, "roi_rel": coord, "scores_equal": same_s,
            "ok": ok}


def proposal_cell(checks):
    """(f): Proposal at the reference's defaults (A = 12, stride 16,
    pre_n 6000, post_n 300) on a seeded (2, 24, 38, 38) score map, card
    against CPU; ms a call."""
    import torch
    from mxtpu_torch import kernels, nd
    N, twoA, H, W = PROP_SHAPE
    rng = np.random.RandomState(SEED + 27)
    cls = rng.rand(N, twoA, H, W).astype(np.float32)
    bbox = (rng.randn(N, 2 * twoA, H, W) * 0.1).astype(np.float32)
    info = np.array([[H * 16, W * 16, 1.0]] * N, np.float32)
    args = {d: [nd.array(a, ctx=d) for a in (cls, bbox, info)]
            for d in (CARD, "cpu")}
    with nms_record() as card_calls:
        r, s = nd.Proposal(*args[CARD], output_score=True)
    with nms_record() as cpu_calls:
        cr, cs = nd.Proposal(*args["cpu"], output_score=True)
    res = proposal_agree(checks, f"Proposal {PROP_SHAPE} defaults", r, s,
                         cr, cs, card_calls, cpu_calls, 16 * max(H, W))

    def call():
        return nd.Proposal(*args[CARD], output_score=True)
    kernels.reset_launch_counts()
    call()
    per = kernels.launch_counts()["nms"]
    ms = device_ms(call, iters=10)
    wall = time_ms(call, iters=10, warmup=2)
    print(f"time Proposal {PROP_SHAPE} pre_n 6000 post_n 300: device "
          f"{ms:.4f} ms a call, wall {wall:.4f} ms (events, host "
          f"included), {per} NMS launch a call", flush=True)
    if per != 1:
        checks.failed.append(f"Proposal: {per} NMS launches a call")
    return {**res, "ms": ms, "wall_ms": wall, "nms_main": per}


def detection_phase(checks, gen):
    """Phase 23 (see the module's docstring): returns the BN launches of
    SSD-300's eager windows, the NMS launches of the detection runs,
    the kernels line's detection rows and the numbers."""
    import torch
    from mxtpu_torch import kernels
    t0 = time.perf_counter()
    try:
        import cv2
        cv2_ok = f"cv2 {cv2.__version__} imports"
    except ImportError as e:
        cv2_ok = f"cv2 does not import ({e})"
    print(f"detection phase: {cv2_ok} on this machine (ImageDetIter "
          f"decodes through it; no record is read here)", flush=True)
    nms_rows = nms_cell(checks)
    bn_rows = det_bn_cell(checks, gen)
    ssd_counts, train, step, batch = ssd_train_cell(checks)
    check = ssd_cpu_check(checks)
    # the main path of the NMS kernel: SSD's detections, Faster R-CNN
    # (its forward, RPN steps and detect) and Proposal at the defaults;
    # each cell counts its own main-path launches from 0 before it
    # times anything
    detect = ssd_detect_cell(checks, step, batch)
    del step
    torch.cuda.empty_cache()
    rcnn_counts, rcnn = rcnn_cell(checks)
    prop = proposal_cell(checks)
    nms_main = {"detect": detect["nms_per_detect"],
                "ssd": detect["nms_main"], "rcnn": rcnn["nms_main"],
                "proposal": prop["nms_main"]}
    nms_main["runs"] = sum(nms_main[k] for k in ("ssd", "rcnn",
                                                 "proposal"))
    print(f"detection phase: NMS launches on the main path {nms_main['runs']}"
          f" (ssd_300 detection {nms_main['ssd']}, faster_rcnn_small "
          f"{nms_main['rcnn']}, Proposal {nms_main['proposal']})",
          flush=True)
    print(f"detection phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return ssd_counts, nms_main, {"nms": nms_rows[NMS_LINE_CASE],
                                  **bn_rows}, {
        "cv2": cv2_ok, "nms": nms_rows, "ssd_train": train,
        "ssd_check": check, "ssd_detect": detect, "rcnn": rcnn,
        "rcnn_counts": rcnn_counts, "proposal": prop}


# ----------------------------------------------------------------------
# phase 24: the persistent compile cache (kernel entries and bucket
# recipes), disk-warmed processes and fleet replicas, and
# GenerateRunner(donate=False) on the card
# ----------------------------------------------------------------------

CACHE_CHILD = "--cache-child"   # this script's own subprocess mode
CACHE_ROWS = 16                 # seeded requests a serving process answers
# what (c) poisons in a copy of (a)'s root
CACHE_POISON = (("kernel", "layer_norm", "corrupt"),
                ("bucket", (1, FLEET_T), "corrupt"),
                ("bucket", (2, FLEET_T), "truncate"))
# one served forward of BERT-Large: #1 f32, #4, #6
CACHE_LAUNCHES = {"flash_attention_fwd": LAYERS, "layer_norm_fwd": 1,
                  "fused_residual_ln_fwd": 2 * LAYERS}
CACHE_GEN_BUCKET, CACHE_GEN_PROMPT = 32, 20
CACHE_GEN_STEPS, CACHE_GEN_TIMED = 16, 20
CACHE_CHILD_TIMEOUT_S = 600
# bench_serving_coldstart's model and ladder (bench.py:1204-1218)
COLD_V, COLD_U, COLD_FFN, COLD_L, COLD_H = 8192, 128, 512, 2, 2
COLD_T, COLD_B, COLD_REPEATS = 64, 8, 2


def cache_rows():
    """The seeded requests every serving process of phase 24 answers:
    CACHE_ROWS token rows of 64-128 tokens."""
    rng = np.random.RandomState(SEED + 40)
    return [rng.randint(0, VOCAB, n).astype(np.float32)
            for n in rng.randint(FLEET_T // 2, FLEET_T + 1, CACHE_ROWS)]


def cache_runner(symbol, weights, **kw):
    """A fleet-phase runner (b <= 8 x T128) over the export, with the
    knob-configured cache (MXTPU_CACHE_DIR)."""
    from mxtpu_torch.serving import ModelRunner
    return ModelRunner(symbol, weights, {"data": (None,)},
                       seq_buckets=[FLEET_T], max_batch_size=FLEET_B,
                       device=CARD, **kw)


def row_digest(a):
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def cache_serve(files, spawn, out):
    """(a)-(c) in a child: the ladder warmed through the cache, the
    time from the process's spawn to its first served request, then
    every seeded row alone and the first 8 as one batch; digests of the
    rows (and, for (a), the rows themselves beside ``out``)."""
    from mxtpu_torch import kernels
    from mxtpu_torch import symbol as sym_mod
    from mxtpu_torch.cache import default_cache
    from mxtpu_torch.ndarray import load_params
    t0 = time.perf_counter()
    runner = cache_runner(sym_mod.load(files[0]), load_params(files[1]))
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    secs = runner.warmup()
    ladder_s = time.perf_counter() - t0
    rows = cache_rows()

    def alone(r):       # a row's logits, trimmed to its length
        return runner.infer({"data": r[None]})[0][0, :len(r)]

    served = [alone(rows[0])]
    first_s = time.time() - spawn
    kernels.reset_launch_counts()
    served.append(alone(rows[1]))
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    served += [alone(r) for r in rows[2:]]
    bucket = (FLEET_B, FLEET_T)
    batch = runner.run_raw(runner._pad_stack(
        [{"data": r} for r in rows[:FLEET_B]], bucket), bucket)[0]
    batch = batch.cpu().numpy()
    if out.name.startswith("a."):
        np.savez(out.with_suffix(".npz"), *served, batch=batch)
    cache = default_cache()
    return {
        "load_s": load_s, "ladder_s": ladder_s, "first_request_s": first_s,
        "bucket_s": {str(b): v for b, v in secs.items()},
        "sources": {str(b): v
                    for b, v in runner.compile_sources().items()},
        "cold_compiles": runner.cold_compiles(),
        "record": fleet_counts(runner._entries[(1, FLEET_T)]),
        "counts": counts,
        "bucket_keys": {str(b): runner._cache_key(b).digest
                        for b in runner.buckets()},
        "stats": cache.stats(),
        "rows": [row_digest(r) for r in served],
        "batch": row_digest(batch)}


def cache_fleet(files, ref):
    """(d) in a child: a threaded fleet over the export with an
    autoscaler (floor 1); w0 is killed with no handoff anywhere, the
    floor repair's replica and a replacement attached by hand warm
    from the root; every seeded row served through the fleet against
    (a)'s row at the canary's tolerance."""
    from mxtpu_torch import symbol as sym_mod
    from mxtpu_torch.ndarray import load_params
    from mxtpu_torch.serving import Autoscaler, FleetRouter
    symbol, weights = sym_mod.load(files[0]), load_params(files[1])
    made = []

    def make(name):
        w = fleet_worker(cache_runner(symbol, weights), name)
        made.append(w)
        return w

    router = FleetRouter(threaded=True, canary=None, tick_s=0.002)
    out = {}
    with router:
        out["w0"] = router.add_worker(make("w0"))
        scaler = Autoscaler(router, make, min_workers=1, max_workers=2,
                            up_depth=1e9, down_depth=0.0, breach_ticks=1,
                            cooldown_s=0.0)
        router.add_controller(scaler.tick)
        t0 = time.perf_counter()
        router.kill("w0")
        ok = fleet_wait(lambda: any(e["kind"] == "scale_up" for e in
                                    scaler.recorder.events()), 300.0)
        out["scale_up_s"] = time.perf_counter() - t0
        ups = [e for e in scaler.recorder.events()
               if e["kind"] == "scale_up"]
        out["scale_up"] = ups[0]["donor"] if ok and ups else None
        t0 = time.perf_counter()
        wr = fleet_worker(cache_runner(symbol, weights), "wR")
        out["wR"] = router.add_worker(wr)
        out["wR_warm_s"] = time.perf_counter() - t0
        rows = cache_rows()
        reqs = [router.submit({"data": r}, seq_len=len(r),
                              timeout_s=FLEET_TIMEOUT_S) for r in rows]
        got = [r.result(timeout=FLEET_TIMEOUT_S + 5.0)[0] for r in reqs]
    want = np.load(ref)
    worst = 0.0
    for i, g in enumerate(got):
        w = want[f"arr_{i}"].astype(np.float64)
        lim = FLEET_ATOL + FLEET_RTOL * np.abs(w)
        worst = max(worst, float((np.abs(g - w) / lim).max())
                    if g.shape == w.shape else np.inf)
    out.update(
        tol_ratio=worst, served=len(got),
        cold=[w.runner.cold_compiles() for w in made[1:]] +
        [wr.runner.cold_compiles()],
        sources=sorted({s for w in made[1:] + [wr]
                        for s in w.runner.compile_sources().values()}),
        record=fleet_counts(wr.runner._entries[(1, FLEET_T)]),
        workers=[w.name for w in made] + ["wR"])
    return out


def cache_gen(files):
    """(e) in a child: causal BERT-Large served by a donating
    GenerateRunner and by one that does not donate (its entries bound
    to a table it owns, the caller's table copied in before a call
    and out after): greedy streams token for token, the logits bit for
    bit, each caller's table unchanged bit for bit, the launch records
    alike; decode step ms of both and the two copies' device ms."""
    import torch
    from mxtpu_torch import kernels
    from mxtpu_torch.serving import GenerateRunner
    spec = (LAYERS, 2, GEN_LANES, HEADS, MAXLEN, UNITS // HEADS)
    kw = dict(prompt_buckets=(CACHE_GEN_BUCKET,), device=CARD)
    runners = {"donate": GenerateRunner.from_export(*files, spec,
                                                    donate=True, **kw),
               "copy": GenerateRunner.from_export(*files, spec,
                                                  donate=False, **kw)}
    rng = np.random.RandomState(SEED + 41)
    n, p = GEN_LANES, CACHE_GEN_PROMPT
    toks = np.zeros((n, CACHE_GEN_BUCKET), np.float32)
    toks[:, :p] = rng.randint(0, VOCAB, (n, p))
    out = {}

    def decode_args(last, i):
        t = np.zeros((n + 1, 1), np.float32)
        t[:n, 0] = last
        st = np.zeros(n + 1, np.float32)
        st[:n] = p + i
        return t, st

    for tag, r in runners.items():
        kv = r.new_cache()
        kept, intact = kv.clone(), True
        logits, new = r.prefill(toks, np.zeros(n, np.float32),
                                np.arange(n, dtype=np.float32), kv)
        intact &= tag == "donate" or (torch.equal(kv, kept)
                                      and new is not kv)
        last = logits[:, p - 1].argmax(-1)
        streams, rows = [last.tolist()], [logits[:, p - 1]]
        kv = new
        for i in range(CACHE_GEN_STEPS):
            kept = kv.clone() if tag == "copy" else None
            lg, new = r.decode(*decode_args(last, i), kv)
            if tag == "copy":
                intact &= torch.equal(kv, kept) and new is not kv
            kv = new
            last = lg[:n, 0].argmax(-1)
            streams.append(last.tolist())
            rows.append(lg[:n, 0])
        del kept
        kernels.reset_launch_counts()
        r.decode(*decode_args(last, CACHE_GEN_STEPS), kv)
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        (ladder,) = r._tables.values()
        out[tag] = {"streams": streams, "rows": row_digest(np.stack(rows)),
                    "intact": bool(intact), "counts": counts,
                    "records": {str(b): fleet_counts(e)
                                for b, e in sorted(ladder.items())},
                    "kv": kv}
    # decode step ms a call (host clock: the copies, the replay and the
    # logits' read), the two runners in turns
    ms = {"donate": [], "copy": []}
    for tag in ("donate", "copy", "copy", "donate"):
        r, kv = runners[tag], out[tag]["kv"]
        args = decode_args(np.zeros(n), CACHE_GEN_STEPS)
        r.decode(*args, kv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CACHE_GEN_TIMED):
            r.decode(*args, kv)
        ms[tag].append((time.perf_counter() - t0) * 1e3 / CACHE_GEN_TIMED)
    own, kv = runners["copy"]._own, out["copy"]["kv"]
    copy_in = time_ms(lambda: own.copy_(kv), iters=20)
    copy_out = time_ms(lambda: own.clone(), iters=20)
    table = own.numel() * own.element_size()
    for tag in ms:
        del out[tag]["kv"]
    # each copy reads the table once and writes it once
    return {**out, "decode_ms": ms, "copy_in_ms": copy_in,
            "copy_out_ms": copy_out, "table_gb": table / 1e9,
            "copy_bound_ms": 4 * table / PEAK_BYTES * 1e3}


def cache_child(argv):
    """One process of phase 24: ``python3 chip_smoke.py --cache-child
    MODE SPAWN_TIME OUT FILE FILE [REF]``, its root in MXTPU_CACHE_DIR.
    It builds every kernel source through the root first (timed, with
    each library's provenance), then runs MODE ("serve": (a)-(c),
    "fleet": (d), "gen": (e)) and writes its record to OUT as JSON."""
    from mxtpu_torch.cache import default_cache
    from mxtpu_torch.context import strict_f32
    from mxtpu_torch.kernels import _build
    strict_f32()
    mode, spawn, out = argv[0], float(argv[1]), Path(argv[2])
    files = argv[3:5]
    # the seconds of each committed store (its fsyncs included), as
    # they fall in the kernel build and in the rest
    cache, stores = default_cache(), []
    store = cache.store

    def timed_store(*args, **kw):
        t0 = time.perf_counter()
        try:
            return store(*args, **kw)
        finally:
            stores.append(time.perf_counter() - t0)

    cache.store = timed_store
    t0 = time.perf_counter()
    per_src = _build.build_all()
    rec = {"mode": mode, "build_s": time.perf_counter() - t0,
           "build_src_s": per_src, "build_source": dict(_build.build_source),
           "kernel_entries": _build.kernel_entries(),
           "build_store_s": sum(stores)}
    del stores[:]
    rec["nvcc_builds"] = sum(v == "nvcc"
                             for v in rec["build_source"].values())
    if mode == "serve":
        rec.update(cache_serve(files, spawn, out))
    elif mode == "fleet":
        rec.update(cache_fleet(files, argv[5]))
    else:
        rec.update(cache_gen(files))
    rec["store_s"] = stores
    out.write_text(json.dumps(rec))


def run_cache_child(mode, root, out, *args):
    """A fresh ``python3`` on this script's child mode with
    MXTPU_CACHE_DIR=root; returns its record, or None (its error
    printed) when it failed."""
    env = dict(os.environ, MXTPU_CACHE_DIR=str(root))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), CACHE_CHILD, mode,
         repr(time.time()), str(out), *map(str, args)], env=env,
        capture_output=True, text=True, timeout=CACHE_CHILD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not Path(out).exists():
        print(f"cache child {mode} on {Path(root).name} exit "
              f"{proc.returncode}:\n{proc.stderr[-3000:]}", flush=True)
        return None
    rec = json.loads(Path(out).read_text())
    rec["wall_s"] = wall
    return rec


def cache_gate(checks, name, ok, detail):
    print(f"check cache {name}: {detail} {'ok' if ok else 'FAIL'}",
          flush=True)
    checks.rows.append({"check": f"cache {name}", "detail": detail,
                        "ok": bool(ok)})
    if not ok:
        checks.failed.append(f"cache: {name}: {detail}")


def cache_poison(root, a):
    """Poison (c)'s copy of (a)'s root as CACHE_POISON says."""
    from mxtpu_torch.cache import poison_corrupt, poison_truncate
    for kind, what, how in CACHE_POISON:
        digest = a["kernel_entries"][what] if kind == "kernel" \
            else a["bucket_keys"][str(what)]
        (poison_corrupt if how == "corrupt" else poison_truncate)(
            Path(root) / f"{digest}.mxc")


def coldstart_row(checks, tmp):
    """bench_serving_coldstart's row in this process: bench's small
    BERT exported, its full ladder warmed against an empty root (cold:
    every bucket built and its recipe stored) and by a fresh runner on
    the populated root (disk: every bucket a verified hit), and the
    first served request of a fresh runner in each mode; best ratio of
    COLD_REPEATS.  The kernels are this process's (no nvcc here)."""
    from mxtpu_torch import nd
    from mxtpu_torch import random as trandom
    from mxtpu_torch.cache import ExecutableCache
    from mxtpu_torch.models import BERTModel
    from mxtpu_torch.serving import ModelRunner
    trandom.seed(SEED)
    net = fresh_names(lambda: BERTModel(
        COLD_V, COLD_U, COLD_FFN, COLD_L, COLD_H, max_length=COLD_T,
        dropout=0.0))
    net.initialize(ctx=CARD)
    rng = np.random.RandomState(0)
    net(nd.array(rng.randint(0, COLD_V, (1, COLD_T)).astype(np.float32),
                 ctx=CARD))
    files = net.export(os.path.join(tmp, "coldbert"))
    del net
    req = [{"data": rng.randint(0, COLD_V, (COLD_T,)).astype(np.float32)}]

    def make(root):
        return ModelRunner.from_export(
            *files, input_specs={"data": (None,)}, seq_buckets=[COLD_T],
            max_batch_size=COLD_B, device=CARD,
            cache=ExecutableCache(root))

    def first_s(r):
        bucket = r.bucket_for(1, COLD_T)
        vals = r._pad_stack(req, bucket)
        t0 = time.perf_counter()
        r.run_raw(vals, bucket)[0].cpu()
        return time.perf_counter() - t0

    runs = []
    for i in range(COLD_REPEATS):
        root = os.path.join(tmp, f"cold{i}")
        cold = make(root)
        t0 = time.perf_counter()
        cold.warmup()
        cold_s = time.perf_counter() - t0
        warm = make(root)
        t0 = time.perf_counter()
        warm.warmup()
        warm_s = time.perf_counter() - t0
        hits = warm._cache.stats()["hit"]
        runs.append({"cold_warmup_s": cold_s, "warm_warmup_s": warm_s,
                     "cold_first_req_s": first_s(make(os.path.join(
                         tmp, f"coldf{i}"))),
                     "warm_first_req_s": first_s(make(root)),
                     "buckets": len(cold.buckets()), "hits": hits,
                     "ratio": cold_s / warm_s})
    ok = all(r["hits"] == r["buckets"] for r in runs)
    best = max(runs, key=lambda r: r["ratio"])
    cache_gate(checks, "serving_coldstart", ok,
               f"bench's small BERT ({COLD_L} layers, {COLD_U} units, "
               f"V {COLD_V}), ladder b<={COLD_B} x T{COLD_T}: cold "
               f"{best['cold_warmup_s']:.4f} s, disk "
               f"{best['warm_warmup_s']:.4f} s, ratio "
               f"{best['ratio']:.3f} (best of {COLD_REPEATS}: " +
               ", ".join(f"{r['ratio']:.3f}" for r in runs) +
               f"); first request {best['cold_first_req_s']:.4f} s cold, "
               f"{best['warm_first_req_s']:.4f} s disk; every disk "
               f"bucket a hit")
    return {"runs": runs, "best": best}


def cache_phase(checks, params):
    """Phase 24 (see the module's docstring): returns its numbers."""
    import shutil
    import tempfile
    import torch
    from mxtpu_torch.kernels import _build
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    (ROOT / "mxtpu_torch" / "_build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "mxtpu_torch" / "_build",
                                prefix="cache_"))
    out = {}
    try:
        files = serve_export(params, str(tmp / "bert"))
        gnet, gen_files = gen_export(str(tmp / "genbert"))
        del gnet
        gc.collect()
        torch.cuda.empty_cache()
        out["coldstart"] = coldstart_row(checks, str(tmp))
        gc.collect()
        torch.cuda.empty_cache()
        root_a, root_c = tmp / "root_a", tmp / "root_c"
        a = run_cache_child("serve", root_a, tmp / "a.json", *files)
        b = run_cache_child("serve", root_a, tmp / "b.json", *files) \
            if a else None
        c = None
        if a:
            shutil.copytree(root_a, root_c,
                            ignore=shutil.ignore_patterns("quarantine"))
            cache_poison(root_c, a)
            c = run_cache_child("serve", root_c, tmp / "c.json", *files)
        d = run_cache_child("fleet", root_a, tmp / "d.json", *files,
                            tmp / "a.npz") if a else None
        e = run_cache_child("gen", root_a, tmp / "e.json", *gen_files)
        quarantined = sorted(q.name.split(".")[2] for q in
                             (root_c / "quarantine").glob("*")) \
            if c else []
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out.update(a=a, b=b, c=c, d=d, e=e)
    for tag, rec in (("a", a), ("b", b), ("c", c), ("d", d), ("e", e)):
        cache_gate(checks, f"({tag}) child", rec is not None,
                   f"process {tag} ran to its end")
    n_src = len(_build.SOURCES)
    if a:
        cache_gate(checks, "(a) cold", a["nvcc_builds"] == n_src and
                   set(a["sources"].values()) == {"cold"} and
                   a["record"] == a["counts"] == CACHE_LAUNCHES,
                   f"nvcc {a['nvcc_builds']} of {n_src} sources in "
                   f"{a['build_s']:.2f} s (" + ", ".join(
                       f"{k} {v:.2f}" for k, v in a["build_src_s"].items())
                   + f"); ladder {a['ladder_s']:.3f} s (" + ", ".join(
                       f"{k} {v:.3f}" for k, v in a["bucket_s"].items()) +
                   f"), all cold, their recipes' stores "
                   f"{sum(a['store_s']):.3f} s (the libraries' "
                   f"{a['build_store_s']:.3f} s); first request "
                   f"{a['first_request_s']:.2f} s after the spawn (load "
                   f"{a['load_s']:.2f} s); a forward's record "
                   f"{a['record']}, counts {a['counts']}")
    if a and b:
        cache_gate(checks, "(b) disk-warmed", b["nvcc_builds"] == 0 and
                   set(b["build_source"].values()) == {"disk"} and
                   set(b["sources"].values()) == {"disk"} and
                   b["cold_compiles"] == 0 and b["record"] == a["record"]
                   and b["counts"] == a["counts"] and
                   b["rows"] == a["rows"] and b["batch"] == a["batch"],
                   f"nvcc {b['nvcc_builds']}, kernels from disk in "
                   f"{b['build_s']:.3f} s; ladder {b['ladder_s']:.3f} s ("
                   + ", ".join(f"{k} {v:.3f}" for k, v in
                               b["bucket_s"].items()) +
                   f"), sources {sorted(set(b['sources'].values()))}, "
                   f"{b['cold_compiles']} cold; first request "
                   f"{b['first_request_s']:.2f} s after the spawn; record "
                   f"{b['record']}; {CACHE_ROWS} rows and the b{FLEET_B} "
                   f"batch {'bit-equal' if b['rows'] == a['rows'] and b['batch'] == a['batch'] else 'DIFFERENT'} to (a)'s")
        out["ratio"] = {"build": a["build_s"] / b["build_s"],
                        "ladder": a["ladder_s"] / b["ladder_s"],
                        "first_request": a["first_request_s"] /
                        b["first_request_s"]}
        print(f"serving_coldstart (processes, BERT-Large f32, ladder b<="
              f"{FLEET_B} x T{FLEET_T}): cold build {a['build_s']:.2f} s "
              f"+ ladder {a['ladder_s']:.3f} s, first request "
              f"{a['first_request_s']:.2f} s; disk build "
              f"{b['build_s']:.3f} s + ladder {b['ladder_s']:.3f} s, "
              f"first request {b['first_request_s']:.2f} s; ratios "
              f"build {out['ratio']['build']:.1f}, ladder "
              f"{out['ratio']['ladder']:.3f}, first request "
              f"{out['ratio']['first_request']:.2f}", flush=True)
    if a and c:
        want_src = {str(w): "cold" for k, w, _ in CACHE_POISON
                    if k == "bucket"}
        kern = {w for k, w, _ in CACHE_POISON if k == "kernel"}
        ok = (quarantined == ["checksum", "checksum", "truncated"] and
              {k for k, v in c["build_source"].items() if v == "nvcc"}
              == kern and c["nvcc_builds"] == len(kern) and
              all(c["sources"][k] == want_src.get(k, "disk")
                  for k in c["sources"]) and
              c["cold_compiles"] == len(want_src) and
              c["stats"]["quarantined"] == len(CACHE_POISON) and
              c["rows"] == a["rows"] and c["batch"] == a["batch"])
        cache_gate(checks, "(c) poisoned", ok,
                   f"quarantined {quarantined}; nvcc rebuilt "
                   f"{sorted(k for k, v in c['build_source'].items() if v == 'nvcc')}"
                   f"; buckets {c['sources']}; {c['cold_compiles']} cold; "
                   f"rows {'bit-equal' if c['rows'] == a['rows'] else 'DIFFERENT'}"
                   f" to (a)'s")
    if d:
        cache_gate(checks, "(d) fleet", d["w0"] == "disk_cache" and
                   d["scale_up"] == "disk_cache" and d["wR"] ==
                   "disk_cache" and d["cold"] == [0, 0] and
                   d["sources"] == ["disk"] and
                   d["record"] == CACHE_LAUNCHES and
                   d["served"] == CACHE_ROWS and d["tol_ratio"] <= 1.0,
                   f"w0 {d['w0']}, the autoscaler's floor repair "
                   f"{d['scale_up']} in {d['scale_up_s']:.2f} s, wR "
                   f"{d['wR']} in {d['wR_warm_s']:.2f} s; cold builds "
                   f"{d['cold']}; record {d['record']}; {d['served']} "
                   f"rows at {d['tol_ratio']:.4f} of the canary's "
                   f"tolerance of (a)'s")
    if e:
        on, cp = e["donate"], e["copy"]
        ok = (on["streams"] == cp["streams"] and on["rows"] == cp["rows"]
              and cp["intact"] and on["records"] == cp["records"] and
              on["counts"] == cp["counts"] == GEN_LAUNCHES)
        ms_on, ms_cp = (float(np.median(e["decode_ms"][t]))
                        for t in ("donate", "copy"))
        cache_gate(checks, "(e) donate=False", ok,
                   f"{GEN_LANES} greedy streams of {CACHE_GEN_STEPS + 1} "
                   f"tokens {'equal' if on['streams'] == cp['streams'] else 'DIFFERENT'}"
                   f", logits {'bit-equal' if on['rows'] == cp['rows'] else 'DIFFERENT'}"
                   f", caller's tables {'unchanged' if cp['intact'] else 'WRITTEN'}"
                   f"; a decode {cp['counts']} (donating {on['counts']}); "
                   f"decode step {ms_on:.3f} ms donating, {ms_cp:.3f} ms "
                   f"not (windows {e['decode_ms']}); copies of the "
                   f"{e['table_gb']:.3f} GB table {e['copy_in_ms']:.4f} "
                   f"in + {e['copy_out_ms']:.4f} out ms (bound "
                   f"{e['copy_bound_ms']:.4f})")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"cache: phase {out['phase_s']:.1f} s (children " + ", ".join(
        f"{t} {r['wall_s']:.1f}" for t, r in (("a", a), ("b", b),
                                              ("c", c), ("d", d),
                                              ("e", e)) if r) + ")",
          flush=True)
    return out


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA "
             "GPU")
    if not (ROOT / "mxtpu_torch" / "csrc").is_dir():
        fail(f"no mxtpu_torch package beside {Path(__file__).name}: run "
             f"it from the root of a checkout")
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == [CACHE_CHILD]:
        cache_child(sys.argv[2:])
        return
    from mxtpu_torch.context import strict_f32
    from mxtpu_torch.kernels import _build
    strict_f32()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    try:
        INT_PEAK["clock_hz"] = float(clk.stdout.split()[0]) * 1e6
    except (IndexError, ValueError):
        fail(f"nvidia-smi clocks.max.sm: {clk.stdout!r} {clk.stderr!r}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    INT_PEAK["sms"] = sms
    print(f"integer pipes: {sms} SMs x {INT_PIPE_LANES} ALU + "
          f"{INT_PIPE_LANES} FMA lanes, {ISSUE_LANES} issued a clock, x "
          f"{INT_PEAK['clock_hz'] / 1e6:.0f} MHz (clocks.max.sm)",
          flush=True)

    t0 = time.perf_counter()
    per_src = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{len(per_src)} sources in parallel "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in per_src.items())})",
          flush=True)

    checks = Checks()
    sass_phase(checks)
    mask_probe_phase(checks)
    gen = torch.Generator(device=CARD).manual_seed(SEED)
    timings = kernel_phase(checks, gen)
    timings.update(backward_phase(checks, gen))
    layer_norm_edge_phase(checks)
    fused_ln_edge_phase(checks)
    timings.update(bn_phase(checks, gen))
    timings.update(conv_phase(checks, gen))
    for (name, dt), r in timings.items():
        lib = "null" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f}"
        extra = f" ad_plain_ms={r['ad_plain_ms']:.4f} (AD through the " \
            f"plain attention)" if "ad_plain_ms" in r else ""
        if "bound_split_ms" in r:
            extra += f" bound_fma_ms={r['bound_fma_ms']:.4f} " \
                f"bound_split_ms={r['bound_split_ms']:.4f}"
        if "bound_bytes_ms" in r:
            extra += f" bound_bytes_ms={r['bound_bytes_ms']:.4f} " \
                f"bound_int_ms={r['bound_int_ms']:.4f} (keep=0.9); " \
                f"kernel_ms_keep1={r['ms_keep1']:.4f}"
        if "ms_keep09" in r:
            extra += f" kernel_ms_keep0.9={r['ms_keep09']:.4f} " \
                f"bound_keep0.9_ms={r['bound_keep09_ms']:.4f} " \
                f"({r['bound_keep09_by']}; integer " \
                f"{r['bound_int_ms']:.4f})"
        print(f"time {name} [{dt}] (device ms per call): "
              f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={lib} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}){extra}; kernel wall_ms="
              f"{r['wall_ms']:.4f} (events, host launch included)",
              flush=True)
    refusal_phase(checks)
    tool_counts, tool_tables = tools_phase(checks)

    f32_train_counts = train_check_phase(checks)
    train_counts, training = train_phase(checks)
    f32_counts, training_f32 = train_phase(checks, None)
    resnet_check_phase(checks)
    rn_counts, resnet = {}, {}
    for layout in ("NCHW", "NHWC"):
        rn_counts[layout], resnet[layout] = resnet_train_phase(checks,
                                                               layout)
    bulk_counts, bulked = bulked_train_phase(checks, card)
    gluon_counts, gluon = gluon_train_phase(checks, card)
    amp_counts, amp_training = amp_train_phase(checks, gen, training,
                                               training_f32, resnet)
    rtc_timings, rtc_info = rtc_phase(checks)
    symbolic_check_phase(checks)
    sym_counts, sym_rtc, symbolic = symbolic_train_phase(checks)

    t0 = time.perf_counter()
    params = mxtpu_params(SEED)
    print(f"weights: {len(params)} arrays from numpy seed {SEED} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    serve_counts, serving = serve_phase(checks, params)
    scales, qs_counts, quant_serving = quant_serve_phase(checks, params,
                                                         gen)
    gen_counts, gen_rows, generation = generate_phase(checks, gen, scales)
    mt_counts, mt_rows, transformer = transformer_phase(checks, gen)
    pipe_counts, zoo_counts, zoo_rows, pipeline = pipeline_phase(checks,
                                                                 gen)
    fleet_counts_run, fleet_one, fleet = fleet_phase(checks, params)
    det_counts, det_nms, det_rows, detection = detection_phase(checks, gen)
    cache = cache_phase(checks, params)
    del params
    counts = {k: train_counts[k] + f32_counts[k] + serve_counts[k] +
              sym_counts[k] + sum(c[k] for c in rn_counts.values()) +
              sum(c[k] for c in gluon_counts.values()) +
              sum(c[k] for c in amp_counts.values()) +
              sum(c[k] for c in qs_counts.values())
              for k in train_counts}

    # BERT's flash forward, dq and dk/dv in both types, every one on the
    # tensor cores (f32 as six bf16 products): bf16 with the BERT-Large
    # bf16 training run's launches, the f32 forward with the serving
    # run's, the f32 dq and dk/dv with the BERT-Large f32 training run's;
    # the backward LayerNorms in bf16, the forward LayerNorms at the
    # serving type (f32); the BatchNorm rows at the BN_LINE_SHAPE,
    # launches over every run
    fa_src, fab_src = ("mxtpu_torch/csrc/flash_attention.cu",
                       "mxtpu_torch/csrc/flash_attention_bwd.cu")
    meta = [
        ("flash_attention_fwd", fa_src,
         "mxtpu/kernels/flash_attention.py:192", "bfloat16",
         train_counts["flash_attention_fwd"]),
        ("flash_attention_fwd", fa_src,
         "mxtpu/kernels/flash_attention.py:192", "float32",
         serve_counts["flash_attention_fwd"]),
        ("flash_attention_bwd_dq", fab_src,
         "mxtpu/kernels/flash_attention.py:347", "bfloat16",
         train_counts["flash_attention_bwd_dq"]),
        ("flash_attention_bwd_dq", fab_src,
         "mxtpu/kernels/flash_attention.py:347", "float32",
         f32_counts["flash_attention_bwd_dq"]),
        ("flash_attention_bwd_dkv", fab_src,
         "mxtpu/kernels/flash_attention.py:368", "bfloat16",
         train_counts["flash_attention_bwd_dkv"]),
        ("flash_attention_bwd_dkv", fab_src,
         "mxtpu/kernels/flash_attention.py:368", "float32",
         f32_counts["flash_attention_bwd_dkv"]),
        ("layer_norm_fwd", "mxtpu_torch/csrc/layer_norm.cu",
         "mxtpu/kernels/layer_norm.py:104", "float32",
         counts["layer_norm_fwd"]),
        ("layer_norm_bwd", "mxtpu_torch/csrc/layer_norm_bwd.cu",
         "mxtpu/kernels/layer_norm.py:137", "bfloat16",
         counts["layer_norm_bwd"]),
        ("fused_residual_ln_fwd", "mxtpu_torch/csrc/fused_residual_ln.cu",
         "mxtpu/kernels/layer_norm.py:355", "float32",
         counts["fused_residual_ln_fwd"]),
        ("fused_residual_ln_bwd",
         "mxtpu_torch/csrc/fused_residual_ln_bwd.cu",
         "mxtpu/kernels/layer_norm.py:384", "bfloat16",
         counts["fused_residual_ln_bwd"]),
        ("batch_norm_fwd", "mxtpu_torch/csrc/batch_norm.cu",
         "mxtpu/kernels/batch_norm.py:319", "bfloat16",
         counts["batch_norm_fwd"]),
        ("batch_norm_bwd", "mxtpu_torch/csrc/batch_norm_bwd.cu",
         "mxtpu/kernels/batch_norm.py:345", "bfloat16",
         counts["batch_norm_bwd"]),
        ("batch_norm_fwd_cm", "mxtpu_torch/csrc/batch_norm.cu",
         "mxtpu/kernels/batch_norm.py:393", "bfloat16",
         counts["batch_norm_fwd_cm"]),
        ("batch_norm_bwd_cm", "mxtpu_torch/csrc/batch_norm_bwd.cu",
         "mxtpu/kernels/batch_norm.py:419", "bfloat16",
         counts["batch_norm_bwd_cm"]),
    ]
    for name, _, _, dt, launches in meta:
        if launches == 0:
            checks.failed.append(f"kernel {name} [{dt}] never launched on "
                                 f"a main path")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "dtype": dt, "launches": launches,
         **{k: timings[(name, dt)][k]
            for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                      "bound_by", "library_ms")}}
        for name, src, rep, dt, launches in meta]}
    # the user kernels of the rtc head, at the head's shape; launches
    # from the rtc-head epoch
    for name, key in (("rtc_softmax_fwd", "softmax_fwd"),
                      ("rtc_softmax_bwd", "softmax_bwd")):
        if sym_rtc.get(key, 0) == 0:
            checks.failed.append(f"kernel {name} never launched on a main "
                                 f"path")
        r = rtc_timings[(name, "head")]
        line["kernels"].append({
            "name": name, "route": "cuda",
            "source": "chip_smoke.py (RTC_SOURCE) via mxtpu_torch/rtc.py",
            "replaces": "mxtpu/rtc.py:45", "dtype": "float32",
            "launches": sym_rtc.get(key, 0),
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}})

    # kernel #13 at the probe's first shape, bf16 (the probe's type);
    # launches from the conv probe's run
    probe_key = "probe_conv_strategies"
    conv_launches = tool_counts.get(probe_key, {}).get("conv_nhwc", 0)
    if conv_launches == 0:
        checks.failed.append("kernel conv_nhwc never launched on a main "
                             "path")
    line["kernels"].append({
        "name": "conv_nhwc", "route": "cuda",
        "source": "mxtpu_torch/csrc/conv_nhwc.cu",
        "replaces": "tools/probe_conv_strategies.py:59",
        "dtype": "bfloat16", "launches": conv_launches,
        **{k: timings[("conv_nhwc", "bfloat16")][k]
           for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                     "bound_by", "library_ms")}})

    # the generation path's #4 and #6 at the decode step's shape, with
    # the launches of the generation server's run
    for name, src, rep in (
            ("layer_norm_fwd", "mxtpu_torch/csrc/layer_norm.cu",
             "mxtpu/kernels/layer_norm.py:104"),
            ("fused_residual_ln_fwd",
             "mxtpu_torch/csrc/fused_residual_ln.cu",
             "mxtpu/kernels/layer_norm.py:355")):
        if gen_counts[name] == 0:
            checks.failed.append(f"kernel {name} never launched on the "
                                 f"generation path")
        line["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "dtype": "float32", "path": "generate",
            "launches": gen_counts[name],
            **{k: gen_rows[name][k]
               for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms")}})

    # the transformer path's #1-#7 at its training shapes (bf16), with
    # the launches of the bf16 row's eager steps
    for name, src, rep in (
            ("flash_attention_fwd", fa_src,
             "mxtpu/kernels/flash_attention.py:192"),
            ("flash_attention_bwd_dq", fab_src,
             "mxtpu/kernels/flash_attention.py:347"),
            ("flash_attention_bwd_dkv", fab_src,
             "mxtpu/kernels/flash_attention.py:368"),
            ("layer_norm_fwd", "mxtpu_torch/csrc/layer_norm.cu",
             "mxtpu/kernels/layer_norm.py:104"),
            ("layer_norm_bwd", "mxtpu_torch/csrc/layer_norm_bwd.cu",
             "mxtpu/kernels/layer_norm.py:137"),
            ("fused_residual_ln_fwd",
             "mxtpu_torch/csrc/fused_residual_ln.cu",
             "mxtpu/kernels/layer_norm.py:355"),
            ("fused_residual_ln_bwd",
             "mxtpu_torch/csrc/fused_residual_ln_bwd.cu",
             "mxtpu/kernels/layer_norm.py:384")):
        if mt_counts[name] == 0:
            checks.failed.append(f"kernel {name} never launched on the "
                                 f"transformer path")
        line["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "dtype": "bfloat16", "path": "transformer",
            "launches": mt_counts[name],
            **{k: mt_rows[name][k]
               for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms")}})

    # phase 21's #8-#11: the pipeline's (ResNet-50 NCHW at b256, the
    # BN_LINE_SHAPE rows' shape) with the fed windows' launches, and the
    # zoo's at ZOO_ROWS with the zoo steps' launches
    bn_src = {"fwd": "mxtpu_torch/csrc/batch_norm.cu",
              "bwd": "mxtpu_torch/csrc/batch_norm_bwd.cu"}
    bn_rep = {"batch_norm_fwd": "mxtpu/kernels/batch_norm.py:319",
              "batch_norm_bwd": "mxtpu/kernels/batch_norm.py:345",
              "batch_norm_fwd_cm": "mxtpu/kernels/batch_norm.py:393",
              "batch_norm_bwd_cm": "mxtpu/kernels/batch_norm.py:419"}
    for path, names, launches, rows in (
            ("pipeline", ("batch_norm_fwd", "batch_norm_bwd"), pipe_counts,
             {n: timings[(n, "bfloat16")] for n in ("batch_norm_fwd",
                                                    "batch_norm_bwd")}),
            ("zoo", tuple(bn_rep), zoo_counts, zoo_rows)):
        for name in names:
            if launches.get(name, 0) == 0:
                checks.failed.append(f"kernel {name} never launched on the "
                                     f"{path} path")
            line["kernels"].append({
                "name": name, "route": "cuda",
                "source": bn_src[name.split("_")[2]],
                "replaces": bn_rep[name], "dtype": "bfloat16",
                "path": path, "launches": launches.get(name, 0),
                **{k: rows[name][k]
                   for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms")}})

    # the fleet path's #1, #4 and #6 (f32, replayed from the fleet
    # runners' captured graphs) with the launches of phase 22's recovery
    # run, timed at the serving shapes
    for name, src, rep in (
            ("flash_attention_fwd", fa_src,
             "mxtpu/kernels/flash_attention.py:192"),
            ("layer_norm_fwd", "mxtpu_torch/csrc/layer_norm.cu",
             "mxtpu/kernels/layer_norm.py:104"),
            ("fused_residual_ln_fwd",
             "mxtpu_torch/csrc/fused_residual_ln.cu",
             "mxtpu/kernels/layer_norm.py:355")):
        if fleet_counts_run.get(name, 0) == 0:
            checks.failed.append(f"kernel {name} never launched on the "
                                 f"fleet path")
        line["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "dtype": "float32", "path": "fleet",
            "launches": fleet_counts_run.get(name, 0),
            **{k: timings[(name, "float32")][k]
               for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms")}})

    # phase 23: #8/#9 at SSD-300's largest BatchNorm shape (8 x 32 x
    # 300², bf16) with the SSD eager windows' launches, and the NMS
    # kernel (no TPU kernel: mxtpu's sweep is a lax.fori_loop) at SSD's
    # detection shape with the main path's launches of (d)-(f)
    for name in ("batch_norm_fwd", "batch_norm_bwd"):
        if det_counts.get(name, 0) == 0:
            checks.failed.append(f"kernel {name} never launched on the "
                                 f"detection path")
        line["kernels"].append({
            "name": name, "route": "cuda",
            "source": bn_src[name.split("_")[2]],
            "replaces": bn_rep[name], "dtype": "bfloat16",
            "path": "detection", "launches": det_counts[name],
            **{k: det_rows[name][k]
               for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms")}})
    if det_nms["runs"] == 0:
        checks.failed.append("kernel nms never launched on the detection "
                             "path")
    line["kernels"].append({
        "name": "nms", "route": "cuda", "source": "mxtpu_torch/csrc/nms.cu",
        "replaces": "mxtpu/ndarray/detection_impl.py:500 (_greedy_nms_keep, "
                    "a lax.fori_loop: no TPU kernel)",
        "dtype": "float32", "path": "detection",
        "launches": det_nms["runs"],
        **{k: det_rows["nms"][k]
           for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                     "bound_by", "library_ms")}})

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": per_src,
              "build_log": dict(_build.build_log), "checks": checks.rows,
              "timings": {f"{n}[{d}]": r for (n, d), r in timings.items()},
              "launches": {"training": train_counts,
                           "training f32": f32_counts,
                           "training f32 check": f32_train_counts,
                           "serving": serve_counts,
                           "generate serving": gen_counts,
                           "transformer bf16": mt_counts,
                           "pipeline resnet50 fed": pipe_counts,
                           "zoo steps": zoo_counts,
                           **{f"resnet50 {k}": c
                              for k, c in rn_counts.items()},
                           "bulked BERT-Large bf16": bulk_counts["bert"],
                           "bulked resnet50 NHWC": bulk_counts["resnet"],
                           **gluon_counts,
                           "amp BERT-Large": amp_counts["bert"],
                           "amp resnet50 NHWC": amp_counts["resnet"],
                           "serving amp (one forward)": qs_counts["amp"],
                           "serving int8 (one forward)": qs_counts["int8"],
                           "serving fleet": fleet_counts_run,
                           "serving fleet (one forward)": fleet_one,
                           "ssd_300 bf16 eager": det_counts,
                           "detection nms": det_nms,
                           "resnet20 fit": sym_counts,
                           "resnet20 rtc head": sym_rtc,
                           **{f"tool {k}": c
                              for k, c in tool_counts.items()}},
              "tools": tool_tables,
              "training": training, "training_f32": training_f32,
              "amp_training": amp_training,
              "quant_serving": quant_serving,
              "resnet50": resnet, "bulked": bulked, "gluon": gluon,
              "serving": serving, "generation": generation,
              "transformer": transformer, "pipeline": pipeline,
              "fleet": fleet, "detection": detection, "cache": cache,
              "symbolic": symbolic,
              "rtc": {**rtc_info, "timings": {
                  f"{n} {t}": r for (n, t), r in rtc_timings.items()}},
              "kernels": line,
              "failed": checks.failed}
    out_dir = ROOT / "mxtpu_torch" / "_build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(
        json.dumps(report, indent=1))

    if checks.failed:
        for f in checks.failed:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""Smoke run of automl_tpu_torch on one NVIDIA GPU (the H100 port's quickest proof).

  python3 chip_smoke.py              # from the root of the repository
  python3 chip_smoke.py --profile    # only: profiles of a training step
                                     # (unfused and fused loss; dots_flash
                                     # with the split and the fused
                                     # backward), of a decode step, of
                                     # an EfficientDet-D0 training step (K6
                                     # knob on and off), of D0 b32
                                     # inference (pre_nms_topk 2048, 5000)
                                     # and of a V2-S training step at 296
                                     # (knob on; RandAugment's share)

Phases, each of which fails the run (non-zero exit) if it fails:
  0. the card's name and power limit (nvidia-smi); no CUDA device -> exit 1;
     the host's toolchain for the host library (g++, jpeglib.h, the JPEG
     libraries ldconfig sees), whether PIL, matplotlib, cv2 and yaml import
     (with their versions) and its CPU count, on "host:" lines;
  1. build: compiles the CUDA kernels from automl_tpu_torch/csrc/ with nvcc
     for sm_90a, one nvcc per source (eight), all at once; prints each
     kernel's registers and spills, and the HGMMA and LDL/STL counts of the
     Hopper kernels' SASS;
  2. K4 (decode attention) against its plain PyTorch version on the card, at
     the serving slice's shapes (decode T=1 and prefill T=512, b8, 8 heads,
     hd 128, S 1024, bf16, cap 50: the Hopper kernels of
     decode_attention_sm90.cu, split-S and wgmma; two calls must be
     bit-equal) and on small cases (GQA 8/2 with T 1-8 across both
     designs, prefix-LM and window masks that leave dead, mixed and
     all-live tiles, head-major rows with (m, l) stats and a fully-masked
     row in both designs, whole splits masked at decode; the SIMT kernel of
     decode_attention.cu on f32, hd 256 and a fully-masked row); the Hopper
     and the SIMT kernel timed in turns with CUDA events at the slice's
     shapes, beside the plain version and the library yardstick; M7's
     shapes (case 7): the speculative verify (b1, T 5, S 768) and a chunk
     prefill (b1, T 256 at offset 256, S 1024) checked and timed likewise,
     per-row masks with a parked row in both designs, the draft's verify,
     causal T DRAFT_PROMPT prefill and T 1 steps at hd 32, and 64 beam rows
     checked;
     the MoE model's generation in phase 5b (case 8): b8, S 576, the causal
     T 512 prefill and T 1 steps with keys 0-512 and 0-575, checked;
  3. K1 / K2 / K5a / K5b (flash-attention forward, fused backward and the
     split backward's dq and dk/dv kernels) against their plain versions at
     the training slice's shapes (b8, T 2048, 8 heads, hd 128, bf16,
     causal, cap 50, sm_scale 1; K2, K5a and K5b called twice must be
     bit-equal) and on small cases (GQA 8/2 through flash_attention with
     either backward, window 16 + cap, packed segment ids, ragged T 77 and
     200 in f32, documents of length 1; bf16 hd 32 / 64 / 128 with ragged
     T, window, segments, no cap, non-causal, documents of length 1); bf16
     K1 / K2 / K5a / K5b are the Hopper kernels (flash_attention_sm90.cu),
     f32 ones the scalar-FMA kernels (flash_attention.cu), whose bf16
     instances are also checked and timed at the slice's shapes, in the
     same call; timed as in 2; and at the default LM's 16 heads (case 9:
     b8, T 2048, hd 128, bf16, causal, cap 50) and the trained draft's
     shapes (case 10: b8, T 2048, 8 heads, hd 32), checked;
  4. K3a / K3b / K3c (fused softmax xent forward, dx, dW) against their
     plain versions at the fused-loss slice's shapes (M 16,384 = b8 x T2048
     tokens, D 1,024, V 100,864, bf16 operands, cap 30, about 20% zero loss
     weights; bf16 K3a, K3b and K3c are the Hopper kernels of
     xent_sm90.cu, called twice they must be bit-equal; the kernels of
     xent.cu, reached with _simt, are checked and timed beside them in the
     same call) and on small cases (the default LM's M 16,384, V 32,000,
     D 2,048 through all three, timed beside xent.cu's K3a and the chain's
     forward and backward; ragged M and V at D 256, 512 and 2,048; cap 0; f32 operands
     and bf16 D 72, which take xent.cu's kernels; untied w through
     fused_softmax_xent's autograd against the CPU; the trained draft's M
     16,384, V 100,864, D 256); timed as in 2;
  5. training slices: step 1 of lm-flops1e19 with use_flash_attention (K1/K2)
     against the same step on the dense attention path, with the fused loss
     "pallas" (K3) against the unfused loss at unembed_matmul_dtype
     "bfloat16_vjp" (the same operand precision), with the chunked loss
     "scan" against the unfused f32 loss, with the split backward (K5a/K5b)
     against the fused one, and with the split backward under the remat
     policies dots and dots_flash against full remat (loss, global grad
     norm, per-leaf cosine, bit-equal leaves); then cli/main_lm trains it
     at b8 T2048 (Lion, cosine schedule, grad clip, weight decay) three
     times: unfused (PHASE5_SHORT_STEPS steps) and with
     fused_softmax_loss=pallas (30), both under full remat with K2, and
     with flash_bwd_fused=false, remat_policy=dots_flash (the JAX
     flagship's policy; PHASE5_SHORT_STEPS). The loss must be finite and
     fall; the full-remat runs must launch K1 exactly 2 * n_layers * steps
     times and K2 n_layers * steps times, every launch the Hopper kernel's
     (a counter per implementation), the fused run K3a, K3b and K3c 30
     times each, the dots_flash run K1, K5a and K5b n_layers * steps times
     each (every launch the Hopper kernel's) and K2 never (the fused run's
     K3a, K3b and K3c launches all the Hopper kernels'); a rerun of the
     unfused run to one step more must resume from the checkpoint of its
     last step;
  5b. the rest of LM training (M6; lm_training_m6_phase), each run through
     cli/main_lm with its launches counted and every one the Hopper
     kernels': (A) the default LM (lm_defaults: D 2,048, 24 layers, V
     32,000, flash attention, Lion) at b8 T2048: step 1 fused "pallas"
     against unfused "bfloat16_vjp" and "scan" against f32 (phase 5's
     limits), M6_DEFAULT_STEPS steps with the fused loss at M6_LOW_LR
     (the loss must fall; at its config's Lion lr 1e-3 it does not), then the largest batch of 8 x 2^n that fits (out of memory
     caught) for M6_PROBE_STEPS steps; (B) MoE at
     lm-flops1e19's width (8 experts, top-2, capacity 1.25, groups of
     4096, aux 0.01, the fused loss): step 1 with E = 1 against the dense
     FFN and with groups of 4096 against 2048 at a capacity where nothing
     drops, M6_MOE_STEPS steps (aux and dropped slots at the first and
     last), greedy
     generation of 64 tokens after 512 at b8 through K4 (S 576)
     teacher-forced against the model's own forward (checked at capacity
     M6_GEN_CF, reported at 1.25), the int8 model's router f32; (C) the
     chunked local attention (chunks of 512): step 1 against the dense
     path given the same two-chunk mask, 10 steps; (D) a prefix-LM from
     TSV files with a SentencePiece model written here: its ids of
     M6_TEXT equal the JAX package's (constants), step 1 with all-zero
     prefix markers against the plain causal run, 10 steps and a
     validation; (E) the JAX flagship's LM composition (D 1,024, 12
     layers, V 32,000, dots_flash, K2) for 30 steps. Each run prints step
     ms, tokens/s, FLOP shares and peak memory;
  6. K6 (the depthwise filter gradient) against its plain version at every
     map of a D0 step (the 13 shapes of its 76 stride-1 depthwise convs,
     bf16, b16: the Hopper kernel of depthwise_sm90.cu, two calls
     bit-equal; the kernel of depthwise.cu, reached with _simt, checked
     and timed beside it), with the launch-weighted sums over a step, and
     on small cases (f32 and C not a multiple of 8, which take
     depthwise.cu: ragged 15 x 17, k5 and k7, batch 1, BiFPN level 7's
     4 x 4, k1; bf16 k7 and k1, a ragged map and a ragged channel chunk on
     the Hopper kernel); timed as in 2, in turns;
  7. detection slice: step 1 of EfficientDet-D0 (512 x 512, b16,
     mixed_precision: bf16 compute) with the K6 knob on against the same
     step with it off, from one set of seeded weights and one batch (the
     loss equal, the depthwise kernel grads and the other grads within
     stated limits); then cli/main_det trains D0 for 20 steps with the knob
     on and 20 with it off (--use_fake_data, batch_size=16): the loss must
     be finite and fall, the knob-on run must launch K6 exactly (K6 calls
     per step, derived from the model) x 20 times, every launch the Hopper
     kernel's, and the knob-off run 0 times, and a rerun of the knob-on run
     to 21 steps must resume from the checkpoint at step 20;
  8. detection inference and eval: D0 (512 x 512, b32, mixed_bfloat16,
     seeded weights, class-predict bias 0 and kernel x300) forward on the
     card, then postprocess_combined (hard NMS) and postprocess_global
     (gaussian) at pre_nms_topk 5000 and 2048 on the card, under sync
     debug mode "error" (a host sync inside raises), and on the CPU from
     the same raw outputs: hard, the same valid_len and classes, boxes and
     scores within INFER_BOX_TOL / INFER_SCORE_TOL in every slot;
     gaussian, the same in the confident slots (score > INFER_CONFIDENT)
     up to the first near tie;
     cli/bench_det's main (D0 b32 forward + postprocess, CUDA events) at
     pre_nms_topk 2048, its JSON line printed;
     entry() on the card (zeros [1, 512, 512, 3]); evaluate_detection on
     D0 b16 with the EMA params of the 20-step knob-off run, 2 synthetic
     batches, in COCO mode (every metric finite or -1; its vis_dir gets
     eval_image_0/1.png of 512 x 1024) and testdev_dir mode (the JSON rows
     with their four keys); the closed loop of tests/test_closed_loop.py
     through the port (efficientdet-test, 400 steps on one box-coded batch,
     then hard-NMS eval): AP50 > 0.5;
  8b. detection serving (inference/driver.py) with the 20-step knob-off
     run's checkpoint (ServingDriver.load): D0's float32 serve of 2
     480 x 640 images (resized on the card) against the same serve on the
     CPU (_detections_agree: the slots up to the first near tie, within
     INFER_BOX_TOL / INFER_SCORE_TOL); ServingDriver.benchmark at b1 and b8
     under mixed_bfloat16 (img/s, ms a call); the b1 export (torch.export,
     serving.pt2; made by a process of its own while phase 8 runs) loaded
     back: its detections bit-equal to the eager
     serve's, and both timed in turns (ms a call); InferenceDriver.inference
     on a JPEG, the annotated image written (and as a PNG); infer_cls
     --runmode=export of EfficientNetV2-B0 b8 loaded back: its logits
     bit-equal to the eager predict's;
  9. classification: (g) K6 at every map of V2-S's stride-1 depthwise
     convs at 168 and 296 (bf16, b8 and b V2S_BATCH) against its plain
     version, timed in turns with depthwise.cu's and cuDNN's (in phase 6's
     call); (a) cli/infer_cls bm on EfficientNetV2-B0 224 b8 and V2-S 384
     b32, and the card's f32 logits against the CPU's (B0 b8, V2-S b4; atol
     CLS_LOGIT_ATOL, top-5 equal; the bf16 top-1 agreement printed); (b)
     cli/main_cls trains V2-S (b V2S_BATCH, bf16, RMSProp, EMA, RandAugment)
     over its 4 progressive stages (168 / 208 / 256 / 296, V2S_STAGE_STEPS
     steps each) with the K6 knob on, then off, in one child process: the
     loss
     finite and falling within each stage after the first, 28 K6 launches
     a step, all the Hopper kernel's, with the knob and none without, per
     stage step
     ms, img/s and peak memory, and the two runs' losses within
     CLS_KNOB_RTOL of each other; (c) V2-S step 1 (b8, 168) knob on
     against off (DET_STEP1_LIMITS), and two f32 steps on the card against
     the CPU (the losses within CLS_LOSS_RTOL; step 1's params, BN
     statistics and EMA within CLS_UPDATE_ATOL / CLS_STATE_SHARE of the
     step's change); (d) 10 steps with mixup and cutmix 0.2; (e)
     cls_train_preprocess on the card against the CPU from the same draws
     (PRE_ATOL, PRE_WARP_SHARE); (f) evaluate_classification at 384 with
     the EMA of the run's last checkpoint;
  10. serving slice: lm-flops1e19 (seeded random weights in the JAX layout
     through the converter, cast for serving) generates 256 tokens greedily
     after a 512-token prompt at batch 8, through generate_lm.load_model and
     greedy_generate. The run must launch K4 exactly n_layers * 256 times,
     every launch the Hopper kernels' (a counter per implementation); its
     prefill logits are held against the plain-attention path;
  11. real input files (run after 9, before 10): the host library
     csrc/host/tfrecord_jpeg.cc built with this machine's codec (nvJPEG
     where there is no libjpeg); fixtures encoded here (DATA_DET_IMAGES
     COCO-like JPEGs, 640 x 480 / 480 x 640 / 640 x 427 with 1-8 boxes,
     through cli/create_coco_tfrecord into 8 shards; DATA_CLS_IMAGES
     ImageNet-like 500 x 375 in 8 shards; decode(encode(x)) above
     DATA_PSNR_DB; the boxes as read equal the written ones x scale in
     float32); each reader's img/s alone
     (the TF-free detection reader at canvas 512 b16 and the native one at
     4 workers and at the CPU count; the ImageNet ones at V2-S's canvas
     b256 likewise); one batch through DevicePrefetcher equal to its
     source; D0 b16 trained 10 steps through cli/main_det from files with
     each reader, step ms beside phase 7's synthetic-fed knob-off run; its
     --mode=eval (128 samples) against an in-process evaluate_detection
     over the same batches (metrics within 1e-4, and the --testdev_dir
     detections equal as multisets); V2-S b256 10 steps at stage 0's 168 px
     from files with --native_loader, beside phase 9's synthetic-fed stage
     0;
  12. the rest of LM serving (after 10; lm_serving_phase): lm-flops1e19,
     seeded, norm scales drawn (LM_NORM_SIGMA), cast for serving. (a) one decode step with a vector cache_index of
     equal entries bit-equal to the scalar one (logits and cache), a parked
     row's cache rows untouched, K4 on; (b) LMServer with K4 (max_batch 8,
     cache 1024, burst 8, prefill_chunk 256) on LM_SERVE_REQUESTS seeded
     requests (prompts 16-700, budgets 16-300): K4 launches = n_layers x
     (8 x bursts + chunks), all Hopper's, the bursts under sync debug mode
     "error", every
     token teacher-forced (SERVE_TF_GAP, SERVE_TF_EXACT); (c) the default
     server (the dots): no K4 launch; useful tokens/s of both (one run
     each: the repeated pair K4, dots was cut to make room for phase 15),
     time to first token, a burst's device-busy share; (d) the
     prefix cache (a 128-token shared prefix), teacher-forced; (e)
     speculative b1 (635 + 128, k 4) with the target as its own draft: K4
     launches = 16 + iterations x 8 x (k + 2), teacher-forced, accept
     rate, tokens/s against greedy_generate; (f)
     beam b2 x 4 (640 + 128): num_beams=1 bit-equal to greedy_generate, 8 x
     128 K4 launches, scores against teacher forcing (BEAM_SCORE_TOL); (g)
     int8: weight bytes, teacher-forced; (h) use_combined_qkv's prefill
     logits against the separate weights; (i) cli/generate_lm on the run
     directory that cli/main_lm wrote in 5 (the fused run, at Lion lr
     FUSED_LR, a checkpoint every FUSED_CKPT_EVERY steps): --serve_slots (stdin prompts,
     --prefill_chunk, --system_prompt), --num_beams, --draft_model_dir (a
     seeded lm-flops2e17 as experiment_config.yaml + params.npz), --int8
     and --step at the earlier checkpoint, on the default device, one
     output per prompt and the weights each read (the line it prints); (j)
     cli/main_lm trains lm-flops2e17 for DRAFT_STEPS steps on the target's
     stream with the target's flags at Lion lr DRAFT_LR (K1 2 x 8 x
     steps, K2 8 x steps, K3a-c once a step, all Hopper's);
     generate_lm.load_model reads both run
     directories; each model's teacher-forced next-token accuracy on a
     period-4 prompt; speculative b1 (k 4) on that prompt (PATTERN_PROMPT +
     PATTERN_NEW) and on README.md's bytes (DRAFT_PROMPT + DRAFT_NEW), as
     (e), beside greedy_generate (the
     README prompt's accept rate strictly between 0 and 1); then the CLI
     with both directories.
  13. segmentation, QAT, GroupNorm and the optimizer search (after 11,
     before 10; seg_qat_search_phase): (A) EfficientDet-D0 with
     heads=["segmentation"] (512 x 512, b16, bf16, seeded, a synthetic
     3-class mask with void pixels): step 1 knob on against off
     (DET_STEP1_LIMITS), SEG_STEPS make_seg_train_step steps with the knob
     on (the loss falls, pixel_acc rises, K6 launches
     filter_grad_calls_per_step x SEG_STEPS, all Hopper's; step ms, peak
     GiB), and one f32 step of efficientdet-test with both heads at 128 x
     128, card against CPU (SEG_F32_RTOL, the state under
     _cls_state_check); (B) cli/main_det --hparams=qat=true on D0 b16 for
     QAT_STEPS steps with the knob on, then the same run without QAT (in
     turns: step ms, peak; K6 launches counted as in 7), fake_quant of
     D0's seeded kernels card against CPU bit for bit, and one f32 QAT
     step of efficientdet-test card against CPU (QAT_F32_RTOL); (C)
     cli/main_cls on V2-S at its first stage (168 x 168, b V2S_BATCH)
     with model.bn_type=gn, GN_STEPS steps with the knob on in a child
     process (28 K6 launches a step, all Hopper's), its step ms beside
     phase 9's BatchNorm stage 0; (D) lm-flops1e19 (b8, T 2048, flash
     attention) SEARCH_LM_STEPS steps with
     program_to_optimizer(LION_PROGRAM) and as many with lion(lr, 0.9,
     0.99) from one tree on the same batches (losses and parameters
     bit-equal; K1 2 x n_layers and K2 n_layers a step, all Hopper's),
     then regularized_evolution from MOMENTUM_PROGRAM on a regression on
     the card (the JAX test's margin; evaluations, cache hits, abstract
     rejections printed).
  14. the parallel layer, first half (M10; m10_phase, last): (A) NCCL at a
     world of one (init_process_group on a file:// store) and
     create_mesh((1, 1, 1)) on the card, an all-reduce over 'model', the
     NCCL version on a "host:" line; (B) lm-flops1e19 (seeded, norm scales
     drawn, cast) with serve_tp on the mesh (the head-leading cache, K4
     head-major) against the batch-major model: prefill logits (bit-equal
     expected), greedy b8 512 + 256 tokens equal (else phase 12's
     teacher-forced limits), n_layers x 256 K4 launches a run, all
     Hopper's, prefill ms in turns and decode ms a step (a run each), and
     LMServer at phase 12's settings on M10_SERVE_REQUESTS requests with
     the same tokens as the batch-major K4 server; (C) K4 at each shard's shapes
     against the unsharded call (BF16_TOL): serve_tp's head-major rows of
     n_kv / m heads for m 2, 4, 8 and serve_sp's return_stats on S / m keys
     merged by merge_partials, m 2 and 4, at decode (the 4th shard of 4
     fully masked) and a T 512 prefill, all Hopper's, and one shard's time
     beside the unsharded call's; (D) step 1 of lm-flops1e19 (flash) on
     the mesh under gspmd and sp against no mesh (M10_STEP1_LIMITS; sp on
     a 'model' axis of 1 takes the flash path: K1 2 x n_layers, K2
     n_layers), then cli/main_lm --mesh_shape=1,1,1 --sharding_config=gspmd
     and without a mesh, M10_TRAIN_STEPS steps each at b8 T2048 (K1 / K2
     counts equal, step ms and peak GiB, the losses against each other,
     the mesh run's rank-0 checkpoint read back).
  15. the parallel layer, second half (M10; m10b_phase, last), NCCL at a
     world of one: (A) parallel/pipeline.py::pipeline_blocks over
     lm-flops1e19's blocks (weights drawn on the card, b8 T2048, flash
     attention) at a stage count of 1 in M10B_MICRO microbatches against
     the plain stack: step 1 within phase 5's loosest limits
     (M10B_PIPE_LIMITS), K1 / K2 2 / 1 a layer and microbatch, all
     Hopper's, step ms in turns; (B) phase 5b's MoE config cut to
     M10B_MOE_LAYERS layers with its experts over 'model' on the mesh
     (1, 1, 1) (the EP dispatch: global routing, the experts' remap, the
     slots' sum over 'model', counted) against no mesh: step 1 bit-equal
     (loss, every grad leaf, layer 0's kept slots), M10B_EP_STEPS Lion
     steps with equal losses, and one step of the MoE blocks microbatched
     through pipeline_blocks on the mesh bit-equal to the same without;
     (C) cli/main_det --mesh_shape=1,1,1 (D0 b16 512, K6 knob on,
     M10B_DET_STEPS steps) and the same run without a mesh: equal losses,
     76 K6 launches a step, all Hopper's, rank 0's checkpoint read back;
     cli/main_cls --mesh_shape=1,1,1 (V2-S 168, b256, knob on,
     M10B_CLS_STEPS steps) and without, in two child processes at once
     beside the D0 runs:
     equal losses and K6 launches; evaluate_detection on D0 with the mesh
     equal to without; (D) K6 on 2 and 4 H-bands of every stride-1
     depthwise map of a D0 step, each band's rows with k // 2 halo rows
     and dy padded by k // 2 zero rows, summed, against the whole map's
     call and the plain version (K6_SHARE), all Hopper's, one band's time
     beside the whole call's.
  16. the JAX package's orbax run directories (orbax_phase, last; ckpt/
     orbax.py -> ckpt/ocdbt.py -> csrc/host/zstd.cc, built with g++ beside
     the kernels): (a) the committed fixture tests/fixtures/jax_lm_test_run
     (JAX's main_lm on lm-test, Lion, 3 steps): every leaf read equals its
     digest in jax_lm_test_run_leaves.json, generate_lm on it decodes the
     same tokens with K4 as with the plain attention, and its frames are
     decoded ORBAX_DECODES times (MB/s); (b) phase 5's fused lm-flops1e19
     state (f32 params and Lion's momentum) written by orbax.write_step as
     a JAX run directory (bytes, write and read seconds, GB/s, read back
     bit-equal): generate_lm greedy b8 512 + 512 from it equals the same
     run from the state.pt, K4 all Hopper's; main_lm resumes 2 steps from
     it (fused loss, K1 / K2 / K3a-c all Hopper's), the state that
     CheckpointManager.restore reads from it (params, Lion's momentum, the
     schedule's count) and both losses bit-equal to resuming from the
     state.pt; the directories are deleted
     after; (c) the 20-step D0 checkpoint written the same way:
     ServingDriver.load of it serves b1 detections bit-equal to the
     state.pt's.

Every kernel time is the mean over calls of CUDA events around one call,
after an L2 flush and a sleep kernel that keeps the card busy while the
host enqueues the call (_time_ms). The library yardstick (library_ms) of
each attention kernel is
torch.compile'd torch.nn.attention.flex_attention with the same tanh cap as
score_mod and the same mask as a block mask (K2, K5a and K5b share its
backward, which computes dq, dk and dv together); that of K3a is the PyTorch
chain bf16 torch.matmul -> cap -> F.cross_entropy (no single PyTorch call
computes the fused loss), and K3b and K3c share that chain's autograd
backward, which computes both; that of K6 is cuDNN's weight gradient of
F.conv2d(groups=C) (torch.ops.aten.convolution_backward, weight only), the
call the port makes with the knob off. The port never calls the others. If
one cannot be compiled or run, the reason is printed and library_ms is
null.

Prints a {"kernels": [...]} JSON line (K4's launches: those of phases 10,
12, 5b's and 14's serve_tp runs and 16 (b); K1, K2 and K3a-c: phase 5's
runs and 5b's and 16 (b)'s resumes, K1 and K2 also 13's, 14's mesh run
and 15's pipeline and EP steps; K6: phases 7, 9, 13 and 15's mesh runs),
then
the
card line, and last {"ok": true, "device":
{...}}. Imports no jax.
"""

from __future__ import annotations

import concurrent.futures
import glob
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time

# Peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16 tensor cores,
# float32 outside the tensor cores, and device memory.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


# Cycles of the sleep kernel before each timed call (about 0.5 ms).
SLEEP_CYCLES = 1_000_000


def _time_ms(fn, iters: int, flush=None) -> float:
  """Mean device time of fn() in ms, CUDA events around each call; `flush`
  runs untimed before each call (to evict the cache from L2). A sleep
  kernel after it keeps the card busy while the host enqueues fn, so that
  the events bracket fn's device work and not the host's time to launch
  it (which is longer than the flush for K4 and flex_attention)."""
  import torch
  fn()
  torch.cuda.synchronize()
  total = 0.0
  for _ in range(iters):
    if flush is not None:
      flush()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    total += start.elapsed_time(end)
  return total / iters


def _bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
  """(bound ms, "operations" or "bytes"): the larger of the two times."""
  t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
  return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _library_ms(label, make_fn, iters, flush, what="flex_attention"):
  """Time of a library yardstick, or None with the reason printed."""
  try:
    fn = make_fn()
    ms = _time_ms(fn, iters, flush)
  except Exception as e:  # the yardstick only: the port never runs it
    print(f"  {label}: no library time ({type(e).__name__}: "
          f"{str(e).splitlines()[0][:300] if str(e) else ''})")
    return None
  print(f"  {label}: {what} {ms:.4f} ms")
  return ms


def _flex():
  import torch
  from torch.nn.attention import flex_attention as fx
  return torch.compile(fx.flex_attention, dynamic=False), fx.create_block_mask


def _cap_mod(cap):
  import torch

  def score_mod(score, b, h, q_idx, kv_idx):
    return cap * torch.tanh(score / cap)
  return score_mod


def _kernel_inputs(dev, gen, b, t, n, n_kv, h, s, dtype, p_live=0.7):
  import torch
  q = torch.randn((b, t, n, h), generator=gen, device=dev) * h ** -0.5
  kc = torch.randn((b * n_kv, h, s), generator=gen, device=dev)
  vc = torch.randn((b * n_kv, s, h), generator=gen, device=dev)
  mask = torch.rand((b, t, s), generator=gen, device=dev) < p_live
  mask[:, :, 0] = True
  return q.to(dtype), kc.to(dtype), vc.to(dtype), mask


def _compare(name, got, want, atol, rtol):
  """Max |got - want|; raises if outside atol + rtol * |want|."""
  import torch
  got, want = got.detach().float(), want.detach().float()
  if not torch.isfinite(got).all():
    raise AssertionError(f"{name}: non-finite kernel output")
  err = (got - want).abs()
  bad = err > atol + rtol * want.abs()
  max_err = float(err.max())
  print(f"  {name}: max|diff| {max_err:.3e} (atol {atol}, rtol {rtol})")
  if bad.any():
    raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                         f"tolerance, max|diff| {max_err:.3e}")
  return max_err


# bf16 outputs: both sides sum in f32 from the same bf16 inputs, then round;
# another summation order can land on the other side of a bf16 rounding
# step, one bf16 ulp: 2^-8 relative, <= 2^-6 absolute at |x| < 4.
BF16_TOL = dict(atol=1.6e-2, rtol=8e-3)
# f32: another summation order over S (or T) and H (the flash backward's
# dq over key tiles too, in a fixed order), and the card's expf/tanhf.
F32_TOL = dict(atol=1e-4, rtol=1e-4)


def _k4_bound(q, mask, n_kv):
  """K4's least time: q, out, the mask and the K/V of every key live for
  one query of its batch row (mask.any over T) once each; 4 flops per live
  (query, key, head, dim)."""
  b, t, n, h = q.shape
  live_keys = float(mask.any(dim=1).sum())
  nbytes = (2 * 2 * b * t * n * h + b * t * mask.shape[-1]
            + 2 * 2 * live_keys * n_kv * h)
  return _bound(4.0 * h * n * float(mask.sum()), nbytes)


def _k4_timed(label, qq, kc, vc, mm, n_kv, check, flush, flex, block_mask,
              simt=True):
  """K4 at one of a slice's shapes: checked against the plain version, a
  second call bit-equal, the SIMT kernel checked beside it; the Hopper
  kernel (and the SIMT one) timed in turns, the plain version and
  flex_attention timed; returns dict(err, ms, plain_ms, library_ms,
  bound_ms, bound_by, simt_ms)."""
  import torch
  from automl_tpu_torch.ops import decode_attention as da
  kern, ref = da.decode_attention, da.decode_attention_reference
  dev = qq.device
  b, t, n, h = qq.shape
  s = kc.shape[-1]
  kw = dict(n_kv_heads=n_kv, logit_cap=50.0)
  err, got = check(label, qq, kc, vc, mm, BF16_TOL, **kw)
  again = kern(qq, kc, vc, mm, **kw)
  if not torch.equal(got, again):
    raise AssertionError(f"{label}: two calls of the Hopper kernel differ")
  print(f"  {label}: a second call bit-equal")
  iters = 100 if t <= 16 else 20
  sm90 = lambda: kern(qq, kc, vc, mm, **kw)
  t_simt = None
  if simt:
    _compare(f"{label} SIMT kernel", kern(qq, kc, vc, mm, _simt=True, **kw),
             ref(qq, kc, vc, mm, **kw), **BF16_TOL)
    simt_fn = lambda: kern(qq, kc, vc, mm, _simt=True, **kw)
    turns = [_time_ms(fn, iters, flush)
             for fn in (sm90, simt_fn, simt_fn, sm90)]
    t_kern, t_simt = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
  else:
    turns = [_time_ms(sm90, iters, flush) for _ in range(2)]
    t_kern = sum(turns) / 2
  t_ref = _time_ms(lambda: ref(qq, kc, vc, mm, **kw), iters, flush)
  bound_ms, bound_by = _k4_bound(qq, mm, n_kv)
  rep = n // n_kv

  def make_lib():
    qf = qq.transpose(1, 2).contiguous()                   # [B, N, T, H]
    kf = kc.reshape(b, n_kv, h, s).transpose(2, 3).repeat_interleave(
        rep, dim=1).contiguous()
    vf = vc.reshape(b, n_kv, s, h).repeat_interleave(rep, dim=1).contiguous()
    bm = block_mask(lambda bb, hh, qi, ki: mm[bb, qi, ki], B=b, H=None,
                    Q_LEN=t, KV_LEN=s, device=dev)
    return lambda: flex(qf, kf, vf, score_mod=_cap_mod(50.0), block_mask=bm,
                        scale=1.0)

  t_lib = _library_ms(label, make_lib, iters, flush)
  if t == 1:
    # What one PyTorch reduction takes to read as many bytes as the live
    # K/V: a floor for a bytes-bound kernel at this size, beside bound_ms.
    live = torch.empty(int(2 * 2 * float(mm.any(dim=1).sum()) * n_kv * h)
                       // 2, dtype=torch.bfloat16, device=dev)
    t_read = _time_ms(lambda: live.amax(), iters, flush)
    print(f"  {label}: torch.amax over {live.numel() * 2 / 1e6:.1f} MB (the "
          f"live K/V's bytes) {t_read:.4f} ms")
    del live
  simt_txt = (f"SIMT kernel {t_simt:.4f} ms ({turns[1]:.4f}, {turns[2]:.4f}), "
              if simt else "")
  print(f"  {label}: Hopper kernel {t_kern:.4f} ms ({turns[0]:.4f}, "
        f"{turns[-1]:.4f}), {simt_txt}plain {t_ref:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; live keys' K/V) (in turns, L2 "
        f"flushed before each call)")
  return dict(err=err, ms=t_kern, plain_ms=t_ref, library_ms=t_lib,
              bound_ms=bound_ms, bound_by=bound_by, simt_ms=t_simt)


def k4_phase(dev, flush):
  """K4 vs plain version; returns {shape label: dict(err, ms, plain_ms,
  library_ms, bound_ms, bound_by)} for the Hopper kernels (bf16 routes to
  csrc/decode_attention_sm90.cu), with the SIMT kernel's time beside."""
  import torch
  from automl_tpu_torch.ops import decode_attention as da
  gen = torch.Generator(device=dev).manual_seed(0)
  kern, ref = da.decode_attention, da.decode_attention_reference

  def check(label, q, kc, vc, mask, tol, sm90=True, **kw):
    before = da.decode_attention.launches_sm90
    got, want = kern(q, kc, vc, mask, **kw), ref(q, kc, vc, mask, **kw)
    torch.cuda.synchronize()
    if (da.decode_attention.launches_sm90 - before == 1) != sm90:
      raise AssertionError(f"{label}: routed to the wrong kernel")
    if not kw.get("return_stats"):
      return _compare(label, got, want, **tol), got
    _compare(f"{label} m", got[1], want[1], **F32_TOL)
    _compare(f"{label} l", got[2], want[2], **F32_TOL)
    return _compare(f"{label} out", got[0], want[0], **tol), got

  print("K4 case 1: slice shapes b8 N8/8 hd128 S1024 bf16 cap50 (Hopper "
        "kernels; the SIMT kernel of decode_attention.cu beside)")
  b, n, h, s = 8, 8, 128, 1024
  q, kc, vc, _ = _kernel_inputs(dev, gen, b, 512, n, n, h, s, torch.bfloat16)
  prefill_mask = (torch.arange(s, device=dev)[None, :]
                  <= torch.arange(512, device=dev)[:, None]).expand(b, 512, s)
  prefill_mask = prefill_mask.contiguous()
  decode_mask = (torch.arange(s, device=dev) <= s - 2).expand(b, 1, s)
  decode_mask = decode_mask.contiguous()
  q1 = q[:, :1].contiguous()
  shapes = {"decode T=1": (q1, decode_mask), "prefill T=512": (q, prefill_mask)}
  flex, block_mask = _flex()
  out = {}
  for label, (qq, mm) in shapes.items():
    out[label] = _k4_timed(label, qq, kc, vc, mm, n, check, flush, flex,
                           block_mask)
  print("K4 case 2: GQA N8/n_kv2, T 1-8 (split-S up to T 4, wgmma above), "
        "S 200, bf16, cap 50")
  for t in range(1, 9):
    q2, kc2, vc2, mask = _kernel_inputs(dev, gen, 2, t, 8, 2, 128, 200,
                                        torch.bfloat16)
    check(f"T={t}", q2, kc2, vc2, mask, BF16_TOL, n_kv_heads=2,
          logit_cap=50.0)

  print("K4 case 3: prefix-LM and window masks (dead, mixed and all-live "
        "tiles), T 400 over S 512, N4/n_kv2, hd 64 and hd 72")
  t, s3 = 400, 512
  qi = torch.arange(t, device=dev)[:, None]
  ki = torch.arange(s3, device=dev)[None, :]
  masks = {"prefix-LM 100": (ki < 100) | (ki <= qi),
           "window 200": (ki <= qi) & (qi - ki < 200)}
  for name, m2 in masks.items():
    m2 = m2.expand(2, t, s3).contiguous()
    classes = da.mask_tile_classes_reference(m2)
    counts = [int((classes == c).sum()) for c in (da.DEAD, da.MIXED, da.LIVE)]
    if min(counts) == 0:
      raise AssertionError(f"{name}: tiles dead / mixed / live {counts}")
    for hd in (64, 72):
      q3, kc3, vc3, _ = _kernel_inputs(dev, gen, 2, t, 4, 2, hd, s3,
                                       torch.bfloat16)
      check(f"{name} hd {hd} (tiles dead/mixed/live {counts})", q3, kc3, vc3,
            m2, BF16_TOL, n_kv_heads=2, logit_cap=50.0)

  print("K4 case 4: head-major rows, return_stats, GQA 4/2, bf16, cap 50 "
        "(decode T 2 and prefill T 100), one fully-masked row each")
  for t in (2, 100):
    q4, kc4, vc4, mask = _kernel_inputs(dev, gen, 2, t, 4, 2, 128, 304,
                                        torch.bfloat16)
    mask[1, t - 1] = False
    _, (o4, _, l4) = check(f"T={t}", q4, kc4, vc4, mask, BF16_TOL,
                           n_kv_heads=2, logit_cap=50.0, layout="head_major",
                           return_stats=True)
    if (float(o4[1, t - 1].abs().max()) != 0.0
        or float(l4[1, t - 1].max()) != 0.0):
      raise AssertionError("fully-masked row: out or l is not 0")

  print("K4 case 5: decode, keys 64-511 masked for every query (whole "
        "splits dead), b2 N8/8 hd128 S1024 bf16")
  q5, kc5, vc5, _ = _kernel_inputs(dev, gen, 2, 1, 8, 8, 128, 1024,
                                   torch.bfloat16)
  k5 = torch.arange(1024, device=dev)
  mask = ((k5 < 64) | ((k5 >= 512) & (k5 < 700))).expand(2, 1, 1024)
  check("dead splits", q5, kc5, vc5, mask.contiguous(), BF16_TOL,
        n_kv_heads=8, logit_cap=50.0)

  print("K4 case 6: the SIMT kernel: GQA N8/n_kv2, ragged S, f32, no cap; "
        "hd 256 bf16; one fully-masked row, f32")
  for s6 in (77, 200):
    q6, kc6, vc6, mask = _kernel_inputs(dev, gen, 3, 5, 8, 2, 64, s6,
                                        torch.float32)
    check(f"S={s6}", q6, kc6, vc6, mask, F32_TOL, sm90=False, n_kv_heads=2)
  q6, kc6, vc6, mask = _kernel_inputs(dev, gen, 2, 3, 4, 1, 256, 96,
                                      torch.bfloat16)
  check("hd 256", q6, kc6, vc6, mask, BF16_TOL, sm90=False, n_kv_heads=1)
  q6, kc6, vc6, mask = _kernel_inputs(dev, gen, 2, 3, 4, 4, 32, 50,
                                      torch.float32)
  mask[1, 2] = False
  _, got = check("fully-masked row", q6, kc6, vc6, mask, F32_TOL, sm90=False,
                 n_kv_heads=4)
  if float(got[1, 2].abs().max()) != 0.0:
    raise AssertionError("fully-masked row is not 0")

  print("K4 case 7: M7's shapes (bf16, cap 50, Hopper kernels): the "
        "speculative verify (b1, T 5, hd 128, S 768) and a chunk prefill (b1, "
        "T 256 at offset 256, S 1024), timed; per-row masks with a parked "
        "row (split-S and wgmma), the draft's verify, prefill and steps at hd "
        "32, 64 beam rows")
  ki = torch.arange(1024, device=dev)
  for label, (t, s7, off) in {"verify T=5": (5, 768, 502),
                              "chunk T=256": (256, 1024, 256)}.items():
    q7, kc7, vc7, _ = _kernel_inputs(dev, gen, 1, t, 8, 8, 128, s7,
                                     torch.bfloat16)
    m7 = (ki[None, :s7] <= off + torch.arange(t, device=dev)[:, None])
    out[label] = _k4_timed(label, q7, kc7, vc7, m7[None].contiguous(), 8,
                           check, flush, flex, block_mask, simt=False)
  # The server's burst: row b at its own length, row 5 parked (key 0 only);
  # the same per-row offsets for a 32-token chunk (the wgmma design).
  for t in (1, 32):
    q7, kc7, vc7, _ = _kernel_inputs(dev, gen, 8, t, 8, 8, 128, 1024,
                                     torch.bfloat16)
    lens = torch.tensor([40, 900, 511, 512, 1, 0, 700, 990], device=dev)
    m7 = ki[None, None] <= lens[:, None, None] + torch.arange(
        t, device=dev)[None, :, None]
    m7[5] = ki == 0
    check(f"per-row lengths, a parked row, T {t}", q7, kc7, vc7,
          m7.contiguous(), BF16_TOL, n_kv_heads=8, logit_cap=50.0)
  q7, kc7, vc7, _ = _kernel_inputs(dev, gen, 1, 5, 8, 8, 32, 768,
                                   torch.bfloat16)
  m7 = (ki[None, :768] <= 502 + torch.arange(5, device=dev)[:, None])
  check("draft verify, T 5 hd 32", q7, kc7, vc7, m7[None].contiguous(),
        BF16_TOL, n_kv_heads=8, logit_cap=50.0)
  # What the lm-flops2e17 draft itself runs in phase 12 (j): its causal
  # prefill of DRAFT_PROMPT tokens (wgmma) and its T 1 steps (split-S), keys
  # live up to ~767.
  q7, kc7, vc7, _ = _kernel_inputs(dev, gen, 1, DRAFT_PROMPT, 8, 8, 32, 768,
                                   torch.bfloat16)
  m7 = (ki[None, :768] <= torch.arange(DRAFT_PROMPT, device=dev)[:, None])
  check(f"draft prefill, T {DRAFT_PROMPT} hd 32, causal from 0", q7, kc7,
        vc7, m7[None].contiguous(), BF16_TOL, n_kv_heads=8, logit_cap=50.0)
  for last in (DRAFT_PROMPT, 766):
    m7 = (ki[:768] <= last).expand(1, 1, 768).contiguous()
    check(f"draft step, T 1 hd 32, keys 0-{last}", q7[:, :1].contiguous(),
          kc7, vc7, m7, BF16_TOL, n_kv_heads=8, logit_cap=50.0)
  q7, kc7, vc7, _ = _kernel_inputs(dev, gen, 64, 1, 8, 8, 128, 768,
                                   torch.bfloat16)
  m7 = (ki[:768] <= 600).expand(64, 1, 768).contiguous()
  check("64 beam rows, T 1", q7, kc7, vc7, m7, BF16_TOL, n_kv_heads=8,
        logit_cap=50.0)
  print("K4 case 8: the MoE model's greedy generation (phase 5b): b8, N8/8, "
        "hd128, S 576, bf16, cap 50: the causal T 512 prefill (wgmma) and T 1 "
        "steps (split-S)")
  q8, kc8, vc8, _ = _kernel_inputs(dev, gen, 8, 512, 8, 8, 128, 576,
                                   torch.bfloat16)
  m8 = ki[None, :576] <= torch.arange(512, device=dev)[:, None]
  check("MoE prefill, T 512, causal from 0", q8, kc8, vc8,
        m8.expand(8, 512, 576).contiguous(), BF16_TOL, n_kv_heads=8,
        logit_cap=50.0)
  for last in (512, 575):
    m8 = (ki[:576] <= last).expand(8, 1, 576).contiguous()
    check(f"MoE step, T 1, keys 0-{last}", q8[:, :1].contiguous(), kc8, vc8,
          m8, BF16_TOL, n_kv_heads=8, logit_cap=50.0)
  torch.cuda.synchronize()
  return out


def _flash_inputs(dev, gen, b, t, n, h, dtype, scale=1.0):
  import torch
  return [(torch.randn((b, t, n, h), generator=gen, device=dev) * scale
           ).to(dtype) for _ in range(4)]


def flash_phase(dev, flush):
  """K1 / K2 / K5a / K5b vs their plain versions; returns {"fwd", "bwd",
  "dq", "dkv"}, each with err, ms, plain_ms, library_ms, bound_ms, bound_by
  at the slice's shapes."""
  import torch
  from automl_tpu_torch.ops import attention as fa
  gen = torch.Generator(device=dev).manual_seed(1)

  b, t, n, h = 8, 2048, 8, 128
  print(f"K1/K2/K5 case 1: slice shapes b{b} T{t} N{n}/{n} hd{h} bf16 causal "
        "cap50 sm_scale 1 (K1/K2/K5a/K5b: the Hopper kernels of "
        "flash_attention_sm90.cu; beside them the scalar-FMA kernels of "
        "flash_attention.cu, reached with _simt)")
  # q as the model feeds it: already scaled (by ~1/sqrt(hd)).
  q, k, v, g = _flash_inputs(dev, gen, b, t, n, h, torch.bfloat16)
  q = (q.float() * h ** -0.5).bfloat16()
  kw = dict(causal=True, logit_cap=50.0, sm_scale=1.0)
  out, lse = fa.flash_fwd_kernel(q, k, v, None, **kw)
  torch.cuda.synchronize()
  out_r, lse_r = fa.flash_fwd_reference(q, k, v, None, **kw)
  err_fwd = _compare("K1 out", out, out_r, **BF16_TOL)
  _compare("K1 lse", lse, lse_r, **F32_TOL)
  out_s, lse_s = fa.flash_fwd_kernel(q, k, v, None, _simt=True, **kw)
  err_fwd_simt = _compare("K1 (scalar FMA) out", out_s, out_r, **BF16_TOL)
  _compare("K1 (scalar FMA) lse", lse_s, lse_r, **F32_TOL)
  del out_s, lse_s
  grads = fa.flash_bwd_kernel(q, k, v, g, out_r, lse_r, None, **kw)
  torch.cuda.synchronize()
  grads_r = fa.flash_bwd_reference(q, k, v, g, out_r, lse_r, None, **kw)
  err_bwd = max(_compare(f"K2 {name}", x, y, **BF16_TOL)
                for name, x, y in zip(("dq", "dk", "dv"), grads, grads_r))
  # K2 sums dq over key tiles in a fixed order: a second call is bit-equal.
  again = fa.flash_bwd_kernel(q, k, v, g, out_r, lse_r, None, **kw)
  same = [bool(torch.equal(x, y)) for x, y in zip(grads, again)]
  print(f"  K2 called twice on the same inputs: dq, dk, dv bit-equal {same}")
  if not all(same):
    raise AssertionError("K2 gave two results on the same inputs")
  del again
  grads_s = fa.flash_bwd_kernel(q, k, v, g, out_r, lse_r, None, _simt=True,
                                **kw)
  err_bwd_simt = max(_compare(f"K2 (scalar FMA) {name}", x, y, **BF16_TOL)
                     for name, x, y in zip(("dq", "dk", "dv"), grads_s,
                                           grads_r))
  del grads, grads_r, grads_s
  # K5a / K5b: no atomics; each block owns its output rows, so a second
  # call is bit-equal.
  args = (q, k, v, g, out_r, lse_r, None)
  dq_r = fa.flash_bwd_dq_reference(*args, **kw)
  dk_r, dv_r = fa.flash_bwd_dkv_reference(*args, **kw)
  before = (fa.flash_attention.launches_dq_sm90,
            fa.flash_attention.launches_dkv_sm90)
  dq = fa.flash_bwd_dq_kernel(*args, **kw)
  dk, dv = fa.flash_bwd_dkv_kernel(*args, **kw)
  torch.cuda.synchronize()
  if (fa.flash_attention.launches_dq_sm90 - before[0],
      fa.flash_attention.launches_dkv_sm90 - before[1]) != (1, 1):
    raise AssertionError("bf16 K5a / K5b did not go to the Hopper kernels")
  err_dq = _compare("K5a dq", dq, dq_r, **BF16_TOL)
  err_dkv = max(_compare("K5b dk", dk, dk_r, **BF16_TOL),
                _compare("K5b dv", dv, dv_r, **BF16_TOL))
  same = [bool(torch.equal(dq, fa.flash_bwd_dq_kernel(*args, **kw)))] + [
      bool(torch.equal(x, y)) for x, y in zip(
          (dk, dv), fa.flash_bwd_dkv_kernel(*args, **kw))]
  print(f"  K5a, K5b called twice on the same inputs: dq, dk, dv bit-equal "
        f"{same}")
  if not all(same):
    raise AssertionError("K5a or K5b gave two results on the same inputs")
  del dq, dk, dv
  dq = fa.flash_bwd_dq_kernel(*args, _simt=True, **kw)
  err_dq_simt = _compare("K5a (scalar FMA) dq", dq, dq_r, **BF16_TOL)
  dk, dv = fa.flash_bwd_dkv_kernel(*args, _simt=True, **kw)
  err_dkv_simt = max(_compare("K5b (scalar FMA) dk", dk, dk_r, **BF16_TOL),
                     _compare("K5b (scalar FMA) dv", dv, dv_r, **BF16_TOL))
  del dq, dk, dv, dq_r, dk_r, dv_r

  live = b * n * t * (t + 1) / 2          # causal (query, key) pairs
  elems = b * t * n * h
  bounds = {
      # 2 products of 2*H flops per live pair; q, k, v read, out (bf16) and
      # lse (f32) written
      "fwd": _bound(4.0 * h * live, 2 * 4 * elems + 4 * b * n * t),
      # 5 products; q, k, v, g, out and lse read, dq, dk, dv written
      "bwd": _bound(10.0 * h * live, 2 * 8 * elems + 4 * b * n * t),
      # K5a: 3 products (s, dp, ds k); the same inputs, dq written
      "dq": _bound(6.0 * h * live, 2 * 6 * elems + 4 * b * n * t),
      # K5b: 4 products (s, dp, ds^T q, p^T g); dk, dv written
      "dkv": _bound(8.0 * h * live, 2 * 7 * elems + 4 * b * n * t),
  }
  flex, block_mask = _flex()
  bm = block_mask(lambda bb, hh, qi, ki: qi >= ki, B=None, H=None, Q_LEN=t,
                  KV_LEN=t, device=dev)
  qf, kf, vf, gf = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))

  def lib_fwd():
    return lambda: flex(qf, kf, vf, score_mod=_cap_mod(50.0), block_mask=bm,
                        scale=1.0)

  def lib_fwd_bwd():
    xs = [x.detach().requires_grad_() for x in (qf, kf, vf)]

    def fn():
      o = flex(*xs, score_mod=_cap_mod(50.0), block_mask=bm, scale=1.0)
      torch.autograd.grad(o, xs, gf)
    return fn

  def lib_bwd():
    xs = [x.detach().requires_grad_() for x in (qf, kf, vf)]
    o = flex(*xs, score_mod=_cap_mod(50.0), block_mask=bm, scale=1.0)
    return lambda: torch.autograd.grad(o, xs, gf, retain_graph=True)

  res = {}
  bwd_args = (q, k, v, g, out, lse, None)
  simt = dict(kw, _simt=True)
  # The library yardstick of K2, K5a and K5b is one: flex_attention's
  # backward, which computes dq, dk and dv together. The scalar-FMA kernels
  # are timed right after the Hopper ones, in the same call.
  for key, kid, kern_fn, ref_fn, lib, err, bound in (
      ("fwd", "K1", lambda: fa.flash_fwd_kernel(q, k, v, None, **kw),
       lambda: fa.flash_fwd_reference(q, k, v, None, **kw), lib_fwd, err_fwd,
       "fwd"),
      ("fwd_simt", "K1 (scalar FMA)",
       lambda: fa.flash_fwd_kernel(q, k, v, None, **simt), "fwd", "fwd",
       err_fwd_simt, "fwd"),
      ("bwd", "K2", lambda: fa.flash_bwd_kernel(*bwd_args, **kw),
       lambda: fa.flash_bwd_reference(*bwd_args, **kw), lib_bwd, err_bwd,
       "bwd"),
      ("bwd_simt", "K2 (scalar FMA)",
       lambda: fa.flash_bwd_kernel(*bwd_args, **simt), "bwd", "bwd",
       err_bwd_simt, "bwd"),
      ("dq", "K5a", lambda: fa.flash_bwd_dq_kernel(*bwd_args, **kw),
       lambda: fa.flash_bwd_dq_reference(*bwd_args, **kw), "bwd", err_dq,
       "dq"),
      ("dq_simt", "K5a (scalar FMA)",
       lambda: fa.flash_bwd_dq_kernel(*bwd_args, **simt), "dq", "bwd",
       err_dq_simt, "dq"),
      ("dkv", "K5b", lambda: fa.flash_bwd_dkv_kernel(*bwd_args, **kw),
       lambda: fa.flash_bwd_dkv_reference(*bwd_args, **kw), "bwd", err_dkv,
       "dkv"),
      ("dkv_simt", "K5b (scalar FMA)",
       lambda: fa.flash_bwd_dkv_kernel(*bwd_args, **simt), "dkv", "bwd",
       err_dkv_simt, "dkv")):
    t_kern = _time_ms(kern_fn, 10, flush)
    # The plain version and the yardstick are the same call for both
    # implementations of a kernel: timed once, with the Hopper kernel.
    t_ref = (_time_ms(ref_fn, 5, flush) if callable(ref_fn)
             else res[ref_fn]["plain_ms"])
    t_lib = (_library_ms(kid, lib, 10, flush) if callable(lib)
             else res[lib]["library_ms"])
    bound_ms, bound_by = bounds[bound]
    res[key] = dict(err=err, ms=t_kern, plain_ms=t_ref, library_ms=t_lib,
                    bound_ms=bound_ms, bound_by=bound_by)
    vs_lib = (f", {t_kern / t_lib:.2f}x the library's time" if t_lib
              else "")
    print(f"  {kid}: kernel {t_kern:.4f} ms, plain {t_ref:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / t_kern:.2f}% of "
          f"it{vs_lib} (L2 flushed before each call)")
  print("  faster than the scalar-FMA kernel (one call): " + ", ".join(
      f"{kid} {res[key + '_simt']['ms'] / res[key]['ms']:.2f}x"
      for kid, key in (("K1", "fwd"), ("K2", "bwd"), ("K5a", "dq"),
                       ("K5b", "dkv"))))
  split_ms = res["dq"]["ms"] + res["dkv"]["ms"]
  print(f"  K5a + K5b: {split_ms:.4f} ms against K2's {res['bwd']['ms']:.4f} "
        f"ms ({split_ms / res['bwd']['ms']:.2f}x); the scalar-FMA K5a + K5b "
        f"{res['dq_simt']['ms'] + res['dkv_simt']['ms']:.4f} ms")
  _library_ms("forward + backward", lib_fwd_bwd, 10, flush)
  del q, k, v, g, out, lse, out_r, lse_r, qf, kf, vf, gf
  torch.cuda.empty_cache()

  def both(name, q, k, v, g, segs=None, tol=F32_TOL, **kw):
    """K1, K2, K5a and K5b against the plain versions on one input."""
    o, l = fa.flash_fwd(q, k, v, segs, **kw)
    o_r, l_r = fa.flash_fwd_reference(q, k, v, segs, **kw)
    _compare(f"{name} out", o, o_r, **tol)
    _compare(f"{name} lse", l, l_r, **F32_TOL)
    args = (q, k, v, g, o_r, l_r, segs)
    ref = fa.flash_bwd_reference(*args, **kw)
    for gname, x, y in zip(("dq", "dk", "dv"), fa.flash_bwd(*args, **kw), ref):
      _compare(f"{name} {gname}", x, y, **tol)
    split = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))
    for gname, x, y in zip(("K5a dq", "K5b dk", "K5b dv"), split, ref):
      _compare(f"{name} {gname}", x, y, **tol)

  for fused in (False, True):
    print(f"K1/{'K2' if fused else 'K5'} case 2: GQA N8/n_kv2 through "
          f"flash_attention (autograd, bwd_fused={fused}), bf16, T 256, cap "
          "50, against the same call on the CPU's plain versions in f32")
    qg, _, _, gg = _flash_inputs(dev, gen, 2, 256, 8, 64, torch.bfloat16)
    kg, vg, _, _ = _flash_inputs(dev, gen, 2, 256, 2, 64, torch.bfloat16)
    outs = []
    for device, dtype in ((dev, torch.bfloat16), ("cpu", torch.float32)):
      xs = [x.detach().to(device, dtype).requires_grad_()
            for x in (qg, kg, vg)]
      o = fa.flash_attention(*xs, logit_cap=50.0, bwd_fused=fused)
      o.backward(gg.to(device, dtype))
      outs.append([o] + [x.grad for x in xs])
    for name, x, y in zip(("out", "dq", "dk", "dv"), *outs):
      _compare(f"GQA {name}", x, y.to(dev), **BF16_TOL)

  print("K1/K2/K5 case 3: window 16 + cap 5, f32, T 300")
  both("window", *_flash_inputs(dev, gen, 2, 300, 2, 64, torch.float32),
       window=16, logit_cap=5.0, sm_scale=0.125)
  print("K1/K2/K5 case 4: packed segment ids, f32, T 256, hd 128")
  segs = torch.cumsum((torch.rand((2, 256), generator=gen, device=dev)
                       < 0.03).int(), dim=1).int().contiguous()
  both("segments", *_flash_inputs(dev, gen, 2, 256, 2, 128, torch.float32),
       segs=segs, sm_scale=0.09)
  for tt in (77, 200):
    print(f"K1/K2/K5 case 5: ragged T {tt}, f32")
    both(f"T={tt}", *_flash_inputs(dev, gen, 2, tt, 3, 32, torch.float32),
         sm_scale=0.2, logit_cap=50.0)
  print("K1/K2/K5 case 6: documents of length 1 (each query sees only itself; "
        "a query with no live key cannot occur under causal masking)")
  qd, kd, vd, gd = _flash_inputs(dev, gen, 1, 70, 2, 16, torch.float32)
  segs1 = torch.arange(70, device=dev, dtype=torch.int32)[None].contiguous()
  both("length-1 docs", qd, kd, vd, gd, segs=segs1, sm_scale=0.3)
  o, _ = fa.flash_fwd(qd, kd, vd, segs1, sm_scale=0.3)
  _compare("length-1 docs out == v", o, vd, atol=1e-6, rtol=0)
  # bf16: K1, K2, K5a and K5b are the Hopper kernels.
  segs_b = torch.cumsum((torch.rand((2, 200), generator=gen, device=dev)
                         < 0.03).int(), dim=1).int().contiguous()
  for name, (bb, tt, nn, hh), extra in (
      ("bf16 hd32 T77 cap50", (2, 77, 3, 32), dict(logit_cap=50.0)),
      ("bf16 hd64 T200 window 16 cap5 segments", (2, 200, 2, 64),
       dict(window=16, logit_cap=5.0, segs=segs_b)),
      ("bf16 hd128 T200 no cap", (2, 200, 2, 128), dict()),
      ("bf16 hd128 T200 non-causal window 40", (2, 200, 2, 128),
       dict(causal=False, window=40))):
    print(f"K1/K2/K5 case 7: {name}")
    both(name, *_flash_inputs(dev, gen, bb, tt, nn, hh, torch.bfloat16),
         tol=BF16_TOL, sm_scale=hh ** -0.5, **extra)
  print("K1/K2/K5 case 8: bf16 documents of length 1, hd 64")
  qd, kd, vd, gd = _flash_inputs(dev, gen, 1, 70, 2, 64, torch.bfloat16)
  both("bf16 length-1 docs", qd, kd, vd, gd, segs=segs1, tol=BF16_TOL,
       sm_scale=0.125)
  o, _ = fa.flash_fwd(qd, kd, vd, segs1, sm_scale=0.125)
  _compare("bf16 length-1 docs out == v", o, vd, atol=0, rtol=0)
  del qd, kd, vd, gd, o
  print("K1/K2/K5 case 9: the default LM's shapes (phase 5b): b8 T2048 "
        "N16/16 hd128 bf16 causal cap50 sm_scale 1 (the Hopper kernels)")
  qd, kd, vd, gd = _flash_inputs(dev, gen, 8, 2048, 16, 128, torch.bfloat16)
  qd = (qd.float() * 128 ** -0.5).bfloat16()
  fl = fa.flash_attention
  before = (fl.launches_fwd_sm90, fl.launches_bwd_sm90, fl.launches_dq_sm90,
            fl.launches_dkv_sm90)
  both("default LM", qd, kd, vd, gd, tol=BF16_TOL, causal=True,
       logit_cap=50.0, sm_scale=1.0)
  if (fl.launches_fwd_sm90 - before[0], fl.launches_bwd_sm90 - before[1],
      fl.launches_dq_sm90 - before[2], fl.launches_dkv_sm90 - before[3]
      ) != (1, 1, 1, 1):
    raise AssertionError("default LM: K1 / K2 / K5a / K5b did not go to the "
                         "Hopper kernels")
  del qd, kd, vd, gd
  print("K1/K2/K5 case 10: the trained draft's shapes (phase 12 (j), "
        "lm-flops2e17): b8 T2048 N8/8 hd32 bf16 causal cap50 sm_scale 1 (the "
        "Hopper kernels)")
  qd, kd, vd, gd = _flash_inputs(dev, gen, 8, 2048, 8, 32, torch.bfloat16)
  qd = (qd.float() * 32 ** -0.5).bfloat16()
  before = (fl.launches_fwd_sm90, fl.launches_bwd_sm90)
  both("draft", qd, kd, vd, gd, tol=BF16_TOL, causal=True, logit_cap=50.0,
       sm_scale=1.0)
  if (fl.launches_fwd_sm90 - before[0], fl.launches_bwd_sm90 - before[1]
      ) != (1, 1):
    raise AssertionError("draft: K1 / K2 did not go to the Hopper kernels")
  del qd, kd, vd, gd
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  return res


# K3b / K3c outputs (dx, dW, f32) against their plain versions: both round
# dz to bf16, from logits summed in another order; where a value lies near
# a rounding step the two land a bf16 step apart (2^-8 of that term).
# Measured on the H100 at the slice's shapes: 2.2e-4 (dx) and 3.2e-5 (dW)
# of the largest entry; the limit is 4.5x the larger.
XENT_GRAD_SHARE = 1e-3


def _compare_scaled(name, got, want, share):
  """_compare with atol = share * max|want| and rtol = share."""
  scale = float(want.detach().abs().max())
  return _compare(name, got, want, atol=share * scale, rtol=share)


def _xent_inputs(dev, gen, m, v, d, dtype, zero_share=0.2):
  """x [m, d], w [v, d] at dtype (logits of std ~1.6 at d 1024), targets
  int32 [m], weights [m] with about zero_share zeros."""
  import torch
  x = torch.randn((m, d), generator=gen, device=dev).to(dtype)
  w = (torch.randn((v, d), generator=gen, device=dev) * 0.05).to(dtype)
  targets = torch.randint(0, v, (m,), generator=gen, device=dev,
                          dtype=torch.int32)
  weights = (torch.rand((m,), generator=gen, device=dev) >= zero_share
             ).float()
  return x, w, targets, weights


def _xent_chain(x, w, targets, weights, cap):
  """The library yardstick of K3: bf16 torch.matmul, the cap, cross_entropy."""
  import torch
  z = torch.matmul(x, w.t()).float()
  z = cap * torch.tanh(z / cap)
  nll = torch.nn.functional.cross_entropy(z, targets.long(), reduction="none")
  return (nll * weights).sum() / weights.sum().clamp_min(1.0)


def _xent_bounds(m, v, d):
  """{"fwd", "dx", "dw"}: (bound ms, bound by) of K3a / K3b / K3c."""
  in_bytes = 2 * (m + v) * d + 4 * m            # x, w, targets
  return {
      # the logits: 2 flops per (token, vocab, dim); lse and tz written
      "fwd": _bound(2.0 * m * v * d, in_bytes + 8 * m),
      # the logit recompute plus dz . w (dz^T . x); lse, coef read, dx (dW)
      # written in f32
      "dx": _bound(4.0 * m * v * d, in_bytes + 8 * m + 4 * m * d),
      "dw": _bound(4.0 * m * v * d, in_bytes + 8 * m + 4 * v * d),
  }


def xent_phase(dev, flush):
  """K3a / K3b / K3c vs their plain versions; returns {"fwd", "dx", "dw"}
  each with err, ms, plain_ms, library_ms, bound_ms, bound_by at the
  slice's shapes (the Hopper kernels of csrc/xent_sm90.cu, with their
  csrc/xent.cu predecessors' times from the same call as simt_ms)."""
  import torch
  from automl_tpu_torch.ops import xent
  gen = torch.Generator(device=dev).manual_seed(2)
  f = xent.fused_softmax_xent

  def sm90_launches():
    return f.launches_dx_sm90 + f.launches_dw_sm90

  def fwd_checked(name, x, w, targets, cap, sm90):
    """K3a through the wrapper against its plain version (F32_TOL), routed
    as `sm90` says; a Hopper call twice must be bit-equal."""
    before = f.launches_fwd_sm90
    lse, tz = xent.xent_fwd(x, w, targets, logit_cap=cap)
    torch.cuda.synchronize()
    if f.launches_fwd_sm90 - before != int(sm90):
      raise AssertionError(f"K3a {name}: routed to the wrong kernel")
    lse_r, tz_r = xent.xent_fwd_reference(x, w, targets, logit_cap=cap)
    err = max(_compare(f"{name} K3a lse", lse, lse_r, **F32_TOL),
              _compare(f"{name} K3a tz", tz, tz_r, **F32_TOL))
    if sm90:
      again = xent.xent_fwd(x, w, targets, logit_cap=cap)
      same = all(torch.equal(a, b) for a, b in zip((lse, tz), again))
      print(f"  {name} K3a called twice on the same inputs: bit-equal {same}")
      if not same:
        raise AssertionError(f"K3a {name} gave two results on the same "
                             "inputs")
    return lse, tz, lse_r, err

  m, d, v, cap = 8 * 2048, 1024, 100_864, 30.0
  print(f"K3 case 1: slice shapes M {m} (b8 x T2048), D {d}, V {v}, bf16 "
        "operands, cap 30, about 20% zero loss weights (K3a-c: the Hopper "
        "kernels of xent_sm90.cu; beside them those of xent.cu, reached with "
        "_simt)")
  x, w, targets, weights = _xent_inputs(dev, gen, m, v, d, torch.bfloat16)
  coef = (weights / weights.sum().clamp_min(1.0)).contiguous()
  lse, tz, lse_r, err = fwd_checked("slice", x, w, targets, cap, True)
  errs = {"fwd": err}
  lse_s, tz_s = xent.xent_fwd_kernel(x, w, targets, logit_cap=cap, _simt=True)
  _compare("slice K3a (xent.cu) lse", lse_s, lse_r, **F32_TOL)
  del lse_s, tz_s
  active = xent.sm90_clusters(d, "fwd")
  print(f"  K3a: {-(-m // 128)} clusters of {d // 256} blocks, {active} at "
        f"once on this card; split plan (whole tiles, parts of each of the "
        f"rest) {xent.split_plan(-(-m // 128), active, -(-v // 64))}")
  kw = dict(logit_cap=cap, out_dtype=torch.float32)
  fns = {"dx": (xent.xent_dx_kernel, xent.xent_dx_reference, "K3b"),
         "dw": (xent.xent_dw_kernel, xent.xent_dw_reference, "K3c")}
  for key, (kern, ref, kid) in fns.items():
    before = sm90_launches()
    got = kern(x, w, targets, lse_r, coef, **kw)
    torch.cuda.synchronize()
    if sm90_launches() != before + 1:
      raise AssertionError(f"{kid}: the bf16 slice did not go to the Hopper "
                           "kernel")
    want = ref(x, w, targets, lse_r, coef, **kw)
    errs[key] = _compare_scaled(f"{kid} {key}", got, want, XENT_GRAD_SHARE)
    # No atomics: each block writes its outputs once, and partial sums are
    # added in a fixed order, so a second call is bit-equal.
    same = bool(torch.equal(got, kern(x, w, targets, lse_r, coef, **kw)))
    print(f"  {kid} called twice on the same inputs: bit-equal {same}")
    if not same:
      raise AssertionError(f"{kid} gave two results on the same inputs")
    if key == "dx":
      zero_rows = float(got[weights == 0].abs().max())
      print(f"  K3b rows of the {int((weights == 0).sum())} zero-weight "
            f"tokens: max|dx| {zero_rows}")
      if zero_rows != 0.0:
        raise AssertionError("a zero-weight token got a nonzero dx")
    del got
    got = kern(x, w, targets, lse_r, coef, _simt=True, **kw)
    _compare_scaled(f"{kid} (xent.cu) {key}", got, want, XENT_GRAD_SHARE)
    del got, want
    own, streamed = (m, v) if key == "dx" else (v, m)
    active = xent.sm90_clusters(d, key)
    plan = xent.split_plan(-(-own // 128), active, -(-streamed // 64))
    print(f"  {kid}: {-(-own // 128)} clusters of {d // 256} blocks, {active}"
          f" at once on this card; split plan (whole tiles, parts of each of "
          f"the rest) {plan}")
  torch.cuda.empty_cache()

  bounds = _xent_bounds(m, v, d)

  def chain_fwd():
    return lambda: _xent_chain(x, w, targets, weights, cap)

  def chain_bwd():
    xs, ws = x.detach().requires_grad_(), w.detach().requires_grad_()
    loss = _xent_chain(xs, ws, targets, weights, cap)
    return lambda: torch.autograd.grad(loss, (xs, ws), retain_graph=True)

  chain = "chain bf16 matmul -> cap -> cross_entropy"
  t_lib = {"fwd": _library_ms("K3a", chain_fwd, 5, flush, chain)}
  torch.cuda.empty_cache()
  t_lib["dx"] = t_lib["dw"] = _library_ms(
      "K3b + K3c", chain_bwd, 3, flush, f"{chain}, autograd backward")
  torch.cuda.empty_cache()
  res = {}
  new = lambda: xent.xent_fwd_kernel(x, w, targets, logit_cap=cap)
  old = lambda: xent.xent_fwd_kernel(x, w, targets, logit_cap=cap,
                                     _simt=True)
  turns = [_time_ms(fn, 3, flush) for fn in (new, old, old, new)]
  t_kern, t_old = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
  t_ref = _time_ms(lambda: xent.xent_fwd_reference(x, w, targets,
                                                   logit_cap=cap), 2, flush)
  res["fwd"] = dict(err=errs["fwd"], ms=t_kern, plain_ms=t_ref,
                    library_ms=t_lib["fwd"], bound_ms=bounds["fwd"][0],
                    bound_by=bounds["fwd"][1], simt_ms=t_old)
  # w's L2 reads by design: once per block of 64 tokens up to D 1,024 (x
  # resident), once per cluster of 128 above (xent.cu's K3a reads x again
  # for each 128-wide vocab tile).
  l2_fwd = -(-m // (64 if d <= xent.SM90_RESIDENT_DIM else 128)) * 2.0 * v * d
  print(f"  K3a: Hopper kernel {t_kern:.4f} ms ({turns[0]:.4f}, "
        f"{turns[3]:.4f}), xent.cu kernel {t_old:.4f} ms ({turns[1]:.4f}, "
        f"{turns[2]:.4f}): {t_old / t_kern:.2f}x; plain {t_ref:.4f} ms, "
        f"bound {bounds['fwd'][0]:.4f} ms ({bounds['fwd'][1]}), "
        f"{100 * bounds['fwd'][0] / t_kern:.2f}% of it; w from L2 by design "
        f"{l2_fwd / 1e9:.1f} GB = {l2_fwd / t_kern / 1e9:.2f} TB/s (in turns, "
        "L2 flushed before each call)")
  # The streamed operand's L2 reads by design: each cluster of
  # xent_sm90.cu reads it once (dx: w per 128 tokens; dW: x per 128 vocab
  # rows).
  l2_bytes = {"dx": -(-m // 128) * 2.0 * v * d,
              "dw": -(-v // 128) * 2.0 * m * d}
  for key, (kern, ref, kid) in fns.items():
    new = lambda kern=kern: kern(x, w, targets, lse, coef, **kw)
    old = lambda kern=kern: kern(x, w, targets, lse, coef, _simt=True, **kw)
    turns = [_time_ms(fn, 3, flush) for fn in (new, old, old, new)]
    t_new, t_old = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    t_ref = _time_ms(lambda ref=ref: ref(x, w, targets, lse, coef, **kw), 2,
                     flush)
    bound_ms, bound_by = bounds[key]
    res[key] = dict(err=errs[key], ms=t_new, plain_ms=t_ref,
                    library_ms=t_lib[key], bound_ms=bound_ms,
                    bound_by=bound_by, simt_ms=t_old)
    print(f"  {kid}: Hopper kernel {t_new:.4f} ms ({turns[0]:.4f}, "
          f"{turns[3]:.4f}), xent.cu kernel {t_old:.4f} ms ({turns[1]:.4f}, "
          f"{turns[2]:.4f}): {t_old / t_new:.2f}x; plain {t_ref:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), "
          f"{100 * bound_ms / t_new:.2f}% of it; the streamed operand from "
          f"L2 by design {l2_bytes[key] / 1e9:.1f} GB = "
          f"{l2_bytes[key] / t_new / 1e9:.2f} TB/s (in turns, L2 flushed "
          "before each call)")
  both = res["dx"]["ms"] + res["dw"]["ms"]
  if t_lib["dx"]:
    print(f"  K3b + K3c: {both:.4f} ms = {both / t_lib['dx']:.2f}x the "
          f"chain's backward ({t_lib['dx']:.4f} ms)")
  del x, w, targets, weights, coef, lse, tz, lse_r
  torch.cuda.empty_cache()

  def small(name, m, v, d, dtype, cap, sm90, time_it=False):
    x, w, targets, weights = _xent_inputs(dev, gen, m, v, d, dtype)
    coef = (weights / weights.sum().clamp_min(1.0)).contiguous()
    _, _, lse_r, _ = fwd_checked(name, x, w, targets, cap, sm90)
    if time_it:
      new = lambda: xent.xent_fwd_kernel(x, w, targets, logit_cap=cap)
      old = lambda: xent.xent_fwd_kernel(x, w, targets, logit_cap=cap,
                                         _simt=True)
      turns = [_time_ms(fn, 3, flush) for fn in (new, old, old, new)]
      chain = _library_ms(f"{name} K3a", lambda: lambda: _xent_chain(
          x, w, targets, weights, cap), 3, flush,
          "chain bf16 matmul -> cap -> cross_entropy")
      bound_ms, bound_by = _xent_bounds(m, v, d)["fwd"]
      print(f"  {name} fwd: Hopper kernel "
            f"{(turns[0] + turns[3]) / 2:.4f} ms, xent.cu kernel "
            f"{(turns[1] + turns[2]) / 2:.4f} ms, chain {chain} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}) (in turns, L2 flushed before "
            "each call)")
    kw = dict(logit_cap=cap, out_dtype=torch.float32)
    bwd_ms = 0.0
    for key, (kern, ref, _) in fns.items():
      before = sm90_launches()
      got = (xent.xent_dx if key == "dx" else xent.xent_dw)(
          x, w, targets, lse_r, coef, **kw)
      if sm90_launches() - before != int(sm90):
        raise AssertionError(f"{name} {key}: routed to the wrong kernel")
      _compare_scaled(f"{name} {key}", got,
                      ref(x, w, targets, lse_r, coef, **kw), XENT_GRAD_SHARE)
      if time_it:
        ms = _time_ms(lambda kern=kern: kern(x, w, targets, lse_r, coef,
                                             **kw), 3, flush)
        bwd_ms += ms
        bound_ms, bound_by = _xent_bounds(m, v, d)[key]
        print(f"  {name} {key}: {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}) (L2 flushed before each call)")
    if time_it:
      def chain_bwd():
        xs, ws = x.detach().requires_grad_(), w.detach().requires_grad_()
        loss = _xent_chain(xs, ws, targets, weights, cap)
        return lambda: torch.autograd.grad(loss, (xs, ws), retain_graph=True)
      lib = _library_ms(f"{name} K3b + K3c", chain_bwd, 3, flush,
                        "chain bf16 matmul -> cap -> cross_entropy, autograd "
                        "backward")
      if lib:
        print(f"  {name} K3b + K3c: {bwd_ms:.4f} ms = {bwd_ms / lib:.2f}x "
              f"the chain's backward ({lib:.4f} ms)")

  print("K3 case 2: the default LM's shapes: M 16384 (b8 x T2048), V 32000, "
        "D 2048, bf16 operands, cap 30 (K3a-c on the Hopper kernels, "
        "clusters of 8)")
  small("D=2048", 16_384, 32_000, 2048, torch.bfloat16, 30.0, True,
        time_it=True)
  print("K3 case 3: ragged M and V on the Hopper kernels: M 300, V 1000, "
        "D 256 (clusters of 1), M 257, V 333, D 512 (of 2) and M 1000, V "
        "1500, D 2048 (of 8), cap 30")
  small("D=256", 300, 1000, 256, torch.bfloat16, 30.0, True)
  small("D=512", 257, 333, 512, torch.bfloat16, 30.0, True)
  small("D=2048 ragged", 1000, 1500, 2048, torch.bfloat16, 30.0, True)
  print("K3 case 4: no cap, M 130, V 2000, D 1024 (the Hopper kernels)")
  small("cap 0", 130, 2000, 1024, torch.bfloat16, 0.0, True)
  print("K3 case 5: ragged M 100, V 1000, D 128, f32 operands, cap 30 "
        "(xent.cu)")
  small("f32", 100, 1000, 128, torch.float32, 30.0, False)
  print("K3 case 6: ragged M 257, V 333, D 72, bf16 operands, no cap "
        "(xent.cu)")
  small("D=72", 257, 333, 72, torch.bfloat16, 0.0, False)
  print("K3 case 7: untied w [D, V] through fused_softmax_xent (autograd), "
        "bf16 operands, M 150, V 700, D 64, against the same call on the "
        "CPU's plain versions")
  x, w, targets, weights = _xent_inputs(dev, gen, 150, 700, 64, torch.float32)
  w = w.t().contiguous()
  outs = []
  for device in (dev, torch.device("cpu")):
    xs = [t.detach().to(device).requires_grad_() for t in (x, w)]
    loss = xent.fused_softmax_xent(*xs, targets.to(device), weights.to(device),
                                   tied=False, logit_cap=30.0)
    loss.backward()
    outs.append([loss.detach()] + [t.grad for t in xs])
  _compare("untied loss", outs[0][0], outs[1][0].to(dev), atol=0, rtol=1e-5)
  for name, a, b in zip(("dx", "dW"), outs[0][1:], outs[1][1:]):
    _compare_scaled(f"untied {name}", a, b.to(dev), 1e-3)
  del x, w, targets, weights, outs
  print("K3 case 8: the trained draft's shapes (phase 12 (j), lm-flops2e17): "
        "M 16384 (b8 x T2048), V 100,864, D 256, bf16 operands, cap 30 (the "
        "Hopper kernels: K3a with x resident, K3b / K3c clusters of 1)")
  small("draft D=256", 16_384, 100_864, 256, torch.bfloat16, 30.0, True)
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  return res


def _step_flops(cfg, b, t, fused=False, policy="full", split=False,
                window=None):
  """(executed, model) FLOPs of one training step.

  Executed: the blocks' matmuls 8 * params * tokens under full remat
  (forward, backward 2x, remat forward), 6 under the dots policies, which
  save them; the attention kernels per layer and causal pair: K1 4 * hd,
  twice (once under dots_flash, which saves its outputs), and K2 10 * hd or
  K5a + K5b 14 * hd (split); the unembed 6 * d * V * tokens, or 10 with the
  fused loss (K3a 2, K3b 4 and K3c 4: both backward kernels recompute the
  logits). Model: what the step must compute, without any recompute:
  6 * params * tokens, attention forward and backward 12 * hd per causal
  pair and layer, the unembed 6 * d * V * tokens; the same for all
  paths. With moe_num_experts, the FFN's rows: executed, each expert's
  capacity (cf * k rows a token, empty slots included); model, the k
  routed slots. `window`: the chunked local attention's chunk c (its
  einsums take every (query, key) pair of a two-chunk window: 2c keys a
  query, executed; the live pairs, model)."""
  d, hd, n, f = cfg.model_dim, cfg.head_dim, cfg.n_heads, \
      cfg.expand_factor * cfg.model_dim
  attn_params = cfg.n_layers * d * hd * (2 * n + 2 * cfg.n_kv_heads)
  ffn_params = cfg.n_layers * (3 if cfg.use_gated_ffn else 2) * d * f
  ffn_rows = ffn_model_rows = 1.0
  if cfg.get("moe_num_experts"):
    ffn_rows = float(cfg.moe_capacity_factor) * int(cfg.moe_top_k)
    ffn_model_rows = float(int(cfg.moe_top_k))
  tokens = b * t
  live = b * n * t * (t + 1) / 2
  pairs = live
  if window:
    # A query at i of its chunk sees the c + i + 1 keys up to it (chunk 0:
    # i + 1); the einsums take all 2c keys of the window.
    nc, c = t // window, window
    pairs = b * n * t * 2 * c
    live = b * n * (nc * c * (c + 1) / 2 + (nc - 1) * c * c)
  unembed = d * cfg.vocab_size * tokens
  k1_runs = 1 if policy == "dots_flash" else 2
  if window:    # plain einsums: forward 4 * hd a pair, backward 8 * hd
    attention = cfg.n_layers * hd * pairs * (
        (2 if policy == "full" else 1) * 4.0 + 8.0)
  else:
    attention = cfg.n_layers * hd * live * (
        k1_runs * 4.0 + (14.0 if split else 10.0))
  executed = ((8.0 if policy == "full" else 6.0)
              * (attn_params + ffn_rows * ffn_params) * tokens
              + attention + (10.0 if fused else 6.0) * unembed)
  model = (6.0 * (attn_params + ffn_model_rows * ffn_params) * tokens
           + cfg.n_layers * 12.0 * hd * live + 6.0 * unembed)
  return executed, model


def _step1(dev, tree, first, configs, base="lm-flops1e19"):
  """{label: (loss, grads)} of step 1 of the named config `base` ("" for
  lm_defaults) (lm_loss_and_grads) for each label's override string, from
  one parameter tree and batch."""
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.train import lm_trainer
  out = {}
  for label, overrides in configs.items():
    c = lm_lib.get_lm_config(base)
    c.override(overrides)
    model = convert.load_jax_params(lm_lib.TransformerLM(c, device=dev), tree)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = lm_trainer.lm_loss_and_grads(model, first)
    torch.cuda.synchronize()
    print(f"step 1, {label} ({overrides}): loss {float(loss):.6f} "
          f"({time.perf_counter() - t0:.2f} s)")
    out[label] = (float(loss), grads)
    del model
  return out


def _step1_check(results, a, b, limits, why, bit_equal=False):
  """|dloss|, the relative difference of the global grad norms and the
  lowest per-leaf cosine of step 1 on paths a and b, within limits; and
  how many grad leaves are bit-equal (with bit_equal, all must be)."""
  import torch
  from automl_tpu_torch.train import lm_trainer
  (loss_a, g_a), (loss_b, g_b) = results[a], results[b]
  norm_a = float(lm_trainer.global_norm(g_a))
  norm_b = float(lm_trainer.global_norm(g_b))
  cos = {k: float(torch.nn.functional.cosine_similarity(
      g_a[k].flatten().double(), g_b[k].flatten().double(), dim=0))
         for k in g_a}
  worst = min(cos, key=cos.get)
  equal = sum(bool(torch.equal(g_a[k], g_b[k])) for k in g_a)
  d_loss, d_norm = abs(loss_a - loss_b), abs(norm_a / norm_b - 1)
  lim_loss, lim_norm, lim_cos = limits
  print(f"step 1, {a} vs {b}: |dloss| {d_loss:.3e} (limit {lim_loss:g}), "
        f"grad norm {norm_a:.5f} vs {norm_b:.5f} (rel. diff {d_norm:.3e}, "
        f"limit {lim_norm:g}), lowest per-leaf cosine {cos[worst]:.7f} at "
        f"{worst} (limit {lim_cos}), {equal} of {len(g_a)} grad leaves "
        f"bit-equal. {why}")
  if not (d_loss <= lim_loss and d_norm <= lim_norm and cos[worst] >= lim_cos
          and (equal == len(g_a) or not bit_equal)):
    raise AssertionError(f"step 1 on the {a} path disagrees with the {b} "
                         "path")


# The counters _train_run reads, by kernel (" sm90": the Hopper kernel's).
TRAIN_KERNELS = ("K1", "K1 sm90", "K2", "K2 sm90", "K5a", "K5a sm90", "K5b",
                 "K5b sm90", "K3a", "K3a sm90", "K3b", "K3b sm90", "K3c",
                 "K3c sm90")


def _train_counters():
  """{kernel: (wrapper, its launch counter)} of TRAIN_KERNELS."""
  from automl_tpu_torch.ops import attention as fa
  from automl_tpu_torch.ops import xent
  return {"K1": (fa.flash_attention, "launches_fwd"),
          "K1 sm90": (fa.flash_attention, "launches_fwd_sm90"),
          "K2": (fa.flash_attention, "launches_bwd"),
          "K2 sm90": (fa.flash_attention, "launches_bwd_sm90"),
          "K5a": (fa.flash_attention, "launches_dq"),
          "K5a sm90": (fa.flash_attention, "launches_dq_sm90"),
          "K5b": (fa.flash_attention, "launches_dkv"),
          "K5b sm90": (fa.flash_attention, "launches_dkv_sm90"),
          "K3a": (xent.fused_softmax_xent, "launches_fwd"),
          "K3a sm90": (xent.fused_softmax_xent, "launches_fwd_sm90"),
          "K3b": (xent.fused_softmax_xent, "launches_dx"),
          "K3b sm90": (xent.fused_softmax_xent, "launches_dx_sm90"),
          "K3c": (xent.fused_softmax_xent, "launches_dw"),
          "K3c sm90": (xent.fused_softmax_xent, "launches_dw_sm90")}


def _train_run(workdir, flags, steps, label, expected, flops, cfg=None,
               batch=8, falls=True):
  """cli/main_lm for `steps` steps with every launch count set to 0 just
  before and read just after; prints the losses and gradient norms, checks
  that the loss is finite and falls (with `falls`) and that the launches
  are `expected` ({kernel: launches}).
  `flops`: (executed, model) FLOPs of a step of `cfg` (default
  lm-flops1e19) at `batch`. Returns {kernel: launches}."""
  import numpy as np
  import torch
  from automl_tpu_torch.cli import main_lm
  from automl_tpu_torch.models import lm as lm_lib

  counters = _train_counters()
  cfg = cfg or lm_lib.get_lm_config("lm-flops1e19")
  torch.cuda.reset_peak_memory_stats()
  for fn, attr in counters.values():
    setattr(fn, attr, 0)
  t0 = time.perf_counter()
  main_lm.main(flags + [f"--train_steps={steps}"])
  wall = time.perf_counter() - t0
  launches = {kid: getattr(fn, attr) for kid, (fn, attr) in counters.items()}
  peak = torch.cuda.max_memory_allocated()
  recs = [json.loads(line) for line in
          open(os.path.join(workdir, "metrics.jsonl")).read().splitlines()]
  valid = [r["validation_loss"] for r in recs if "validation_loss" in r]
  recs = [r for r in recs if "loss" in r]
  losses = [r["loss"] for r in recs]
  secs = [r["secs_per_step"] for r in recs]
  gnorms = [r["gnorm"] for r in recs]
  print(f"losses: {' '.join(f'{x:.4f}' for x in losses)}"
        + (f"; validation loss {valid}" if valid else ""))
  print(f"gradient norms: {' '.join(f'{x:.2f}' for x in gnorms)}")
  if [r["step"] for r in recs] != list(range(1, steps + 1)) or not all(
      math.isfinite(x) for x in losses + valid):
    raise AssertionError("training steps missing or loss not finite")
  if falls and not np.mean(losses[-5:]) < losses[0]:
    raise AssertionError(f"loss did not fall: step 1 {losses[0]:.4f}, mean "
                         f"of the last 5 {np.mean(losses[-5:]):.4f}")
  print(f"launches in the run: {launches} (expected {expected})")
  if launches != expected:
    raise AssertionError("the run did not go through the kernels as "
                         "expected")
  step_s = float(np.median(secs[min(4, steps - 1):]))
  flops, model_flops = flops
  print(f"train b{batch} T{cfg.seq_len} ({label}): {steps} steps in "
        f"{wall:.1f} s (model build included); step "
        f"{step_s * 1e3:.1f} ms (median of steps "
        f"{min(5, steps)}-{steps}), "
        f"{batch * cfg.seq_len / step_s:.0f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB; {flops / 1e12:.2f} TFLOP per step executed "
        f"= {100 * flops / step_s / PEAK_BF16_FLOPS:.2f}% of 989 TFLOP/s, "
        f"{model_flops / 1e12:.2f} TFLOP model = "
        f"{100 * model_flops / step_s / PEAK_BF16_FLOPS:.2f}%; loss "
        f"{losses[0]:.4f} -> {np.mean(losses[-5:]):.4f} (mean of the last 5)")
  return launches


FUSED_CKPT_EVERY = 15
# Steps of phase 5's unfused and dots_flash runs (30 before phase 12 (j),
# then 10; cut for the script's time: the step time is the median of
# steps 5 on).
PHASE5_SHORT_STEPS = 6
# The fused run's Lion lr, a third of lm-flops1e19's 3e-3: phase 12 (j)'s
# target. A step costs the same at any lr; at 1e-3 the draft that (j)
# trains comes to agree with the target in part on README.md's bytes, at
# 3e-3 on neither prompt (PERF.md section 6).
FUSED_LR = 1e-3


def training_phase(dev, workdir):
  """lm-flops1e19 training through main_lm: unfused, with the fused loss,
  and with the split backward under remat_policy dots_flash; returns
  {run: {kernel: launches}} of the three runs."""
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.train import lm_trainer

  batch, steps = 8, 30
  # Step 1 on each path, from the weights and first batch that the runs
  # below start from.
  cfg = lm_lib.get_lm_config("lm-flops1e19")
  tree = convert.numpy_init(cfg, 0)
  first = next(iter(lm_trainer.SyntheticLMData(batch, cfg.seq_len,
                                               cfg.vocab_size)))
  first = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
  flash = "use_flash_attention=true"
  split = f"{flash},flash_bwd_fused=false"
  results = _step1(dev, tree, first, {
      "flash": flash,
      "dense": "use_flash_attention=false",
      "fused pallas": f"{flash},fused_softmax_loss=pallas",
      "unfused bfloat16_vjp": f"{flash},unembed_matmul_dtype=bfloat16_vjp",
      "fused scan": f"{flash},fused_softmax_loss=scan",
      "split": split,
      "split dots": f"{split},remat_policy=dots",
      "split dots_flash": f"{split},remat_policy=dots_flash",
  })
  # The dense path rounds the probabilities to bf16 before p.v (as the JAX
  # dots path does); the kernels keep them in f32, and sum in another
  # order. Measured on the H100: |dloss| 5e-5, norms 7e-6 apart, cosine
  # 0.999996; the limits are 20x, 140x and 40x those.
  _step1_check(results, "flash", "dense", (1e-3, 1e-3, 0.9999),
               "The limits: 20x, 140x, 40x (1 - cosine) of the measured.")
  # Both multiply bf16 operands with f32 sums; K3 rounds dz to bf16 where
  # the unfused backward rounds the cotangent of the logits, and both sum
  # in other orders. Measured on the H100: |dloss| 3.8e-6, norms 8.8e-5
  # apart, cosine 0.9999982.
  _step1_check(results, "fused pallas", "unfused bfloat16_vjp",
               (1e-4, 1e-3, 0.99995),
               "The limits: 26x, 11x, 28x (1 - cosine) of the measured.")
  # The same f32 math taken 256 tokens at a time, in other matmul calls.
  # Measured on the H100: |dloss| 0, norms 2.0e-6 apart, cosine 0.9999982.
  _step1_check(results, "fused scan", "flash", (1e-5, 5e-5, 0.99995),
               "The limits: 1e-5, 25x, 28x (1 - cosine) of the measured.")
  # A remat policy changes what the backward recomputes, never a value: the
  # kernels and matmuls that run again give the same bits. Measured on the
  # H100: the loss and all 82 grad leaves bit-equal, under dots and
  # dots_flash alike; so they must be.
  for policy in ("split dots", "split dots_flash"):
    _step1_check(results, policy, "split", (0.0, 0.0, 0.999999),
                 "Must be bit-equal.", bit_equal=True)
  # The forward is the same, and K5b runs K2's dk / dv code; K5a sums dq
  # over key tiles in registers where K2 adds them in a fixed order in L2,
  # so dq (and all that it feeds) may differ in its last bits. Measured
  # on the H100 with the Hopper K5a / K5b: the loss equal, norms 8.6e-6
  # apart, cosine 0.9999984, 8 of 82 leaves bit-equal.
  _step1_check(results, "split", "flash", (1e-6, 5e-5, 0.99995),
               "The limits: 1e-6, 5.8x, 31x (1 - cosine) of the measured.")
  del results, tree, first
  torch.cuda.empty_cache()

  common = ["--config_name=lm-flops1e19", f"--batch_size={batch}",
            "--warmup_steps=3", "--log_every=1", "--device=cuda"]
  flags = common + [f"--model_dir={workdir}", f"--experiment_config={flash}"]
  n = cfg.n_layers * steps
  short = PHASE5_SHORT_STEPS
  n_short = cfg.n_layers * short
  none = dict.fromkeys(TRAIN_KERNELS, 0)
  t = cfg.seq_len
  runs = {}
  # Full remat re-runs K1 in the backward: 2 x n_layers a step. bf16
  # activations: every K1 and K2 launch is the Hopper kernel's ("sm90").
  sm90 = lambda k1, k2: {"K1": k1, "K1 sm90": k1, "K2": k2, "K2 sm90": k2}
  runs["unfused"] = _train_run(
      workdir, flags, short, "unfused loss, full remat, K2",
      dict(none, **sm90(2 * n_short, n_short)), _step_flops(cfg, batch, t))
  _resume_check(flags, workdir, short)
  # Phase 12 serves this run's directory: (i) its latest step and, with
  # --step, the one FUSED_CKPT_EVERY saves before it; (j) its latest step
  # as the target of a trained draft.
  fused_dir = workdir + "_fused"
  runs["fused"] = _train_run(
      fused_dir, common + [
          f"--model_dir={fused_dir}", f"--ckpt_every={FUSED_CKPT_EVERY}",
          f"--learning_rate={FUSED_LR}",
          f"--experiment_config={flash},fused_softmax_loss=pallas"], steps,
      "fused loss, full remat, K2",
      # bf16 operands at D 1,024: every K3a, K3b and K3c launch the Hopper
      # kernels' (csrc/xent_sm90.cu).
      dict(none, **sm90(2 * n, n), K3a=steps, K3b=steps, K3c=steps,
           **{"K3a sm90": steps, "K3b sm90": steps, "K3c sm90": steps}),
      _step_flops(cfg, batch, t, fused=True))
  split_dir = workdir + "_split"
  # dots_flash saves K1's (out, lse): K1 once per layer and step. Every K5a
  # and K5b launch is the Hopper kernel's. Nothing reads this run's
  # checkpoint: it writes none (2.7 GB less on the disk).
  with _NoCheckpoints():
    runs["split"] = _train_run(
        split_dir, common + [
            f"--model_dir={split_dir}",
            f"--experiment_config={split},remat_policy=dots_flash"], short,
        "unfused loss, remat_policy dots_flash, K5a + K5b",
        dict(none, **sm90(n_short, 0), **{"K5a": n_short,
                                          "K5a sm90": n_short,
                                          "K5b": n_short,
                                          "K5b sm90": n_short}),
        _step_flops(cfg, batch, t, policy="dots_flash", split=True))
  torch.cuda.empty_cache()
  return runs



def _resume_check(flags, workdir, steps, cli="automl_tpu_torch.cli.main_lm"):
  """A rerun of `cli` to steps + 1 must resume from the checkpoint at
  `steps`."""
  import importlib
  importlib.import_module(cli).main(flags + [f"--train_steps={steps + 1}"])
  recs = [json.loads(line) for line in
          open(os.path.join(workdir, "metrics.jsonl")).read().splitlines()]
  if [r["step"] for r in recs][steps:] != [steps + 1]:
    raise AssertionError("the rerun did not resume from the checkpoint")
  print(f"checkpoint at step {steps} restored: the rerun trained only step "
        f"{steps + 1} (loss {recs[-1]['loss']:.4f})")


# ---------------------------------------------------------------------------
# M6: the rest of LM training on the card (lm_training_m6_phase).
# ---------------------------------------------------------------------------

# The config values convert.numpy_init reads: one seeded tree per value set.
_TREE_KEYS = ("param_dtype", "model_dim", "head_dim", "n_layers", "n_heads",
              "n_kv_heads", "expand_factor", "use_combined_qkv",
              "use_per_dim_scale", "use_gated_ffn", "moe_num_experts",
              "use_post_ln", "vocab_size", "tie_embeddings")


class _Trees:
  """convert.numpy_init memoised by the config values it reads, for the
  whole run: every run of a configuration, step-1 checks, main_lm runs and
  generate_lm's seeded models alike, starts from one seeded tree drawn
  once (lm-flops1e19's seed 0 is drawn for some fifteen models). numpy
  draws ~50M normals a second on one core (the default LM's 1.7B take ~35
  s), so prefetch() draws the trees in threads (numpy's fill releases the
  GIL) while the kernels build, and wait() waits for them before anything
  is timed. Inside `with`, convert.numpy_init is this lookup. Every caller
  copies the arrays (load_state_dict), none writes into them."""

  def __init__(self):
    from automl_tpu_torch import convert
    self._convert = convert
    self._draw = convert.numpy_init
    self._trees = {}
    self._pool = concurrent.futures.ThreadPoolExecutor(4)
    self._t0 = time.perf_counter()

  @staticmethod
  def _key(cfg, seed):
    return tuple(cfg.get(k) for k in _TREE_KEYS) + (seed,)

  def prefetch(self, cfg, seed=0):
    from automl_tpu_torch.config import Config
    key = self._key(cfg, seed)
    if key not in self._trees:
      self._trees[key] = self._pool.submit(
          self._draw, Config(cfg.as_dict()), seed)

  def get(self, cfg, seed=0):
    self.prefetch(cfg, seed)
    return self._trees[self._key(cfg, seed)].result()

  def wait(self):
    t = time.perf_counter()
    concurrent.futures.wait(self._trees.values())
    print(f"seeded trees: {len(self._trees)} drawn in "
          f"{time.perf_counter() - self._t0:.1f} s from their start, waited "
          f"{time.perf_counter() - t:.1f} s for them")

  def drop(self, cfg, seed=0):
    self._trees.pop(self._key(cfg, seed), None)

  def __enter__(self):
    self._convert.numpy_init = self.get
    return self

  def __exit__(self, *exc):
    self._convert.numpy_init = self._draw
    self._trees.clear()
    self._pool.shutdown(wait=False, cancel_futures=True)


class _NoCheckpoints:
  """CheckpointManager.save as a no-op for the duration of a `with`: the
  M6 runs resume nothing, and the default LM's and the MoE model's
  checkpoints (weights and Lion momentum in f32) would write 13-14 GB each
  to a machine whose disk takes 45 GiB of writes a run."""

  def __enter__(self):
    from automl_tpu_torch.train import checkpoint
    self._cls, self._save = checkpoint.CheckpointManager, \
        checkpoint.CheckpointManager.save
    self._cls.save = lambda self, step, state: False
    return self

  def __exit__(self, *exc):
    self._cls.save = self._save


def _m6_configs():
  """{run: (Config, its override string)} of the phase: the default LM
  (lm_defaults, flash attention, the fused loss), the MoE and
  chunked-attention variants of lm-flops1e19, lm-flops1e19 itself (the
  prefix-LM run and the dense references) and the JAX flagship's LM
  composition (bench_suite.py's _lm_model + bench_lm_train: D 1,024, 12
  layers, V 32,000, dots_flash with the fused flash backward, the unfused
  loss)."""
  from automl_tpu_torch.models import lm as lm_lib
  out = {}
  for run, (base, overrides) in {
      "default": ("", M6_FLASH + ",fused_softmax_loss=pallas"),
      "moe": ("lm-flops1e19", M6_FLASH + ",fused_softmax_loss=pallas,"
              + M6_MOE),
      "chunk": ("lm-flops1e19", M6_FLASH + ",fused_softmax_loss=pallas,"
                + M6_CHUNK),
      "dense": ("lm-flops1e19", M6_FLASH + ",fused_softmax_loss=pallas"),
      "flagship": ("", M6_FLAGSHIP),
  }.items():
    c = lm_lib.get_lm_config(base)
    c.override(overrides)
    out[run] = (c, overrides)
  return out


M6_FLASH = "use_flash_attention=true"
M6_MOE = "moe_num_experts=8,moe_top_k=2"
M6_CHUNK = "use_window_chunk=true,window_chunk_size=512"
M6_FLAGSHIP = ("model_dim=1024,n_layers=12,n_heads=8,n_kv_heads=8,"
               "head_dim=128,vocab_size=32000,use_flash_attention=true,"
               "remat_policy=dots_flash")
# The first batch size the default LM's probe tries (then up while it
# fits, or down until it does): the prediction of PERF.md section 6.
M6_PROBE_BATCH = 64
# Steps of the default LM's run (at M6_LOW_LR) and of each batch probe:
# 30 and 5 before phase 14 existed, then 20 and 3, cut to make room in
# the script's time (the default LM's step is ~0.89 s, b64's ~6.3 s); the
# probes to 2 with phase 12 (j) (a step after the first is timed).
M6_DEFAULT_STEPS = 20
M6_PROBE_STEPS = 2
# Steps of the MoE run (30 before phase 12 (j); cut for the script's time).
M6_MOE_STEPS = 20
# The default LM's run: a tenth of its config's Lion lr, where the loss
# must fall (at 1e-3 it does not; PERF.md section 6).
M6_LOW_LR = 1e-4
# The generation check's capacity factor: at E / k no slot is dropped in a
# decode step's group of 8 tokens nor in the teacher-forcing forward of
# 575, so the two compute one function (at 1.25 a decode group keeps 2
# slots an expert, JAX's semantics, and drops about a quarter of them).
M6_GEN_CF = 4.0
# The int8 MoE model's greedy tokens against the bf16 model's on one
# prefill: the share of equal argmaxes, JAX's own limit
# (tests/test_lm.py:854, test_int8_moe_router_stays_float_and_serves).
M6_INT8_AGREE = 0.9

# The prefix-LM run's SentencePiece model: the specials, the 256 byte
# pieces, a user-defined piece and a word list (unigram scores), written by
# lm_pipeline.sentencepiece_model_proto with the identity normalizer.
M6_WORDS = ("the", "a", "of", "fish", "swim", "deep", "blue", "sea", "red",
            "coral", "reef", "light", "dark", "water", "sand", "wave",
            "tide", "moon", "sun", "star")
M6_TEXT = "the blue fish <sep> swims deep · ÿ 日本"
# The ids JAX's SentencePieceModel (automl_tpu/data/lm_pipeline.py) gives
# M6_TEXT under that model, computed on the CPU with the JAX package
# (the card's machine has no jax).
M6_TEXT_IDS = (262, 274, 268, 261, 260, 270, 320, 272, 261, 198, 187, 261,
               199, 195, 261, 234, 155, 169, 234, 160, 176)


def _m6_spm_pieces():
  pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<s>", 0.0, 3),
            ("<unk>", 0.0, 2)]
  pieces += [(f"<0x{i:02X}>", 0.0, 6) for i in range(256)]
  pieces += [("<sep>", 0.0, 4), ("▁", -3.0, 1)]
  for i, w in enumerate(M6_WORDS):
    pieces += [("▁" + w, -4.0 - 0.1 * i, 1), (w, -6.0 - 0.1 * i, 1)]
  pieces += [(c, -8.0, 1) for c in "abcdefghijklmnopqrstuvwxyz"]
  return pieces


def _m6_prefix_files(workdir, seed=7, n_train=600, n_valid=64):
  """(model path, train TSV, valid TSV): the SentencePiece model and
  input<TAB>target pairs (the target: the input's words reversed, so that
  the loss can fall)."""
  import numpy as np
  from automl_tpu_torch.data import lm_pipeline
  os.makedirs(workdir, exist_ok=True)
  model = os.path.join(workdir, "m6.model")
  with open(model, "wb") as f:
    f.write(lm_pipeline.sentencepiece_model_proto(_m6_spm_pieces()))
  rng = np.random.default_rng(seed)
  paths = []
  for name, n in (("train", n_train), ("valid", n_valid)):
    lines = []
    for _ in range(n):
      words = list(rng.choice(M6_WORDS, rng.integers(4, 24)))
      lines.append(" ".join(words) + " <sep>\t" + " ".join(words[::-1]))
    paths.append(os.path.join(workdir, f"{name}.tsv"))
    with open(paths[-1], "w") as f:
      f.write("\n".join(lines) + "\n")
  return model, *paths


def _m6_two_chunk_mask(c):
  """causal_mask in place of lm.causal_mask: the chunked local attention's
  mask (chunk i attends causally to chunks i - 1 and i) materialised, for
  the dense path."""
  def mask(q_positions, k_positions, window_size=None, segment_ids_q=None,
           segment_ids_k=None, prefix_q=None, prefix_k=None):
    del window_size, prefix_q, prefix_k
    dist = q_positions[..., :, None] - k_positions[..., None, :]
    chunks = (q_positions[..., :, None] // c) - (k_positions[..., None, :]
                                                  // c)
    m = (dist >= 0) & (chunks <= 1)
    if segment_ids_q is not None:
      m &= segment_ids_q[..., :, None] == segment_ids_k[..., None, :]
    return m
  return mask


def _moe_records():
  """Records the MoE FFN's kept-slot share and aux at every call inside
  TransformerLM.forward (a 0-d tensor each, read after the run: no host
  sync): one record a layer and model call, none from a remat recompute
  in the backward. Returns (records, undo)."""
  from automl_tpu_torch.models import lm as lm_lib
  records = {"kept": [], "aux": []}
  inside = [False]
  slots, forward = lm_lib.MoEFFN.slots, lm_lib.MoEFFN.forward
  lm_forward = lm_lib.TransformerLM.forward

  def rec_lm_forward(self, *a, **k):
    inside[0] = True
    try:
      return lm_forward(self, *a, **k)
    finally:
      inside[0] = False

  def rec_slots(self, *a, **k):
    dest, keep = slots(self, *a, **k)
    if inside[0]:
      records["kept"].append(keep.float().mean().detach())
    return dest, keep

  def rec_forward(self, x):
    out, aux = forward(self, x)
    if inside[0]:
      records["aux"].append(aux.detach())
    return out, aux

  lm_lib.MoEFFN.slots, lm_lib.MoEFFN.forward = rec_slots, rec_forward
  lm_lib.TransformerLM.forward = rec_lm_forward

  def undo():
    lm_lib.MoEFFN.slots, lm_lib.MoEFFN.forward = slots, forward
    lm_lib.TransformerLM.forward = lm_forward
  return records, undo


def _m6_default_lm(dev, trees, workdir, cfg, batch, steps):
  """(A): the default LM: step-1 checks, `steps` steps at M6_LOW_LR, then the largest batch of 8 * 2^n that fits
  for M6_PROBE_STEPS steps. Returns {kernel: launches} of the steps run."""
  import gc
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.train import lm_trainer
  t = cfg.seq_len
  tree = trees.get(cfg)
  n_params = sum(x.size for x in convert.flatten_tree(tree).values())
  print(f"(A) the default LM (lm_defaults: d {cfg.model_dim}, {cfg.n_layers} "
        f"layers, {cfg.n_heads} heads, V {cfg.vocab_size}; {n_params} "
        f"params), b{batch} T{t}, flash attention, Lion")
  first = next(iter(lm_trainer.SyntheticLMData(batch, t, cfg.vocab_size)))
  first = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
  # The two pairs one at a time: each holds two sets of 1.7B gradients.
  res = _step1(dev, tree, first, {
      "fused pallas": f"{M6_FLASH},fused_softmax_loss=pallas",
      "unfused bfloat16_vjp": f"{M6_FLASH},unembed_matmul_dtype=bfloat16_vjp",
  }, base="")
  _step1_check(res, "fused pallas", "unfused bfloat16_vjp",
               (1e-4, 1e-3, 0.99995), "The limits of phase 5 (lm-flops1e19).")
  del res
  torch.cuda.empty_cache()
  res = _step1(dev, tree, first, {
      "fused scan": f"{M6_FLASH},fused_softmax_loss=scan",
      "flash": M6_FLASH}, base="")
  _step1_check(res, "fused scan", "flash", (1e-5, 5e-5, 0.99995),
               "The limits of phase 5 (lm-flops1e19).")
  del res, first
  torch.cuda.empty_cache()

  overrides = f"{M6_FLASH},fused_softmax_loss=pallas"
  common = [f"--experiment_config={overrides}", "--warmup_steps=3",
            "--log_every=1", "--device=cuda"]

  def expected(n):
    k = cfg.n_layers * n
    none = dict.fromkeys(("K5a", "K5a sm90", "K5b", "K5b sm90"), 0)
    return dict(none, **{"K1": 2 * k, "K1 sm90": 2 * k, "K2": k,
                         "K2 sm90": k, "K3a": n, "K3a sm90": n, "K3b": n,
                         "K3b sm90": n, "K3c": n, "K3c sm90": n})

  # The config's own Lion lr 1e-3 (warmup 3) does not bring the loss down
  # in 20-30 steps at these widths: the gradient norm grows from step 4 on,
  # in the JAX package's step as in this one (PERF.md section 6;
  # tests/test_torch_lm_train.py::test_default_lm_widths_lion_matches_jax).
  # The one run is at M6_LOW_LR, where the loss must fall (a run at 1e-3
  # beside it, of the same step, was cut for the script's time).
  d = os.path.join(workdir, f"b{batch}_lr{M6_LOW_LR:g}")
  launches = _train_run(
      d, common + [f"--model_dir={d}", f"--batch_size={batch}",
                   f"--learning_rate={M6_LOW_LR}"], steps,
      f"the default LM at lr {M6_LOW_LR:g}, fused loss, full remat, K2",
      expected(steps), _step_flops(cfg, batch, t, fused=True), cfg=cfg,
      batch=batch)
  torch.cuda.empty_cache()

  def fits(b):
    d = os.path.join(workdir, f"b{b}")
    try:
      got = _train_run(
          d, common + [f"--model_dir={d}", f"--batch_size={b}"],
          M6_PROBE_STEPS, f"the default LM at b{b}, {M6_PROBE_STEPS} steps",
          expected(M6_PROBE_STEPS),
          _step_flops(cfg, b, t, fused=True), cfg=cfg, batch=b, falls=False)
    except torch.OutOfMemoryError as e:
      print(f"  b{b}: out of memory ({str(e).splitlines()[0][:120]})")
      got = None
    gc.collect()
    torch.cuda.empty_cache()
    return got

  b = M6_PROBE_BATCH
  best = None
  if (got := fits(b)) is not None:
    best = (b, got)
    while (got := fits(2 * b)) is not None:
      b *= 2
      best = (b, got)
  else:
    while b > batch and best is None:
      b //= 2
      if (got := fits(b)) is not None:
        best = (b, got)
  if best is None:
    raise AssertionError("the default LM fits at no batch above b8")
  print(f"  the largest batch of 8 * 2^n that fits: b{best[0]}")
  return {k: launches[k] + best[1][k] for k in launches}


def _moe_step1_checks(dev, trees, cfg, dense_cfg, batch):
  """(B) 1: E = 1 with ample capacity against the dense FFN, and routing
  groups of 4096 against 2048 at a capacity where nothing drops."""
  import numpy as np
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.train import lm_trainer
  t = cfg.seq_len
  first = next(iter(lm_trainer.SyntheticLMData(batch, t, cfg.vocab_size)))
  first = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
  dense_tree = trees.get(dense_cfg)
  # E = 1: the dense tree's FFN with an expert axis of 1 and a router
  # [L, d, 1] (a softmax over one expert is 1 whatever its logit).
  flat = dict(convert.flatten_tree(dense_tree))
  for name in ("w0", "w1", "wg"):
    flat[f"blocks/ffn/{name}"] = flat[f"blocks/ffn/{name}"][:, None]
  flat["blocks/ffn/router"] = np.random.default_rng(3).standard_normal(
      (cfg.n_layers, cfg.model_dim, 1)).astype(np.float32) * np.float32(
          cfg.model_dim ** -0.5)
  base = f"{M6_FLASH},fused_softmax_loss=pallas"
  res = _step1(dev, convert.unflatten_tree(flat), first, {
      "moe E=1": f"{base},moe_num_experts=1,moe_top_k=1,"
                 "moe_capacity_factor=1.0"})
  res.update(_step1(dev, dense_tree, first, {"dense FFN": base}))
  del flat
  loss, grads = res["moe E=1"]
  router = [g for k, g in grads.items() if k.endswith("ffn.router")]
  if any(bool(g.abs().max() != 0) for g in router):
    raise AssertionError("E = 1: the router got a nonzero gradient")
  # The loss adds 0.01 x aux, aux = 1 a layer exactly at E = 1.
  aux = float(cfg.moe_aux_loss_weight) * cfg.n_layers
  res["moe E=1"] = (loss - aux, {k: (g[0] if ".ffn.w" in k else g)
                                 for k, g in grads.items()
                                 if not k.endswith("ffn.router")})
  print(f"  E = 1: the aux term {aux:g} taken off the loss; the router's "
        "gradient is exactly 0 (checked)")
  _step1_check(res, "moe E=1", "dense FFN", (1e-4, 1e-3, 0.99995),
               "The limits: PERF.md section 6's prediction.")
  del res, grads, router
  torch.cuda.empty_cache()
  res = _step1(dev, trees.get(cfg), first, {
      "groups of 4096": f"{base},{M6_MOE},moe_capacity_factor=4.0",
      "groups of 2048": f"{base},{M6_MOE},moe_capacity_factor=4.0,"
                        "moe_group_size=2048"})
  _step1_check(res, "groups of 4096", "groups of 2048", (1e-5, 1e-4, 0.9999),
               "Capacity factor 4 = E / k: no slot dropped in either. "
               "The limits: PERF.md section 6's prediction.")
  del res, first
  torch.cuda.empty_cache()


def _moe_generation(dev, trees, cfg):
  """(B) 3-4: greedy_generate 64 tokens after 512 at b8 through K4 (S
  576), teacher-forced against the model's own full forward, at capacity
  factors 1.25 (reported) and M6_GEN_CF (checked); then the int8 model's
  router. Returns the K4 launches."""
  import numpy as np
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm as lm_lib
  flat = dict(convert.flatten_tree(trees.get(cfg)))
  rng = np.random.default_rng(100)
  for path, value in flat.items():
    if path.endswith("scale"):
      flat[path] = (LM_NORM_SIGMA * rng.standard_normal(value.shape)).astype(
          np.float32)
  tree = convert.unflatten_tree(flat)
  del flat
  b, t0, new = 8, 512, 64
  prompt = torch.from_numpy(np.random.default_rng(101).integers(
      3, cfg.vocab_size, (b, t0))).to(dev)
  k4 = 0
  for cf in (1.25, M6_GEN_CF):
    c = lm_lib.get_lm_config("lm-flops1e19")
    c.override(f"{M6_FLASH},{M6_MOE},moe_capacity_factor={cf},"
               "decode_kernel_min_s=0")
    model = lm_lib.cast_lm_params_for_serving(convert.load_jax_params(
        lm_lib.TransformerLM(c, device=dev), tree))
    records, undo = _moe_records()
    _k4_reset()
    try:
      t = time.perf_counter()
      out = lm_lib.greedy_generate(model, prompt, new)
      torch.cuda.synchronize()
      wall = time.perf_counter() - t
    finally:
      undo()
    label = f"MoE greedy b{b} {t0} + {new}, capacity factor {cf}"
    k4 += _k4_expect(label, c.n_layers * new)
    kept = torch.stack(records["kept"]).cpu()
    print(f"  {label}: {wall:.2f} s; dropped slots: prefill "
          f"{1 - float(kept[:c.n_layers].mean()):.4f} (groups of "
          f"{model.blocks[0].ffn.routing(b * t0)[0]}), decode "
          f"{1 - float(kept[c.n_layers:].mean()):.4f} (groups of {b})")
    seqs = [(prompt[i].tolist(), out[i, t0:].tolist()) for i in range(b)]
    # At 1.25 a decode step and the full forward drop other slots: the
    # shares are reported, not held to the limits.
    _teacher_forced(model, label, seqs, check=cf == M6_GEN_CF)
    del records
  with torch.inference_mode():
    want = model(prompt)[0].argmax(-1)
    lm_lib.quantize_lm_params(model)
    got = model(prompt)[0].argmax(-1)
  router = model.blocks[0].ffn.router
  agree = float((got == want).float().mean())
  print(f"  int8 MoE model: router {type(router).__name__} "
        f"{router.dtype}, expert w0 {type(model.blocks[0].ffn.w0).__name__}; "
        f"prefill argmax agreement with bf16 {agree:.4f} (limit "
        f"{M6_INT8_AGREE})")
  if not (isinstance(router, torch.nn.Parameter)
          and router.dtype == torch.float32
          and isinstance(model.blocks[0].ffn.w0, lm_lib.QuantizedWeight)
          and agree >= M6_INT8_AGREE):
    raise AssertionError("int8 MoE: the router was quantised or the model "
                         "disagrees")
  del model, tree, out
  torch.cuda.empty_cache()
  return k4


def lm_training_m6_phase(dev, workdir, trees):
  """M6 on the card, runs (A)-(E) (the module docstring's phase 5b);
  returns {kernel: launches} of its runs (each counted from 0 just before
  the run, read just after), K4 under "K4"."""
  import torch
  from automl_tpu_torch.data import lm_pipeline
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.train import lm_trainer

  t_phase = time.perf_counter()
  cfgs = _m6_configs()
  totals = {}

  def add(launches):
    for k, v in launches.items():
      totals[k] = totals.get(k, 0) + v

  none = dict.fromkeys(("K1", "K1 sm90", "K2", "K2 sm90", "K5a", "K5a sm90",
                        "K5b", "K5b sm90", "K3a", "K3a sm90", "K3b",
                        "K3b sm90", "K3c", "K3c sm90"), 0)

  def k3(n):
    return {"K3a": n, "K3a sm90": n, "K3b": n, "K3b sm90": n, "K3c": n,
            "K3c sm90": n}

  with _NoCheckpoints():
    # (A)
    t = time.perf_counter()
    cfg = cfgs["default"][0]
    add(_m6_default_lm(dev, trees, os.path.join(workdir, "default"), cfg,
                       8, M6_DEFAULT_STEPS))
    trees.drop(cfg)
    print(f"(A) {time.perf_counter() - t:.1f} s")

    # (B)
    t = time.perf_counter()
    cfg, dense = cfgs["moe"][0], cfgs["dense"][0]
    print(f"(B) MoE at lm-flops1e19's width: {cfg.moe_num_experts} experts, "
          f"top-{cfg.moe_top_k}, capacity factor {cfg.moe_capacity_factor}, "
          f"groups of {cfg.moe_group_size}, aux weight "
          f"{cfg.moe_aux_loss_weight}, flash attention, the fused loss")
    _moe_step1_checks(dev, trees, cfg, dense, 8)
    d = os.path.join(workdir, "moe")
    records, undo = _moe_records()
    try:
      steps = M6_MOE_STEPS
      n = cfg.n_layers * steps
      launches = _train_run(
          d, ["--config_name=lm-flops1e19", "--batch_size=8",
              "--warmup_steps=3", "--log_every=1", "--device=cuda",
              f"--model_dir={d}",
              f"--experiment_config={cfgs['moe'][1]}"], steps,
          "MoE, fused loss, full remat, K2",
          dict(none, **{"K1": 2 * n, "K1 sm90": 2 * n, "K2": n,
                        "K2 sm90": n}, **k3(steps)),
          _step_flops(cfg, 8, cfg.seq_len, fused=True), cfg=cfg)
    finally:
      undo()
    add(launches)
    aux_steps = torch.stack(records["aux"]).cpu().reshape(steps, -1).sum(1)
    drop_steps = 1 - torch.stack(records["kept"]).cpu().reshape(
        steps, cfg.n_layers).mean(1)
    print(f"  MoE run: aux (summed over {cfg.n_layers} layers) step 1 "
          f"{float(aux_steps[0]):.4f}, step {steps} "
          f"{float(aux_steps[-1]):.4f} (perfect balance {cfg.n_layers}); "
          f"dropped slots step 1 {float(drop_steps[0]):.4f}, step {steps} "
          f"{float(drop_steps[-1]):.4f}, "
          f"mean {float(drop_steps.mean()):.4f}")
    del records
    totals["K4"] = _moe_generation(dev, trees, cfg)
    totals["K4 sm90"] = totals["K4"]
    trees.drop(cfg)
    print(f"(B) {time.perf_counter() - t:.1f} s")

    # (C)
    t = time.perf_counter()
    cfg = cfgs["chunk"][0]
    c = int(cfg.window_chunk_size)
    print(f"(C) chunked local attention at lm-flops1e19's width, chunks of "
          f"{c}, the fused loss")
    first = next(iter(lm_trainer.SyntheticLMData(8, cfg.seq_len,
                                                 cfg.vocab_size)))
    first = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
    base = "fused_softmax_loss=pallas"
    res = _step1(dev, trees.get(dense), first,
                 {"window chunk": cfgs["chunk"][1]})
    mask_fn = lm_lib.causal_mask
    lm_lib.causal_mask = _m6_two_chunk_mask(c)
    try:
      res.update(_step1(dev, trees.get(dense), first, {
          "dense, the two-chunk mask": f"use_flash_attention=false,{base}"}))
    finally:
      lm_lib.causal_mask = mask_fn
    _step1_check(res, "window chunk", "dense, the two-chunk mask",
                 (1e-3, 1e-3, 0.9999), "The flash-against-dense limits.")
    del res, first
    torch.cuda.empty_cache()
    d = os.path.join(workdir, "chunk")
    add(_train_run(
        d, ["--config_name=lm-flops1e19", "--batch_size=8",
            "--warmup_steps=3", "--log_every=1", "--device=cuda",
            f"--model_dir={d}", f"--experiment_config={cfgs['chunk'][1]}"],
        10, "chunked local attention, fused loss, full remat",
        dict(none, **k3(10)),
        _step_flops(cfg, 8, cfg.seq_len, fused=True, window=c), cfg=cfg))
    print(f"(C) {time.perf_counter() - t:.1f} s")

    # (D)
    t = time.perf_counter()
    cfg = cfgs["dense"][0]
    spm, train, valid = _m6_prefix_files(os.path.join(workdir, "prefix_data"))
    tok = lm_pipeline.SentencePieceModel(spm)
    ids = tok.encode(M6_TEXT)
    print(f"(D) prefix-LM from files with a SentencePiece model ({spm}: "
          f"{tok.vocab_size} pieces): {M6_TEXT!r} -> {ids}; the JAX "
          f"package's ids {list(M6_TEXT_IDS)}; decoded {tok.decode(ids)!r}")
    if ids != list(M6_TEXT_IDS):
      raise AssertionError("SentencePiece ids differ from the JAX package's")
    loader = lm_pipeline.PrefixLMLoader.from_tsv_file(
        train, 8, cfg.seq_len, tokenizer=tok)
    first = {k: torch.from_numpy(v).to(dev)
             for k, v in next(iter(loader)).items()}
    print(f"  first batch: {int(first['causal_attention'].sum())} prefix "
          f"tokens, {int((first['loss_weights'] > 0).sum())} with a loss "
          f"weight, {int(first['segment_ids'].max())} examples")
    plain = {k: v for k, v in first.items() if k != "causal_attention"}
    zero = dict(plain, causal_attention=torch.zeros_like(
        first["causal_attention"]))
    base = f"{M6_FLASH},fused_softmax_loss=pallas"
    res = _step1(dev, trees.get(cfg), zero, {"zero prefix markers": base})
    res.update(_step1(dev, trees.get(cfg), plain, {"plain causal": base}))
    _step1_check(res, "zero prefix markers", "plain causal",
                 (1e-3, 1e-3, 0.9999), "The flash-against-dense limits.")
    del res, first, plain, zero
    torch.cuda.empty_cache()
    d = os.path.join(workdir, "prefix")
    # The markers take the materialised mask (as in JAX), so no K1 / K2.
    add(_train_run(
        d, ["--config_name=lm-flops1e19", "--batch_size=8",
            "--warmup_steps=3", "--log_every=1", "--device=cuda",
            f"--model_dir={d}", f"--experiment_config={base}",
            "--prefix_lm", f"--tokenizer={spm}", f"--train_file={train}",
            f"--valid_file={valid}", "--eval_every=10", "--eval_steps=1"],
        10, "prefix-LM from files, fused loss, full remat",
        dict(none, **k3(10)), _step_flops(cfg, 8, cfg.seq_len, fused=True),
        cfg=cfg))
    # lm-flops1e19's tree stays: the phases after this one start from it.
    print(f"(D) {time.perf_counter() - t:.1f} s")

    # (E)
    t = time.perf_counter()
    cfg = cfgs["flagship"][0]
    print("(E) the JAX flagship's LM composition (bench_suite.py:355-381): "
          f"d {cfg.model_dim}, {cfg.n_layers} layers, V {cfg.vocab_size}, "
          "b8 T2048, Lion, dots_flash with the fused flash backward")
    d = os.path.join(workdir, "flagship")
    n = cfg.n_layers * 30
    add(_train_run(
        d, ["--batch_size=8", "--warmup_steps=3", "--log_every=1",
            "--device=cuda", f"--model_dir={d}",
            f"--experiment_config={M6_FLAGSHIP}"], 30,
        "the flagship, unfused loss, dots_flash, K2",
        dict(none, **{"K1": n, "K1 sm90": n, "K2": n, "K2 sm90": n}),
        _step_flops(cfg, 8, cfg.seq_len, policy="dots_flash"), cfg=cfg))
    trees.drop(cfg)
    print(f"(E) {time.perf_counter() - t:.1f} s")
  torch.cuda.empty_cache()
  print(f"M6 phase launches: {totals}")
  print(f"M6 phase: {time.perf_counter() - t_phase:.1f} s")
  return totals


# K6 against its plain version: both sum f32 products of the same inputs,
# in other orders, over B*H*W terms per output; relative to the largest
# entry of the result. Measured on the H100 at the slice's shapes (the
# kernel of depthwise.cu): 2.3e-7, 4.1e-7 and 2.5e-7; the limit is 24x the
# largest.
K6_SHARE = 1e-5

# EfficientDet-D0's stride-1 depthwise convs at 512 x 512 (C, H, W, k) and
# their calls in a training step (76 in all), recorded with the port.
D0_K6_SHAPES = {(32, 256, 256, 3): 1, (144, 128, 128, 3): 1,
                (64, 64, 64, 3): 11, (240, 64, 64, 5): 1, (64, 32, 32, 3): 14,
                (672, 32, 32, 5): 2, (480, 32, 32, 5): 1, (480, 32, 32, 3): 2,
                (64, 16, 16, 3): 14, (1152, 16, 16, 3): 1,
                (1152, 16, 16, 5): 3, (64, 8, 8, 3): 14, (64, 4, 4, 3): 11}


def k6_phase(dev, flush):
  """K6 vs its plain version at every map of a D0 step (bf16, b16: the
  Hopper kernel of depthwise_sm90.cu, with the kernel of depthwise.cu,
  reached with _simt, and cuDNN's weight gradient timed in turns in the
  same call) and on small cases; returns {shape label: dict(err, ms,
  plain_ms, library_ms, bound_ms, bound_by, simt_ms, launches)}."""
  import torch
  from automl_tpu_torch.ops import depthwise as dw
  gen = torch.Generator(device=dev).manual_seed(3)
  cl = torch.channels_last
  f = dw.depthwise_filter_grad

  def inputs(b, c, h, w, dtype):
    return [torch.randn((b, c, h, w), generator=gen, device=dev).to(dtype)
            .contiguous(memory_format=cl) for _ in range(2)]

  kern, ref = dw.depthwise_filter_grad_kernel, dw.depthwise_filter_grad_reference
  print(f"K6 case 1: every stride-1 depthwise conv map of a D0 step, bf16, "
        f"b16 ({sum(D0_K6_SHAPES.values())} calls a step)")
  res = {}
  b = 16
  for (c, h, w, k), per_step in D0_K6_SHAPES.items():
    label = f"[{b},{c},{h},{w}] k{k}"
    x, dy = inputs(b, c, h, w, torch.bfloat16)
    before = f.launches_sm90
    got = kern(x, dy, k)
    torch.cuda.synchronize()
    if f.launches_sm90 != before + 1:
      raise AssertionError(f"K6 {label}: did not go to the Hopper kernel")
    err = _compare_scaled(label, got, ref(x, dy, k), K6_SHARE)
    # No atomics in a sum: fixed partial sums, summed in a fixed order.
    if not torch.equal(got, kern(x, dy, k)):
      raise AssertionError(f"K6 gave two results on the same inputs: {label}")
    _compare_scaled(f"{label} (depthwise.cu)", kern(x, dy, k, _simt=True),
                    got, K6_SHARE)
    pad = (k - 1) // 2
    weight = torch.randn((c, 1, k, k), generator=gen, device=dev).to(
        torch.bfloat16)

    def make_lib(x=x, dy=dy, weight=weight, pad=pad, c=c):
      def fn():
        return torch.ops.aten.convolution_backward(
            dy, x, weight, None, [1, 1], [pad, pad], [1, 1], False, [0, 0],
            c, [False, True, False])[1]
      lib = fn().float()
      print(f"  {label}: cuDNN's weight gradient (bf16) against the plain "
            f"version: max|diff| {float((lib - got).abs().max()):.3e} of "
            f"max|dW| {float(got.abs().max()):.3e}")
      return fn

    new = lambda x=x, dy=dy, k=k: kern(x, dy, k)
    old = lambda x=x, dy=dy, k=k: kern(x, dy, k, _simt=True)
    turns = [_time_ms(fn, 20, flush) for fn in (new, old, old, new)]
    t_new, t_old = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    t_ref = _time_ms(lambda: ref(x, dy, k), 3, flush)
    t_lib = _library_ms(label, make_lib, 20, flush,
                        "cuDNN depthwise weight gradient")
    n = b * c * h * w
    # x and dy read once (bf16), dW written (f32); 2 k^2 f32 flops per
    # element of dy.
    bound_ms, bound_by = _bound(2.0 * k * k * n, 2 * 2 * n + 4 * c * k * k,
                                PEAK_F32_FLOPS)
    res[label] = dict(err=err, ms=t_new, plain_ms=t_ref, library_ms=t_lib,
                      bound_ms=bound_ms, bound_by=bound_by, simt_ms=t_old,
                      launches=per_step)
    plan = dw.sm90_plan(b, c, h, w, k, dw._sms(dev.index or 0))
    print(f"  {label} ({per_step} a step; plan {tuple(plan)}): Hopper kernel "
          f"{t_new:.4f} ms ({turns[0]:.4f}, {turns[3]:.4f}), depthwise.cu "
          f"{t_old:.4f} ms ({turns[1]:.4f}, {turns[2]:.4f}), cuDNN "
          f"{t_lib if t_lib is None else round(t_lib, 4)} ms, plain "
          f"{t_ref:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{100 * bound_ms / t_new:.2f}% of it (in turns, L2 flushed before "
          "each call)")
    del x, dy, got
  torch.cuda.empty_cache()
  sums = {key: sum(r["launches"] * r[key] for r in res.values())
          for key in ("ms", "simt_ms", "bound_ms")}
  lib_sum = (None if any(r["library_ms"] is None for r in res.values())
             else sum(r["launches"] * r["library_ms"] for r in res.values()))
  print(f"K6 over a D0 step ({sum(D0_K6_SHAPES.values())} calls, the sums "
        f"of calls x time): Hopper kernel {sums['ms']:.4f} ms, depthwise.cu "
        f"{sums['simt_ms']:.4f} ms, cuDNN "
        f"{'n/a' if lib_sum is None else f'{lib_sum:.4f}'} ms, bound "
        f"{sums['bound_ms']:.4f} ms")
  print("K6 case 2: small cases (C not a multiple of 8 and float32 take "
        "depthwise.cu)")
  for name, (b, c, h, w, k, dtype) in {
      "f32 ragged 15x17 k5 C13 b1": (1, 13, 15, 17, 5, torch.float32),
      "bf16 ragged 15x17 k3 C13 b1": (1, 13, 15, 17, 3, torch.bfloat16),
      "f32 k7 C33 (two channel chunks)": (2, 33, 9, 70, 7, torch.float32),
      "f32 BiFPN level 7 4x4 k3": (16, 64, 4, 4, 3, torch.float32),
      "f32 k1": (2, 8, 5, 6, 1, torch.float32),
      "bf16 k7 C40 (five chunks of 8)": (2, 40, 9, 70, 7, torch.bfloat16),
      "bf16 k1 C8": (2, 8, 5, 6, 1, torch.bfloat16),
      "bf16 ragged 15x17 k5 C24 b3": (3, 24, 15, 17, 5, torch.bfloat16),
      "bf16 C136 33x31 k3 b7 (a ragged chunk)": (7, 136, 33, 31, 3,
                                                 torch.bfloat16)}.items():
    x, dy = inputs(b, c, h, w, dtype)
    before = f.launches_sm90
    got = dw.depthwise_filter_grad(x, dy, k)
    sm90 = f.launches_sm90 - before
    if sm90 != int(dw.takes_sm90(dtype, c)):
      raise AssertionError(f"K6 {name}: routed to the wrong kernel")
    _compare_scaled(f"{name} ({'Hopper' if sm90 else 'depthwise.cu'})", got,
                    ref(x, dy, k), K6_SHARE)
    if sm90 and not torch.equal(got, dw.depthwise_filter_grad(x, dy, k)):
      raise AssertionError(f"K6 gave two results on the same inputs: {name}")
  torch.cuda.synchronize()
  return res


D0_BATCH = 16


def _det_config(**overrides):
  from automl_tpu_torch.configs.efficientdet_configs import (
      get_efficientdet_config)
  cfg = get_efficientdet_config("efficientdet-d0")
  cfg.override(dict(mixed_precision=True, batch_size=D0_BATCH, **overrides))
  return cfg


def _det_step1(dev, cfg):
  """(loss, grads) of step 1 of D0 with the K6 knob off and on, from one
  model (seeded weights) and one preprocessed batch, the drop_connect masks
  drawn from one seed in both."""
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.ops import depthwise as dw
  from automl_tpu_torch.train import runners, train_lib
  precision.set_policy("mixed_bfloat16")
  model = runners.seeded_detection_model(cfg, 0, dev)
  params = convert.model_state(model)
  raw = pipeline.SyntheticDetection(D0_BATCH, cfg.image_size, cfg.max_instances_per_image,
                                    cfg.num_classes).batch
  raw = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
  gen = torch.Generator(device=dev)
  batch = runners.make_preprocess(cfg)(raw, gen.manual_seed(7))
  loss_and_grads = train_lib.make_det_loss_and_grads(model, cfg)
  out = {}
  for knob in (False, True):
    dw.enable_pallas_filter_grad(knob)
    try:
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      loss, _, grads, _ = loss_and_grads(params, batch, None,
                                         gen.manual_seed(8))
      torch.cuda.synchronize()
    finally:
      dw.enable_pallas_filter_grad(False)
    print(f"D0 step 1, K6 knob {'on' if knob else 'off'}: loss "
          f"{float(loss):.6f} ({time.perf_counter() - t0:.2f} s)")
    out[knob] = (float(loss), grads)
  k6_leaves = sorted(
      f"{name}.kernel" for name, m in model.named_modules()
      if type(m).__name__ == "DepthwiseConv2D" and m.strides == (1, 1))
  return out, k6_leaves


def _det_step1_check(out, k6_leaves, what="D0"):
  """The knob changes only how the depthwise filter gradients are summed:
  the loss is the same, those grads agree to bf16 rounding (both are
  rounded to the bf16 compute dtype from f32 sums in other orders), the
  rest to the last bits of the dx they feed."""
  import torch
  (loss_off, g_off), (loss_on, g_on) = out[False], out[True]

  def cos(a, b):
    return float(torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0))

  def rel(a, b):
    return float((a.float() - b.float()).abs().max() /
                 b.float().abs().max().clamp_min(1e-30))

  d_loss = abs(loss_on - loss_off)
  k6 = {k: (cos(g_on[k], g_off[k]), rel(g_on[k], g_off[k]))
        for k in k6_leaves}
  rest = [k for k in g_off if k not in k6 and g_off[k].abs().max() > 0]
  others = {k: (cos(g_on[k], g_off[k]), rel(g_on[k], g_off[k]))
            for k in rest}
  worst_cos = min(k6, key=lambda k: k6[k][0])
  worst_rel = max(k6, key=lambda k: k6[k][1])
  o_cos = min(others, key=lambda k: others[k][0])
  o_rel = max(others, key=lambda k: others[k][1])
  print(f"{what} step 1, knob on vs off: |dloss| {d_loss:.3e} (limit "
        f"{DET_STEP1_LIMITS['loss']:g}); {len(k6)} depthwise kernel grads: "
        f"lowest cosine {k6[worst_cos][0]:.7f} at {worst_cos} (limit "
        f"{DET_STEP1_LIMITS['k6_cos']}), largest max|diff| / max|grad| "
        f"{k6[worst_rel][1]:.3e} at {worst_rel} (limit "
        f"{DET_STEP1_LIMITS['k6_rel']:g}); {len(others)} other grads: lowest "
        f"cosine {others[o_cos][0]:.7f} at {o_cos} (limit "
        f"{DET_STEP1_LIMITS['other_cos']}), largest max|diff| / max|grad| "
        f"{others[o_rel][1]:.3e} at {o_rel} (limit "
        f"{DET_STEP1_LIMITS['other_rel']:g})")
  if not (d_loss <= DET_STEP1_LIMITS["loss"]
          and k6[worst_cos][0] >= DET_STEP1_LIMITS["k6_cos"]
          and k6[worst_rel][1] <= DET_STEP1_LIMITS["k6_rel"]
          and others[o_cos][0] >= DET_STEP1_LIMITS["other_cos"]
          and others[o_rel][1] <= DET_STEP1_LIMITS["other_rel"]):
    raise AssertionError(f"{what} step 1 with the K6 knob on disagrees with "
                         "the knob off")


# Step 1 limits, knob on vs off. Measured on the H100 (b16, bf16): the
# loss equal, the depthwise kernel grads at most 1.3e-3 of a leaf's largest
# entry apart (a bf16 step: both are rounded to bf16 from f32 sums in other
# orders), cosine 1.0000000 to 7 digits, every other grad bit-equal (the
# same cuDNN dx). The limits: 1e-6, 7.7x, 1e-4 and 1e-3 off those.
DET_STEP1_LIMITS = dict(loss=1e-6, k6_cos=0.9999, k6_rel=1e-2,
                        other_cos=0.99999, other_rel=1e-3)


def _det_train_run(workdir, flags, steps, knob, per_step):
  """cli/main_det for `steps` steps with the K6 knob set in-process and its
  launch count set to 0 just before and read just after; checks that the
  loss is finite and falls. Returns (launches, step ms, img/s, peak GiB)."""
  import numpy as np
  import torch
  from automl_tpu_torch.cli import main_det
  from automl_tpu_torch.ops import depthwise as dw
  torch.cuda.reset_peak_memory_stats()
  dw.enable_pallas_filter_grad(knob)
  dw.depthwise_filter_grad.launches = 0
  dw.depthwise_filter_grad.launches_sm90 = 0
  t0 = time.perf_counter()
  try:
    main_det.main(flags + [f"--train_steps={steps}"])
  finally:
    dw.enable_pallas_filter_grad(False)
  wall = time.perf_counter() - t0
  launches = dw.depthwise_filter_grad.launches
  sm90 = dw.depthwise_filter_grad.launches_sm90
  peak = torch.cuda.max_memory_allocated() / 2**30
  recs = [json.loads(line) for line in
          open(os.path.join(workdir, "metrics.jsonl")).read().splitlines()]
  losses = [r["loss"] for r in recs]
  print(f"losses (K6 knob {'on' if knob else 'off'}): "
        f"{' '.join(f'{x:.4f}' for x in losses)}")
  if [r["step"] for r in recs] != list(range(1, steps + 1)) or not all(
      math.isfinite(x) for x in losses):
    raise AssertionError("training steps missing or loss not finite")
  if not np.mean(losses[-5:]) < losses[0]:
    raise AssertionError(f"loss did not fall: step 1 {losses[0]:.4f}, mean "
                         f"of the last 5 {np.mean(losses[-5:]):.4f}")
  expected = per_step * steps if knob else 0
  print(f"K6 launches in the run: {launches}, {sm90} of them the Hopper "
        f"kernel's (expected {expected}: {per_step} per step x {steps} steps "
        "with the knob on, all Hopper; 0 off)")
  if launches != expected or sm90 != expected:
    raise AssertionError("the run did not go through K6 as expected")
  step_s = float(np.median([r["secs_per_step"] for r in recs][4:]))
  print(f"D0 train b{D0_BATCH} 512x512 bf16, K6 knob "
        f"{'on' if knob else 'off'}: {steps} steps in {wall:.1f} s (model "
        f"build included); step {step_s * 1e3:.1f} ms (median of steps "
        f"5-{steps}), {D0_BATCH / step_s:.1f} img/s, peak memory "
        f"{peak:.2f} GiB; loss {losses[0]:.4f} -> {np.mean(losses[-5:]):.4f} "
        "(mean of the last 5)")
  return launches, step_s * 1e3, D0_BATCH / step_s, peak


def detection_phase(dev, workdir):
  """EfficientDet-D0 training: step 1 knob on vs off, then 20 steps through
  main_det with the knob on (and a resume to 21) and 20 with it off.
  Returns the knob-on run's K6 launches and the knob-off run's step ms."""
  import torch
  from automl_tpu_torch.models import efficientdet
  cfg = _det_config()
  out, k6_leaves = _det_step1(dev, cfg)
  _det_step1_check(out, k6_leaves)
  del out
  torch.cuda.empty_cache()
  per_step = efficientdet.filter_grad_calls_per_step(
      efficientdet.EfficientDet(cfg, device="meta"))
  steps = 20
  flags = ["--mode=train", "--model_name=efficientdet-d0", "--use_fake_data",
           f"--hparams=mixed_precision=true,batch_size={D0_BATCH}",
           "--log_every=1", "--device=cuda"]
  on = _det_train_run(workdir, flags + [f"--model_dir={workdir}"], steps,
                      True, per_step)
  _resume_check(flags + [f"--model_dir={workdir}"], workdir, steps,
                "automl_tpu_torch.cli.main_det")
  off_dir = workdir + "_off"
  off = _det_train_run(off_dir, flags + [f"--model_dir={off_dir}"], steps,
                       False, per_step)
  print(f"D0 step ms, knob on vs off (one call): {on[1]:.1f} vs {off[1]:.1f}"
        f"; img/s {on[2]:.1f} vs {off[2]:.1f}; peak {on[3]:.2f} vs "
        f"{off[3]:.2f} GiB")
  torch.cuda.empty_cache()
  return on[0], off[1]


D0_INFER_BATCH = 32
# Postprocess on the card against the same code on the CPU, from the same
# raw outputs. Hard NMS: valid_len and classes equal, boxes within
# INFER_BOX_TOL px (of D0's 512-px canvas: about 1.6 float32 steps at 512)
# and scores within INFER_SCORE_TOL. Gaussian NMS decays every overlap by
# a factor that the last bit of a box moves, so two overlapping candidates
# whose live scores are that close may be picked in either order, and the
# slots after such a pick differ: the confident slots (score >
# INFER_CONFIDENT) agree one by one within the same limits up to the first
# slot where the two sides pick different boxes, whose two scores must be
# within INFER_SCORE_TOL (a near tie); later slots are not compared.
INFER_BOX_TOL = 1e-4
INFER_SCORE_TOL = 1e-5
INFER_CONFIDENT = 0.3


def _infer_model(dev, batch):
  """D0 (mixed_bfloat16) with seeded weights whose class-predict bias is 0
  and kernel scaled by 300 (the init's logits lie within +-2e-3 of 0, so
  every score would tie to 4 digits: the scaled ones spread, and the
  confident set is not a field of ties), and a seeded batch of uniform
  [0, 1) NHWC images on the card."""
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import efficientdet
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.ops import anchors
  precision.set_policy("mixed_bfloat16")
  model = efficientdet.build_detection_model("efficientdet-d0", device=dev)
  tree = convert.det_numpy_init(model, 0)
  predict = tree["class_net"]["class-predict"]["pointwise"]
  predict["bias"][:] = 0.0
  predict["kernel"] *= 300.0
  convert.load_det_params(model, tree)
  gen = torch.Generator(device=dev).manual_seed(11)
  h, w = anchors.parse_image_size(model.config.image_size)
  images = torch.rand((batch, h, w, 3), generator=gen, device=dev)
  return model, images


def _detections_agree(name, card, cpu, exact, confident=INFER_CONFIDENT):
  """card and cpu: (boxes, scores, classes, valid_len) of one batch.
  exact: the same detections in every slot (hard NMS); else the slots
  scoring above `confident` up to the first near tie (gaussian NMS, see
  INFER_BOX_TOL)."""
  import torch
  card = [t.cpu() for t in card]
  if exact:
    if not torch.equal(card[3], cpu[3]) or not torch.equal(card[2], cpu[2]):
      raise AssertionError(f"{name}: valid_len or classes differ: card "
                           f"{card[3].tolist()}, CPU {cpu[3].tolist()}")
    boxes_d = float((card[0] - cpu[0]).abs().max())
    scores_d = float((card[1] - cpu[1]).abs().max())
    n, note = int(cpu[3].sum()), "every slot"
  else:
    boxes_d = scores_d = 0.0
    n, ties = 0, []
    for b in range(cpu[1].shape[0]):
      for i in range(int(min(cpu[3][b], card[3][b]))):
        if float(cpu[1][b, i]) <= confident:
          break
        db = float((card[0][b, i] - cpu[0][b, i]).abs().max())
        ds = abs(float(card[1][b, i] - cpu[1][b, i]))
        if (db > INFER_BOX_TOL or int(card[2][b, i]) != int(cpu[2][b, i])):
          if ds > INFER_SCORE_TOL:
            raise AssertionError(
                f"{name}: image {b} slot {i}: the card picked score "
                f"{float(card[1][b, i]):.7f}, the CPU "
                f"{float(cpu[1][b, i]):.7f}: not a near tie")
          ties.append(i)
          break
        boxes_d, scores_d = max(boxes_d, db), max(scores_d, ds)
        n += 1
    note = (f"confident slots up to the first near tie ({len(ties)} of "
            f"{cpu[1].shape[0]} images reached one, at slots {ties})")
  print(f"  {name}: {n} detections compared ({note}), max|box diff| "
        f"{boxes_d:.3e} px (limit {INFER_BOX_TOL:g}), max|score diff| "
        f"{scores_d:.3e} (limit {INFER_SCORE_TOL:g})")
  if boxes_d > INFER_BOX_TOL or scores_d > INFER_SCORE_TOL or n == 0:
    raise AssertionError(f"{name}: card and CPU disagree")


def _infer_check(dev):
  """D0 b32 forward on the card, then postprocess_combined (hard) and
  postprocess_global (gaussian) at pre_nms_topk 5000 and 2048 on the card
  and, from the same raw outputs, on the CPU. The card's postprocess runs
  under torch.cuda.set_sync_debug_mode("error"): a call that waits for the
  card inside it raises."""
  import copy
  import torch
  from automl_tpu_torch.ops import postprocess
  model, images = _infer_model(dev, D0_INFER_BATCH)
  with torch.no_grad():
    cls_out, box_out = model(images.permute(0, 3, 1, 2), train=False)
  cpu_out = ([c.cpu() for c in cls_out], [b.cpu() for b in box_out])
  for topk in (5000, 2048):
    cfg = copy.deepcopy(model.config)
    cfg.nms_configs.pre_nms_topk = topk
    for name, fn, exact in (
        ("combined (hard)", postprocess.postprocess_combined, True),
        ("global (gaussian)", postprocess.postprocess_global, False)):
      fn(cfg, cls_out, box_out)               # anchors cached on the card
      torch.cuda.synchronize()
      torch.cuda.set_sync_debug_mode("error")
      try:
        card = fn(cfg, cls_out, box_out)
      finally:
        torch.cuda.set_sync_debug_mode("default")
      cpu = fn(cfg, *cpu_out)
      print(f"D0 b{D0_INFER_BATCH} postprocess {name}, pre_nms_topk {topk}: "
            f"valid_len card {card[3].tolist()[:8]}...; no host sync inside "
            "(sync debug mode 'error')")
      _detections_agree(f"{name} top-{topk}, card vs CPU", card, cpu, exact)
  del model, images, cls_out, box_out
  torch.cuda.empty_cache()


def _bench_det(topk):
  """cli/bench_det.main in this process (a process of its own took ~8 s
  more to start); returns its JSON line."""
  import contextlib
  import io
  from automl_tpu_torch.cli import bench_det
  printed = io.StringIO()
  with contextlib.redirect_stdout(printed):
    rc = bench_det.main([f"--pre_nms_topk={topk}"])
  if rc != 0:
    raise AssertionError(f"bench_det failed ({rc})")
  line = printed.getvalue().strip().splitlines()[-1]
  print(f"bench_det --pre_nms_topk={topk}: {line}")
  return json.loads(line)


def _entry_check(dev):
  """entry() on the card: D0, seeded weights, zeros [1, 512, 512, 3]."""
  import torch
  from automl_tpu_torch.entry import entry
  fn, (images,) = entry(dev)
  boxes, scores, classes, valid_len = fn(images)
  torch.cuda.synchronize()
  print(f"entry(): valid_len {valid_len.tolist()}; first rows (ymin, xmin, "
        f"ymax, xmax, score, class):")
  for i in range(3):
    print(f"  {[round(float(v), 4) for v in boxes[0, i]]} "
          f"{float(scores[0, i]):.6f} {int(classes[0, i])}")
  if (tuple(boxes.shape) != (1, 100, 4) or not bool(
      torch.isfinite(boxes).all()) or not bool(torch.isfinite(scores).all())):
    raise AssertionError("entry() detections malformed")


def _eval_check(dev, ckpt_dir, workdir):
  """evaluate_detection on D0 at b16 with the EMA params of the 20-step
  knob-off run, over 2 synthetic eval batches, in COCO mode and in
  testdev_dir mode: every metric finite or -1, the JSON rows with the four
  keys."""
  import torch
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.train import optimizers, runners, schedules, train_lib
  from automl_tpu_torch.train.checkpoint import CheckpointManager
  cfg = _det_config()
  precision.set_policy("mixed_bfloat16")
  model = runners.seeded_detection_model(cfg, 0, dev)
  tx = optimizers.masked_for_params(optimizers.build_optimizer(
      "momentum", schedules.detection_lr(cfg, 1), momentum=cfg.momentum))
  state = CheckpointManager(ckpt_dir).restore(
      train_lib.create_train_state(model, tx))
  if state is None or state.ema_params is None:
    raise AssertionError(f"no checkpoint with EMA params in {ckpt_dir}")

  def batches():
    return iter(pipeline.SyntheticDetection(
        D0_BATCH, cfg.image_size, cfg.max_instances_per_image,
        cfg.num_classes))
  t = time.perf_counter()
  vis_dir = os.path.join(workdir, "vis")
  m = runners.evaluate_detection(model, state.ema_params, cfg, batches(), 2,
                                 vis_dir=vis_dir)
  print(f"evaluate_detection, D0 b{D0_BATCH}, EMA params of step "
        f"{state.step}, 2 batches ({time.perf_counter() - t:.1f} s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in m.items()))
  if len(m) != 12 or not all(math.isfinite(v) and (v >= 0 or v == -1)
                             for v in m.values()):
    raise AssertionError(f"COCO metrics malformed: {m}")
  _check_eval_images(vis_dir, 2, (512, 1024, 3))
  td = runners.evaluate_detection(model, state.ema_params, cfg, batches(), 2,
                                  testdev_dir=os.path.join(workdir,
                                                           "testdev"))
  rows = json.load(open(td["detections_json"]))
  print(f"evaluate_detection, testdev_dir mode: AP {td['AP']}, {len(rows)} "
        f"rows in {os.path.basename(td['detections_json'])}")
  if td["AP"] != -1.0 or not rows or any(
      set(r) != {"image_id", "category_id", "bbox", "score"} for r in rows):
    raise AssertionError("test-dev detections malformed")
  del model, state
  torch.cuda.empty_cache()


def _check_eval_images(vis_dir, n, shape):
  """vis_dir holds eval_image_0..n-1.png, each of `shape`."""
  import numpy as np
  from PIL import Image
  names = sorted(os.listdir(vis_dir))
  want = [f"eval_image_{i}.png" for i in range(n)]
  shapes = [np.asarray(Image.open(os.path.join(vis_dir, f))).shape
            for f in names]
  print(f"eval images in {os.path.basename(vis_dir)}/: {names}, shapes "
        f"{sorted(set(shapes))}")
  if names != want or any(s != shape for s in shapes):
    raise AssertionError(f"eval images: want {want} of {shape}")


def _closed_loop(dev, steps=400):
  """tests/test_closed_loop.py's recipe through the port, on the card:
  efficientdet-test overfits one synthetic batch whose pixels encode its
  boxes (f32, momentum), then hard-NMS detections on that batch through
  the COCO evaluator must reach AP50 > 0.5, JAX's own criterion."""
  import numpy as np
  import torch
  from automl_tpu_torch.configs.efficientdet_configs import (
      get_efficientdet_config)
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.eval.coco_metric import COCOEvaluator
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.ops import postprocess
  from automl_tpu_torch.train import optimizers, runners, schedules, train_lib
  precision.set_policy("float32")
  try:
    cfg = get_efficientdet_config("efficientdet-test")
    cfg.override(dict(learning_rate=0.02, lr_warmup_init=0.002))
    cfg.nms_configs.method = "hard"
    cfg.nms_configs.sigma = 0.0
    model = runners.seeded_detection_model(cfg, 0, dev)
    tx = optimizers.masked_for_params(optimizers.build_optimizer(
        "momentum", schedules.detection_lr(cfg, steps_per_epoch=100)))
    state = train_lib.create_train_state(model, tx)
    step_fn = train_lib.make_det_train_step(model, tx, cfg)
    data = pipeline.SyntheticDetection(4, 64, max_instances=10,
                                       num_classes=3, seed=3).batch
    imgs = data["image"].astype(np.float32)
    for i in range(imgs.shape[0]):
      for g in range(10):
        if data["gt_classes"][i, g] > 0:
          y0, x0, y1, x1 = data["gt_boxes"][i, g].astype(int)
          c = int(data["gt_classes"][i, g])
          imgs[i, y0:y1, x0:x1] = [255 * (c == k) for k in (1, 2, 3)]
    images = ((torch.from_numpy(imgs) - torch.tensor(cfg.mean_rgb))
              / torch.tensor(cfg.stddev_rgb))
    batch = {"image": images.permute(0, 3, 1, 2).contiguous(
                 memory_format=torch.channels_last).to(dev),
             "gt_boxes": torch.from_numpy(data["gt_boxes"]).to(dev),
             "gt_classes": torch.from_numpy(data["gt_classes"]).to(dev)}
    gen = torch.Generator(device=dev)
    t = time.perf_counter()
    for _ in range(steps):
      state, m = step_fn(state, batch, gen.manual_seed(1))
    loss = float(m["loss"])
    with torch.no_grad():
      c, b = model(batch["image"], train=False)
      dets, valid = postprocess.generate_detections(
          cfg, c, b, torch.ones(4, device=dev), torch.arange(4, device=dev))
    ev = COCOEvaluator()
    ev.add_batch_from_detections(dets.cpu().numpy(), valid.cpu().numpy(),
                                 data["gt_boxes"], data["gt_classes"])
    metrics = ev.compute()
  finally:
    precision.set_policy("mixed_bfloat16")
  print(f"closed loop, efficientdet-test, {steps} steps "
        f"({time.perf_counter() - t:.1f} s): loss {loss:.4f}, AP50 "
        f"{metrics['AP50']:.4f} (must be > 0.5), AP {metrics['AP']:.4f}")
  if not metrics["AP50"] > 0.5:
    raise AssertionError("the closed loop did not reach AP50 > 0.5")


# Calls a turn of phase 8b's timings (30 until the script outgrew its
# time limit).
DRIVER_BM_RUNS = 10


def _driver_images(n, h, w, seed=21):
  """n COCO-like uint8 images [n, h, w, 3], a few filled boxes each."""
  import numpy as np
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(n):
    yx = rng.uniform(0, 0.6, (3, 2)) * (h, w)
    boxes = np.concatenate([yx, yx + rng.uniform(0.1, 0.4, (3, 2)) * (h, w)],
                           1)
    out.append(_smooth_image(rng, h, w, boxes))
  return np.stack(out)


def _serve_ms(fns, x, runs=DRIVER_BM_RUNS):
  """{name: ms a call} of each fn(x), timed in turns (a, b, b, a), each
  turn `runs` calls on the host clock ending in a synchronise."""
  import torch
  times = {name: [] for name in fns}
  order = list(fns) + list(fns)[::-1]
  with torch.no_grad():
    for name in fns:
      fns[name](x)
    torch.cuda.synchronize()
    for name in order:
      t = time.perf_counter()
      for _ in range(runs):
        fns[name](x)
      torch.cuda.synchronize()
      times[name].append((time.perf_counter() - t) / runs * 1e3)
  return {name: sum(v) / len(v) for name, v in times.items()}


def _same_detections(name, got, want):
  """Bit-equal detections (the exported program and the eager one run the
  same ops on the same inputs): valid_len, classes, boxes and scores."""
  import torch
  diffs = [float((g.float() - w.float()).abs().max()) for g, w in
           zip(got, want)]
  print(f"  {name}: valid_len {got[3].tolist()} vs {want[3].tolist()}, "
        f"max|diff| boxes {diffs[0]:.3e}, scores {diffs[1]:.3e}, classes "
        f"{diffs[2]:.3e}")
  if not all(torch.equal(g, w) for g, w in zip(got, want)):
    raise AssertionError(f"{name}: the detections differ")


# Phase 8b's D0 b1 export: ServingDriver.export in a process of its own.
_EXPORT_CHILD = r"""
import sys, time, torch
from automl_tpu_torch.inference import driver
d = driver.ServingDriver("efficientdet-d0", batch_size=1,
                         device=torch.device("cuda:0")).load(sys.argv[1])
t = time.perf_counter()
d.export(sys.argv[2])
print(f"EXPORT_S {time.perf_counter() - t:.3f}")
"""


def _start_export(ckpt_dir, workdir):
  """ServingDriver.export of D0 b1 (mixed_bfloat16) from `ckpt_dir` into
  workdir/export, started in a process of its own (torch.export traces on
  the host for tens of seconds). Returns (the process, its log's path)."""
  os.makedirs(workdir, exist_ok=True)
  log_path = os.path.join(workdir, "export.log")
  with open(log_path, "w") as log:
    proc = subprocess.Popen(
        [sys.executable, "-c", _EXPORT_CHILD, ckpt_dir,
         os.path.join(workdir, "export")],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
        stderr=subprocess.STDOUT)
  return proc, log_path


def _finish_export(export):
  """Waits for _start_export's process; returns its export's seconds."""
  proc, log_path = export
  rc = proc.wait(timeout=600)
  with open(log_path) as f:
    out = f.read()
  if rc != 0:
    print(out[-6000:])
    raise AssertionError(f"the D0 export exited {rc}")
  return float(next(line for line in out.splitlines()
                    if line.startswith("EXPORT_S "))[len("EXPORT_S "):])


def _stop_export(export):
  proc, _ = export
  if proc.poll() is None:
    proc.kill()
    proc.wait()


def driver_phase(dev, ckpt_dir, workdir, card, export):
  """The detection serving API (inference/driver.py) on D0 with the
  20-step knob-off run's checkpoint: f32 serve of 2 non-square images on
  the card against the CPU; ServingDriver.benchmark at b1 and b8 under
  mixed_bfloat16; the b1 export (torch.export; `export`, _start_export's
  process, made it while phase 8 ran) loaded back, its detections equal
  to the eager serve's and its ms a call beside the eager one's;
  InferenceDriver.inference on a JPEG; infer_cls --runmode=export of
  V2-B0 b8, its logits equal to the eager predict's."""
  import numpy as np
  import torch
  from PIL import Image
  from automl_tpu_torch.cli import infer_cls
  from automl_tpu_torch.configs.effnet_configs import get_model_config
  from automl_tpu_torch.data import preprocessing
  from automl_tpu_torch.inference import driver, visualize
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.train import runners
  t_phase = time.perf_counter()
  os.makedirs(workdir, exist_ok=True)
  try:
    images = torch.from_numpy(_driver_images(2, 480, 640))

    def serve_f32(where):
      d = driver.ServingDriver("efficientdet-d0", batch_size=2,
                               mixed_precision=False,
                               device=where).load(ckpt_dir)
      with torch.no_grad():
        return d.program(images.to(where))

    on_card, on_cpu = serve_f32(dev), serve_f32(torch.device("cpu"))
    print(f"ServingDriver D0 f32 serve (per_class) of 2 480 x 640 images, "
          f"the checkpoint {ckpt_dir}: valid_len {on_card[3].tolist()}, top "
          f"scores {[[round(v, 5) for v in r] for r in on_card[1][:, :3].tolist()]}")
    _detections_agree("D0 serve f32, card vs CPU", on_card, on_cpu,
                      exact=False, confident=0.0)

    for b in (1, 8):
      d = driver.ServingDriver("efficientdet-d0", batch_size=b,
                               device=dev).load(ckpt_dir)
      r = d.benchmark(bm_runs=DRIVER_BM_RUNS)
      print(f"ServingDriver.benchmark D0 b{b} mixed_bfloat16 ({card}): "
            f"{r['fps']:.2f} img/s, {r['latency_ms']:.2f} ms a call")
      del d

    d = driver.ServingDriver("efficientdet-d0", batch_size=1,
                             device=dev).load(ckpt_dir)
    export_s = _finish_export(export)
    t = time.perf_counter()
    program = driver.load_exported(os.path.join(workdir, "export"))
    print(f"D0 b1 export (torch.export, mixed_bfloat16; in its own process "
          f"while phase 8 ran): {export_s:.1f} s; load "
          f"{time.perf_counter() - t:.1f} s")
    h, w = json.load(open(os.path.join(workdir, "export",
                                       "config.json")))["image_size"]
    x = torch.from_numpy(_driver_images(1, h, w, seed=22)).to(dev)
    with torch.no_grad():
      _same_detections("D0 b1 exported vs eager serve", program(x),
                       d.program(x))
    ms = _serve_ms({"eager": d.program, "exported": program}, x)
    print(f"D0 b1 serve, eager vs exported ({card}): {ms['eager']:.2f} vs "
          f"{ms['exported']:.2f} ms a call")
    del d, program

    jpeg = os.path.join(workdir, "fixture.jpg")
    Image.fromarray(_driver_images(1, 427, 640, seed=23)[0]).save(
        jpeg, quality=90)
    dets, annotated = driver.InferenceDriver(
        "efficientdet-d0", ckpt_dir, device=dev).inference(
            jpeg, os.path.join(workdir, "annotated"))
    png = os.path.join(workdir, "annotated", "fixture.png")
    visualize.save_image_array_as_png(annotated, png)
    print(f"InferenceDriver.inference on {os.path.basename(jpeg)}: "
          f"valid_len {dets['valid_len'].tolist()}, annotated "
          f"{annotated.shape} -> {os.path.basename(png)} "
          f"({os.path.getsize(png)} bytes)")
    if annotated.shape != (427, 640, 3) or not os.path.exists(
        os.path.join(workdir, "annotated", "fixture.jpg")):
      raise AssertionError("InferenceDriver.inference wrote no image")

    out_dir = os.path.join(workdir, "v2b0_export")
    infer_cls.main(["--runmode=export", "--model_name=efficientnetv2-b0",
                    "--batch_size=8", f"--export_dir={out_dir}",
                    "--device=cuda"])
    cls_program = torch.export.load(os.path.join(out_dir, "model.pt2")).module()
    cfg = get_model_config("efficientnetv2-b0")
    model = runners.seeded_classification_model(cfg.model, 0, dev).eval()
    isize = int(cfg.eval.isize)
    norm, _ = preprocessing.norm_for_augname(cfg.data.get("augname"))
    x = torch.from_numpy(_driver_images(8, isize + 32, isize + 32,
                                        seed=24)).to(dev)
    with torch.no_grad():
      got = cls_program(x)
      want = infer_cls.Predict(model, isize, norm)(x)
    print(f"infer_cls --runmode=export V2-B0 b8 ({got.dtype}): max|logit "
          f"diff| exported vs eager {float((got - want).abs().max()):.3e} "
          f"(logits up to {float(want.abs().max()):.3e})")
    if not torch.equal(got, want):
      raise AssertionError("V2-B0's exported logits differ from predict's")
  finally:
    precision.set_policy("mixed_bfloat16")
  torch.cuda.empty_cache()
  print(f"driver phase: {time.perf_counter() - t_phase:.1f} s")


def inference_phase(dev, ckpt_dir, workdir):
  """EfficientDet-D0 inference and COCO eval: the card's postprocess
  against the CPU's, bench_det at pre_nms_topk 2048, entry(),
  evaluate_detection on the trained EMA params, and the closed loop."""
  _infer_check(dev)
  # One bench_det run, at bench.py's 2048 (the run at the config's 5000 was
  # cut for the script's time; the card's postprocess is checked at both).
  bench = {topk: _bench_det(topk) for topk in (2048,)}
  for topk, r in bench.items():
    print(f"D0 b{r['batch']} inference, pre_nms_topk {topk}: "
          f"{r['value']:.1f} img/s, {r['ms_per_call']:.2f} ms a call "
          f"(forward {r['forward_ms']:.2f} ms, postprocess "
          f"{r['postprocess_ms']:.2f} ms; {r['card']})")
  _entry_check(dev)
  _eval_check(dev, ckpt_dir, workdir)
  _closed_loop(dev)


def _infer_profile(dev):
  """D0 b32 inference under torch.profiler, at pre_nms_topk 2048 and 5000:
  wall and device-busy time of forward + postprocess_global and of the
  postprocess alone, the kernel launches of each, the largest device rows;
  then CUDA events around pre_nms, the NMS loop (batched_nms) and the
  whole postprocess, one call each, 11 times in turns: the medians, and
  the share of the postprocess that is not pre_nms."""
  import copy
  import torch
  from automl_tpu_torch.cli.bench_det import event_ms
  from automl_tpu_torch.ops import nms as nms_lib
  from automl_tpu_torch.ops import postprocess
  model, images = _infer_model(dev, D0_INFER_BATCH)
  for topk in (2048, 5000):
    cfg = copy.deepcopy(model.config)
    cfg.nms_configs.pre_nms_topk = topk

    @torch.no_grad()
    def forward():
      return model(images.permute(0, 3, 1, 2), train=False)

    outputs = forward()
    for label, fn in (
        ("forward + postprocess", lambda: postprocess.postprocess_global(
            cfg, *forward())),
        ("postprocess alone", lambda: postprocess.postprocess_global(
            cfg, *outputs))):
      fn()
      torch.cuda.synchronize()
      wall_us, rows, host = _profiled(lambda: (fn(), torch.cuda.synchronize()))
      busy = sum(r[0] for r in rows)
      launches = sum(c for _, c, k in host if k == "cudaLaunchKernel")
      print(f"profile, D0 b{D0_INFER_BATCH} {label}, pre_nms_topk {topk}: "
            f"wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
            f"({100 * busy / wall_us:.1f}% of the wall time), "
            f"{launches} cudaLaunchKernel")
      for dt, count, key in rows[:8]:
        print(f"  {dt / 1e3:9.3f} ms {100 * dt / busy:5.1f}%  {count:5d} "
              f"calls  {key[:90]}")
    boxes, scores, _ = postprocess.pre_nms(cfg, *outputs)
    p = postprocess.nms_params(cfg)
    args = (p["max_output_size"], p["iou_thresh"], p["sigma"],
            p["score_thresh"], p["method"])
    times = {}
    for _ in range(11):                       # in turns; the host is noisy
      for label, fn in (
          ("pre_nms", lambda: postprocess.pre_nms(cfg, *outputs)),
          ("nms loop", lambda: nms_lib.batched_nms(boxes, scores, *args)),
          ("postprocess", lambda: postprocess.postprocess_global(
              cfg, *outputs))):
        times.setdefault(label, []).append(event_ms(fn)[1])
    ms = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"D0 b{D0_INFER_BATCH} postprocess, pre_nms_topk {topk} (CUDA "
          f"events, median of 11 in turns): pre_nms {ms['pre_nms']:.3f} ms, "
          f"NMS loop ({p['method']}, {p['max_output_size']} rounds over "
          f"{boxes.shape[1]} candidates) {ms['nms loop']:.3f} ms, whole "
          f"postprocess {ms['postprocess']:.3f} ms: all but pre_nms, "
          f"{100 * (1 - ms['pre_nms'] / ms['postprocess']):.1f}%, is the "
          "NMS loop and its gather (the loop alone and the whole call "
          "differ by the host's noise); each: "
          + "; ".join(f"{k} " + " ".join(f"{t:.1f}" for t in v)
                      for k, v in times.items()))
  del model, images
  torch.cuda.empty_cache()


def _profiled(fn):
  """(wall us, device rows, host rows) of one fn() under torch.profiler;
  fn must end in a synchronisation. Device rows: (device us, calls, kernel
  name); host rows: (self CPU us, calls, op or autograd node name), each
  sorted largest first."""
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
               acc_events=True) as p:
    t0 = time.perf_counter()
    fn()
    wall_us = (time.perf_counter() - t0) * 1e6
  rows, host = [], []   # device: kernels only (an op's row repeats them)
  for e in p.key_averages():
    dt = getattr(e, "self_device_time_total", None)
    if dt is None:
      dt = e.self_cuda_time_total
    if dt > 0 and str(e.device_type).endswith("CUDA"):
      rows.append((dt, e.count, e.key))
    elif str(e.device_type).endswith("CPU") and e.self_cpu_time_total > 0:
      host.append((e.self_cpu_time_total, e.count, e.key))
  return wall_us, sorted(rows, reverse=True), sorted(host, reverse=True)


def profile_phase(dev):
  """Under torch.profiler (run with --profile): two steps of the training
  slice, unfused and with the fused loss "pallas" (full remat, K2), then
  under remat_policy dots_flash with the split (K5a/K5b) and the fused (K2)
  backward, device time by kernel and the device-busy share of the steps'
  wall time; then the serving
  slice's decode step, from greedy_generate with 1 and with 65 new tokens
  (the difference over 64 steps)."""
  import numpy as np
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.cli import generate_lm
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.train import lm_trainer, optimizers, schedules

  flash = "use_flash_attention=true"
  for overrides in (f"{flash},fused_softmax_loss=false",
                    f"{flash},fused_softmax_loss=pallas",
                    f"{flash},remat_policy=dots_flash,flash_bwd_fused=false",
                    f"{flash},remat_policy=dots_flash,flash_bwd_fused=true"):
    cfg = lm_lib.get_lm_config("lm-flops1e19")
    cfg.override(overrides)
    model = convert.load_jax_params(lm_lib.TransformerLM(cfg, device=dev),
                                    convert.numpy_init(cfg, 0))
    lr_fn = schedules.lm_lr("cosine_decay", cfg.learning_rate,
                            num_train_steps=30, warmup_steps=3)
    tx = optimizers.build_optimizer("lion", lr_fn)
    step_fn = lm_trainer.make_lm_train_step(
        model, tx, weight_decay=cfg.weight_decay, lr_fn=lr_fn)
    state = lm_trainer.init_train_state(model, tx)
    data = iter(lm_trainer.SyntheticLMData(8, cfg.seq_len, cfg.vocab_size))

    def step(state):
      batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
      state, logs = step_fn(state, batch)
      float(logs["loss"])
      return state

    state = step(state)
    n = 2
    torch.cuda.reset_peak_memory_stats()

    def steps():
      nonlocal state
      for _ in range(n):
        state = step(state)

    wall_us, rows, _ = _profiled(steps)
    busy = sum(r[0] for r in rows)
    print(f"profile, {n} training steps, {overrides}: wall "
          f"{wall_us / n / 1e3:.1f} ms/step, device busy "
          f"{busy / n / 1e3:.1f} ms/step ({100 * busy / wall_us:.1f}% of "
          f"the wall time), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for dt, count, key in rows[:20]:
      print(f"  {dt / n / 1e3:9.2f} ms/step {100 * dt / busy:5.1f}%  "
            f"{count // n:5d} calls/step  {key[:90]}")
    del model, state, step_fn, tx
    torch.cuda.empty_cache()

  _det_profile(dev)
  _infer_profile(dev)
  _cls_profile(dev)

  # The serving slice's shapes: b8, a 512-token prompt, cache 1024.
  _, model = generate_lm.load_model(config_name="lm-flops1e19", seed=0,
                                    device=dev)
  lm_lib.cast_lm_params_for_serving(model)
  b, t0, new = 8, 512, 512
  prompt = torch.from_numpy(np.random.default_rng(1).integers(
      3, cfg.vocab_size, (b, t0))).to(dev)
  kv_pos = torch.arange(t0 + new, device=dev).expand(b, t0 + new)
  pos = torch.arange(t0, device=dev).expand(b, t0)

  @torch.inference_mode()
  def prefill():
    model(prompt, positions=pos, cache=model.init_cache(b, t0 + new),
          cache_index=0, kv_positions=kv_pos)
    torch.cuda.synchronize()

  def generate():
    lm_lib.greedy_generate(model, prompt, new)
    torch.cuda.synchronize()

  # decode = generate - prefill, over new - 1 steps; the wall time from
  # unprofiled runs (the profiler's own host cost would inflate it).
  walls = []
  for fn in (prefill, generate):
    fn()
    t = time.perf_counter()
    fn()
    walls.append(time.perf_counter() - t)
  (_, rows_p, _), (_, rows_g, _) = _profiled(prefill), _profiled(generate)
  per_step = {}
  for rows, sign in ((rows_g, 1), (rows_p, -1)):
    for dt, _, key in rows:
      per_step[key] = per_step.get(key, 0.0) + sign * dt / (new - 1)
  busy = sum(per_step.values())
  k4 = sum(v for k, v in per_step.items()
           if "decode_attention_kernel" in k or "k4_" in k)
  wall_us = (walls[1] - walls[0]) / (new - 1) * 1e6
  print(f"profile, decode step (b{b}, {t0} + {new} tokens, cache "
        f"{t0 + new}; generate minus prefill over {new - 1} steps): wall "
        f"{wall_us / 1e3:.3f} ms/step, device busy {busy / 1e3:.3f} ms/step "
        f"({100 * busy / wall_us:.1f}% of the wall time), K4 "
        f"{k4 / 1e3:.3f} ms/step")


def _cls_profile(dev):
  """V2-S training steps at its last stage (296 x 296, b V2S_BATCH, bf16,
  RandAugment m 10, the K6 knob on): step times (host clock, 5 steps),
  the preprocess and RandAugment alone (host clock around synchronised
  calls), then two steps under torch.profiler: device time by kernel, the
  device-busy share, K6's time and the launches a step."""
  import torch
  from automl_tpu_torch.data import augment, pipeline, preprocessing
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.ops import depthwise as dw
  from automl_tpu_torch.train import optimizers, runners, schedules, train_lib
  cfg = _cls_config()
  size, b = 296, V2S_BATCH
  precision.set_policy("mixed_bfloat16")
  model = runners.seeded_classification_model(cfg.model, 0, dev)
  tx = optimizers.masked_for_params(optimizers.build_optimizer(
      "rmsprop", schedules.warmup_lr("exponential", 0.016, steps_per_epoch=1,
                                     warmup_epochs=5)))
  state = train_lib.create_train_state(model, tx)
  prep = runners.make_cls_preprocess(cfg, size, 10.0, 0.0, 0.0)
  step_fn = train_lib.make_cls_train_step(model, tx, cfg, preprocess_fn=prep)
  raw = pipeline.SyntheticClassification(b, int(size * 1.15) // 2 * 2,
                                         1000).batch
  raw = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
  gen = torch.Generator(device=dev)

  def steps(count):
    nonlocal state
    for _ in range(count):
      state, m = step_fn(state, raw, gen.manual_seed(state.step))
      float(m["loss"])

  def timed(fn, count=5):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(count):
      fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / count * 1e3

  dw.enable_pallas_filter_grad(True)
  try:
    steps(3)
    step_ms = timed(lambda: steps(1))
    prep_ms = timed(lambda: prep(raw, gen.manual_seed(1)))
    imgs = torch.rand((b, size, size, 3), device=dev) * 255
    draws = augment.randaugment_draws(b, 2, size, size, gen.manual_seed(2))
    ra_ms = timed(lambda: augment.randaugment(imgs, draws, 10.0))
    crop = preprocessing.cls_train_draws(b, size, gen.manual_seed(3), 2)
    crop_ms = timed(lambda: preprocessing.random_resized_crop(
        raw["image"], crop["crop"], size))
    print(f"V2-S b{b} {size}x{size} step (K6 knob on): {step_ms:.1f} ms "
          f"(host clock, 5 steps); the preprocess alone {prep_ms:.1f} ms "
          f"({100 * prep_ms / step_ms:.1f}%), of which RandAugment (2 layers "
          f"x 16 ops on every image) {ra_ms:.1f} ms "
          f"({100 * ra_ms / step_ms:.1f}% of the step) and the crop "
          f"{crop_ms:.1f} ms")
    del imgs
    n = 2
    wall_us, rows, host_rows = _profiled(lambda: steps(n))
  finally:
    dw.enable_pallas_filter_grad(False)
  busy = sum(r[0] for r in rows)
  k6 = sum(r[0] for r in rows if "filter_grad" in r[2]
           or "reduce_parts_kernel" in r[2])
  k6_calls = sum(r[1] for r in rows if "filter_grad" in r[2])
  launches = sum(c for _, c, k in host_rows if k == "cudaLaunchKernel")
  print(f"profile, {n} V2-S training steps b{b} {size}x{size}, K6 knob on: "
        f"wall {wall_us / n / 1e3:.1f} ms/step, device busy "
        f"{busy / n / 1e3:.1f} ms/step ({100 * busy / wall_us:.1f}% of the "
        f"wall time), K6 {k6 / n / 1e3:.2f} ms/step in {k6_calls // n} "
        f"launches, {launches // n} cudaLaunchKernel a step")
  for dt, count, key in rows[:20]:
    print(f"  {dt / n / 1e3:9.2f} ms/step {100 * dt / busy:5.1f}%  "
          f"{count // n:5d} calls/step  {key[:90]}")
  del model, state, step_fn
  torch.cuda.empty_cache()


def _det_profile(dev):
  """D0 training steps (b16, bf16): step times with the K6 knob off / on /
  off / on in turns (5 steps each, host clock); then two steps under
  torch.profiler with the knob off, then on: device time by kernel, the
  device-busy share, host (self CPU) time by op and autograd node, and the
  ops whose host time the knob on adds or removes most."""
  import torch
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.ops import depthwise as dw
  from automl_tpu_torch.train import optimizers, runners, schedules, train_lib
  cfg = _det_config()
  precision.set_policy("mixed_bfloat16")
  model = runners.seeded_detection_model(cfg, 0, dev)
  tx = optimizers.masked_for_params(optimizers.build_optimizer(
      "momentum", schedules.detection_lr(cfg, 1), momentum=cfg.momentum))
  state = train_lib.create_train_state(model, tx)
  step_fn = train_lib.make_det_train_step(
      model, tx, cfg, preprocess_fn=runners.make_preprocess(cfg))
  raw = pipeline.SyntheticDetection(D0_BATCH, cfg.image_size,
                                    cfg.max_instances_per_image,
                                    cfg.num_classes).batch
  raw = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
  gen = torch.Generator(device=dev)

  def steps(count):
    nonlocal state
    for _ in range(count):
      state, m = step_fn(state, raw, gen.manual_seed(state.step))
      float(m["loss"])

  try:
    for knob in (False, True, False, True):
      dw.enable_pallas_filter_grad(knob)
      steps(2)
      t0 = time.perf_counter()
      steps(5)
      print(f"D0 step, K6 knob {'on' if knob else 'off'} (in turns): "
            f"{(time.perf_counter() - t0) / 5 * 1e3:.1f} ms")
  finally:
    dw.enable_pallas_filter_grad(False)
  n = 2
  host = {}
  for knob in (False, True):
    dw.enable_pallas_filter_grad(knob)
    try:
      steps(1)
      wall_us, rows, host_rows = _profiled(lambda: steps(n))
    finally:
      dw.enable_pallas_filter_grad(False)
    host[knob] = {key: (dt, count) for dt, count, key in host_rows}
    busy = sum(r[0] for r in rows)
    k6 = sum(r[0] for r in rows if "filter_grad" in r[2]
             or "reduce_parts_kernel" in r[2])
    k6_calls = sum(r[1] for r in rows if "filter_grad" in r[2]
                   or "reduce_parts_kernel" in r[2])
    print(f"profile, {n} D0 training steps b{D0_BATCH}, K6 knob "
          f"{'on' if knob else 'off'}: wall {wall_us / n / 1e3:.1f} ms/step, "
          f"device busy {busy / n / 1e3:.1f} ms/step ({100 * busy / wall_us:.1f}"
          f"% of the wall time), K6 {k6 / n / 1e3:.2f} ms/step in "
          f"{k6_calls // n} launches, host self "
          f"time in ops {sum(r[0] for r in host_rows) / n / 1e3:.1f} ms/step")
    for dt, count, key in rows[:20]:
      print(f"  {dt / n / 1e3:9.2f} ms/step {100 * dt / busy:5.1f}%  "
            f"{count // n:5d} calls/step  {key[:90]}")
    print("  host, self CPU time by op:")
    for dt, count, key in host_rows[:15]:
      print(f"  {dt / n / 1e3:9.2f} ms/step  {count // n:5d} calls/step  "
            f"{key[:90]}")
  diff = sorted(
      ((host[True].get(k, (0, 0))[0] - host[False].get(k, (0, 0))[0], k)
       for k in host[True].keys() | host[False].keys()),
      key=lambda d: -abs(d[0]))
  print("host self CPU time, knob on minus off, by op (ms/step, calls/step "
        "off -> on):")
  for d, key in diff[:15]:
    print(f"  {d / n / 1e3:+9.2f} ms/step  {host[False].get(key, (0, 0))[1] // n:5d}"
          f" -> {host[True].get(key, (0, 0))[1] // n:5d}  {key[:90]}")
  del model, state, step_fn
  torch.cuda.empty_cache()


def serving_phase(dev):
  """lm-flops1e19 greedy serving; returns the K4 launches it made."""
  import numpy as np
  import torch
  from automl_tpu_torch.cli import generate_lm
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.ops import decode_attention as da

  # 256 new tokens (512 until the script outgrew its time limit): the cache
  # of 768 is at decode_kernel_min_s, so every decode step takes K4.
  batch, t0, new = 8, 512, 256
  t = time.perf_counter()
  cfg, model = generate_lm.load_model(config_name="lm-flops1e19", seed=0,
                                      device=dev)
  lm_lib.cast_lm_params_for_serving(model)
  n_params = sum(p.numel() for p in model.parameters())
  print(f"lm-flops1e19: {n_params} params, d {cfg.model_dim}, "
        f"{cfg.n_layers} layers, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
        f"hd {cfg.head_dim}, V {cfg.vocab_size}, "
        f"{cfg.activation_dtype}; built in {time.perf_counter() - t:.1f} s")
  prompt = torch.from_numpy(np.random.default_rng(1).integers(
      3, cfg.vocab_size, (batch, t0))).to(dev)
  total = t0 + new
  kv_pos = torch.arange(total, device=dev).expand(batch, total)
  pos = torch.arange(t0, device=dev).expand(batch, t0)

  @torch.inference_mode()
  def prefill():
    cache = model.init_cache(batch, total)
    return model(prompt, positions=pos, cache=cache, cache_index=0,
                 kv_positions=kv_pos)[0]

  def with_plain_attention(fn):
    cfg.use_decode_kernel = False
    try:
      return fn()
    finally:
      cfg.use_decode_kernel = True

  logits = prefill()
  logits_plain = with_plain_attention(prefill)
  if logits.shape != (batch, t0, cfg.vocab_size) or not bool(
      torch.isfinite(logits).all()):
    raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite "
                         "or of the wrong shape")
  diff = (logits - logits_plain).abs()
  max_d, mean_d = float(diff.max()), float(diff.mean())
  agree = float((logits.argmax(-1) == logits_plain.argmax(-1)).float().mean())
  # The plain path rounds scores and probabilities to bf16 (as the JAX dots
  # path does) where the kernel keeps them in f32: bf16-level noise through
  # 8 layers, on logits capped at 30.
  print(f"prefill logits, kernel vs plain attention: max|diff| {max_d:.4f} "
        f"(limit 0.25), mean|diff| {mean_d:.5f} (limit 0.02), "
        f"argmax agreement {agree:.4f}")
  if max_d > 0.25 or mean_d > 0.02:
    raise AssertionError("prefill logits disagree with the plain path")
  del logits, logits_plain, diff

  prefill_ms = _time_ms(prefill, 3)
  prefill_plain_ms = _time_ms(lambda: with_plain_attention(prefill), 3)
  print(f"prefill b{batch} x {t0}: {prefill_ms:.2f} ms "
        f"(plain attention {prefill_plain_ms:.2f} ms)")

  def generate():
    return lm_lib.greedy_generate(model, prompt, new)

  lm_lib.greedy_generate(model, prompt, 4)      # warm the decode shapes
  torch.cuda.synchronize()
  da.decode_attention.launches = 0
  da.decode_attention.launches_sm90 = 0
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  tokens = generate()
  end.record()
  end.synchronize()
  launches = da.decode_attention.launches
  sm90 = da.decode_attention.launches_sm90
  gen_ms = start.elapsed_time(end)
  expected = cfg.n_layers * new
  print(f"decode_attention launches in the run: {launches}, {sm90} of them "
        f"the Hopper kernels' (expected {cfg.n_layers} x (1 + {new - 1}) = "
        f"{expected}, all Hopper)")
  if launches != expected or sm90 != expected:
    raise AssertionError("the run did not go through the kernel as expected")
  if tokens.shape != (batch, total) or not bool(
      (tokens[:, :t0] == prompt).all()) or not bool(
          ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
    raise AssertionError("generated tokens malformed")

  start.record()
  tokens_plain = with_plain_attention(generate)
  end.record()
  end.synchronize()
  plain_ms = start.elapsed_time(end)
  same = tokens[:, t0:] == tokens_plain[:, t0:]
  prefix = [int(r.cumprod(0).sum()) for r in same.int()]
  decode_ms = (gen_ms - prefill_ms) / (new - 1)
  print(f"generate b{batch}, {t0} + {new} tokens: {gen_ms:.1f} ms; "
        f"decode {decode_ms:.3f} ms/step, "
        f"{batch * new / gen_ms * 1e3:.1f} tokens/s "
        f"(plain attention: {plain_ms:.1f} ms, "
        f"{(plain_ms - prefill_plain_ms) / (new - 1):.3f} ms/step)")
  print(f"generated tokens equal to the plain-attention run: "
        f"{int(same.sum())} of {same.numel()}; equal prefix per row {prefix}")
  return launches


# ---------------------------------------------------------------------------
# The rest of LM serving: LMServer, speculative decoding, beam search, int8
# weights, the combined qkv and the generate_lm CLI's modes.
# ---------------------------------------------------------------------------

# Teacher-forced limits of a generated token (bf16 logits capped at 30, the
# cached path against one no-cache forward): the argmax of the forward, or
# within SERVE_TF_GAP of its max logit (the serving phase's prefill limit),
# and at least SERVE_TF_EXACT of the tokens exact argmaxes. Measured on one
# H100 (the norm scales below): the largest gap 0.0729 (the K4
# server), 0.0712 (the prefix cache), 0.0882 (int8), 0 (speculative); exact
# 99.77%, 99.53%, 99.80% and 100%.
SERVE_TF_GAP = 0.25
SERVE_TF_EXACT = 0.99
# |beam score - the teacher-forced, length-normalised sum of log-probs of
# the returned sequence| (bf16 logits through 8 layers, f32 sums):
# measured 0.0322 on one H100 (b2 x 4 beams, 512 + 256 tokens); the
# limit is three times that.
BEAM_SCORE_TOL = 0.1
# Cut from 24, then 16, for the script's time.
LM_SERVE_REQUESTS = 12
# Requests of (b) also run alone through greedy_generate for the report
# (b1 decodes at ~15 ms a token or more on the card's host: the first 8,
# 1,549 tokens, took tens of seconds of the phase; teacher forcing checks
# every token of all 24).
LM_GREEDY_REPORT = 1
# The phase's models draw their norm scales from N(0, LM_NORM_SIGMA²)
# (zero at init). With zero scales a seeded lm-flops1e19 repeats one token
# whatever its context (top-1 leads top-2 by ~7.7 logits), so a wrong cache
# would go unseen; at 1.0 the greedy tokens follow the context (3-4
# distinct tokens in 48, my CPU run at f32) while the top-1 lead stays
# large enough (1% of tokens under 0.09) that bf16 rounding flips few
# argmaxes and beam search's f32 sums keep num_beams=1 equal to greedy.
# From 1.25 up the logits turn flat (6% of leads under 0.02).
LM_NORM_SIGMA = 1.0


# Phase 12 (j): the draft's training and its two prompts. The pattern is
# drawn as the training stream draws its rows (SyntheticLMData, another
# seed); the text starts at README.md's first paragraph. At lr 3e-4 and
# 150 steps the draft agrees in part with phase 5's target (FUSED_LR) on
# README.md's bytes; with both models at their configs' 3e-3 (the draft
# to 250 steps) it agreed on neither prompt (PERF.md section 6).
DRAFT_STEPS = 150
DRAFT_LR = 3e-4
DRAFT_PROMPT_SEED = 20
# (j)'s prompts and new tokens. The cache (prompt + new + k + 1 = 768) is
# at decode_kernel_min_s, so every step of both models takes K4. At 256 new
# tokens README.md's bytes accept in part (0.1931 on one H100, PERF.md
# section 6); at 128 they accepted nothing, and (j) now fails on a rate of
# 0 or 1 there, where the verify's partial-accept path would go unrun.
DRAFT_PROMPT = 507
DRAFT_NEW = 256
# The pattern prompt's length and new tokens (DRAFT_PROMPT and DRAFT_NEW
# until the script outgrew its time limit): the same cache of 768, a
# quarter of the tokens; it accepts nothing (0.0 at 256 new tokens on one
# H100) and checks no rate.
PATTERN_PROMPT = 699
PATTERN_NEW = 64
README_PARAGRAPH = "A brand-new, TPU-first"


def _write_model_dir(path, cfg, tree):
  """A model directory as generate_lm --model_dir reads it:
  experiment_config.yaml + params.npz (the JAX-layout tree)."""
  import yaml
  from automl_tpu_torch import convert
  os.makedirs(path, exist_ok=True)
  convert.save_npz(os.path.join(path, "params.npz"), tree)
  with open(os.path.join(path, "experiment_config.yaml"), "w") as f:
    yaml.safe_dump(cfg.as_dict(), f)


def _lm_tree(cfg, seed):
  """convert.numpy_init's tree with the norm scales drawn (LM_NORM_SIGMA)."""
  import numpy as np
  from automl_tpu_torch import convert
  flat = convert.flatten_tree(convert.numpy_init(cfg, seed))
  rng = np.random.default_rng(seed + 100)
  for path, value in flat.items():
    if path.endswith("scale"):
      flat[path] = (LM_NORM_SIGMA * rng.standard_normal(value.shape)).astype(
          np.float32)
  return convert.unflatten_tree(flat)


def _teacher_forced(model, label, seqs, check=True):
  """seqs: [(context ids, generated ids)]. One no-cache forward of each
  context + output; every generated token must be the forward's argmax or
  within SERVE_TF_GAP of its max logit, and SERVE_TF_EXACT of them exact
  argmaxes (with check; else the numbers are only printed). Returns
  (exact, total, largest gap)."""
  import torch
  exact = total = 0
  worst = 0.0
  with torch.inference_mode():
    for ctx, gen in seqs:
      if not gen:
        continue
      ids = torch.tensor([list(ctx) + list(gen)], device=model.device)
      logits = model(ids[:, :-1])[0][0, len(ctx) - 1:].float()  # [n, V]
      tok = torch.tensor(gen, device=model.device)
      gap = logits.max(-1).values - logits.gather(-1, tok[:, None])[:, 0]
      exact += int((logits.argmax(-1) == tok).sum())
      total += len(gen)
      worst = max(worst, float(gap.max()))
      if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: non-finite logits")
  share = exact / max(total, 1)
  limits = "limit" if check else "reported; the limit would be"
  print(f"  {label}: teacher-forced, {exact} of {total} tokens the argmax "
        f"({share:.4f}; {limits} {SERVE_TF_EXACT}), largest gap to the max "
        f"logit {worst:.4f} ({limits} {SERVE_TF_GAP})")
  if check and (worst > SERVE_TF_GAP or share < SERVE_TF_EXACT):
    raise AssertionError(f"{label}: outside the teacher-forced limits")
  return exact, total, worst


def _k4_counts():
  from automl_tpu_torch.ops import decode_attention as da
  f = da.decode_attention
  return f.launches, f.launches_sm90


def _k4_reset():
  from automl_tpu_torch.ops import decode_attention as da
  da.decode_attention.launches = da.decode_attention.launches_sm90 = 0
  da.decode_attention.launches_simt = 0


def _k4_expect(label, expected):
  """The launches since _k4_reset: exactly `expected`, all Hopper's."""
  launches, sm90 = _k4_counts()
  print(f"  {label}: K4 launches {launches}, {sm90} of them the Hopper "
        f"kernels' (expected {expected}, all Hopper)")
  if launches != expected or sm90 != expected:
    raise AssertionError(f"{label}: K4 launches {launches} / {sm90} Hopper, "
                         f"expected {expected}")
  return launches


def _equal_prefix(a, b):
  n = 0
  for x, y in zip(a, b):
    if x != y:
      break
    n += 1
  return n


def _instrument(server, no_sync):
  """Wraps the server's device calls: each ends in a synchronise and stamps
  the host clock (stamps[k] is the end of timeline entry k); with no_sync,
  the bursts run under sync debug mode "error" (a host sync inside
  raises)."""
  import torch
  stamps = []

  def wrap(fn, check):
    def run(*a, **kw):
      if check:
        torch.cuda.set_sync_debug_mode("error")
      try:
        out = fn(*a, **kw)
      finally:
        if check:
          torch.cuda.set_sync_debug_mode(0)
      torch.cuda.synchronize()
      stamps.append(time.perf_counter())
      return out
    return run

  server._decode_burst = wrap(server._decode_burst, no_sync)
  for name in ("_prefill", "_chunk_prefill", "_template"):
    setattr(server, name, wrap(getattr(server, name), False))
  return stamps


def _serve(label, model, requests, shared_prefix=None, no_sync=False, **kw):
  """One serve() of `requests` [(prompt, budget)]: (results, server,
  seconds, useful tokens/s, [TTFT s], [completion s])."""
  import torch
  from automl_tpu_torch.inference.lm_server import GenRequest, LMServer
  server = LMServer(model, max_batch=8, max_seq_len=1024, burst=8,
                    prefill_chunk=256, **kw)
  stamps = _instrument(server, no_sync)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  results = server.serve([GenRequest(p, m) for p, m in requests],
                         shared_prefix=shared_prefix)
  secs = time.perf_counter() - t0
  useful = sum(len(r.tokens) for r in results)
  ev = server.request_events
  ttft = [stamps[ev[i]["first"] - 1] - t0 for i in range(len(requests))]
  done = [stamps[ev[i]["done"] - 1] - t0 for i in range(len(requests))]
  kinds = [e["kind"] for e in server.timeline]
  print(f"  {label}: {len(requests)} requests, {useful} tokens in "
        f"{secs:.3f} s: {useful / secs:.1f} useful tokens/s; "
        f"{kinds.count('burst')} bursts, {kinds.count('chunk')} chunks, "
        f"{kinds.count('prefill')} prefills; steps {server.steps}, busy "
        f"slot-steps {server.busy_slot_steps} "
        f"({server.busy_slot_steps / max(8 * server.steps, 1):.3f} of the "
        f"slots); TTFT median {sorted(ttft)[len(ttft) // 2]:.3f} s, max "
        f"{max(ttft):.3f} s")
  return results, server, secs, useful / secs, ttft, done


def _burst_profile(label, server):
  """One burst of 8 active slots at length 512 of a 1024 cache: host ms a
  step (wall, unprofiled) and the device's busy share (torch.profiler)."""
  import torch
  dev, b = server.device, server.B
  cache = server.model.init_cache(b, server.S)
  tok = torch.randint(3, 1000, (b,), device=dev)
  lengths = torch.full((b,), 512, device=dev)
  active = torch.ones((b,), dtype=torch.bool, device=dev)
  remaining = torch.full((b,), 100, device=dev)
  win = torch.full((b, 1), -2, device=dev)

  @torch.inference_mode()
  def burst():
    server._decode_burst(cache, tok, lengths, active, remaining, win)
    torch.cuda.synchronize()

  burst()
  t = time.perf_counter()
  burst()
  wall_us = (time.perf_counter() - t) * 1e6
  _, rows, _ = _profiled(burst)
  busy = sum(r[0] for r in rows)
  k4 = sum(r[0] for r in rows if "k4_" in r[2] or "decode_attention" in r[2])
  steps = server.burst
  print(f"  {label}: a burst of {steps} steps, 8 slots at 512 of 1024: wall "
        f"{wall_us / steps / 1e3:.3f} ms/step, device busy "
        f"{busy / steps / 1e3:.3f} ms/step ({100 * busy / wall_us:.1f}% of "
        f"the wall time), K4 {k4 / steps / 1e3:.3f} ms/step")


def _speculative(label, model, draft, prompt, new, k, ref, greedy_s,
                 partial=False):
  """speculative_generate b1 (a warm-up, then timed with its stats): K4
  once a layer in each prefill, then in each iteration k + 1 draft steps
  and one verify (8 x (k + 2) for two 8-layer models); the output held to
  greedy decoding by teacher forcing; with `partial`, an accept rate of 0
  or 1 fails (the verify then never keeps part of a draft). Returns the
  K4 launches."""
  import torch
  from automl_tpu_torch.models.speculative import speculative_generate
  t0 = prompt.shape[1]
  speculative_generate(model, draft, prompt, 8, n_draft=k)   # warm-up
  _k4_reset()
  torch.cuda.synchronize()
  t = time.perf_counter()
  out, stats = speculative_generate(model, draft, prompt, new, n_draft=k,
                                    return_stats=True)
  torch.cuda.synchronize()
  secs = time.perf_counter() - t
  n_t, n_d = model.cfg.n_layers, draft.cfg.n_layers
  launches = _k4_expect(label, n_t + n_d + stats["iterations"]
                        * (n_t + (k + 1) * n_d))
  gen = out[0, t0:].tolist()
  print(f"  {label}: {stats['iterations']} iterations, accept rate "
        f"{stats['accept_rate']:.4f}, {new / secs:.1f} tokens/s "
        f"({secs:.3f} s; greedy_generate {new / greedy_s:.1f}); equal "
        f"prefix against greedy_generate "
        f"{_equal_prefix(gen, ref[0, t0:].tolist())} of {new}")
  _teacher_forced(model, label, [(prompt[0].tolist(), gen)])
  if partial and not 0 < stats["accept_rate"] < 1:
    raise AssertionError(f"{label}: accept rate {stats['accept_rate']}, so "
                         f"the partial-accept path did not run")
  return launches


def lm_serving_phase(dev, workdir, target_run):
  """M7 on the card (checks (a)-(h)), cli/generate_lm on the run directory
  that main_lm wrote for lm-flops1e19 (`target_run`: phase 5's fused run)
  (i), and speculative decoding with a draft that main_lm trains here on
  the target's stream (j). Returns (the K4 launches of its runs, the draft
  run's {kernel: launches}), each counted from 0 just before the run and
  read just after."""
  import copy
  import numpy as np
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.cli import generate_lm
  from automl_tpu_torch.data import lm_pipeline
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.models.beam import beam_search_generate
  from automl_tpu_torch.train import checkpoint
  from automl_tpu_torch.train.lm_trainer import SyntheticLMData

  t_phase = time.perf_counter()
  cfg = lm_lib.get_lm_config("lm-flops1e19")
  tree = _lm_tree(cfg, 0)
  model = convert.load_jax_params(lm_lib.TransformerLM(cfg, device=dev), tree)
  del tree
  int8 = lm_lib.quantize_lm_params(copy.deepcopy(model))
  lm_lib.cast_lm_params_for_serving(model)
  lm_lib.cast_lm_params_for_serving(int8)
  n_layers, v = cfg.n_layers, cfg.vocab_size
  # A seeded lm-flops2e17 (d 256, hd 32, the same V) written as a directory
  # of experiment_config.yaml + params.npz: (i)'s draft, which keeps the
  # CLI's params.npz route driven.
  draft_dir = os.path.join(workdir, "draft")
  dcfg = lm_lib.get_lm_config("lm-flops2e17")
  _write_model_dir(draft_dir, dcfg, _lm_tree(dcfg, 1))
  print(f"lm serving phase: lm-flops1e19, norm scales drawn N(0, "
        f"{LM_NORM_SIGMA}^2), built in {time.perf_counter() - t_phase:.1f} s")
  rng = np.random.default_rng(15)
  launches = 0

  # (a) a vector cache_index of equal entries against the scalar one, K4 on.
  print("(a) vector and scalar cache_index, b8, a 512-token prefill into a "
        "1024 cache, then one decode step")
  b, t0, s = 8, 512, 1024
  prompt = torch.from_numpy(rng.integers(3, v, (b, t0))).to(dev)
  step = torch.from_numpy(rng.integers(3, v, (b, 1))).to(dev)
  kv_pos = torch.arange(s, device=dev).expand(b, s)
  with torch.inference_mode():
    cache = model.init_cache(b, s)
    model(prompt, positions=kv_pos[:, :t0], cache=cache, cache_index=0,
          kv_positions=kv_pos)
    caches = [[{k: x.clone() for k, x in layer.items()} for layer in cache]
              for _ in range(3)]
    pos = torch.full((b, 1), t0, device=dev)
    _k4_reset()
    scalar = model(step, positions=pos, cache=caches[0], cache_index=t0,
                   kv_positions=kv_pos)[0]
    vector = model(step, positions=pos, cache=caches[1],
                   cache_index=torch.full((b,), t0, device=dev),
                   kv_positions=kv_pos)[0]
    parked = torch.full((b,), t0, device=dev)
    parked[5] = s
    model(step, positions=pos, cache=caches[2], cache_index=parked,
          kv_positions=kv_pos)
    torch.cuda.synchronize()
  _k4_expect("(a)", 3 * n_layers)
  rows = slice(5 * cfg.n_kv_heads, 6 * cfg.n_kv_heads)
  same_cache = all(torch.equal(x[k], y[k]) for x, y in zip(caches[0],
                                                             caches[1])
                   for k in ("k", "v"))
  untouched = all(torch.equal(x[k][rows], y[k][rows])
                  for x, y in zip(cache, caches[2]) for k in ("k", "v"))
  print(f"  logits bit-equal: {torch.equal(scalar, vector)}; caches "
        f"bit-equal: {same_cache}; the parked row's cache rows untouched: "
        f"{untouched}")
  if not (torch.equal(scalar, vector) and same_cache and untouched):
    raise AssertionError("(a) the vector cache_index disagrees")
  del cache, caches

  # (b) LMServer with K4: LM_SERVE_REQUESTS requests, prompts 16-700 (some
  # chunked).
  lens = rng.integers(16, 701, LM_SERVE_REQUESTS)
  lens[:6] = rng.integers(257, 701, 6)
  rng.shuffle(lens)
  requests = [(rng.integers(3, v, int(n)).tolist(),
               int(min(rng.integers(16, 301), 1024 - n))) for n in lens]
  print(f"(b) LMServer, K4 on: max_batch 8, max_seq_len 1024, burst 8, "
        f"prefill_chunk 256; {len(requests)} requests, prompts "
        f"{min(lens)}-{max(lens)} ({int((lens > 256).sum())} over 256), "
        f"budgets {min(m for _, m in requests)}-"
        f"{max(m for _, m in requests)}")
  warm = [(requests[0][0], 9)]
  _serve("warm-up", model, warm, use_decode_kernel=True)
  _k4_reset()
  res_k, srv, _, tps_k1, ttft_k, done_k = _serve(
      "K4 server", model, requests, no_sync=True, use_decode_kernel=True)
  kinds = [e["kind"] for e in srv.timeline]
  launches += _k4_expect("(b)", n_layers * (srv.burst * kinds.count("burst")
                                            + kinds.count("chunk")))
  print("  no host sync inside a burst (sync debug mode \"error\")")
  _teacher_forced(model, "(b)", [(p, r.tokens)
                                 for (p, _), r in zip(requests, res_k)])
  prefixes = []
  for (p, m), r in zip(requests[:LM_GREEDY_REPORT], res_k):
    ref = lm_lib.greedy_generate(model, torch.tensor([p], device=dev), m)
    prefixes.append(_equal_prefix(ref[0, len(p):].tolist(), r.tokens))
  print(f"  equal prefix against a per-request greedy_generate, the first "
        f"{LM_GREEDY_REPORT} requests (tokens): {prefixes} (of "
        f"{[m for _, m in requests[:LM_GREEDY_REPORT]]})")
  print(f"  first-token / completion timeline index per request: "
        f"{[(srv.request_events[i]['first'], srv.request_events[i]['done']) for i in range(len(requests))]}")

  # (c) the default server: the dots, no K4.
  print("(c) the default server (use_decode_kernel None: the dots)")
  _serve("warm-up", model, warm)
  _k4_reset()
  res_d, _, _, tps_d1, ttft_d, done_d = _serve("dots server", model,
                                               requests)
  _k4_expect("(c)", 0)
  same = [_equal_prefix(a.tokens, b.tokens) for a, b in zip(res_k, res_d)]
  print(f"  tokens equal to (b)'s: {sum(a.tokens == b.tokens for a, b in zip(res_k, res_d))} "
        f"of {len(requests)} requests; equal prefix {same}")
  med = lambda xs: sorted(xs)[len(xs) // 2]
  print(f"  K4 then dots: useful tokens/s {tps_k1:.1f}, {tps_d1:.1f}; TTFT "
        f"median K4 {med(ttft_k):.3f} s, dots {med(ttft_d):.3f} s; "
        f"completion median K4 {med(done_k):.3f} s, dots "
        f"{med(done_d):.3f} s")
  from automl_tpu_torch.inference.lm_server import LMServer
  for label, flag in (("K4 burst", True), ("dots burst", None)):
    _burst_profile(label, LMServer(model, max_batch=8, max_seq_len=1024,
                                   burst=8, use_decode_kernel=flag))

  # (d) the prefix cache: 8 requests behind a 128-token shared prefix.
  prefix = rng.integers(3, v, 128).tolist()
  reqs_d = [(rng.integers(3, v, int(n)).tolist(), int(m)) for n, m in zip(
      rng.integers(16, 301, 8), rng.integers(16, 129, 8))]
  print("(d) the prefix cache: 8 requests behind a 128-token shared prefix, "
        "K4 on")
  _k4_reset()
  res_p, _, _, _, _, _ = _serve("prefix server", model, reqs_d,
                                shared_prefix=prefix, use_decode_kernel=True)
  launches += _k4_counts()[0]
  _teacher_forced(model, "(d)", [(prefix + p, r.tokens)
                                 for (p, _), r in zip(reqs_d, res_p)])

  # (e) speculative decoding, b1: t0 635 + 128 new, k 4 (buf 768; 507 +
  # 256 until the script outgrew its time limit).
  t0, new, k = 635, 128, 4
  prompt = torch.from_numpy(rng.integers(3, v, (1, t0))).to(dev)
  print(f"(e) speculative decoding, b1, {t0} + {new} tokens, k {k}, K4 on")
  torch.cuda.synchronize()
  t = time.perf_counter()
  ref = lm_lib.greedy_generate(model, prompt, new)
  torch.cuda.synchronize()
  greedy_s = time.perf_counter() - t
  print(f"  greedy_generate b1: {new / greedy_s:.1f} tokens/s "
        f"({greedy_s:.3f} s; cache {t0 + new} < 768: the dots)")
  launches += _speculative("(e) self-draft", model, model, prompt, new, k,
                           ref, greedy_s)

  # (f) beam search, b2 x 4 beams, 640 + 128 (a cache of 768; 512 + 256
  # until the script outgrew its time limit).
  t0, new = 640, 128
  prompt = torch.from_numpy(rng.integers(3, v, (2, t0))).to(dev)
  print(f"(f) beam search, b2, {t0} + {new} tokens")
  one, _ = beam_search_generate(model, prompt, new, num_beams=1)
  greedy = lm_lib.greedy_generate(model, prompt, new)
  print(f"  num_beams=1 bit-equal to greedy_generate: "
        f"{torch.equal(one, greedy)}")
  if not torch.equal(one, greedy):
    raise AssertionError("(f) num_beams=1 differs from greedy_generate")
  _k4_reset()
  torch.cuda.synchronize()
  t = time.perf_counter()
  out, scores = beam_search_generate(model, prompt, new, num_beams=4)
  torch.cuda.synchronize()
  secs = time.perf_counter() - t
  launches += _k4_expect("(f) 4 beams", n_layers * new)
  with torch.inference_mode():
    logp = torch.log_softmax(model(out[:, :-1])[0][:, t0 - 1:].float(), -1)
    forced = logp.gather(-1, out[:, t0:, None])[..., 0].sum(-1) / new ** 0.6
  err = float((forced - scores).abs().max())
  print(f"  4 beams: {2 * new / secs:.1f} tokens/s ({secs:.3f} s); scores "
        f"{scores.tolist()}, teacher-forced {forced.tolist()}: max|diff| "
        f"{err:.4f} (limit {BEAM_SCORE_TOL}); equal prefix against greedy "
        f"{[_equal_prefix(a, b) for a, b in zip(out[:, t0:].tolist(), greedy[:, t0:].tolist())]}")
  if not err <= BEAM_SCORE_TOL:
    raise AssertionError("(f) beam scores disagree with teacher forcing")

  # (g) int8 weights.
  nbytes = lambda m: sum(p.numel() * p.element_size()
                         for p in m.parameters())
  print(f"(g) int8: weights {nbytes(int8) / 1e6:.1f} MB against "
        f"{nbytes(model) / 1e6:.1f} MB cast for serving (bf16, embed f32)")
  t0, new = 640, 128          # 512 + 256 until the script outgrew its limit
  prompt = torch.from_numpy(rng.integers(3, v, (4, t0))).to(dev)
  _k4_reset()
  out8 = lm_lib.greedy_generate(int8, prompt, new)
  launches += _k4_expect("(g) int8 greedy b4", n_layers * new)
  _teacher_forced(int8, "(g) int8", [(p[:t0], p[t0:])
                                     for p in out8.tolist()])
  out16 = lm_lib.greedy_generate(model, prompt, new)
  print(f"  equal prefix against the bf16 model: "
        f"{[_equal_prefix(a, b) for a, b in zip(out8[:, t0:].tolist(), out16[:, t0:].tolist())]} of {new}")
  del int8

  # (h) use_combined_qkv: wqkv stacked from the separate weights.
  ccfg = copy.deepcopy(cfg)
  ccfg.update(dict(use_combined_qkv=True))
  combined = lm_lib.TransformerLM(ccfg, device=dev)
  state = model.state_dict()
  for i in range(n_layers):
    pre = f"blocks.{i}.attn."
    state[pre + "wqkv"] = torch.stack([state.pop(pre + w)
                                       for w in ("wq", "wk", "wv")])
  combined.load_state_dict(state)
  lm_lib.cast_lm_params_for_serving(combined)
  prompt = torch.from_numpy(rng.integers(3, v, (2, 512))).to(dev)
  kv_pos = torch.arange(1024, device=dev).expand(2, 1024)
  with torch.inference_mode():
    got, want = (m(prompt, positions=kv_pos[:, :512],
                   cache=m.init_cache(2, 1024), cache_index=0,
                   kv_positions=kv_pos)[0] for m in (combined, model))
  diff = (got - want).abs()
  print(f"(h) use_combined_qkv prefill logits (b2 x 512) against the separate "
        f"weights: max|diff| {float(diff.max()):.4f} (limit 0.25), "
        f"mean|diff| {float(diff.mean()):.5f} (limit 0.02)")
  if float(diff.max()) > 0.25 or float(diff.mean()) > 0.02:
    raise AssertionError("(h) the combined qkv disagrees")
  del combined, state, got, want, diff

  # (i) the CLI on the card, each mode with its default device, on the run
  # directory that main_lm wrote.
  del model
  torch.cuda.empty_cache()
  ckpt = os.path.join(target_run, "ckpt")
  latest = max(checkpoint.all_checkpoint_steps(ckpt))
  earlier = latest - FUSED_CKPT_EVERY
  print(f"(i) cli/generate_lm --model_dir=<main_lm's run directory of "
        f"lm-flops1e19: phase 5's fused run, steps {earlier} and {latest}>, "
        "default device")
  base = [f"--model_dir={target_run}", "--max_new_tokens=32"]
  texts = [f"request {i}: " + "the quick brown fox " * (2 + 9 * i)
           for i in range(8)]
  at = lambda d, step: f"weights of {os.path.join(d, 'ckpt')} at step {step}"
  npz = f"weights of {os.path.join(draft_dir, 'params.npz')}"
  runs = {
      "serve_slots": (base + ["--serve_slots=8", "--prefill_chunk=256",
                              "--system_prompt=You are a helpful model. "],
                      "\n".join(texts) + "\n", [at(target_run, latest)]),
      "num_beams": (base + ["--num_beams=4", f"--prompt={texts[1]}"], None,
                    [at(target_run, latest)]),
      "draft (params.npz)": (base + [f"--draft_model_dir={draft_dir}",
                                     f"--prompt={texts[2]}"], None,
                             [at(target_run, latest), npz]),
      "int8": (base + ["--int8", f"--prompt={texts[3]}"], None,
               [at(target_run, latest)]),
      f"step {earlier}": (base + [f"--step={earlier}", f"--prompt={texts[4]}"],
                          None, [at(target_run, earlier)]),
  }
  for name, (argv, stdin, reads) in runs.items():
    launches += _cli_run(f"(i) {name}", argv, stdin, reads,
                         len(texts) if stdin else 1)

  # (j) a draft that main_lm trains on the target's stream (SyntheticLMData,
  # seed 0, b8 T2048), both directories read by the CLI's loader.
  draft_run = os.path.join(workdir, "draft_run")
  steps = DRAFT_STEPS
  k = 4
  print(f"(j) main_lm trains lm-flops2e17 (the draft) for {steps} steps at "
        f"b8 T2048 on the target's stream, with the target's flags (Lion, "
        f"lr {DRAFT_LR:g}); then speculative decoding "
        f"with it against lm-flops1e19 at step {latest}, b1, k {k}: "
        f"{PATTERN_PROMPT} + {PATTERN_NEW} tokens of a pattern, "
        f"{DRAFT_PROMPT} + {DRAFT_NEW} of README.md")
  # bf16, hd 32, D 256: every launch the Hopper kernels'; full remat runs
  # K1 twice a layer and step.
  nd = dcfg.n_layers * steps
  expected = dict.fromkeys(TRAIN_KERNELS, 0)
  expected.update({"K1": 2 * nd, "K1 sm90": 2 * nd, "K2": nd, "K2 sm90": nd})
  expected.update(dict.fromkeys(("K3a", "K3a sm90", "K3b", "K3b sm90", "K3c",
                                 "K3c sm90"), steps))
  draft_launches = _train_run(
      draft_run, [
          "--config_name=lm-flops2e17", "--batch_size=8", "--warmup_steps=3",
          "--log_every=1", "--device=cuda", f"--model_dir={draft_run}",
          f"--learning_rate={DRAFT_LR}",
          "--experiment_config=use_flash_attention=true,"
          "fused_softmax_loss=pallas"], steps,
      "the draft, fused loss, full remat, K2",
      expected, _step_flops(dcfg, 8, dcfg.seq_len, fused=True), cfg=dcfg)
  _, target = generate_lm.load_model(model_dir=target_run, device=dev)
  _, draft = generate_lm.load_model(model_dir=draft_run, device=dev)
  lm_lib.cast_lm_params_for_serving(target)
  lm_lib.cast_lm_params_for_serving(draft)
  pattern = next(iter(SyntheticLMData(1, PATTERN_PROMPT - 1, v,
                                      seed=DRAFT_PROMPT_SEED)))["tokens"]
  with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "README.md")) as f:
    readme = f.read()
  text = lm_pipeline.ByteTokenizer().encode(
      readme[readme.index(README_PARAGRAPH):])[:DRAFT_PROMPT]
  ids = pattern[0].tolist()
  print(f"  teacher-forced next-token accuracy on the pattern prompt (from "
        f"position 4, where the stream's rule fixes the token): target "
        f"{_next_token_share(target, ids):.4f}, draft "
        f"{_next_token_share(draft, ids):.4f}")
  for name, ids, new, partial in (
      ("a 4-token pattern repeated", ids, PATTERN_NEW, False),
      ("README.md's bytes", text, DRAFT_NEW, True)):
    prompt = torch.tensor([ids], device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ref = lm_lib.greedy_generate(target, prompt, new)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t
    print(f"  {name}, {len(ids)} tokens: greedy_generate b1 "
          f"{new / greedy_s:.1f} tokens/s ({greedy_s:.3f} s)")
    launches += _speculative(f"(j) trained draft, {name}", target, draft,
                             prompt, new, k, ref, greedy_s, partial)
  launches += _cli_run(
      "(j) cli", [f"--model_dir={target_run}", f"--draft_model_dir={draft_run}",
                  f"--prompt={texts[5]}", "--max_new_tokens=32"], None,
      [at(target_run, latest), at(draft_run, steps)], 1)
  del target, draft
  torch.cuda.empty_cache()
  print(f"lm serving phase: {time.perf_counter() - t_phase:.1f} s")
  return launches, draft_launches


def _next_token_share(model, ids):
  """The share of positions from 4 on where one no-cache forward of `ids`
  puts its argmax on the next token (the stream's rule: a token repeats
  the one 4 before it)."""
  import torch
  with torch.inference_mode():
    logits = model(torch.tensor([ids[:-1]], device=model.device))[0][0]
  hits = logits.argmax(-1)[3:] == torch.tensor(ids[4:], device=model.device)
  return float(hits.float().mean())


def _cli_run(label, argv, stdin, reads, want_n):
  """cli/generate_lm.main(argv) with `stdin` as its standard input: the
  lines it prints on the weights it read must be `reads`, and it must
  return want_n outputs. Returns its K4 launches."""
  import contextlib
  import io
  from automl_tpu_torch.cli import generate_lm
  t = time.perf_counter()
  saved = sys.stdin
  sys.stdin = io.StringIO(stdin or "")
  printed = io.StringIO()
  _k4_reset()
  try:
    with contextlib.redirect_stdout(printed):
      outs = generate_lm.main(argv)
  finally:
    sys.stdin = saved
  k4 = _k4_counts()[0]
  lines = [ln[len("generate_lm: "):] for ln in printed.getvalue().splitlines()
           if ln.startswith("generate_lm: weights of ")]
  print(f"  {label}: {len(outs)} outputs (expected {want_n}) in "
        f"{time.perf_counter() - t:.1f} s; K4 launches {k4}; {lines}; first: "
        f"{outs[0][:40]!r}")
  if len(outs) != want_n:
    raise AssertionError(f"{label}: {len(outs)} outputs")
  if lines != reads:
    raise AssertionError(f"{label}: read {lines}, expected {reads}")
  return k4


# ---------------------------------------------------------------------------
# Classification (EfficientNetV2): inference, training, K6 at V2-S's maps.
# ---------------------------------------------------------------------------

# The cut: V2-S trains at b256 (the config's global batch is 4,096). 256
# is the cap of the cut (the largest power of two <= 256 that fits at the
# last stage's 296 x 296), not a measured limit: it fits, its stage-3 step
# peaking at 56.68 GiB (this script's stage line, H100 80GB HBM3 at 700 W),
# and no larger batch was tried.
V2S_BATCH = 256
# Steps a stage: cut from 10 for the script's time (the step time is the
# median of a stage's steps 3 on).
V2S_STAGE_STEPS = 6
# The K6 knob-on and knob-off runs draw the same batches, crops, RandAugment
# ops and masks from the same seeds; they differ only in the bf16 rounding
# of the 28 depthwise filter gradients (f32 sums in other orders), from step
# 1's update on. Measured on the H100 (b256): stage 0's losses at most
# 0.15% apart, each stage's mean loss at most 0.34%. The limits: each of
# stage 0's steps and each stage's mean within CLS_KNOB_RTOL.
CLS_KNOB_RTOL = 1e-2
# Card f32 logits (TF32 off) against the CPU's from the same weights: the
# fc kernel is scaled (FC_SCALE) so that the logits are of order 1 and the
# top 5 are apart (seeded weights give logits of order 1e-3 and 1e-1).
CLS_LOGIT_ATOL = 1e-3
FC_SCALE = {"efficientnetv2-b0": 2000.0, "efficientnetv2-s": 30.0}
# cls_train_preprocess on the card against the CPU from the same draws, on
# [0, 255]: images whose RandAugment layers draw no nearest warp within
# PRE_ATOL everywhere; the others at most PRE_WARP_SHARE of their pixels
# off by more (a source coordinate within an ulp of .5 rounds either way).
PRE_ATOL = 1e-3
PRE_WARP_SHARE = 1e-3
CLS_LOSS_RTOL = 1e-4
# The state after one f32 RMSProp step, card against CPU: the params
# within CLS_STATE_SHARE of the largest update (decay 0.9 and nu from 0, so
# an update is at most lr * sqrt(10) an element), the BN statistics within
# CLS_STATE_SHARE of their largest change; the same for their EMA. A
# per-leaf relative rule cannot hold: where a train-mode BN cancels a
# gradient (a block's last BN beta, whose residual stream only 1x1 convs,
# each before a BN, read), both devices' gradients are rounding noise that
# RMSProp scales by up to lr / sqrt(eps); where a statistic is zero in exact
# arithmetic (the mean of an expand conv fed by a BN's zero-mean output),
# both devices' statistics are rounding noise.
CLS_F32_LR = 0.016
CLS_STATE_SHARE = 1e-3
CLS_UPDATE_ATOL = CLS_STATE_SHARE * CLS_F32_LR * 10 ** 0.5


def _cls_config(name="efficientnetv2-s", **overrides):
  from automl_tpu_torch.configs.effnet_configs import get_model_config
  cfg = get_model_config(name)
  cfg.override(overrides)
  return cfg


def _stride1_depthwise_maps(model, size: int) -> dict:
  """{(C, H, W, k): calls a step} of the K6 calls of a classifier's training
  step at size x size: the stride-1 depthwise convs, with the map each
  sees (the stem and every stride-2 block halve it, SAME)."""
  from automl_tpu_torch.nn import layers as L
  h = -(-size // 2)
  maps = {}
  for block in model.blocks:
    dwc = getattr(block, "depthwise_conv2d", None)
    if isinstance(dwc, L.DepthwiseConv2D) and dwc.strides == (1, 1):
      key = (dwc.out_ch, h, h, dwc.kernel_size[0])
      maps[key] = maps.get(key, 0) + 1
    h = -(-h // block.args.strides)
  return maps


def _cls_infer_check(dev):
  """(a) infer_cls's predict (bm) on V2-B0 224 b8 and V2-S 384 b32; the
  card's f32 logits (TF32 off) against the CPU's from the same weights (B0
  b8, V2-S b4): atol CLS_LOGIT_ATOL and the top-5 equal; under
  mixed_bfloat16, the share of images whose top-1 is the CPU f32's."""
  import numpy as np
  import torch
  from automl_tpu_torch.cli import infer_cls
  from automl_tpu_torch.data import preprocessing
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.train import runners
  for name, b in (("efficientnetv2-b0", 8), ("efficientnetv2-s", 32)):
    r = infer_cls.main([f"--model_name={name}", "--runmode=bm",
                        f"--batch_size={b}", "--device=cuda"])
    cfg = _cls_config(name)
    print(f"infer_cls bm {name} {cfg.eval.isize}x{cfg.eval.isize} b{b} "
          f"(mixed_bfloat16, predict = eval preprocess + forward, CUDA "
          f"events): {r['fps']} img/s, {r['latency_ms']} ms a call")
  for name, b in (("efficientnetv2-b0", 8), ("efficientnetv2-s", 4)):
    cfg = _cls_config(name)
    isize = int(cfg.eval.isize)
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (b, isize + 32, isize + 32,
                                                    3), dtype=np.uint8))
    logits = {}
    for where, policy in (("cpu", "float32"), ("cuda", "float32"),
                          ("cuda", "mixed_bfloat16")):
      precision.set_policy(policy)
      model = runners.seeded_classification_model(cfg.model, 0, where)
      with torch.no_grad():
        model.head.fc.kernel.mul_(FC_SCALE[name])
        x = preprocessing.cls_eval_preprocess(images.to(where), isize)
        logits[(where, policy)] = model(x, train=False).float().cpu()
      del model
    precision.set_policy("mixed_bfloat16")
    cpu, card = logits[("cpu", "float32")], logits[("cuda", "float32")]
    err = float((card - cpu).abs().max())
    same5 = torch.equal(cpu.topk(5).indices, card.topk(5).indices)
    bf16 = logits[("cuda", "mixed_bfloat16")]
    agree = float((bf16.argmax(-1) == cpu.argmax(-1)).float().mean())
    gap = float((cpu.topk(6).values[:, :5] - cpu.topk(6).values[:, 1:])
                .min())
    print(f"{name} b{b} {isize}x{isize}, card f32 vs CPU f32 logits: "
          f"max|diff| {err:.3e} (limit {CLS_LOGIT_ATOL}, logits up to "
          f"{float(cpu.abs().max()):.3f}, smallest top-5 gap {gap:.3e}); "
          f"top-5 equal {same5}; mixed_bfloat16 top-1 = CPU f32 top-1 in "
          f"{100 * agree:.1f}% of the images")
    if not (err <= CLS_LOGIT_ATOL and same5):
      raise AssertionError(f"{name}: the card's f32 logits disagree with "
                           "the CPU's")
  torch.cuda.empty_cache()


_CLS_CHILD = r"""
import json, sys, time, torch
from automl_tpu_torch.cli import main_cls
from automl_tpu_torch.ops import depthwise as dw
from automl_tpu_torch.train import runners
f = dw.depthwise_filter_grad
marks = []
def mark():
  torch.cuda.synchronize()
  marks.append(dict(launches=f.launches, sm90=f.launches_sm90,
                    peak=torch.cuda.max_memory_allocated()))
  torch.cuda.reset_peak_memory_stats()
make = runners.make_cls_preprocess
def at_each_stage(*a, **k):
  mark()
  return make(*a, **k)
runners.make_cls_preprocess = at_each_stage
for knob, argv in json.loads(sys.argv[1]):
  dw.enable_pallas_filter_grad(knob)
  marks.clear()
  f.launches = f.launches_sm90 = 0
  t = time.perf_counter()
  main_cls.main(argv)
  mark()
  print("CLS_RUN " + json.dumps(dict(marks=marks,
                                     secs=time.perf_counter() - t)),
        flush=True)
  torch.cuda.empty_cache()
"""


def _cls_train_runs(runs, steps: int, per_step: int, stage_sizes,
                    hparams="", label="V2-S"):
  """(b) cli/main_cls trains V2-S for `steps` steps over its progressive
  stages once for each (model_dir, K6 knob) of `runs`, one run after the
  other in one child process (its start paid once), the knob set in the
  child, its launch count and peak memory read at each stage's start (a
  wrapper of runners.make_cls_preprocess) and at the end. Checks the loss
  (finite, falling within each stage after the first) and the launches
  (per_step a step, all Hopper, with the knob; none without). `hparams`
  (",k=v,...") follows the batch size in --hparam_str. Returns, for each
  run, ([(size, step ms, img/s, peak GiB, launches)] per stage, the
  losses)."""
  argvs = []
  for workdir, knob in runs:
    shutil.rmtree(workdir, ignore_errors=True)
    argvs.append((knob, [
        "--model_name=efficientnetv2-s", f"--model_dir={workdir}",
        f"--train_steps={steps}", "--log_every=1", "--device=cuda",
        f"--hparam_str=train.batch_size={V2S_BATCH}{hparams}"]))
  root = os.path.dirname(os.path.abspath(__file__))
  t0 = time.perf_counter()
  proc = subprocess.run([sys.executable, "-c", _CLS_CHILD,
                         json.dumps(argvs)], cwd=root,
                        capture_output=True, text=True, timeout=900,
                        check=False)
  wall = time.perf_counter() - t0
  if proc.returncode != 0:
    print(proc.stdout[-3000:], proc.stderr[-6000:])
    raise AssertionError(f"main_cls ({runs}) exited {proc.returncode}")
  # Each run's lines end at its CLS_RUN line.
  outs, lines = [], []
  for line in proc.stdout.splitlines():
    if line.startswith("CLS_RUN "):
      outs.append((lines, json.loads(line[len("CLS_RUN "):])))
      lines = []
    else:
      lines.append(line)
  if len(outs) != len(runs):
    raise AssertionError(f"main_cls ran {len(outs)} of {len(runs)} runs")
  print(f"{label}: {len(runs)} run(s) of {steps} steps in one child process "
        f"in {wall:.1f} s (its start and the model builds included)")
  return [_cls_run_check(workdir, knob, steps, per_step, stage_sizes, label,
                         lines, run["marks"], run["secs"])
          for (workdir, knob), (lines, run) in zip(runs, outs)]


def _cls_run_check(workdir, knob, steps, per_step, stage_sizes, label,
                   lines, marks, wall):
  """One run of _cls_train_runs (`wall`: its seconds in the child): its
  losses, stages and launches checked and printed."""
  import numpy as np
  for line in lines:
    if line.startswith("step ") and int(line.split()[1]) % 10 in (1, 0):
      print(f"  {line}")
  recs = [json.loads(line) for line in
          open(os.path.join(workdir, "metrics.jsonl")).read().splitlines()]
  losses = [r["loss"] for r in recs]
  print(f"losses (K6 knob {'on' if knob else 'off'}): "
        f"{' '.join(f'{x:.3f}' for x in losses)}")
  if [r["step"] for r in recs] != list(range(1, steps + 1)) or not all(
      math.isfinite(x) for x in losses):
    raise AssertionError("training steps missing or loss not finite")
  # Each stage draws its own synthetic batch (at its canvas), repeated
  # through the stage: the loss must fall within each stage after the
  # first (the mean of its last 3 steps below its first step's). Stage 0
  # rises before it falls, in both runs alike: 40 steps of a 350-epoch
  # config make steps_per_epoch 1, so the lr warms up to 0.016 in 5 steps,
  # and RMSProp's nu starts at 0 (decay 0.9), which scales step t's update
  # by 1 / sqrt(1 - 0.9^t), 3.2x at step 1. The update itself is held to
  # the CPU's in _cls_step1, and the two runs' losses to each other in
  # cls_phase.
  per_stage = steps // len(stage_sizes)
  for i in range(1, len(stage_sizes)):
    stage = losses[i * per_stage:(i + 1) * per_stage]
    if not np.mean(stage[-3:]) < stage[0]:
      raise AssertionError(f"loss did not fall in stage {i}: {stage[0]:.4f} "
                           f"-> {np.mean(stage[-3:]):.4f}")
  out = []
  for i, size in enumerate(stage_sizes):
    launches = marks[i + 1]["launches"] - marks[i]["launches"]
    sm90 = marks[i + 1]["sm90"] - marks[i]["sm90"]
    secs = [r["secs_per_step"] for r in recs[i * per_stage:(i + 1) *
                                              per_stage]]
    step_ms = float(np.median(secs[2:])) * 1e3
    peak = marks[i + 1]["peak"] / 2**30
    out.append((size, step_ms, V2S_BATCH / step_ms * 1e3, peak, launches))
    print(f"{label} train b{V2S_BATCH} stage {i} {size}x{size} bf16, K6 knob "
          f"{'on' if knob else 'off'}: step {step_ms:.1f} ms (median of the "
          f"stage's steps 3-{per_stage}), {V2S_BATCH / step_ms * 1e3:.1f} "
          f"img/s, peak memory {peak:.2f} GiB, K6 launches {launches} "
          f"({sm90} Hopper)")
    expected = per_step * per_stage if knob else 0
    if launches != expected or sm90 != expected:
      raise AssertionError(f"stage {i}: {launches} K6 launches ({sm90} "
                           f"Hopper), expected {expected}")
  print(f"{label}, {steps} steps in {wall:.1f} s (the model build included; "
        f"the child's start not); loss by stage, first step -> mean of the "
        f"last 3: "
        + ", ".join(f"{stage[0]:.4f} -> {np.mean(stage[-3:]):.4f}"
                    for stage in (losses[i * per_stage:(i + 1) * per_stage]
                                  for i in range(len(stage_sizes)))))
  return out, losses


def _cls_knob_losses_check(on, off):
  """The knob-on and knob-off V2-S runs' losses against each other: each
  of stage 0's steps and each stage's mean within CLS_KNOB_RTOL."""
  import numpy as np
  on, off = np.asarray(on), np.asarray(off)
  per = V2S_STAGE_STEPS
  step_rel = np.abs(on[:per] - off[:per]) / np.abs(off[:per])
  means_on, means_off = (x.reshape(-1, per).mean(1) for x in (on, off))
  mean_rel = np.abs(means_on - means_off) / np.abs(means_off)
  print(f"V2-S losses, K6 knob on vs off: stage 0's steps at most "
        f"{100 * step_rel.max():.3f}% apart, the stages' mean losses "
        f"{' '.join(f'{a:.4f}/{b:.4f}' for a, b in zip(means_on, means_off))}"
        f" at most {100 * mean_rel.max():.3f}% apart (limit "
        f"{100 * CLS_KNOB_RTOL:g}%); the whole run's steps at most "
        f"{100 * (np.abs(on - off) / np.abs(off)).max():.3f}% apart")
  if step_rel.max() > CLS_KNOB_RTOL or mean_rel.max() > CLS_KNOB_RTOL:
    raise AssertionError("the V2-S run with the K6 knob on drifted from "
                         "the run with it off")


def _cls_state_check(name, new, ref_new, ref_old, limit=None, what="V2-S"):
  """Leaves after one f32 step, card against CPU: the largest max|diff|
  within `limit`, by default CLS_STATE_SHARE of the largest change the
  step made to these leaves on the CPU."""
  diff = {k: float((new[k].double() - ref_new[k].double()).abs().max())
          for k in ref_new}
  step = max(float((ref_new[k].double() - ref_old[k].double()).abs().max())
             for k in ref_new)
  limit = CLS_STATE_SHARE * step if limit is None else limit
  worst = max(diff, key=diff.get)
  print(f"  {name}: {len(diff)} leaves, largest change {step:.3e}, largest "
        f"max|card - CPU| {diff[worst]:.3e} at {worst} (limit {limit:.3e})")
  if diff[worst] > limit:
    raise AssertionError(f"{what} f32 step 1: the card's {name} disagree "
                         "with the CPU's")


def _cls_step1(dev):
  """(c) Step 1 of V2-S (b8, 168 x 168, bf16) with the K6 knob off and on,
  from one model and one preprocessed batch, the dropout / drop_connect
  masks from one seed; then _cls_card_vs_cpu from the same weights and
  batch."""
  import torch
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.nn import layers as L
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.ops import depthwise as dw
  from automl_tpu_torch.ops import losses
  from automl_tpu_torch.train import runners
  cfg = _cls_config()
  b, size = 8, 168
  raw = pipeline.SyntheticClassification(b, int(size * 1.15) // 2 * 2,
                                         1000).batch
  precision.set_policy("mixed_bfloat16")
  model = runners.seeded_classification_model(cfg.model, 0, dev)
  prep = runners.make_cls_preprocess(cfg, size, 2.5, 0.0, 0.0)
  cpu_gen = torch.Generator()
  batch = prep({k: torch.from_numpy(v).to(dev) for k, v in raw.items()},
               cpu_gen.manual_seed(7))
  trainable = {k: p for k, p in model.named_parameters()}
  out = {}
  for knob in (False, True):
    dw.enable_pallas_filter_grad(knob)
    try:
      logits = model(batch["image"], train=True,
                     generator=cpu_gen.manual_seed(8))
      L.take_bn_updates(model)
      loss = losses.cross_entropy(logits, batch["label"], 0.1)
      grads = torch.autograd.grad(loss, list(trainable.values()),
                                  allow_unused=True)
      torch.cuda.synchronize()
    finally:
      dw.enable_pallas_filter_grad(False)
    print(f"V2-S step 1 (b{b}, {size}x{size}), K6 knob "
          f"{'on' if knob else 'off'}: loss {float(loss.detach()):.6f}")
    out[knob] = (float(loss.detach()),
                 {k: g if g is not None else torch.zeros_like(p)
                  for (k, p), g in zip(trainable.items(), grads)})
  k6_leaves = sorted(
      f"{name}.kernel" for name, m in model.named_modules()
      if isinstance(m, L.DepthwiseConv2D) and m.strides == (1, 1))
  if len(k6_leaves) != 28:
    raise AssertionError(f"V2-S has {len(k6_leaves)} stride-1 depthwise "
                         "convs, not 28")
  _det_step1_check(out, k6_leaves, "V2-S")
  del model, out, batch
  torch.cuda.empty_cache()

  _cls_card_vs_cpu(dev, cfg, raw, prep, f"b{b}, {size}x{size}")


def _cls_card_vs_cpu(dev, cfg, raw, prep, what):
  """Two f32 make_cls_train_step steps (RMSProp, EMA, the stage's
  preprocess) on the card and on the CPU from the same weights, batch and
  draws (a CPU generator feeds both): each step's loss within
  CLS_LOSS_RTOL (step 2's after the update); after step 1 the params, the
  BN statistics and their EMA under _cls_state_check."""
  import torch
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.train import optimizers, runners, train_lib
  precision.set_policy("float32")
  losses_by, snaps = {}, {}
  snap = lambda d: {k: v.detach().clone().cpu() for k, v in d.items()}
  for where in (str(dev), "cpu"):
    m = runners.seeded_classification_model(cfg.model, 0, where)
    tx = optimizers.masked_for_params(optimizers.build_optimizer(
        "rmsprop", CLS_F32_LR))
    step = train_lib.make_cls_train_step(m, tx, cfg, preprocess_fn=prep)
    state = train_lib.create_train_state(m, tx)
    old = snap(state.params)
    batch = {k: torch.from_numpy(v).to(where) for k, v in raw.items()}
    gen = torch.Generator()
    t0 = time.perf_counter()
    state, metrics = step(state, batch, gen.manual_seed(9))
    snaps[where] = (snap(state.params), old, snap(state.ema_params))
    state, metrics2 = step(state, batch, gen.manual_seed(10))
    losses_by[where] = (float(metrics["loss"]), float(metrics2["loss"]))
    print(f"V2-S f32 steps 1 and 2 ({what}) on the {where}: loss "
          f"{losses_by[where][0]:.7f}, {losses_by[where][1]:.7f} "
          f"({time.perf_counter() - t0:.1f} s)")
    del m, state, step, batch
  precision.set_policy("mixed_bfloat16")
  card, cpu = losses_by[str(dev)], losses_by["cpu"]
  rel = [abs(a - c) / abs(c) for a, c in zip(card, cpu)]
  print(f"V2-S f32 steps 1 and 2, card vs CPU: loss rel. diff {rel[0]:.3e} "
        f"and {rel[1]:.3e} (limit {CLS_LOSS_RTOL})")
  (p_card, _, ema_card), (p_cpu, old_cpu, ema_cpu) = (snaps[str(dev)],
                                                       snaps["cpu"])
  stats = [k for k in p_cpu if optimizers.is_batch_stat(k)]
  params = [k for k in p_cpu if k not in stats]
  for what, card_d, cpu_d in (("", p_card, p_cpu),
                              ("EMA of the ", ema_card, ema_cpu)):
    _cls_state_check(what + "params", {k: card_d[k] for k in params},
                     {k: cpu_d[k] for k in params}, old_cpu, CLS_UPDATE_ATOL)
    _cls_state_check(what + "BN statistics", {k: card_d[k] for k in stats},
                     {k: cpu_d[k] for k in stats}, old_cpu)
  if max(rel) > CLS_LOSS_RTOL:
    raise AssertionError("V2-S f32 steps on the card disagree with the CPU")
  torch.cuda.empty_cache()


def _cls_mixing_run(workdir):
  """(d) 10 V2-S steps (b32, one stage at 168 x 168) with V2-M's
  mixup_alpha = cutmix_alpha = 0.2, through main_cls: every step mixes
  (augment.mixing called once a step), the loss finite."""
  import torch
  from automl_tpu_torch.cli import main_cls
  from automl_tpu_torch.data import augment
  shutil.rmtree(workdir, ignore_errors=True)
  calls = []
  mixing = augment.mixing
  augment.mixing = lambda *a, **k: calls.append(1) or mixing(*a, **k)
  try:
    t0 = time.perf_counter()
    out = main_cls.main([
        "--model_name=efficientnetv2-s", f"--model_dir={workdir}",
        "--train_steps=10", "--log_every=1", "--device=cuda",
        "--hparam_str=train.batch_size=32,train.stages=1,train.isize=168,"
        "data.mixup_alpha=0.2,data.cutmix_alpha=0.2"])
  finally:
    augment.mixing = mixing
  recs = [json.loads(line) for line in
          open(os.path.join(workdir, "metrics.jsonl")).read().splitlines()]
  losses = [r["loss"] for r in recs]
  print(f"V2-S b32 168x168 with mixup and cutmix 0.2 (half the batch each): "
        f"10 steps in {time.perf_counter() - t0:.1f} s, mixing called "
        f"{len(calls)} times; losses {' '.join(f'{x:.3f}' for x in losses)}")
  if len(calls) != 10 or len(losses) != 10 or not all(
      math.isfinite(x) for x in losses) or not math.isfinite(out["loss"]):
    raise AssertionError("the mixing run failed")
  torch.cuda.empty_cache()


def _cls_preprocess_check(dev):
  """(e) cls_train_preprocess (crop, flip, RandAugment 2 layers at m 10,
  v2 normalization) at b32 from 340 x 340 canvases to 296 x 296, on the
  card and on the CPU from the same draws, compared on [0, 255]: images
  with no nearest warp drawn within PRE_ATOL, the others at most
  PRE_WARP_SHARE of their pixels off by more."""
  import torch
  from automl_tpu_torch.data import augment, pipeline, preprocessing
  b, canvas, out = 32, 340, 296
  images = torch.from_numpy(pipeline.SyntheticClassification(
      b, canvas, 1000, seed=3).batch["image"])
  draws = preprocessing.cls_train_draws(b, out, torch.Generator().manual_seed(
      0), 2)   # seed 0 draws all 16 ops
  to = lambda d, dev: {k: (to(v, dev) if isinstance(v, dict) else v.to(dev))
                       for k, v in d.items()}
  res = {}
  for where in ("cpu", dev):
    x = preprocessing.cls_train_preprocess(images.to(where), to(draws, where),
                                           out, "randaug", 10.0)
    res[str(where)] = (x.float().cpu().permute(0, 2, 3, 1) * 128.0 + 128.0)
  cpu, card = res["cpu"], res[str(dev)]
  warps = {augment.OPS.index(n) for n in ("rotate", "shear_x", "shear_y",
                                          "translate_x", "translate_y")}
  off = ((card - cpu).abs() > PRE_ATOL).any(-1).float().mean((1, 2))
  worst_plain = worst_warp = 0.0
  for i in range(b):
    ops = set(draws["randaug"]["op"][i].tolist())
    if ops & warps:
      worst_warp = max(worst_warp, float(off[i]))
    else:
      worst_plain = max(worst_plain, float((card[i] - cpu[i]).abs().max()))
  n_warp = sum(bool(set(o.tolist()) & warps) for o in draws["randaug"]["op"])
  print(f"cls_train_preprocess b{b} {canvas}->{out}, RandAugment m10, card "
        f"vs CPU from the same draws: {b - n_warp} images without a nearest "
        f"warp, max|diff| {worst_plain:.3e} on [0, 255] (limit {PRE_ATOL}); "
        f"{n_warp} with one, at most {100 * worst_warp:.3f}% of an image's "
        f"pixels off by more than {PRE_ATOL} (limit {100 * PRE_WARP_SHARE}%)")
  if worst_plain > PRE_ATOL or worst_warp > PRE_WARP_SHARE:
    raise AssertionError("cls_train_preprocess on the card disagrees with "
                         "the CPU")
  ops_seen = sorted({augment.OPS[o] for o in
                     draws["randaug"]["op"].flatten().tolist()})
  print(f"  ops drawn: {len(ops_seen)} of 16 ({', '.join(ops_seen)})")


def _cls_eval_check(dev, ckpt_dir):
  """(f) evaluate_classification at 384 x 384 (V2-S's eval size, b32, 2
  synthetic minival batches) with the EMA of the knob-on run's last
  checkpoint (stage 4): top-1 and top-5 in [0, 1]."""
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.cli import infer_cls
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.train import runners
  cfg = _cls_config()
  precision.set_policy("mixed_bfloat16")
  model = runners.seeded_classification_model(cfg.model, 0, dev)
  infer_cls.load_params(model, ckpt_dir, use_ema=True)
  t0 = time.perf_counter()
  m = runners.evaluate_classification(
      model, convert.model_state(model), cfg,
      iter(pipeline.SyntheticClassification(32, 384 + 32, 1000)), 2)
  print(f"evaluate_classification, V2-S 384x384 b32, the EMA of the last "
        f"checkpoint, 2 synthetic batches ({time.perf_counter() - t0:.1f} "
        f"s): top1 {m['top1']:.4f}, top5 {m['top5']:.4f}, samples "
        f"{m['samples']:.0f}")
  if m["samples"] != 64 or not (0 <= m["top1"] <= m["top5"] <= 1):
    raise AssertionError(f"classification eval malformed: {m}")
  del model
  torch.cuda.empty_cache()


def k6_v2s_phase(dev, flush, sizes=(168, 296), batches=(8, V2S_BATCH)):
  """(g) K6 at every distinct map of V2-S's training steps at 168 and 296
  (bf16, b8 and the smoke's batch): the Hopper kernel against its plain
  version (K6_SHARE, a second call bit-equal), then the Hopper kernel,
  depthwise.cu's and cuDNN's weight gradient timed in turns (L2
  flushed), beside the bound; and each step's launch-weighted sums."""
  import torch
  from automl_tpu_torch.models.efficientnet import EfficientNet
  from automl_tpu_torch.ops import depthwise as dw
  model = EfficientNet(_cls_config().model, device="meta")
  gen = torch.Generator(device=dev).manual_seed(5)
  kern = dw.depthwise_filter_grad_kernel
  ref = dw.depthwise_filter_grad_reference
  f = dw.depthwise_filter_grad
  for size in sizes:
    maps = _stride1_depthwise_maps(model, size)
    for b in batches:
      sums = dict(ms=0.0, simt=0.0, lib=0.0, bound=0.0)
      for (c, h, w, k), calls in maps.items():
        label = f"[{b},{c},{h},{w}] k{k}"
        x, dy = [torch.randn((b, c, h, w), generator=gen, device=dev)
                 .to(torch.bfloat16).contiguous(
                     memory_format=torch.channels_last) for _ in range(2)]
        before = f.launches_sm90
        got = kern(x, dy, k)
        torch.cuda.synchronize()
        if f.launches_sm90 != before + 1:
          raise AssertionError(f"K6 {label}: not the Hopper kernel")
        _compare_scaled(f"V2-S {size} {label}", got, ref(x, dy, k), K6_SHARE)
        if not torch.equal(got, kern(x, dy, k)):
          raise AssertionError(f"K6 gave two results: {label}")
        weight = torch.randn((c, 1, k, k), generator=gen, device=dev).to(
            torch.bfloat16)
        pad = (k - 1) // 2
        fns = {
            "ms": lambda: kern(x, dy, k),
            "simt": lambda: kern(x, dy, k, _simt=True),
            "lib": lambda: torch.ops.aten.convolution_backward(
                dy, x, weight, None, [1, 1], [pad, pad], [1, 1], False,
                [0, 0], c, [False, True, False])[1]}
        order = ["ms", "simt", "lib", "lib", "simt", "ms"]
        turns = {key: [] for key in fns}
        for key in order:
          turns[key].append(_time_ms(fns[key], 20, flush))
        t = {key: sum(v) / len(v) for key, v in turns.items()}
        n = b * c * h * w
        bound_ms, by = _bound(2.0 * k * k * n, 2 * 2 * n + 4 * c * k * k,
                              PEAK_F32_FLOPS)
        for key in ("ms", "simt", "lib"):
          sums[key] += calls * t[key]
        sums["bound"] += calls * bound_ms
        plan = dw.sm90_plan(b, c, h, w, k, dw._sms(dev.index or 0))
        print(f"  K6 V2-S {size}: {label} x{calls} a step (plan "
              f"{tuple(plan)}): Hopper {t['ms']:.4f} ms, depthwise.cu "
              f"{t['simt']:.4f}, cuDNN {t['lib']:.4f}, bound {bound_ms:.4f} "
              f"({by}); Hopper/cuDNN {t['ms'] / t['lib']:.2f}")
        del x, dy, got
      print(f"K6 over a V2-S step at {size}x{size}, b{b} "
            f"({sum(maps.values())} calls, calls x ms): Hopper "
            f"{sums['ms']:.4f} ms, depthwise.cu {sums['simt']:.4f}, cuDNN "
            f"{sums['lib']:.4f}, bound {sums['bound']:.4f}; Hopper/cuDNN "
            f"{sums['ms'] / sums['lib']:.2f}")
  torch.cuda.empty_cache()


def cls_phase(dev, workdir):
  """Classification: (a) inference, (b) V2-S training through main_cls
  with the K6 knob on and off, (c) the step-1 checks, (d) mixing, (e) the
  preprocess card vs CPU, (f) eval with the EMA. Returns the knob-on run's
  K6 launches and the knob-off and knob-on runs' stage-0 step ms."""
  import torch
  from automl_tpu_torch.models.efficientnet import EfficientNet
  from automl_tpu_torch.train import runners
  t0 = time.perf_counter()
  _cls_infer_check(dev)
  cfg = _cls_config()
  sizes = [runners._progressive_stage_params(cfg, i, 4)[0] for i in range(4)]
  meta = EfficientNet(cfg.model, device="meta")
  per_step = sum(_stride1_depthwise_maps(meta, sizes[0]).values())
  print(f"V2-S progressive stages: {sizes} px, RandAugment magnitude "
        f"{[runners._progressive_stage_params(cfg, i, 4)[1] for i in range(4)]}"
        f"; {per_step} K6 calls a step; maps at {sizes[0]}: "
        f"{_stride1_depthwise_maps(meta, sizes[0])}, at {sizes[-1]}: "
        f"{_stride1_depthwise_maps(meta, sizes[-1])}")
  steps = 4 * V2S_STAGE_STEPS
  (on, losses_on), (off, losses_off) = _cls_train_runs(
      [(workdir, True), (workdir + "_off", False)], steps, per_step, sizes)
  for (size, ms_on, _, peak_on, _), (_, ms_off, _, peak_off, _) in zip(on,
                                                                       off):
    print(f"V2-S {size}x{size} b{V2S_BATCH}: step {ms_on:.1f} ms knob on vs "
          f"{ms_off:.1f} off; peak {peak_on:.2f} vs {peak_off:.2f} GiB")
  _cls_knob_losses_check(losses_on, losses_off)
  _cls_step1(dev)
  _cls_mixing_run(workdir + "_mix")
  _cls_preprocess_check(dev)
  _cls_eval_check(dev, os.path.join(workdir, "ckpt"))
  torch.cuda.empty_cache()
  print(f"classification phase: {time.perf_counter() - t0:.1f} s")
  return sum(r[4] for r in on), off[0][1], on[0][1]


# ---------------------------------------------------------------------------
# 11. Real input files: the host library, fixtures, readers, training and
# eval from TFRecords.
# ---------------------------------------------------------------------------

# Fixtures (halved from 512 and 1,024 for the script's time; the
# readers time 8 D0 batches of 16 and 2 V2-S batches of 256 from them).
DATA_DET_IMAGES = 256      # COCO-like fixtures, 8 shards
DATA_CLS_IMAGES = 512      # ImageNet-like fixtures, 8 shards
DATA_SHARDS = 8
DATA_PSNR_DB = 30.0        # decode(encode(x)) of a fixture, quality 90
DATA_EVAL_SAMPLES = 128


def host_facts():
  """The card machine's toolchain for the host library: g++, libjpeg's
  header, the JPEG libraries the loader sees; the drawing and video
  modules (PIL, matplotlib, cv2, yaml: inference/visualize.py,
  cli/inspector.py's video mode, label_util's yaml maps) with their
  versions; and the CPU count."""
  def sh(cmd):
    p = subprocess.run(cmd, shell=True, capture_output=True, text=True,
                       timeout=60, check=False)
    return p.returncode, (p.stdout + p.stderr).strip()
  rc, out = sh("g++ --version")
  print(f"host: g++: {out.splitlines()[0] if rc == 0 and out else 'missing'}")
  rc, _ = sh("echo '#include <jpeglib.h>' | g++ -E -x c++ - >/dev/null")
  print(f"host: jpeglib.h {'found' if rc == 0 else 'not found'} by g++")
  _, out = sh("ldconfig -p | grep -E 'libjpeg|libnvjpeg'")
  for line in out.splitlines() or ["(none)"]:
    print(f"host: ldconfig: {line.strip()}")
  for module in ("PIL", "matplotlib", "cv2", "yaml"):
    rc, out = sh(f"{sys.executable} -c 'import {module}; "
                 f"print({module}.__version__)'")
    print(f"host: {module} " + (out.splitlines()[-1] if rc == 0 else
                                "not importable"))
  print(f"host: nproc {os.cpu_count()}")


def _smooth_image(rng, h, w, boxes=()):
  """A COCO-like test image: gradients, a little noise, and a filled
  rectangle of its own colour per box (ymin, xmin, ymax, xmax) in
  pixels."""
  import numpy as np
  y = np.arange(h, dtype=np.float32)[:, None, None]
  x = np.arange(w, dtype=np.float32)[None, :, None]
  c = rng.uniform(0.2, 1.0, 3).astype(np.float32)
  img = (x * (255 / w) * c + y * (255 / h) * c[::-1]) * 0.5 + 40
  for y0, x0, y1, x1 in boxes:
    img[int(y0):int(y1), int(x0):int(x1)] = rng.uniform(0, 255, 3)
  img += rng.randint(-3, 4, (h, w, 1))
  return np.clip(img, 0, 255).astype(np.uint8)


def _data_fixtures(root):
  """DATA_DET_IMAGES COCO-like JPEGs (640 x 480, 480 x 640, 640 x 427; 1-8
  boxes) as a COCO directory, turned into 8 shards by
  cli/create_coco_tfrecord, and DATA_CLS_IMAGES ImageNet-like 500 x 375
  JPEGs in 8 shards, all encoded on this machine
  (native_loader.jpeg_encode_rgb). Checks decode(encode(x)) on a
  few. Returns (det pattern, cls pattern, {source id: (h, w, annotations)})."""
  import numpy as np
  from automl_tpu_torch.cli import create_coco_tfrecord
  from automl_tpu_torch.data import native_loader as nl
  rng = np.random.RandomState(0)
  os.makedirs(os.path.join(root, "images"))
  images, anns, meta, psnr = [], [], {}, []
  t0 = time.perf_counter()
  for i in range(DATA_DET_IMAGES):
    h, w = ((480, 640), (640, 480), (427, 640))[i % 3]
    n = rng.randint(1, 9)
    bh, bw = rng.uniform(0.1, 0.5, n) * h, rng.uniform(0.1, 0.5, n) * w
    y0, x0 = rng.uniform(0, 1, n) * (h - bh), rng.uniform(0, 1, n) * (w - bw)
    boxes = np.stack([y0, x0, y0 + bh, x0 + bw], 1)
    img = _smooth_image(rng, h, w, boxes)
    data = nl.jpeg_encode_rgb(img, 90)
    if i < 8:
      psnr.append(10 * np.log10(255 ** 2 / np.mean(
          (nl.jpeg_decode_full(data).astype(np.float64) - img) ** 2)))
    with open(os.path.join(root, "images", f"{i}.jpg"), "wb") as f:
      f.write(data)
    images.append({"id": 1 + i, "file_name": f"{i}.jpg", "height": h,
                   "width": w})
    a = [{"id": len(anns) + j + 1, "image_id": 1 + i,
          "bbox": [float(x0[j]), float(y0[j]), float(bw[j]), float(bh[j])],
          "category_id": int(rng.randint(1, 91)), "iscrowd": 0,
          "area": float(bw[j] * bh[j])} for j in range(n)]
    anns += a
    meta[1 + i] = (h, w, a)
  with open(os.path.join(root, "ann.json"), "w") as f:
    json.dump({"images": images, "annotations": anns, "categories": [
        {"id": c, "name": str(c)} for c in range(1, 91)]}, f)
  create_coco_tfrecord.main([
      f"--image_dir={os.path.join(root, 'images')}",
      f"--object_annotations_file={os.path.join(root, 'ann.json')}",
      f"--output_file_prefix={os.path.join(root, 'coco', 'train')}",
      f"--num_shards={DATA_SHARDS}"])
  writers = [nl.TFRecordWriter(os.path.join(root, f"train-{s:05d}-of-"
                                            f"{DATA_SHARDS:05d}"))
             for s in range(DATA_SHARDS)]
  for i in range(DATA_CLS_IMAGES):
    y0, x0 = rng.uniform(0, 1, 2) * (200, 250)
    img = _smooth_image(rng, 375, 500, [(y0, x0, y0 + 175, x0 + 250)])
    data = nl.jpeg_encode_rgb(img, 90)
    if i < 4:
      psnr.append(10 * np.log10(255 ** 2 / np.mean(
          (nl.jpeg_decode_full(data).astype(np.float64) - img) ** 2)))
    writers[i % DATA_SHARDS].write(nl.build_example({
        "image/encoded": [data], "image/class/label": [int(i % 1000)]}))
  for w in writers:
    w.close()
  print(f"data: fixtures ({DATA_DET_IMAGES} COCO-like, {DATA_CLS_IMAGES} "
        f"ImageNet-like JPEGs, quality 90, {DATA_SHARDS} shards each) in "
        f"{time.perf_counter() - t0:.1f} s; decode(encode(x)) PSNR "
        f"{min(psnr):.2f}-{max(psnr):.2f} dB (must be > {DATA_PSNR_DB})")
  if min(psnr) <= DATA_PSNR_DB:
    raise AssertionError("a fixture's decode is too far from its source")
  return (os.path.join(root, "coco", "train-*"),
          os.path.join(root, "train-*"), meta)


def _check_read_boxes(det_pattern, meta):
  """The eval reader's boxes equal the written ones (normalised float32 in
  the record) times the scale, in float32, and their classes."""
  import numpy as np
  from automl_tpu_torch.data import pipeline
  n = 0
  for batch in itertools.islice(pipeline.DetectionTFRecordLoader(
      det_pattern, False, 16, 512, 100), 2):
    for i, sid in enumerate(batch["source_id"]):
      h, w, anns = meta[int(sid)]
      fh, fw = np.float32(h), np.float32(w)
      scale = np.float32(512) / max(fh, fw)
      norm = lambda v, d: np.float32(v / d)
      want = np.array([[norm(a["bbox"][1], h) * fh, norm(a["bbox"][0], w) * fw,
                        norm(a["bbox"][1] + a["bbox"][3], h) * fh,
                        norm(a["bbox"][0] + a["bbox"][2], w) * fw]
                       for a in anns], np.float32) * scale
      got = batch["gt_boxes"][i, :len(anns)]
      if not (np.array_equal(got, want) and list(
          batch["gt_classes"][i, :len(anns)]) == [a["category_id"]
                                                  for a in anns]):
        raise AssertionError(f"record {sid}: read boxes {got} != {want}")
      n += 1
  print(f"data: {n} records' boxes as read equal the written ones x scale "
        "(float32, exact)")


def _reader_rate(make, batches: int, label: str) -> float:
  """img/s of a reader alone: one batch to warm up, then `batches`."""
  it = iter(make())
  next(it)
  t0 = time.perf_counter()
  n = sum(next(it)["image"].shape[0] for _ in range(batches))
  rate = n / (time.perf_counter() - t0)
  if hasattr(it, "close"):
    it.close()
  print(f"data: reader {label}: {rate:.1f} img/s ({n} images)")
  return rate


def _file_step_ms(workdir) -> float:
  import numpy as np
  recs = [json.loads(line) for line in
          open(os.path.join(workdir, "metrics.jsonl")).read().splitlines()]
  if not all(math.isfinite(r["loss"]) for r in recs if "loss" in r):
    raise AssertionError(f"{workdir}: a loss is not finite")
  return float(np.median([r["secs_per_step"] for r in recs
                          if "secs_per_step" in r][4:])) * 1e3


def data_phase(dev, root, d0_synthetic_ms=None, v2s_synthetic_ms=None):
  """11. The host library with this machine's codec; the fixtures; each
  reader's img/s alone; D0 b16 trained 10 steps through cli/main_det from
  files with each reader, its eval mode (AP against an in-process
  evaluate_detection over the same batches, within 1e-4) and test-dev
  JSON; V2-S b256 10 steps at stage 0's size (168 px) through cli/main_cls
  from files with --native_loader; one batch through DevicePrefetcher.
  The from-files step times stand beside the synthetic-fed ones of the
  same call (the D0 knob-off run, V2-S's knob-off stage 0)."""
  import numpy as np
  import torch
  from automl_tpu_torch.cli import main_cls, main_det
  from automl_tpu_torch.data import native_loader as nl
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.ops import depthwise as dw
  from automl_tpu_torch.train import runners
  t_phase = time.perf_counter()
  shutil.rmtree(root, ignore_errors=True)
  lib = nl.build_host()        # built beside the kernels at the start
  print(f"data: host library {lib.name} (codec {nl.codec()})")
  det_pattern, cls_pattern, meta = _data_fixtures(root)
  _check_read_boxes(det_pattern, meta)
  nproc = os.cpu_count() or 1
  files = sorted(glob.glob(det_pattern))
  cls_files = sorted(glob.glob(cls_pattern))
  v2s_canvas = int(runners.resolve_train_size(_cls_config()) * 1.15) // 2 * 2
  _reader_rate(lambda: pipeline.DetectionTFRecordLoader(
      det_pattern, True, D0_BATCH, 512), 8,
      f"DetectionTFRecordLoader (TF-free) b{D0_BATCH} canvas 512, "
      f"{nproc} threads")
  for workers in sorted({4, nproc}):
    _reader_rate(lambda: nl.NativeParallelDetectionLoader(
        files, D0_BATCH, 512, num_workers=workers), 8,
        f"NativeParallelDetectionLoader b{D0_BATCH} canvas 512, {workers} "
        "workers")
  _reader_rate(lambda: pipeline.ImageNetTFRecordLoader(
      cls_pattern, True, V2S_BATCH, v2s_canvas, 1000), 2,
      f"ImageNetTFRecordLoader (TF-free) b{V2S_BATCH} canvas {v2s_canvas}, "
      f"{nproc} threads")
  for workers in sorted({4, nproc}):
    _reader_rate(lambda: nl.NativeParallelClassificationLoader(
        cls_files, V2S_BATCH, v2s_canvas, 1000, num_workers=workers), 2,
        f"NativeParallelClassificationLoader b{V2S_BATCH} canvas "
        f"{v2s_canvas}, {workers} workers")

  # DevicePrefetcher: one batch staged on the card equals its source.
  src = next(iter(pipeline.DetectionTFRecordLoader(det_pattern, False,
                                                   D0_BATCH, 512)))
  pf = pipeline.DevicePrefetcher(iter([src]), dev)
  (staged,) = list(pf)
  pf.close()
  for k, v in src.items():
    if staged[k].device.type != "cuda" or not torch.equal(
        staged[k].cpu(), torch.as_tensor(v)):
      raise AssertionError(f"DevicePrefetcher: {k} differs from its source")
  print(f"data: DevicePrefetcher staged a b{D0_BATCH} batch ({len(src)} "
        "keys) on the card, equal to its source")

  # D0 b16 from files, each reader (the K6 knob off, as in the synthetic
  # knob-off run it stands beside).
  flags = ["--mode=train", "--model_name=efficientdet-d0",
           f"--train_file_pattern={det_pattern}",
           f"--hparams=mixed_precision=true,batch_size={D0_BATCH}",
           "--log_every=1", "--device=cuda", "--train_steps=10"]
  step_ms = {}
  for name, extra in (("TF-free reader", []),
                      (f"native loader, {nproc} workers",
                       ["--native_loader", f"--native_workers={nproc}"])):
    d = os.path.join(root, "d0_" + ("native" if extra else "tf_free"))
    dw.depthwise_filter_grad.launches = 0
    main_det.main(flags + extra + [f"--model_dir={d}"])
    step_ms[name] = _file_step_ms(d)
    print(f"data: D0 b{D0_BATCH} 512x512 bf16 from files ({name}): step "
          f"{step_ms[name]:.1f} ms (median of steps 5-10), "
          f"{D0_BATCH / step_ms[name] * 1e3:.1f} img/s; K6 launches "
          f"{dw.depthwise_filter_grad.launches} (knob off)")
  synth = ("not measured in this call" if d0_synthetic_ms is None else
           f"{d0_synthetic_ms:.1f} ms")
  print(f"data: D0 b{D0_BATCH} step ms, synthetic-fed {synth} vs from files "
        + ", ".join(f"{k} {v:.1f}" for k, v in step_ms.items()))

  # --mode=eval on the TF-free run's checkpoint against an in-process
  # evaluate_detection over the same batches; --testdev_dir writes JSON.
  d = os.path.join(root, "d0_tf_free")
  eval_flags = ["--mode=eval", "--model_name=efficientdet-d0",
                f"--model_dir={d}", f"--val_file_pattern={det_pattern}",
                f"--eval_samples={DATA_EVAL_SAMPLES}", "--device=cuda",
                f"--hparams=mixed_precision=true,batch_size={D0_BATCH}"]
  got = main_det.main(eval_flags)
  cfg = _det_config()
  model = runners.seeded_detection_model(cfg, 0, dev)
  template, _ = runners.detection_state(model, cfg)
  from automl_tpu_torch.train.checkpoint import CheckpointManager
  params = runners.restore_eval_params(
      CheckpointManager(os.path.join(d, "ckpt")), template, None)
  want = runners.evaluate_detection(
      model, params, cfg, iter(pipeline.DetectionTFRecordLoader(
          det_pattern, False, D0_BATCH, 512)), DATA_EVAL_SAMPLES // D0_BATCH)
  worst = max(abs(got[k] - want[k]) for k in want)
  print(f"data: --mode=eval {json.dumps(got)} vs in-process "
        f"{json.dumps(want)}; largest metric difference {worst:.2e} (limit "
        "1e-4)")
  if set(got) != set(want) or worst > 1e-4:
    raise AssertionError("eval mode's metrics differ from evaluate_detection")
  # The metrics of 10 steps from random weights are about 0, so the
  # detections themselves are compared too: the test-dev JSON of the eval
  # mode and of evaluate_detection, as multisets of rows, equal.
  testdev = main_det.main(eval_flags + [
      f"--testdev_dir={os.path.join(root, 'testdev')}"])
  want_json = runners.evaluate_detection(
      model, params, cfg, iter(pipeline.DetectionTFRecordLoader(
          det_pattern, False, D0_BATCH, 512)), DATA_EVAL_SAMPLES // D0_BATCH,
      testdev_dir=os.path.join(root, "testdev_in_process"))
  rows, want_rows = (json.load(open(r["detections_json"]))
                     for r in (testdev, want_json))
  key = lambda r: (r["image_id"], r["category_id"], tuple(r["bbox"]),
                   r["score"])
  if testdev["AP"] != -1.0 or not rows or set(rows[0]) != {
      "image_id", "category_id", "bbox", "score"}:
    raise AssertionError(f"--testdev_dir: {testdev}, {rows[:1]}")
  if sorted(map(key, rows)) != sorted(map(key, want_rows)):
    raise AssertionError("--testdev_dir's detections differ from "
                         "evaluate_detection's")
  print(f"data: --testdev_dir wrote {len(rows)} detections to "
        f"{os.path.basename(testdev['detections_json'])}, equal to the "
        "in-process evaluate_detection's")
  del model, template, params
  torch.cuda.empty_cache()

  # V2-S b256 at stage 0's size from files, the native loader.
  d = os.path.join(root, "v2s_native")
  main_cls.main(["--model_name=efficientnetv2-s", f"--model_dir={d}",
                 f"--train_file_pattern={cls_pattern}", "--native_loader",
                 f"--native_workers={nproc}", "--train_steps=10",
                 "--log_every=1", "--device=cuda",
                 f"--hparam_str=train.batch_size={V2S_BATCH},train.stages=1,"
                 "train.isize=168"])
  ms = _file_step_ms(d)
  synth = ("not measured in this call" if v2s_synthetic_ms is None else
           f"{v2s_synthetic_ms:.1f} ms")
  print(f"data: V2-S b{V2S_BATCH} 168x168 bf16 from files (native loader, "
        f"{nproc} workers): step {ms:.1f} ms (median of steps 5-10), "
        f"{V2S_BATCH / ms * 1e3:.1f} img/s; synthetic-fed stage 0 {synth}")
  torch.cuda.empty_cache()
  print(f"data phase: {time.perf_counter() - t_phase:.1f} s")




# ---------------------------------------------------------------------------
# 13. Segmentation, QAT, GroupNorm and the optimizer search
# (seg_qat_search_phase).
# ---------------------------------------------------------------------------

SEG_STEPS = 20
QAT_STEPS = 6                # 10 until the script outgrew its time limit
GN_STEPS = 5
SEARCH_LM_STEPS = 6          # 10 until the script outgrew its time limit
SEARCH_LM_LR = 1e-4
# f32 step 1 on efficientdet-test at 128 x 128 (b4; at its own 64 the
# level-7 maps are 1 x 1 and a train-mode BN there normalises two numbers),
# card (TF32 off) against the CPU from one seeded tree, batch and set of
# drop_connect masks. Segmentation (both heads): the loss within
# SEG_F32_RTOL, the params after one momentum step within CLS_STATE_SHARE
# of the step's largest change (_cls_state_check). QAT (detection): the
# loss terms within QAT_F32_RTOL: fake-quant rounds each activation to its
# tensor's int8 grid, so a last-bit difference of a conv moves an element
# across a rounding boundary, a whole quantization step. Measured on the
# H100: the seg loss 1.2e-7 apart, the state 6e-8 against limits of 1e-5;
# the QAT loss terms equal.
SEG_F32_RTOL = 1e-4
SEG_F32_LR = 0.08
QAT_F32_RTOL = 1e-3


def _seg_batch(dev, b, size, classes, seed=3):
  """A synthetic segmentation batch, drawn on the host (the same on every
  device): a mask at the head's stride 4 of `classes` classes in blocks of
  4 x 4 mask pixels (each block's class drawn), its first two rows and 5%
  of its pixels void (-1); the image the block's class as a brightness
  offset plus unit noise, so the mask can be learnt from it."""
  import torch
  g = torch.Generator().manual_seed(seed)
  h = size // 4
  mask = torch.randint(0, classes, (b, h // 4, h // 4), generator=g)
  mask = mask.repeat_interleave(4, 1).repeat_interleave(4, 2)
  level = (mask.float() - (classes - 1) / 2).repeat_interleave(
      4, 1).repeat_interleave(4, 2)
  image = level[:, None] + torch.randn(b, 3, size, size, generator=g)
  void = torch.rand(b, h, h, generator=g) < 0.05
  mask = torch.where(void, -1, mask)
  mask[:, :2] = -1
  return {"image": image.to(dev).contiguous(
      memory_format=torch.channels_last), "mask": mask.to(dev)}


def _seg_step1(dev, cfg):
  """(loss, grads) of segmentation step 1 of D0 (bf16) with the K6 knob
  off and on, from one model and batch, the drop_connect masks from one
  seed."""
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.ops import depthwise as dw
  from automl_tpu_torch.train import runners, train_lib
  precision.set_policy("mixed_bfloat16")
  model = runners.seeded_detection_model(cfg, 0, dev)
  params = convert.model_state(model)
  batch = _seg_batch(dev, D0_BATCH, cfg.image_size, cfg.seg_num_classes)
  loss_and_grads = train_lib.make_seg_loss_and_grads(model, cfg)
  gen = torch.Generator(device=dev)
  out = {}
  for knob in (False, True):
    dw.enable_pallas_filter_grad(knob)
    try:
      loss, aux, grads, _ = loss_and_grads(params, batch, gen.manual_seed(8))
      torch.cuda.synchronize()
    finally:
      dw.enable_pallas_filter_grad(False)
    print(f"D0 seg step 1, K6 knob {'on' if knob else 'off'}: loss "
          f"{float(loss):.6f}, pixel_acc {float(aux['pixel_acc']):.4f}")
    out[knob] = (float(loss), grads)
  k6_leaves = sorted(
      f"{name}.kernel" for name, m in model.named_modules()
      if type(m).__name__ == "DepthwiseConv2D" and m.strides == (1, 1))
  return out, k6_leaves


def _seg_train(dev, cfg, per_step):
  """SEG_STEPS make_seg_train_step steps of D0 (bf16, b16, momentum SGD at
  the detection schedule, EMA) on one batch with the knob on: the loss
  falls, pixel_acc rises, K6 launches per_step a step, all Hopper. Returns
  (launches, step ms, peak GiB)."""
  import numpy as np
  import torch
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.ops import depthwise as dw
  from automl_tpu_torch.train import runners, schedules, train_lib
  precision.set_policy("mixed_bfloat16")
  model = runners.seeded_detection_model(cfg, 0, dev)
  state, tx = runners.detection_state(model, cfg, schedules.detection_lr(
      cfg, SEG_STEPS))
  step_fn = train_lib.make_seg_train_step(model, tx, cfg)
  batch = _seg_batch(dev, D0_BATCH, cfg.image_size, cfg.seg_num_classes)
  gen = torch.Generator(device=dev)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  dw.depthwise_filter_grad.launches = 0
  dw.depthwise_filter_grad.launches_sm90 = 0
  dw.enable_pallas_filter_grad(True)
  metrics = []
  try:
    for step in range(SEG_STEPS):
      if step == 4:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
      state, m = step_fn(state, batch, gen.manual_seed(
          runners.step_seed(0, step)))
      metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (SEG_STEPS - 4) * 1e3
  finally:
    dw.enable_pallas_filter_grad(False)
  launches = dw.depthwise_filter_grad.launches
  sm90 = dw.depthwise_filter_grad.launches_sm90
  peak = torch.cuda.max_memory_allocated() / 2**30
  losses = [float(m["loss"]) for m in metrics]
  acc = [float(m["pixel_acc"]) for m in metrics]
  print(f"D0 seg losses: {' '.join(f'{x:.4f}' for x in losses)}")
  print(f"D0 seg pixel_acc: {' '.join(f'{x:.3f}' for x in acc)}")
  expected = per_step * SEG_STEPS
  print(f"D0 seg train b{D0_BATCH} {cfg.image_size}x{cfg.image_size} bf16, "
        f"K6 knob on: step {step_ms:.1f} ms (mean of steps 5-{SEG_STEPS}), "
        f"{D0_BATCH / step_ms * 1e3:.1f} img/s, peak memory {peak:.2f} GiB; "
        f"loss {losses[0]:.4f} -> {np.mean(losses[-5:]):.4f}, pixel_acc "
        f"{acc[0]:.3f} -> {np.mean(acc[-5:]):.3f} (mean of the last 5); K6 "
        f"launches {launches}, {sm90} Hopper (expected {expected}: "
        f"{per_step} a step)")
  if not all(math.isfinite(x) for x in losses):
    raise AssertionError("D0 seg: loss not finite")
  if not (np.mean(losses[-5:]) < losses[0] and np.mean(acc[-5:]) > acc[0]):
    raise AssertionError("D0 seg: the loss did not fall or pixel_acc did not "
                         "rise")
  if launches != expected or sm90 != expected:
    raise AssertionError("D0 seg: the run did not go through K6 as expected")
  del model, state, step_fn, metrics
  torch.cuda.empty_cache()
  return launches, step_ms, peak


def _small_det_config(heads=("object_detection",)):
  """efficientdet-test at 128 x 128 (see SEG_F32_RTOL) with `heads`."""
  from automl_tpu_torch.configs.efficientdet_configs import (
      get_efficientdet_config)
  cfg = get_efficientdet_config("efficientdet-test")
  cfg.override(dict(image_size=128, heads=list(heads)))
  return cfg


def _seg_card_vs_cpu(dev):
  """One f32 make_seg_train_step step of efficientdet-test with both heads
  (the seg logits are the last output) on the card and on the CPU from one
  seeded tree, batch and drop_connect masks (a CPU generator feeds both):
  the loss within SEG_F32_RTOL, the params, BN statistics and EMA under
  _cls_state_check."""
  import torch
  from automl_tpu_torch.nn import precision
  from automl_tpu_torch.train import optimizers, runners, train_lib
  cfg = _small_det_config(("object_detection", "segmentation"))
  precision.set_policy("float32")
  snap = lambda d: {k: v.detach().clone().cpu() for k, v in d.items()}
  res = {}
  try:
    for where in (str(dev), "cpu"):
      m = runners.seeded_detection_model(cfg, 0, where)
      tx = optimizers.masked_for_params(optimizers.build_optimizer(
          "momentum", SEG_F32_LR, momentum=0.9))
      step = train_lib.make_seg_train_step(m, tx, cfg)
      state = train_lib.create_train_state(m, tx)
      old = snap(state.params)
      state, metrics = step(state, _seg_batch(where, 4, 128, 3),
                            torch.Generator().manual_seed(9))
      res[where] = ({k: float(v) for k, v in metrics.items()},
                    snap(state.params), old, snap(state.ema_params))
  finally:
    precision.set_policy("mixed_bfloat16")
  card, cpu = res[str(dev)], res["cpu"]
  rel = abs(card[0]["loss"] - cpu[0]["loss"]) / abs(cpu[0]["loss"])
  print(f"efficientdet-test (both heads, 128x128, b4) f32 seg step 1: loss "
        f"{card[0]['loss']:.7f} on the card, {cpu[0]['loss']:.7f} on the "
        f"CPU (rel. diff {rel:.3e}, limit {SEG_F32_RTOL}); pixel_acc "
        f"{card[0]['pixel_acc']:.5f} vs {cpu[0]['pixel_acc']:.5f}")
  stats = [k for k in cpu[1] if optimizers.is_batch_stat(k)]
  params = [k for k in cpu[1] if k not in stats]
  for what, i in (("", 1), ("EMA of the ", 3)):
    for name, keys in (("params", params), ("BN statistics", stats)):
      _cls_state_check(what + name, {k: card[i][k] for k in keys},
                       {k: cpu[i][k] for k in keys}, cpu[2],
                       what="efficientdet-test seg")
  if rel > SEG_F32_RTOL:
    raise AssertionError("the f32 seg step on the card disagrees with the "
                         "CPU")


def _fake_quant_check(dev):
  """quant.fake_quant (8 bits, per output channel) of every kernel of D0's
  seeded tree on the card against the CPU: bit-equal."""
  import torch
  from automl_tpu_torch.nn import quant
  from automl_tpu_torch.train import runners
  model = runners.seeded_detection_model(_det_config(), 0, "cpu")
  kernels = {k: v for k, v in model.state_dict().items()
             if k.endswith(".kernel")}
  equal = sum(bool(torch.equal(quant.fake_quant(v, 8, axis=0),
                               quant.fake_quant(v.to(dev), 8, axis=0).cpu()))
              for v in kernels.values())
  n = sum(v.numel() for v in kernels.values())
  print(f"fake_quant of D0's {len(kernels)} seeded kernels ({n} weights), "
        f"card vs CPU: {equal} of {len(kernels)} bit-equal")
  if equal != len(kernels):
    raise AssertionError("fake_quant on the card differs from the CPU's")


def _qat_card_vs_cpu(dev):
  """One f32 make_det_train_step step of efficientdet-test under QAT on
  the card and on the CPU from one seeded tree, one batch (preprocessed on
  the host) and one set of drop_connect masks: the loss terms within
  QAT_F32_RTOL."""
  import torch
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.nn import precision, quant
  from automl_tpu_torch.train import optimizers, runners, train_lib
  cfg = _small_det_config()
  raw = pipeline.SyntheticDetection(4, 128, cfg.max_instances_per_image,
                                    cfg.num_classes).batch
  batch = runners.make_preprocess(cfg)(
      {k: torch.from_numpy(v) for k, v in raw.items()},
      torch.Generator().manual_seed(7))
  precision.set_policy("float32")
  res = {}
  try:
    with quant.qat_scope():
      for where in (str(dev), "cpu"):
        m = runners.seeded_detection_model(cfg, 0, where)
        tx = optimizers.masked_for_params(optimizers.build_optimizer(
            "momentum", 0.08, momentum=0.9))
        step = train_lib.make_det_train_step(m, tx, cfg)
        state = train_lib.create_train_state(m, tx)
        _, metrics = step(state, {k: v.to(where) for k, v in batch.items()},
                          torch.Generator().manual_seed(9))
        res[where] = {k: float(v) for k, v in metrics.items()}
  finally:
    precision.set_policy("mixed_bfloat16")
  rels = {k: abs(res[str(dev)][k] - res["cpu"][k]) / max(abs(res["cpu"][k]),
                                                           1e-12)
          for k in ("loss", "det_loss", "cls_loss", "box_loss")}
  print(f"efficientdet-test (128x128, b4) f32 QAT step 1, card vs CPU: "
        + ", ".join(f"{k} {res[str(dev)][k]:.7f} vs {res['cpu'][k]:.7f} "
                    f"(rel. {rels[k]:.3e})" for k in rels)
        + f"; limit {QAT_F32_RTOL}")
  if max(rels.values()) > QAT_F32_RTOL:
    raise AssertionError("the f32 QAT step on the card disagrees with the "
                         "CPU")


def _search_lm(dev):
  """(D) lm-flops1e19 (b8, T 2048, flash attention, full remat) trained
  SEARCH_LM_STEPS steps with program_to_optimizer(LION_PROGRAM) and as many
  with lion(lr, b1=0.9, b2=0.99), each from the same seeded tree on the
  same batches: the losses and the final parameters bit-equal (the same
  f32 products summed in the same pairs). Returns {kernel: launches} of
  both runs."""
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.ops import attention as fa
  from automl_tpu_torch.search.program import (LION_PROGRAM, Program,
                                               program_to_optimizer)
  from automl_tpu_torch.train import lm_trainer
  from automl_tpu_torch.train.optimizers import lion
  counters = {"K1 sm90": "launches_fwd_sm90", "K2 sm90": "launches_bwd_sm90",
              "K5a sm90": "launches_dq_sm90", "K5b sm90": "launches_dkv_sm90",
              "K1": "launches_fwd", "K2": "launches_bwd",
              "K5a": "launches_dq", "K5b": "launches_dkv"}
  cfg = lm_lib.get_lm_config("lm-flops1e19")
  cfg.override("use_flash_attention=true")
  tree = convert.numpy_init(cfg, 0)
  data = iter(lm_trainer.SyntheticLMData(8, cfg.seq_len, cfg.vocab_size))
  batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
             for _ in range(SEARCH_LM_STEPS)]
  runs, total = {}, dict.fromkeys(counters, 0)
  for label, tx in (
      ("program", program_to_optimizer(Program(LION_PROGRAM, ("g", "m", "w")),
                                       SEARCH_LM_LR)),
      ("lion", lion(SEARCH_LM_LR, b1=0.9, b2=0.99))):
    model = convert.load_jax_params(lm_lib.TransformerLM(cfg, device=dev),
                                    tree)
    state = lm_trainer.init_train_state(model, tx)
    step = lm_trainer.make_lm_train_step(model, tx)
    for attr in counters.values():
      setattr(fa.flash_attention, attr, 0)
    losses = []
    for i, batch in enumerate(batches):
      if i == 1:   # after the first step's warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
      state, logs = step(state, batch)
      losses.append(logs["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (len(batches) - 1) * 1e3
    launches = {k: getattr(fa.flash_attention, a) for k, a in
                counters.items()}
    for k in total:
      total[k] += launches[k]
    runs[label] = ([float(x) for x in losses],
                   {k: p.detach().clone() for k, p in state.params.items()})
    print(f"lm-flops1e19 b8 T{cfg.seq_len}, {label} Lion (lr "
          f"{SEARCH_LM_LR:g}): step {step_ms:.1f} ms (mean of steps "
          f"2-{SEARCH_LM_STEPS}); losses "
          f"{' '.join(f'{x:.5f}' for x in runs[label][0])}; launches "
          f"{launches}")
    n = cfg.n_layers * SEARCH_LM_STEPS
    want = dict.fromkeys(counters, 0)
    want.update({"K1": 2 * n, "K1 sm90": 2 * n, "K2": n, "K2 sm90": n})
    if launches != want:
      raise AssertionError(f"{label} run: launches {launches}, expected "
                           f"{want}")
    del model, state, step
    torch.cuda.empty_cache()
  (l_p, w_p), (l_l, w_l) = runs["program"], runs["lion"]
  equal = sum(bool(torch.equal(w_p[k], w_l[k])) for k in w_l)
  worst = max(float((w_p[k] - w_l[k]).abs().max()) for k in w_l)
  print(f"program Lion vs lion: losses {'bit-equal' if l_p == l_l else 'differ'}"
        f" (largest rel. diff {max(abs(a - b) / abs(b) for a, b in zip(l_p, l_l)):.3e}); "
        f"{equal} of {len(w_l)} parameter leaves bit-equal after "
        f"{SEARCH_LM_STEPS} steps, largest max|diff| {worst:.3e}. Must be "
        "bit-equal.")
  if l_p != l_l or equal != len(w_l):
    raise AssertionError("program_to_optimizer(LION_PROGRAM) does not "
                         "reproduce lion on the card")
  return total


def _search_evolution(dev):
  """regularized_evolution from MOMENTUM_PROGRAM on a linear regression
  whose tensors live on the card (tests/test_search.py's flow: 15 cycles,
  population 8, seed 1, each evaluation 30 steps at lr 0.05), the abstract
  gate on meta tensors of the card tensors' shapes: the best fitness no
  worse than the seed's (the JAX test's margin) and finite."""
  import torch
  from automl_tpu_torch.search import evolution
  from automl_tpu_torch.search.program import (MOMENTUM_PROGRAM, Program,
                                               program_to_optimizer)
  g = torch.Generator().manual_seed(0)
  x = torch.randn(64, 4, generator=g).to(dev)
  y = x @ torch.tensor([1.0, -2.0, 0.5, 3.0], device=dev)

  def evaluate(prog):
    tx = program_to_optimizer(prog, learning_rate=0.05)
    w = torch.zeros(4, device=dev)
    state = tx.init(w)
    loss = float("inf")
    for _ in range(30):
      r = x @ w - y
      loss, grad = torch.mean(r * r), 2.0 / x.shape[0] * (x.T @ r)
      up, state = tx.update(grad, state, w)
      w = w + up
    return float(loss)

  t0 = time.perf_counter()
  seed = Program(MOMENTUM_PROGRAM, inputs=("g", "m", "w"))
  base = evaluate(seed)
  spec = torch.empty(4, device=dev)
  best, best_fit, stats = evolution.regularized_evolution(
      seed, evaluate, cycles=15, population_size=8, seed=1,
      abstract_inputs=dict(g=spec, m=spec, w=spec))
  print(f"evolution on the card: seed fitness {base:.6g}, best {best_fit:.6g} "
        f"({stats['evaluations']} evaluations, {stats['cache_hits']} cache "
        f"hits, {stats['rejected_abstract']} abstract rejections, "
        f"{stats['failed_evaluations']} failed; "
        f"{time.perf_counter() - t0:.1f} s); best program: "
        f"{' | '.join(str(best).splitlines())}")
  if not (best_fit <= base and math.isfinite(best_fit)):
    raise AssertionError("the evolution did not improve on its seed")


def seg_qat_search_phase(dev, workdir, v2s_bn_ms):
  """(A) D0 segmentation, (B) D0 QAT through main_det, (C) V2-S with
  GroupNorm through main_cls, (D) the optimizer search on the LM and on a
  regression. Returns {"K6": launches of (A)-(C), and (D)'s flash
  launches}."""
  import torch
  from automl_tpu_torch.models import efficientdet
  from automl_tpu_torch.models.efficientnet import EfficientNet
  from automl_tpu_torch.nn import quant
  from automl_tpu_torch.train import runners
  t_phase = time.perf_counter()
  # (A)
  t = time.perf_counter()
  cfg = _det_config(heads=["segmentation"])
  out, k6_leaves = _seg_step1(dev, cfg)
  _det_step1_check(out, k6_leaves, "D0 seg")
  del out
  torch.cuda.empty_cache()
  per_step = efficientdet.filter_grad_calls_per_step(
      efficientdet.EfficientDet(cfg, device="meta"))
  seg_launches, _, _ = _seg_train(dev, cfg, per_step)
  _seg_card_vs_cpu(dev)
  print(f"(A) segmentation: {time.perf_counter() - t:.1f} s")
  # (B)
  t = time.perf_counter()
  det_per_step = efficientdet.filter_grad_calls_per_step(
      efficientdet.EfficientDet(_det_config(), device="meta"))
  flags = ["--mode=train", "--model_name=efficientdet-d0", "--use_fake_data",
           "--log_every=1", "--device=cuda"]
  hp = f"--hparams=mixed_precision=true,batch_size={D0_BATCH}"
  qat_dir, plain_dir = workdir + "_qat", workdir + "_plain"
  try:
    qat = _det_train_run(qat_dir, flags + [f"--model_dir={qat_dir}",
                                           hp + ",qat=true"], QAT_STEPS, True,
                         det_per_step)
    if not quant.qat_enabled():
      raise AssertionError("main_det --hparams=qat=true left QAT off")
    plain = _det_train_run(plain_dir, flags + [f"--model_dir={plain_dir}", hp],
                           QAT_STEPS, True, det_per_step)
  finally:
    quant.disable_qat()
  print(f"D0 b{D0_BATCH} step ms with QAT vs without (in turns, one call): "
        f"{qat[1]:.1f} vs {plain[1]:.1f} ({qat[1] / plain[1]:.2f}x); peak "
        f"{qat[3]:.2f} vs {plain[3]:.2f} GiB")
  _fake_quant_check(dev)
  _qat_card_vs_cpu(dev)
  print(f"(B) QAT: {time.perf_counter() - t:.1f} s")
  # (C)
  t = time.perf_counter()
  ccfg = _cls_config()
  size, ram, mix, cut = runners._progressive_stage_params(ccfg, 0, 4)
  gn_per_step = sum(_stride1_depthwise_maps(
      EfficientNet(ccfg.model, device="meta"), size).values())
  [(gn, _)] = _cls_train_runs(
      [(workdir + "_gn", True)], GN_STEPS, gn_per_step, [size],
      hparams=(f",model.bn_type=gn,train.stages=1,train.isize={size},"
               f"data.ram={ram},data.mixup_alpha={mix},"
               f"data.cutmix_alpha={cut}"), label="V2-S GroupNorm")
  print(f"V2-S {size}x{size} b{V2S_BATCH}, K6 knob on: step {gn[0][1]:.1f} ms "
        f"with GroupNorm vs {v2s_bn_ms:.1f} with BatchNorm (phase 9's stage "
        f"0, one call); peak {gn[0][3]:.2f} GiB")
  print(f"(C) GroupNorm: {time.perf_counter() - t:.1f} s")
  # (D)
  t = time.perf_counter()
  flash = _search_lm(dev)
  _search_evolution(dev)
  print(f"(D) search: {time.perf_counter() - t:.1f} s")
  print(f"segmentation / QAT / GroupNorm / search phase: "
        f"{time.perf_counter() - t_phase:.1f} s")
  return dict(flash, K6=seg_launches + qat[0] + plain[0] + gn[0][4])


# ---------------------------------------------------------------------------
# The parallel layer, first half (M10): the mesh and NCCL at a world of one,
# sharded LM serving around K4, K4 at each shard's shapes, LM training on a
# mesh.
# ---------------------------------------------------------------------------

# Requests of (B)'s LMServer runs (phase 12's settings, fewer requests).
M10_SERVE_REQUESTS = 8
M10_TRAIN_STEPS = 6          # 10 until the script outgrew its time limit
# Step 1 on a mesh of one against no mesh: phase 5's tightest limits (the
# chunked loss against the f32 one).
M10_STEP1_LIMITS = (1e-5, 5e-5, 0.99995)


def _m10_k4_shards(dev, flush):
  """(C): K4 at each shard's shapes against the unsharded call of the same
  cache (BF16_TOL): serve_tp's head-major rows of n_kv / m heads for m 2,
  4 and 8, and serve_sp's return_stats on S / m keys merged by
  merge_partials over the stacked shards, m 2 and 4; decode (T 1 after a
  512-token prompt: the 4th shard of 4 fully masked) and prefill (T 512,
  causal). Returns the largest error."""
  import torch
  from automl_tpu_torch.ops import decode_attention as da
  gen = torch.Generator(device=dev).manual_seed(18)
  b, n, n_kv, h, s = 8, 8, 8, 128, 1024
  kern = da.decode_attention
  worst = 0.0
  _k4_reset()
  calls = 0
  for t in (1, 512):
    q, kc, vc, _ = _kernel_inputs(dev, gen, b, t, n, n_kv, h, s,
                                  torch.bfloat16)
    pos = torch.arange(512 - (t == 512) * 512, 512 + (t == 1), device=dev)
    mask = (torch.arange(s, device=dev)[None, :] <= pos[:, None])
    mask = mask[None].expand(b, t, s).contiguous()
    full = kern(q, kc, vc, mask, n_kv_heads=n_kv, logit_cap=50.0)
    calls += 1
    for m in (2, 4, 8):
      nkv_l = n_kv // m
      parts = []
      for r in range(m):
        heads = slice(r * nkv_l, (r + 1) * nkv_l)
        k_l = kc.view(b, n_kv, h, s)[:, heads].transpose(0, 1).reshape(
            nkv_l * b, h, s).contiguous()
        v_l = vc.view(b, n_kv, s, h)[:, heads].transpose(0, 1).reshape(
            nkv_l * b, s, h).contiguous()
        parts.append(kern(q[:, :, heads].contiguous(), k_l, v_l, mask,
                          n_kv_heads=nkv_l, logit_cap=50.0,
                          layout="head_major"))
        calls += 1
      worst = max(worst, _compare(f"tp m {m}, T {t}: {nkv_l} kv head(s) a "
                                  "rank, head-major", torch.cat(parts, 2),
                                  full, **BF16_TOL))
    for m in (2, 4):
      sl = s // m
      stats = []
      for r in range(m):
        keys = slice(r * sl, (r + 1) * sl)
        stats.append(kern(q, kc[..., keys].contiguous(),
                          vc[:, keys].contiguous(),
                          mask[..., keys].contiguous(), n_kv_heads=n_kv,
                          logit_cap=50.0, return_stats=True))
        calls += 1
      dead = [r for r, (_, _, l) in enumerate(stats) if not bool(l.any())]
      merged = da.merge_partials(
          *(torch.stack(x) for x in zip(*stats)),
          lambda x: x.amax(0, keepdim=True),
          lambda x: x.sum(0, keepdim=True))[0]
      worst = max(worst, _compare(
          f"sp m {m}, T {t}: {sl} keys a rank, merged (fully masked "
          f"shards, l = 0: {dead})", merged, full, **BF16_TOL))
      if t == 1 and m == 4 and dead != [3]:
        raise AssertionError(f"sp m 4: the 4th shard should be the only "
                             f"fully masked one, got {dead}")
  _k4_expect("(C)", calls)
  # One shard's call beside the unsharded decode (T 1).
  q, kc, vc, _ = _kernel_inputs(dev, gen, b, 1, n, n_kv, h, s, torch.bfloat16)
  mask = (torch.arange(s, device=dev) <= 512)[None, None].expand(
      b, 1, s).contiguous()
  k1 = kc.view(b, n_kv, h, s)[:, :1].transpose(0, 1).reshape(b, h, s) \
      .contiguous()
  v1 = vc.view(b, n_kv, s, h)[:, :1].transpose(0, 1).reshape(b, s, h) \
      .contiguous()
  fns = {"unsharded": lambda: kern(q, kc, vc, mask, n_kv_heads=n_kv,
                                   logit_cap=50.0),
         "tp m 8 (1 kv head)": lambda: kern(
             q[:, :, :1].contiguous(), k1, v1, mask, n_kv_heads=1,
             logit_cap=50.0, layout="head_major"),
         "sp m 4 (256 keys, return_stats)": lambda: kern(
             q, kc[..., :256].contiguous(), vc[:, :256].contiguous(),
             mask[..., :256].contiguous(), n_kv_heads=n_kv, logit_cap=50.0,
             return_stats=True)}
  times = {k: _time_ms(f, 100, flush) for k, f in fns.items()}
  times_b = {k: _time_ms(f, 100, flush) for k, f in reversed(fns.items())}
  print("  K4 decode T 1, S 1024, b8: " + ", ".join(
      f"{k} {times[k]:.4f}, {times_b[k]:.4f} ms" for k in fns)
      + " (in turns, L2 flushed)")
  return worst


def _m10_serving(dev, mesh, flush):
  """(B): serve_tp (the head-leading cache, K4 head-major) against the
  batch-major model on one seeded lm-flops1e19; returns the K4 launches of
  the serve_tp runs."""
  import copy
  import numpy as np
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm as lm_lib

  cfg = lm_lib.get_lm_config("lm-flops1e19")
  tree = _lm_tree(cfg, 0)
  tcfg = copy.deepcopy(cfg)
  tcfg.override(dict(serve_tp=True))
  bm = convert.load_jax_params(lm_lib.TransformerLM(cfg, device=dev), tree)
  tp = convert.load_jax_params(
      lm_lib.TransformerLM(tcfg, device=dev, mesh=mesh), tree)
  del tree
  lm_lib.cast_lm_params_for_serving(bm)
  lm_lib.cast_lm_params_for_serving(tp)
  n_layers, v = cfg.n_layers, cfg.vocab_size
  # 256 new tokens (512 until the script outgrew its time limit): a cache
  # of 768, decode_kernel_min_s.
  batch, t0, new = 8, 512, 256
  total = t0 + new
  rng = np.random.default_rng(1)
  prompt = torch.from_numpy(rng.integers(3, v, (batch, t0))).to(dev)
  kv_pos = torch.arange(total, device=dev).expand(batch, total)
  pos = kv_pos[:, :t0]
  cache_shape = tuple(tp.init_cache(1, 8)[0]["k"].shape)
  print(f"(B) serve_tp: the head-leading cache (k of one layer at b1, S 8: "
        f"{cache_shape}), K4 head-major, against the batch-major model; "
        f"lm-flops1e19, norm scales drawn N(0, {LM_NORM_SIGMA}^2), b{batch}, "
        f"{t0} + {new} tokens")

  def prefill(model):
    @torch.inference_mode()
    def run():
      cache = model.init_cache(batch, total)
      return model(prompt, positions=pos, cache=cache, cache_index=0,
                   kv_positions=kv_pos)[0]
    return run

  lt, lb = prefill(tp)(), prefill(bm)()
  print(f"  prefill logits, serve_tp vs batch-major: bit-equal "
        f"{torch.equal(lt, lb)}, max|diff| {float((lt - lb).abs().max()):.3e}")
  if not bool(torch.isfinite(lt).all()):
    raise AssertionError("(B) serve_tp prefill logits not finite")
  del lt, lb
  pre = [_time_ms(prefill(m), 3) for m in (tp, bm, bm, tp)]
  print(f"  prefill b{batch} x {t0} (cache {total}): serve_tp {pre[0]:.2f}, "
        f"{pre[3]:.2f} ms; batch-major {pre[1]:.2f}, {pre[2]:.2f} ms "
        f"(in turns)")
  pre_tp, pre_bm = (pre[0] + pre[3]) / 2, (pre[1] + pre[2]) / 2

  lm_lib.greedy_generate(tp, prompt, 4)          # warm the decode shapes
  lm_lib.greedy_generate(bm, prompt, 4)
  out, ms = {}, {"tp": [], "bm": []}
  launches = 0
  # One run each (a second pair, bm then tp, was cut to make room for
  # phase 15).
  for name in ("tp", "bm"):
    model = tp if name == "tp" else bm
    torch.cuda.synchronize()
    _k4_reset()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    tokens = lm_lib.greedy_generate(model, prompt, new)
    end.record()
    end.synchronize()
    ms[name].append(start.elapsed_time(end))
    n = _k4_expect(f"greedy, {name}", n_layers * new)
    if name == "tp" and "tp" not in out:
      launches += n
    out.setdefault(name, tokens)
  for name, pre_ms in (("tp", pre_tp), ("bm", pre_bm)):
    print(f"  generate {name}: " + ", ".join(
        f"{x:.1f} ms (decode {(x - pre_ms) / (new - 1):.3f} ms/step)"
        for x in ms[name]))
  same = out["tp"][:, t0:] == out["bm"][:, t0:]
  parts = [int(r.cumprod(0).sum()) for r in same.int()]
  print(f"  generated tokens equal to the batch-major run: "
        f"{int(same.sum())} of {same.numel()}; equal prefix per row "
        f"{parts} (of {new})")
  if not bool(same.all()):
    print(f"  the runs part at decode step(s) {[p for p in parts if p < new]}"
          ": teacher-forced check of the serve_tp tokens")
    _teacher_forced(bm, "(B) greedy serve_tp", [
        (prompt[i].tolist(), out["tp"][i, t0:].tolist())
        for i in range(batch)])

  # One LMServer run each at phase 12's settings.
  lens = rng.integers(16, 701, M10_SERVE_REQUESTS)
  lens[:2] = rng.integers(257, 701, 2)
  requests = [(rng.integers(3, v, int(n)).tolist(),
               int(min(rng.integers(16, 301), 1024 - n))) for n in lens]
  _serve("warm-up, serve_tp", tp, [(requests[0][0], 9)])
  _serve("warm-up, batch-major", bm, [(requests[0][0], 9)],
         use_decode_kernel=True)
  _k4_reset()
  res_tp, srv, _, _, _, _ = _serve("serve_tp server", tp, requests)
  kinds = [e["kind"] for e in srv.timeline]
  # serve_tp decodes through K4 at any length: the grouped prefills too.
  launches += _k4_expect("(B) serve_tp server", n_layers * (
      srv.burst * kinds.count("burst") + kinds.count("chunk")
      + kinds.count("prefill")))
  res_bm, _, _, _, _, _ = _serve("batch-major K4 server", bm, requests,
                                 use_decode_kernel=True)
  equal = sum(a.tokens == b.tokens for a, b in zip(res_tp, res_bm))
  print(f"  server tokens equal to the batch-major server's: {equal} of "
        f"{len(requests)} requests; equal prefix "
        f"{[_equal_prefix(a.tokens, b.tokens) for a, b in zip(res_tp, res_bm)]}")
  if equal != len(requests):
    _teacher_forced(bm, "(B) serve_tp server", [
        (p, r.tokens) for (p, _), r in zip(requests, res_tp)])
  del bm, tp
  torch.cuda.empty_cache()
  return launches


def _m10_training(dev, mesh, workdir):
  """(D): lm-flops1e19 step 1 and M10_TRAIN_STEPS steps through main_lm on
  the mesh of one (gspmd) against no mesh; sp on the same mesh takes the
  flash path. Returns {kernel: launches} of the mesh run."""
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.ops import attention as fa
  from automl_tpu_torch.train import lm_trainer

  batch = 8
  cfg = lm_lib.get_lm_config("lm-flops1e19")
  cfg.override("use_flash_attention=true")
  tree = convert.numpy_init(cfg, 0)
  first = next(iter(lm_trainer.SyntheticLMData(batch, cfg.seq_len,
                                               cfg.vocab_size)))
  first = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
  results = {}
  for label, sharding, ring, on_mesh in (
      ("no mesh", None, False, False),
      ("mesh gspmd", lm_lib.ShardingConfig(), False, True),
      ("mesh sp", lm_lib.ShardingConfig.sequence_parallel(), True, True)):
    c = lm_lib.get_lm_config("lm-flops1e19")
    c.override(dict(use_flash_attention=True, use_ring_attention=ring))
    model = convert.load_jax_params(lm_lib.TransformerLM(
        c, sharding, device=dev, mesh=mesh if on_mesh else None), tree)
    fa.flash_attention.launches_fwd_sm90 = 0
    fa.flash_attention.launches_bwd_sm90 = 0
    loss, grads = lm_trainer.lm_loss_and_grads(model, first)
    grads = {k: g.to_local() if hasattr(g, "to_local") else g
             for k, g in grads.items()}
    k1, k2 = (fa.flash_attention.launches_fwd_sm90,
              fa.flash_attention.launches_bwd_sm90)
    print(f"  step 1, {label}: loss {float(loss):.6f}; K1 {k1}, K2 {k2} "
          f"Hopper launches (expected {2 * cfg.n_layers}, {cfg.n_layers})")
    if (k1, k2) != (2 * cfg.n_layers, cfg.n_layers):
      raise AssertionError(f"(D) {label}: step 1 did not take the flash "
                           "path")
    results[label] = (float(loss), grads)
    del model
  del tree, first
  for label in ("mesh gspmd", "mesh sp"):
    _step1_check(results, label, "no mesh", M10_STEP1_LIMITS,
                 "Phase 5's tightest limits; one rank: expected bit-equal.")
  del results
  torch.cuda.empty_cache()

  steps = M10_TRAIN_STEPS
  common = ["--config_name=lm-flops1e19", f"--batch_size={batch}",
            "--warmup_steps=3", "--log_every=1", "--device=cuda",
            "--experiment_config=use_flash_attention=true"]
  n = cfg.n_layers * steps
  expected = dict.fromkeys(("K1", "K1 sm90", "K2", "K2 sm90", "K5a",
                            "K5a sm90", "K5b", "K5b sm90", "K3a", "K3a sm90",
                            "K3b", "K3b sm90", "K3c", "K3c sm90"), 0)
  expected.update({"K1": 2 * n, "K1 sm90": 2 * n, "K2": n, "K2 sm90": n})
  flops = _step_flops(cfg, batch, cfg.seq_len)
  mesh_dir, plain_dir = workdir + "_mesh", workdir + "_plain"
  runs = {}
  runs["mesh"] = _train_run(
      mesh_dir, common + [f"--model_dir={mesh_dir}", "--mesh_shape=1,1,1",
                          "--sharding_config=gspmd"], steps,
      "mesh (1, 1, 1), gspmd", expected, flops, falls=False)
  saved = torch.load(os.path.join(mesh_dir, "ckpt", str(steps), "state.pt"),
                     map_location="cpu", weights_only=True)
  print(f"  the mesh run's checkpoint: step {saved['step']}, "
        f"{len(saved['params'])} full parameter tensors (rank 0's state.pt)")
  del saved
  with _NoCheckpoints():
    runs["plain"] = _train_run(
        plain_dir, common + [f"--model_dir={plain_dir}"], steps, "no mesh",
        expected, flops, falls=False)
  losses = {}
  for name, d in (("mesh", mesh_dir), ("plain", plain_dir)):
    recs = [json.loads(l) for l in open(os.path.join(d, "metrics.jsonl"))]
    losses[name] = [r["loss"] for r in recs if "loss" in r]
  d1 = abs(losses["mesh"][0] - losses["plain"][0])
  equal = sum(a == b for a, b in zip(losses["mesh"], losses["plain"]))
  print(f"  main_lm losses, mesh vs no mesh: step 1 |dloss| {d1:.3e} (limit "
        f"{M10_STEP1_LIMITS[0]}), {equal} of {steps} steps equal")
  if d1 > M10_STEP1_LIMITS[0]:
    raise AssertionError("(D) step 1 of the mesh run disagrees")
  return runs["mesh"]


def m10_phase(dev, workdir):
  """M10's first half on the card (A)-(D); returns {kernel: launches} of
  its main-path runs (K4: the serve_tp runs; K1 / K2: the mesh training
  run), each counted from 0 just before the run."""
  import torch
  import torch.distributed as dist
  from automl_tpu_torch.parallel import create_mesh

  t_phase = time.perf_counter()
  os.makedirs(workdir, exist_ok=True)
  store = os.path.abspath(os.path.join(workdir, "nccl_store"))
  if os.path.exists(store):
    os.remove(store)
  # (A) NCCL at a world of one; the mesh (1, 1, 1) on the card.
  dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                          world_size=1)
  try:
    mesh = create_mesh((1, 1, 1), device="cuda")
    one = torch.ones(4, device=dev)
    dist.all_reduce(one, group=mesh.get_group("model"))
    torch.cuda.synchronize()
    nccl = ".".join(map(str, torch.cuda.nccl.version()))
    print(f"host: NCCL {nccl}; process group backend "
          f"{dist.get_backend()}, world {dist.get_world_size()}; mesh "
          f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
          f"{mesh.device_type}; an all-reduce over 'model' gives "
          f"{one.tolist()}")
    if one.tolist() != [1.0] * 4:
      raise AssertionError("(A) the NCCL all-reduce of a world of one")
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    t = time.perf_counter()
    k4 = _m10_serving(dev, mesh, flush_buf.zero_)
    print(f"(B) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    print("(C) K4 at each shard's shapes against the unsharded call")
    err = _m10_k4_shards(dev, flush_buf.zero_)
    print(f"(C) largest error {err:.3e}; {time.perf_counter() - t:.1f} s")
    del flush_buf
    torch.cuda.empty_cache()
    t = time.perf_counter()
    print("(D) training on the mesh (1, 1, 1) against no mesh")
    runs = _m10_training(dev, mesh, workdir)
    print(f"(D) {time.perf_counter() - t:.1f} s")
  finally:
    dist.destroy_process_group()
  print(f"M10 phase: {time.perf_counter() - t_phase:.1f} s")
  return dict(runs, K4=k4)


# Phase 15 (the parallel layer, second half). The GPipe check's
# microbatches (b8 in 4 of 2); the MoE model's depth, cut to 2 layers (the
# widths are phase 5b's: d 1,024, 8 experts of 8,192, top-2) so that its
# weights, drawn on the card, build in a moment; the EP run's Lion steps;
# the D0 runs' steps on the mesh and off it; V2-S's steps.
M10B_MICRO = 4
M10B_MOE_LAYERS = 2
M10B_EP_STEPS = 3
M10B_DET_STEPS = 3
M10B_CLS_STEPS = 3
# GPipe against the plain stack at step 1: the microbatches' bf16 weight
# gradients are summed over 4 backward passes, where the plain stack's come
# from one matmul over the batch: phase 5's loosest step-1 limits (flash
# against dense).
M10B_PIPE_LIMITS = (1e-3, 1e-3, 0.9999)


def _local(t):
  return t.to_local() if hasattr(t, "to_local") else t


def _card_init(model, seed):
  """Seeded weights drawn on the card with convert.numpy_init's scales
  (other numbers): a normal over the fan-in of each weight, the norm
  scales zero."""
  import torch
  gen = None
  with torch.no_grad():
    for name, p in model.named_parameters():
      t = _local(p)
      if gen is None:
        gen = torch.Generator(device=t.device).manual_seed(seed)
      leaf = name.split(".")[-1]
      if t.ndim == 1 or leaf in ("scale", "per_dim_scale"):
        t.zero_()
        continue
      if leaf in ("wq", "wk", "wv"):
        fan = t.shape[-3]
      elif leaf == "wo":
        fan = t.shape[-2] * t.shape[-1]
      elif leaf == "embed":
        fan = t.shape[-1]
      else:
        fan = t.shape[-2]
      t.copy_(torch.randn(t.shape, generator=gen, device=t.device)
              * fan ** -0.5)


def _copy_params(dst, src):
  import torch
  mine = dict(src.named_parameters())
  with torch.no_grad():
    for name, p in dst.named_parameters():
      _local(p).copy_(mine[name])


def _flash_counts():
  from automl_tpu_torch.ops import attention as fa
  f = fa.flash_attention
  return {"K1": f.launches_fwd, "K1 sm90": f.launches_fwd_sm90,
          "K2": f.launches_bwd, "K2 sm90": f.launches_bwd_sm90}


def _flash_reset():
  from automl_tpu_torch.ops import attention as fa
  for k in ("launches_fwd", "launches_fwd_sm90", "launches_bwd",
            "launches_bwd_sm90"):
    setattr(fa.flash_attention, k, 0)


def _pipe_loss_and_grads(model, batch, mesh, micro):
  """(loss, {name: grad}) of the LM loss with the blocks run through
  parallel/pipeline.py::pipeline_blocks over 'model' in `micro`
  microbatches: TransformerLM.forward's embedding, positions, remat and
  head around it (an MoE block's aux summed over the stages and averaged
  over the microbatches, weighted as the trainer weights it)."""
  import functools
  import torch
  import torch.nn.functional as F
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.parallel.pipeline import pipeline_blocks
  cfg = model.cfg
  params = dict(model.named_parameters())
  for p in params.values():
    p.grad = None
  tokens = batch["tokens"]
  inputs, targets = tokens[:, :-1], tokens[:, 1:]
  b, t = inputs.shape
  adt = lm_lib._dtype(cfg.activation_dtype)
  positions = torch.arange(t, device=tokens.device).expand(b, t)
  x = F.embedding(inputs, lm_lib._w(model.embed, model.par)).to(adt) * (
      cfg.model_dim ** 0.5)
  kw = {}
  if (policy := lm_lib._remat_policy(cfg)) is not None:
    kw["context_fn"] = functools.partial(
        torch.utils.checkpoint.create_selective_checkpoint_contexts, policy)
  moe = bool(cfg.get("moe_num_experts"))

  def block_fn(block, h, extras):
    outs = torch.utils.checkpoint.checkpoint(
        block, h, extras[0], None, None, None, None, use_reentrant=False,
        **kw)
    return outs[0], (outs[2] if moe else h.new_zeros((), dtype=torch.float32))
  x, aux = pipeline_blocks(x, list(model.blocks), (positions,), block_fn,
                           mesh, "model", micro)
  loss = lm_lib.lm_loss(lm_lib.unembed_logits(model, model.final_norm(x)),
                        targets)
  if moe:
    loss = loss + float(cfg.get("moe_aux_loss_weight", 0.0) or 0.0) * aux
  loss.backward()
  grads = {k: p.grad for k, p in params.items()}
  for p in params.values():
    p.grad = None
  return loss.detach(), grads


def _lm_step_ms(fn, runs: int = 2) -> float:
  import torch
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(runs):
    fn()
  torch.cuda.synchronize()
  return (time.perf_counter() - t0) / runs * 1e3


def _m10b_pipeline(dev, mesh):
  """(A): GPipe's schedule at a stage count of 1 over lm-flops1e19's blocks
  (b8, T 2048, flash attention) in M10B_MICRO microbatches against the
  plain stack; returns the pipeline run's {kernel: launches}."""
  import torch
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.train import lm_trainer
  cfg = lm_lib.get_lm_config("lm-flops1e19")
  cfg.override(M6_FLASH)
  model = lm_lib.TransformerLM(cfg, device=dev)
  _card_init(model, 0)
  batch = {k: torch.from_numpy(v).to(dev) for k, v in next(iter(
      lm_trainer.SyntheticLMData(8, cfg.seq_len, cfg.vocab_size))).items()}
  L, m = cfg.n_layers, M10B_MICRO
  results, counts = {}, {}
  for label, fn in (
      ("plain", lambda: lm_trainer.lm_loss_and_grads(model, batch)),
      ("pipeline", lambda: _pipe_loss_and_grads(model, batch, mesh, m))):
    _flash_reset()
    loss, grads = fn()
    torch.cuda.synchronize()
    counts[label] = _flash_counts()
    results[label] = (float(loss), {k: g.float() for k, g in grads.items()})
    print(f"  step 1, {label}: loss {float(loss):.6f}; K1 "
          f"{counts[label]['K1']} ({counts[label]['K1 sm90']} Hopper), K2 "
          f"{counts[label]['K2']} ({counts[label]['K2 sm90']} Hopper)")
  for label, n in (("plain", 1), ("pipeline", m)):
    c = counts[label]
    if (c["K1"], c["K2"]) != (2 * L * n, L * n) or \
        (c["K1 sm90"], c["K2 sm90"]) != (c["K1"], c["K2"]):
      raise AssertionError(f"(A) {label}: expected {2 * L * n} K1 and "
                           f"{L * n} K2 launches, all Hopper's")
  print(f"  K1 / K2 a layer: 2 / 1 on the plain stack's b8, 2 / 1 on each "
        f"of the pipeline's {m} microbatches of b{8 // m}")
  _step1_check(results, "pipeline", "plain", M10B_PIPE_LIMITS,
               "Phase 5's loosest step-1 limits (flash against dense).")
  del results
  torch.cuda.empty_cache()
  plain = lambda: lm_trainer.lm_loss_and_grads(model, batch)
  pipe = lambda: _pipe_loss_and_grads(model, batch, mesh, m)
  turns = [_lm_step_ms(f) for f in (plain, pipe, pipe, plain)]
  print(f"  step (forward + backward) ms in turns: plain "
        f"{(turns[0] + turns[3]) / 2:.1f} ({turns[0]:.1f}, {turns[3]:.1f}), "
        f"pipeline of {m} microbatches at 1 stage "
        f"{(turns[1] + turns[2]) / 2:.1f} ({turns[1]:.1f}, {turns[2]:.1f})")
  del model
  torch.cuda.empty_cache()
  return counts["pipeline"]


def _m10b_ep(dev, mesh):
  """(B): phase 5b's MoE config (depth M10B_MOE_LAYERS) through the expert
  parallel path on the mesh (1, 1, 1) (the global routing's prefix over
  the data ranks, the experts' remap to this rank's, the sum of the slots
  over 'model') against no mesh; then one step with the blocks
  microbatched through pipeline_blocks on each (dp x PP x EP at one rank),
  also bit-equal. Returns the mesh runs' {kernel: launches}."""
  import torch
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.train import lm_trainer
  from automl_tpu_torch.train import optimizers as opt_lib
  cfg = lm_lib.get_lm_config("lm-flops1e19")
  cfg.override(f"{M6_FLASH},{M6_MOE},n_layers={M10B_MOE_LAYERS}")
  plain = lm_lib.TransformerLM(cfg, device=dev)
  _card_init(plain, 1)
  meshed = lm_lib.TransformerLM(cfg, device=dev, mesh=mesh)
  _copy_params(meshed, plain)
  data = iter(lm_trainer.SyntheticLMData(8, cfg.seq_len, cfg.vocab_size))
  batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
             for _ in range(M10B_EP_STEPS)]
  # The EP dispatch's sum over 'model' runs once a MoE layer and forward
  # pass (the remat's recompute included) on the mesh, never without.
  comm, reduces = lm_lib.comm, [0]
  orig_reduce = comm.reduce_from_axis

  def count_reduce(*args):
    reduces[0] += 1
    return orig_reduce(*args)
  comm.reduce_from_axis = count_reduce
  kept = {}
  for label, model in (("no mesh", plain), ("mesh", meshed)):
    moe = model.blocks[0].ffn
    orig = moe._global_slots

    def spy(idx, orig=orig, label=label):
      out = orig(idx)
      kept.setdefault(label, out[1])
      return out
    moe._global_slots = spy
  try:
    _flash_reset()
    loss_m, grads_m = lm_trainer.lm_loss_and_grads(meshed, batches[0])
    counts = _flash_counts()
    ep_reduces = reduces[0]
    loss_p, grads_p = lm_trainer.lm_loss_and_grads(plain, batches[0])
    plain_reduces = reduces[0] - ep_reduces
  finally:
    comm.reduce_from_axis = orig_reduce
    for model in (plain, meshed):
      del model.blocks[0].ffn._global_slots
  equal = sum(bool(torch.equal(_local(grads_m[k]), grads_p[k]))
              for k in grads_p)
  same_keep = bool(torch.equal(kept["mesh"], kept["no mesh"]))
  print(f"  step 1: loss {float(loss_m):.6f} on the mesh, {float(loss_p):.6f}"
        f" without; {equal} of {len(grads_p)} grad leaves bit-equal; layer "
        f"0's kept slots {int(kept['mesh'].sum())} of "
        f"{kept['mesh'].numel()}, equal: {same_keep}; the EP sum over "
        f"'model' ran {ep_reduces} times on the mesh, {plain_reduces} "
        f"without")
  if ep_reduces < M10B_MOE_LAYERS or plain_reduces:
    raise AssertionError("(B) the mesh run did not take the expert "
                         "parallel dispatch")
  if not (float(loss_m) == float(loss_p) and equal == len(grads_p)
          and same_keep):
    raise AssertionError("(B) expert parallelism on one rank is not "
                         "bit-equal to no mesh")
  del grads_m, grads_p
  losses = {}
  for label, model in (("mesh", meshed), ("no mesh", plain)):
    tx = opt_lib.build_optimizer("lion", 1e-4)
    step = lm_trainer.make_lm_train_step(model, tx)
    state = lm_trainer.init_train_state(model, tx)
    if label == "mesh":
      before = _flash_counts()
    out = []
    for b in batches:
      state, logs = step(state, b)
      out.append(float(logs["loss"]))
    if label == "mesh":
      after = _flash_counts()
      counts = {k: counts[k] + after[k] - before[k] for k in counts}
    losses[label] = out
    del state
  print(f"  {M10B_EP_STEPS} Lion steps, losses: mesh {losses['mesh']}, no "
        f"mesh {losses['no mesh']}")
  if losses["mesh"] != losses["no mesh"]:
    raise AssertionError("(B) the EP run's losses differ from no mesh")
  # dp x PP x EP at one rank: each microbatch routes its own 4,096 tokens,
  # on the mesh through the EP dispatch.
  _copy_params(meshed, plain)
  before = _flash_counts()
  loss_mm, grads_mm = _pipe_loss_and_grads(meshed, batches[0], mesh,
                                           M10B_MICRO)
  after = _flash_counts()
  counts = {k: counts[k] + after[k] - before[k] for k in counts}
  loss_mp, grads_mp = _pipe_loss_and_grads(plain, batches[0], mesh,
                                           M10B_MICRO)
  equal = sum(bool(torch.equal(_local(grads_mm[k]), grads_mp[k]))
              for k in grads_mp)
  print(f"  one step with the MoE blocks in {M10B_MICRO} microbatches "
        f"through pipeline_blocks (each routes its 4,096 tokens on its "
        f"own): loss {float(loss_mm):.6f} on the mesh, "
        f"{float(loss_mp):.6f} without; {equal} of {len(grads_mp)} grad "
        f"leaves bit-equal")
  if not (float(loss_mm) == float(loss_mp) and equal == len(grads_mp)
          and math.isfinite(float(loss_mm))):
    raise AssertionError("(B) the microbatched MoE step on the mesh is not "
                         "bit-equal to no mesh")
  del plain, meshed, grads_mm, grads_mp
  torch.cuda.empty_cache()
  return counts


def _m10b_det(workdir):
  """(C) D0 b16 512 x 512 through cli/main_det with the K6 knob on,
  M10B_DET_STEPS steps on the mesh (1, 1, 1) and as many without; returns
  the mesh run's K6 launches."""
  import torch
  from automl_tpu_torch.cli import main_det
  from automl_tpu_torch.ops import depthwise as dw
  f = dw.depthwise_filter_grad
  steps = M10B_DET_STEPS
  flags = ["--mode=train", "--model_name=efficientdet-d0", "--use_fake_data",
           f"--hparams=mixed_precision=true,batch_size={D0_BATCH}",
           "--log_every=1", "--device=cuda", f"--train_steps={steps}"]
  losses, launches = {}, {}
  for label, extra in (("mesh", ["--mesh_shape=1,1,1"]), ("no mesh", [])):
    d = workdir + ("_det_mesh" if extra else "_det_plain")
    shutil.rmtree(d, ignore_errors=True)
    dw.enable_pallas_filter_grad(True)
    f.launches = f.launches_sm90 = 0
    try:
      main_det.main(flags + [f"--model_dir={d}"] + extra)
    finally:
      dw.enable_pallas_filter_grad(False)
    launches[label] = (f.launches, f.launches_sm90)
    recs = [json.loads(l) for l in open(os.path.join(d, "metrics.jsonl"))]
    losses[label] = [r["loss"] for r in recs]
  for label in ("mesh", "no mesh"):
    print(f"  D0 losses, {label}: "
          + " ".join(f"{x:.4f}" for x in losses[label]))
  equal = sum(a == b for a, b in zip(losses["mesh"], losses["no mesh"]))
  print(f"  {equal} of {steps} steps' losses equal; K6 launches on the mesh "
        f"{launches['mesh'][0]} ({launches['mesh'][1]} Hopper), without "
        f"{launches['no mesh'][0]} (expected 76 x {steps} each)")
  if losses["mesh"] != losses["no mesh"] or not all(
      math.isfinite(x) for x in losses["mesh"]):
    raise AssertionError("(C) the D0 mesh run's losses differ")
  for got in launches.values():
    if got != (76 * steps, 76 * steps):
      raise AssertionError("(C) the D0 runs did not go through the Hopper K6")
  saved = torch.load(os.path.join(workdir + "_det_mesh", "ckpt", str(steps),
                                  "state.pt"), map_location="cpu",
                     weights_only=True)
  print(f"  the mesh run's checkpoint: step {saved['step']}, "
        f"{len(saved['params'])} tensors (rank 0's state.pt)")
  if saved["step"] != steps:
    raise AssertionError("(C) the mesh run's checkpoint")
  return launches["mesh"][0]


def _m10b_cls_start(workdir):
  """(C) V2-S at 168 x 168, b256, K6 knob on, M10B_CLS_STEPS steps through
  cli/main_cls on the mesh (1, 1, 1) and without, in two child processes
  started at once (they run beside the D0 runs); returns {label: (model
  dir, log path, process)}."""
  flags = ["--model_name=efficientnetv2-s", f"--train_steps={M10B_CLS_STEPS}",
           "--log_every=1", "--device=cuda",
           f"--hparam_str=train.batch_size={V2S_BATCH},train.stages=0,"
           "train.isize=168"]
  root = os.path.dirname(os.path.abspath(__file__))
  procs = {}
  for label, extra in (("mesh", ["--mesh_shape=1,1,1"]), ("no mesh", [])):
    d = workdir + ("_cls_mesh" if extra else "_cls_plain")
    shutil.rmtree(d, ignore_errors=True)
    log = d + ".log"
    with open(log, "w") as f:
      procs[label] = (d, log, subprocess.Popen(
          [sys.executable, "-c", _CLS_CHILD, json.dumps(
              [(True, flags + [f"--model_dir={d}", *extra])])],
          cwd=root, stdout=f,
          stderr=subprocess.STDOUT, text=True))
  return procs


def _m10b_cls_finish(procs):
  """Waits for _m10b_cls_start's children and checks them: equal losses
  and K6 launches, all Hopper's; returns the mesh run's K6 launches."""
  losses, launches = {}, {}
  for label, (d, log, proc) in procs.items():
    proc.wait(timeout=600)
    out = open(log).read()
    if proc.returncode != 0:
      print(out[-6000:])
      raise AssertionError(f"(C) main_cls ({label}) exited "
                           f"{proc.returncode}")
    marks = json.loads(next(l for l in out.splitlines()
                            if l.startswith("CLS_RUN "))[8:])["marks"]
    launches[label] = (marks[-1]["launches"] - marks[0]["launches"],
                       marks[-1]["sm90"] - marks[0]["sm90"])
    recs = [json.loads(l) for l in open(os.path.join(d, "metrics.jsonl"))]
    losses[label] = [r["loss"] for r in recs if "loss" in r]
  print(f"  V2-S 168 b{V2S_BATCH} losses on the mesh {losses['mesh']}, "
        f"without {losses['no mesh']}; K6 launches {launches['mesh']} on the "
        f"mesh (all, Hopper), {launches['no mesh']} without")
  if losses["mesh"] != losses["no mesh"] or len(losses["mesh"]) != \
      M10B_CLS_STEPS:
    raise AssertionError("(C) the V2-S mesh run's losses differ")
  n, sm90 = launches["mesh"]
  if n != launches["no mesh"][0] or n == 0 or n != sm90:
    raise AssertionError("(C) the V2-S runs' K6 launches")
  return n


def _m10b_eval(dev, mesh):
  """(C) evaluate_detection on D0 with the mesh against without it."""
  import torch
  from automl_tpu_torch.data import pipeline
  from automl_tpu_torch.train import runners
  cfg = _det_config()
  model = runners.seeded_detection_model(cfg, 0, dev)
  batches = [next(iter(pipeline.SyntheticDetection(8, 512, 10, 90, seed=s)))
             for s in range(2)]
  params = dict(model.state_dict(keep_vars=True))
  got = {label: runners.evaluate_detection(model, params, cfg,
                                           iter(batches), 2, mesh=m)
         for label, m in (("mesh", mesh), ("no mesh", None))}
  print(f"  evaluate_detection (D0, 2 batches of 8): AP {got['mesh']['AP']} "
        f"on the mesh, {got['no mesh']['AP']} without; "
        f"{len(got['mesh'])} metrics")
  if got["mesh"] != got["no mesh"]:
    raise AssertionError("(C) evaluate_detection with the mesh differs")
  del model
  torch.cuda.empty_cache()


def _m10b_k6_bands(dev, flush):
  """(D): K6 on the H-bands of every stride-1 depthwise map of a D0 step
  (2 and 4 bands, each the band's rows with k // 2 halo rows, zeros past
  the image, and dy padded by k // 2 zero rows), summed, against the
  whole map's K6 call and the plain version (K6_SHARE); all Hopper's.
  Returns the largest error."""
  import torch
  import torch.nn.functional as F
  from automl_tpu_torch.ops import depthwise as dw
  gen = torch.Generator(device=dev).manual_seed(5)
  cl = torch.channels_last
  f = dw.depthwise_filter_grad
  kern, ref = dw.depthwise_filter_grad_kernel, \
      dw.depthwise_filter_grad_reference
  b, worst, timed = D0_BATCH, 0.0, False
  for (c, h, w, k) in D0_K6_SHAPES:
    x, dy = (torch.randn((b, c, h, w), generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=cl) for _ in range(2))
    whole = kern(x, dy, k)
    plain = ref(x, dy, k)
    r = k // 2
    xp = F.pad(x, (0, 0, r, r))
    for m in (2, 4):
      hb = h // m
      if h % m or hb < r:
        continue
      bands = [(xp[:, :, i * hb:i * hb + hb + 2 * r].contiguous(
          memory_format=cl), F.pad(dy[:, :, i * hb:(i + 1) * hb],
                                   (0, 0, r, r)).contiguous(memory_format=cl))
               for i in range(m)]
      before = (f.launches, f.launches_sm90)
      total = sum(kern(xb, dyb, k) for xb, dyb in bands)
      if (f.launches - before[0], f.launches_sm90 - before[1]) != (m, m):
        raise AssertionError("(D) a band's K6 did not go to the Hopper "
                             "kernel")
      label = f"[{b},{c},{h},{w}] k{k} in {m} bands of {hb} (+{2 * r})"
      worst = max(worst, _compare_scaled(f"{label} vs the whole call", total,
                                         whole, K6_SHARE),
                  _compare_scaled(f"{label} vs plain", total, plain,
                                  K6_SHARE))
      if not timed and m == 4:
        xb, dyb = bands[0]
        t_band = _time_ms(lambda: kern(xb, dyb, k), 10, flush)
        t_whole = _time_ms(lambda: kern(x, dy, k), 10, flush)
        print(f"  {label}: one band's K6 {t_band:.4f} ms, the whole map's "
              f"{t_whole:.4f} ms (L2 flushed before each call)")
        timed = True
    del x, dy, xp
  torch.cuda.empty_cache()
  return worst


def m10b_phase(dev, workdir):
  """M10's second half on the card (A)-(D) at a world of one (NCCL);
  returns {kernel: launches} of its main-path runs, each counted from 0
  just before the run: K1 / K2 of (A)'s pipeline step and (B)'s mesh
  steps, K6 of (C)'s D0 and V2-S mesh runs."""
  import torch
  import torch.distributed as dist
  from automl_tpu_torch.parallel import create_mesh

  t_phase = time.perf_counter()
  os.makedirs(workdir, exist_ok=True)
  torch.cuda.set_device(dev)
  mesh = create_mesh((1, 1, 1), device="cuda")
  print(f"M10b: process group {dist.get_backend()}, world "
        f"{dist.get_world_size()}, mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
  try:
    t = time.perf_counter()
    print(f"(A) GPipe over lm-flops1e19's blocks, 1 stage, {M10B_MICRO} "
          "microbatches, against the plain stack")
    pipe = _m10b_pipeline(dev, mesh)
    print(f"(A) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    print(f"(B) MoE (8 experts, top-2, {M10B_MOE_LAYERS} layers) with its "
          "experts over 'model' on the mesh (1, 1, 1) against no mesh")
    ep = _m10b_ep(dev, mesh)
    print(f"(B) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    print("(C) the detection and classification meshes")
    cls_procs = _m10b_cls_start(workdir)
    try:
      k6_det = _m10b_det(workdir)
      k6_cls = _m10b_cls_finish(cls_procs)
    finally:
      for _, _, proc in cls_procs.values():
        if proc.poll() is None:
          proc.kill()
          proc.wait()
    _m10b_eval(dev, mesh)
    print(f"(C) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    print("(D) K6 on H-bands with their halos against the whole map")
    err = _m10b_k6_bands(dev, flush_buf.zero_)
    del flush_buf
    print(f"(D) largest error {err:.3e}; {time.perf_counter() - t:.1f} s")
  finally:
    dist.destroy_process_group()
  print(f"M10b phase: {time.perf_counter() - t_phase:.1f} s")
  return {"K1 sm90": pipe["K1 sm90"] + ep["K1 sm90"],
          "K2 sm90": pipe["K2 sm90"] + ep["K2 sm90"], "K6": k6_det + k6_cls}


# ---------------------------------------------------------------------------
# The JAX package's orbax run directories (orbax_phase): ckpt/orbax.py ->
# ckpt/ocdbt.py -> csrc/host/zstd.cc.
# ---------------------------------------------------------------------------

ORBAX_FIXTURE = os.path.join("tests", "fixtures", "jax_lm_test_run")
ORBAX_DECODES = 200      # passes over the fixture's frames for the rate
ORBAX_NEW = 16           # tokens the fixture's model decodes


def _leaf_digest(t):
  """(dtype name, shape, sha256) of a tensor as orbax restores it (numpy's
  dtype names; bfloat16 by its bits)."""
  import hashlib
  import torch
  bf16 = t.dtype == torch.bfloat16
  arr = (t.view(torch.int16) if bf16 else t).contiguous().numpy()
  return ("bfloat16" if bf16 else arr.dtype.name, list(arr.shape),
          hashlib.sha256(arr.tobytes()).hexdigest())


def _orbax_fixture(dev):
  """(a) The committed JAX run directory: its leaves against their
  digests, generate_lm's tokens with K4 against the plain attention, and
  the decoder's rate over its frames."""
  import numpy as np
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.ckpt import ocdbt, orbax, zstd
  from automl_tpu_torch.cli import generate_lm
  from automl_tpu_torch.models import lm as lm_lib
  root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      ORBAX_FIXTURE)
  step_dir = os.path.join(root, "ckpt", "3")
  with open(root + "_leaves.json") as f:
    digests = json.load(f)
  leaves = {k: v for k, v in convert.flatten_tree(
      orbax.read_step(step_dir)).items() if torch.is_tensor(v)}
  bad = [k for k in digests if k not in leaves or list(
      _leaf_digest(leaves[k])) != [digests[k]["dtype"], digests[k]["shape"],
                                   digests[k]["sha256"]]]
  print(f"(a) {ORBAX_FIXTURE}: {len(leaves)} leaves read, "
        f"{len(digests) - len(bad)} of {len(digests)} equal to their digests")
  if bad or len(leaves) != len(digests):
    raise AssertionError(f"(a) leaves differ from their digests: {bad[:5]}")

  cfg, model = generate_lm.load_model(model_dir=root, device=dev)
  model.cfg.decode_kernel_min_s = 0       # K4 at the fixture's short cache
  prompt = torch.from_numpy(np.random.default_rng(5).integers(
      3, cfg.vocab_size, (2, 24))).to(dev)
  _k4_reset()
  tokens = lm_lib.greedy_generate(model, prompt, ORBAX_NEW)
  launches, _ = _k4_counts()
  model.cfg.use_decode_kernel = False
  plain = lm_lib.greedy_generate(model, prompt, ORBAX_NEW)
  same = int((tokens == plain).all(1).sum())
  print(f"(a) generate_lm on it ({cfg.activation_dtype}): b2 24 + "
        f"{ORBAX_NEW} tokens, K4 launches {launches} (expected "
        f"{cfg.n_layers * ORBAX_NEW}), rows equal to the plain attention's "
        f"{same} of 2")
  if launches != cfg.n_layers * ORBAX_NEW or same != 2:
    raise AssertionError("(a) generate_lm with K4 differs from the plain "
                         "attention, or K4 did not run")

  store = ocdbt.OcdbtStore(os.path.join(step_dir, "default"))
  keys = [k for k in store.list() if not k.endswith(".zarray")]
  frames = store.read_many(keys)
  out_bytes = sum(len(zstd.decompress(f)) for f in frames)
  in_bytes = sum(len(f) for f in frames)
  t = time.perf_counter()
  for _ in range(ORBAX_DECODES):
    for f in frames:
      zstd.decompress(f)
  secs = time.perf_counter() - t
  print(f"(a) zstd: {len(frames)} frames ({in_bytes} bytes -> {out_bytes}) "
        f"decoded {ORBAX_DECODES} times in {secs:.3f} s: "
        f"{ORBAX_DECODES * out_bytes / secs / 1e6:.1f} MB/s out, "
        f"{ORBAX_DECODES * in_bytes / secs / 1e6:.1f} MB/s in (one thread)")


def _orbax_lm(dev, workdir, fused_dir):
  """(b) Phase 5's fused lm-flops1e19 state as a JAX run directory: write,
  read back, serve and resume against its state.pt. Returns {kernel:
  launches} of the resume from the JAX directory and its K4 launches."""
  import numpy as np
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.ckpt import orbax
  from automl_tpu_torch.cli import generate_lm, main_lm
  from automl_tpu_torch.models import lm as lm_lib
  from automl_tpu_torch.train import checkpoint, lm_trainer

  fused_ckpt = os.path.join(fused_dir, "ckpt")
  step = checkpoint.all_checkpoint_steps(fused_ckpt)[-1]
  state_pt = os.path.join(fused_ckpt, str(step), "state.pt")
  t = time.perf_counter()
  saved = torch.load(state_pt, map_location="cpu", weights_only=True,
                     mmap=True)
  lion, _, sched = saved["opt_state"]
  tree = {"step": np.asarray(saved["step"], np.int32),
          "params": convert.torch_to_jax_tree(saved["params"]),
          "opt_state": [
              {"momentum": convert.torch_to_jax_tree(lion["momentum"])},
              None, {"count": np.asarray(sched["count"], np.int32)}]}
  del lion
  print(f"(b) {state_pt} as JAX's tree in {time.perf_counter() - t:.1f} s")
  jdir = os.path.join(workdir, "jax_run")
  os.makedirs(os.path.join(jdir, "ckpt"))
  shutil.copy(os.path.join(fused_dir, "experiment_config.yaml"), jdir)
  step_dir = os.path.join(jdir, "ckpt", str(step))
  t = time.perf_counter()
  nbytes = orbax.write_step(step_dir, tree)
  write_s = time.perf_counter() - t
  t = time.perf_counter()
  back = orbax.read_step(step_dir)
  read_s = time.perf_counter() - t
  want = convert.flatten_tree(tree)
  got = convert.flatten_tree(back)
  equal = sum(torch.equal(torch.from_numpy(np.asarray(v)), got[k])
              for k, v in want.items() if v is not None)
  n = sum(v is not None for v in want.values())
  print(f"(b) orbax.write_step: {nbytes} bytes in {write_s:.2f} s "
        f"({nbytes / write_s / 1e9:.2f} GB/s); read_step {read_s:.2f} s "
        f"({nbytes / read_s / 1e9:.2f} GB/s, warm page cache); {equal} of "
        f"{n} leaves read back bit-equal")
  if equal != n or sorted(got) != sorted(want):
    raise AssertionError("(b) the written directory reads back otherwise")
  del tree, back, want, got
  # What the resume restores beyond the params: Lion's momentum (found
  # through the chain's index 0), the None entry and the schedule's count,
  # held tensor by tensor to the state.pt's.
  template = lm_trainer.LMTrainState(
      step=0, params={k: torch.empty_like(v)
                      for k, v in saved["params"].items()},
      opt_state=saved["opt_state"])
  restored = checkpoint.CheckpointManager(
      os.path.join(jdir, "ckpt")).restore(template)
  want = convert.flatten_tree({f: saved[f] for f in restored._fields})
  got = convert.flatten_tree(restored._asdict())
  bad = sorted(set(want) ^ set(got)) + [
      k for k in want if k in got
      and not (torch.equal(want[k], got[k]) and want[k].dtype == got[k].dtype
               if torch.is_tensor(want[k]) else want[k] == got[k])]
  print(f"(b) CheckpointManager.restore of the JAX directory: {len(want)} "
        f"leaves of the state.pt's LMTrainState (step, params, Lion's "
        f"momentum, the schedule's count), differing: {bad[:5]}")
  if bad:
    raise AssertionError(f"(b) the restored state differs at {bad[:5]}")
  del saved, template, restored, want, got

  batch, t0, new = 8, 512, 512
  prompt = None
  tokens = {}
  k4 = 0
  for name, model_dir in (("the JAX directory", jdir),
                          ("the state.pt", fused_dir)):
    t = time.perf_counter()
    cfg, model = generate_lm.load_model(model_dir=model_dir, device=dev,
                                        step=step)
    lm_lib.cast_lm_params_for_serving(model)
    load_s = time.perf_counter() - t
    if prompt is None:
      prompt = torch.from_numpy(np.random.default_rng(1).integers(
          3, cfg.vocab_size, (batch, t0))).to(dev)
    _k4_reset()
    t = time.perf_counter()
    tokens[name] = lm_lib.greedy_generate(model, prompt, new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    print(f"(b) generate_lm from {name}: loaded in {load_s:.2f} s, greedy "
          f"b{batch} {t0} + {new} in {gen_s:.2f} s")
    k4 += _k4_expect(f"(b) {name}", cfg.n_layers * new)
    del model
    torch.cuda.empty_cache()
  same = torch.equal(*tokens.values())
  print(f"(b) tokens from the JAX directory equal to the state.pt's: {same}")
  if not same:
    raise AssertionError("(b) the JAX directory serves other tokens")

  port_dir = os.path.join(workdir, "port_run")
  os.makedirs(os.path.join(port_dir, "ckpt", str(step)))
  shutil.copy(os.path.join(fused_dir, "experiment_config.yaml"), port_dir)
  os.link(state_pt, os.path.join(port_dir, "ckpt", str(step), "state.pt"))
  flags = ["--config_name=lm-flops1e19", f"--batch_size={batch}",
           "--warmup_steps=3", "--log_every=1", "--device=cuda",
           f"--learning_rate={FUSED_LR}",
           "--experiment_config=use_flash_attention=true,"
           "fused_softmax_loss=pallas", f"--train_steps={step + 2}"]
  counters = _train_counters()
  n_layers = lm_lib.get_lm_config("lm-flops1e19").n_layers
  hopper = lambda k1, k2, k3: {
      "K1": k1, "K1 sm90": k1, "K2": k2, "K2 sm90": k2,
      **{f"K3{c}{s}": k3 for c in "abc" for s in ("", " sm90")}}
  expected = dict(dict.fromkeys(TRAIN_KERNELS, 0),
                  **hopper(2 * n_layers * 2, n_layers * 2, 2))
  losses, launches = {}, None
  for name, model_dir in (("the JAX directory", jdir),
                          ("the state.pt", port_dir)):
    for fn, attr in counters.values():
      setattr(fn, attr, 0)
    t = time.perf_counter()
    with _NoCheckpoints():
      main_lm.main(flags + [f"--model_dir={model_dir}"])
    got = {kid: getattr(fn, attr) for kid, (fn, attr) in counters.items()}
    launches = launches or got
    recs = [json.loads(line) for line in open(
        os.path.join(model_dir, "metrics.jsonl")).read().splitlines()]
    losses[name] = [r["loss"] for r in recs if "loss" in r]
    print(f"(b) main_lm resumed from {name} at step {step}: steps "
          f"{[r['step'] for r in recs if 'loss' in r]}, losses "
          f"{losses[name]} in {time.perf_counter() - t:.1f} s; launches "
          f"{got}")
    if ([r["step"] for r in recs if "loss" in r] != [step + 1, step + 2]
        or not all(math.isfinite(x) for x in losses[name])
        or got != expected):
      raise AssertionError(f"(b) the resume from {name} did not train "
                           f"steps {step + 1}-{step + 2} through the "
                           f"kernels as expected ({expected})")
  # Step step + 1's loss reads the params alone; step + 2's also the
  # momentum and the count that the first step's update used.
  print(f"(b) the resumed steps' losses, JAX directory vs state.pt: "
        f"{losses['the JAX directory']!r} vs {losses['the state.pt']!r}")
  if losses["the JAX directory"] != losses["the state.pt"]:
    raise AssertionError("(b) the resumed losses differ")
  return launches, k4


def _orbax_d0(dev, workdir, det_ckpt):
  """(c) The 20-step D0 checkpoint written as a JAX step: ServingDriver
  serves b1 from it as from the state.pt."""
  import numpy as np
  import torch
  from automl_tpu_torch import convert
  from automl_tpu_torch.ckpt import orbax
  from automl_tpu_torch.configs.efficientdet_configs import (
      get_efficientdet_config)
  from automl_tpu_torch.inference import driver
  from automl_tpu_torch.models.efficientdet import EfficientDet
  from automl_tpu_torch.train import checkpoint, train_lib

  step = checkpoint.all_checkpoint_steps(det_ckpt)[-1]
  saved = torch.load(os.path.join(det_ckpt, str(step), "state.pt"),
                     map_location="cpu", weights_only=True)
  state = train_lib.TrainState(**{f: saved[f] for f in
                                  train_lib.TrainState._fields})
  j = convert.det_state_to_jax(state, EfficientDet(
      get_efficientdet_config("efficientdet-d0"), device="cpu"))
  tree = {"step": np.asarray(j["step"], np.int32), "params": j["params"],
          "opt_state": {"inner_state": [
              {"trace": j["trace"]}, {"count": np.asarray(j["count"],
                                                          np.int32)}]},
          "ema_params": j["ema_params"],
          "normalizer": (None if j["normalizer"] is None
                         else np.asarray(j["normalizer"], np.float32))}
  jckpt = os.path.join(workdir, "det", "ckpt")
  os.makedirs(jckpt)
  nbytes = orbax.write_step(os.path.join(jckpt, str(step)), tree)
  images = torch.from_numpy(_driver_images(1, 480, 640))
  out = {}
  for name, d in (("the JAX directory", jckpt), ("the state.pt", det_ckpt)):
    drv = driver.ServingDriver("efficientdet-d0", batch_size=1,
                               device=dev).load(d)
    with torch.no_grad():
      out[name] = drv.program(images.to(dev))
    del drv
  print(f"(c) D0 step {step} as a JAX step: {nbytes} bytes")
  _same_detections("(c) ServingDriver D0 b1 from the JAX directory vs the "
                   "state.pt", *out.values())


def orbax_phase(dev, workdir, fused_dir, det_ckpt):
  """The JAX package's run directories on the card: (a) the committed
  fixture, (b) lm-flops1e19 at full width, (c) D0 serving. Returns {kernel:
  launches} of (b)'s resume plus its K4 launches under "K4 sm90"."""
  shutil.rmtree(workdir, ignore_errors=True)
  os.makedirs(workdir)
  try:
    _orbax_fixture(dev)
    launches, k4 = _orbax_lm(dev, workdir, fused_dir)
    _orbax_d0(dev, workdir, det_ckpt)
  finally:
    shutil.rmtree(workdir, ignore_errors=True)
  return dict(launches, **{"K4 sm90": k4})


def _entry(name, source, replaces, launches, r):
  return {"name": name, "route": "cuda", "source": source,
          "replaces": replaces, "launches": launches,
          "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
          "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
          "library_ms": r["library_ms"]}


def _sass_report(lib):
  """Per kernel of a built library: its wgmma (HGMMA) instructions and its
  local-memory loads and stores (LDL / STL: spills) in the SASS, by
  cuobjdump, where the toolkit has it."""
  import re
  from torch.utils.cpp_extension import CUDA_HOME
  tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "", "bin",
                                                   "cuobjdump")
  if not os.path.exists(tool):
    print(f"  sass: no cuobjdump ({tool})")
    return
  sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                        text=True, timeout=120, check=False).stdout
  for body in re.split(r"\n\s*Function : ", sass)[1:]:
    # Template arguments: an int (ILi128E; K6's k: ILi3E) and, for the
    # flash backward, a bool (Lb1E: K2 with its dq half; Lb0E: K5b
    # without); the xent kernels' bool alone (ILb1E: K3b, dx; ILb0E: K3c,
    # dW).
    name = re.sub(
        r".*?\d((?:flash|k4|xent|filter_grad)_\w*?_kernel)(?:ILi(\d+)E"
        r"(?:Lb([01])E)?"
        r"|ILb([01])E)?.*",
        lambda m: m[1] + (
            f"<{m[2]}{', kDq=' + m[3] if m[3] else ''}>" if m[2] else
            f"<kDx={m[4]}>" if m[4] else ""),
        body.splitlines()[0].strip())
    ops = re.findall(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", body)
    count = lambda *names: sum(op in names for op in ops)
    first = re.search(r"HGMMA\.\S+", body)
    print(f"  sass {lib.name.split('-')[0]}: {name}: {count('HGMMA')} "
          f"HGMMA ({first.group(0) if first else '-'}, ...), "
          f"{count('LDL', 'STL')} LDL/STL")


def _timed(secs, name, fn, *args):
  """fn(*args), its wall seconds kept as secs[name]."""
  t = time.perf_counter()
  out = fn(*args)
  secs[name] = round(time.perf_counter() - t, 1)
  return out


def main() -> int:
  import torch
  from automl_tpu_torch.ckpt import zstd
  from automl_tpu_torch.data import native_loader
  from automl_tpu_torch.ops import cuda_build

  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs only on a GPU",
          file=sys.stderr)
    return 1
  t_start = time.perf_counter()
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda:0")
  profile = "--profile" in sys.argv[1:]
  trees = None
  if not profile:
    # The LM phases' weights, drawn on the host while the kernels build.
    trees = _Trees()
    for cfg, _ in _m6_configs().values():
      trees.prefetch(cfg)
  card = subprocess.run(
      ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
       "--format=csv,noheader"],
      capture_output=True, text=True, timeout=60, check=True).stdout.strip()
  print(f"card: {card}")
  print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
  host_facts()

  t = time.perf_counter()
  sources = ("decode_attention", "decode_attention_sm90", "flash_attention",
             "flash_attention_sm90", "xent", "xent_sm90", "depthwise",
             "depthwise_sm90")
  with concurrent.futures.ThreadPoolExecutor(len(sources) + 2) as pool:
    # The host libraries of phases 16 and 11.
    hosts = [pool.submit(zstd.build), pool.submit(native_loader.build_host)]
    libs = list(pool.map(cuda_build.build, sources))
  print(f"build: {', '.join(l.name for l in libs)}, "
        f"{', '.join(h.result().name for h in hosts)} in "
        f"{time.perf_counter() - t:.1f} s (nvcc and g++ in parallel)")
  for lib in libs:
    log = lib.parent / (lib.name + ".log")
    for line in log.read_text().splitlines() if log.exists() else ():
      if ("registers" in line or "spill" in line
          or "Performance Loss" in line):
        print(f"  ptxas: {line.strip()}")
  for name in ("decode_attention_sm90", "flash_attention_sm90", "xent_sm90",
               "depthwise_sm90"):
    _sass_report(libs[sources.index(name)])

  if profile:
    profile_phase(dev)
    return 0
  trees.wait()
  flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
  secs = {}     # wall seconds by phase, for the timeline line at the end
  k4 = _timed(secs, "2 K4", k4_phase, dev, flush_buf.zero_)
  flash = _timed(secs, "3 K1/K2/K5", flash_phase, dev, flush_buf.zero_)
  k3 = _timed(secs, "4 K3", xent_phase, dev, flush_buf.zero_)
  k6 = _timed(secs, "6 K6", k6_phase, dev, flush_buf.zero_)
  _timed(secs, "9g K6 at V2-S", k6_v2s_phase, dev, flush_buf.zero_)
  del flush_buf
  torch.cuda.empty_cache()
  # The training runs' model_dirs, inside the checkout (build/ is ignored).
  build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
  workdir = os.path.join(build, "chip_smoke_lm")
  det_dir = os.path.join(build, "chip_smoke_det")
  cls_dir = os.path.join(build, "chip_smoke_cls")
  m6_dir = os.path.join(build, "chip_smoke_lm_m6")
  sqs_dir = os.path.join(build, "chip_smoke_sqs")
  for d in (sqs_dir + "_qat", sqs_dir + "_plain", sqs_dir + "_gn"):
    shutil.rmtree(d, ignore_errors=True)
  for d in (workdir, workdir + "_fused", workdir + "_split", m6_dir, det_dir,
            det_dir + "_off", os.path.join(build, "chip_smoke_infer"),
            os.path.join(build, "chip_smoke_serve"),
            os.path.join(build, "chip_smoke_lm_serving"),
            cls_dir, cls_dir + "_off", cls_dir + "_mix",
            os.path.join(build, "chip_smoke_m10"),
            os.path.join(build, "chip_smoke_m10_mesh"),
            os.path.join(build, "chip_smoke_m10_plain"),
            os.path.join(build, "chip_smoke_m10b")):
    shutil.rmtree(d, ignore_errors=True)
  with trees:
    runs = _timed(secs, "5 training", training_phase, dev, workdir)
    m6 = _timed(secs, "5b M6", lm_training_m6_phase, dev, m6_dir, trees)
    k6_launches, d0_synthetic_ms = _timed(secs, "7 detection",
                                          detection_phase, dev, det_dir)
    det_ckpt = os.path.join(det_dir + "_off", "ckpt")
    serve_dir = os.path.join(build, "chip_smoke_serve")
    # Phase 8b's torch.export of D0 traces on the host for ~35 s: a process
    # of its own does it while phase 8 runs.
    export = _start_export(det_ckpt, serve_dir)
    try:
      _timed(secs, "8 inference", inference_phase, dev, det_ckpt,
             os.path.join(build, "chip_smoke_infer"))
      _timed(secs, "8b driver", driver_phase, dev, det_ckpt, serve_dir, card,
             export)
    finally:
      _stop_export(export)
    cls_k6_launches, v2s_synthetic_ms, v2s_on_ms = _timed(
        secs, "9 classification", cls_phase, dev, cls_dir)
    _timed(secs, "11 data", data_phase, dev,
           os.path.join(build, "chip_smoke_data"), d0_synthetic_ms,
           v2s_synthetic_ms)
    sqs = _timed(secs, "13 seg/QAT/search", seg_qat_search_phase, dev, sqs_dir,
                 v2s_on_ms)
    k4_launches = _timed(secs, "10 serving", serving_phase, dev)
    k4_serving, draft = _timed(
        secs, "12 LM serving", lm_serving_phase, dev,
        os.path.join(build, "chip_smoke_lm_serving"), workdir + "_fused")
    k4_launches += k4_serving
    k4_launches += m6["K4 sm90"]
    m10 = _timed(secs, "14 M10", m10_phase, dev,
                 os.path.join(build, "chip_smoke_m10"))
    k4_launches += m10["K4"]
    m10b = _timed(secs, "15 M10b", m10b_phase, dev,
                  os.path.join(build, "chip_smoke_m10b"))
    jax_dirs = _timed(secs, "16 orbax", orbax_phase, dev,
                      os.path.join(build, "chip_smoke_orbax"),
                      workdir + "_fused", det_ckpt)
    k4_launches += jax_dirs["K4 sm90"]
  for label in ("prefill T=512", "verify T=5", "chunk T=256"):
    print(f"K4 {label}: {json.dumps(k4[label])}")
  print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all; by "
        f"phase: {json.dumps(secs)}")
  print(json.dumps({"kernels": [
      _entry("decode_attention",
             "automl_tpu_torch/csrc/decode_attention_sm90.cu",
             "automl_tpu/ops/decode_attention.py:51", k4_launches,
             k4["decode T=1"]),
      _entry("flash_fwd", "automl_tpu_torch/csrc/flash_attention_sm90.cu",
             "automl_tpu/ops/attention.py:82",
             runs["unfused"]["K1 sm90"] + m6["K1 sm90"] + sqs["K1 sm90"]
             + m10["K1 sm90"] + m10b["K1 sm90"] + draft["K1 sm90"]
             + jax_dirs["K1 sm90"],
             flash["fwd"]),
      _entry("flash_bwd", "automl_tpu_torch/csrc/flash_attention_sm90.cu",
             "automl_tpu/ops/attention.py:320",
             runs["unfused"]["K2 sm90"] + m6["K2 sm90"] + sqs["K2 sm90"]
             + m10["K2 sm90"] + m10b["K2 sm90"] + draft["K2 sm90"]
             + jax_dirs["K2 sm90"],
             flash["bwd"]),
      _entry("flash_bwd_dq", "automl_tpu_torch/csrc/flash_attention_sm90.cu",
             "automl_tpu/ops/attention.py:240", runs["split"]["K5a sm90"],
             flash["dq"]),
      _entry("flash_bwd_dkv", "automl_tpu_torch/csrc/flash_attention_sm90.cu",
             "automl_tpu/ops/attention.py:277", runs["split"]["K5b sm90"],
             flash["dkv"]),
      _entry("xent_fwd", "automl_tpu_torch/csrc/xent_sm90.cu",
             "automl_tpu/ops/xent.py:66",
             runs["fused"]["K3a sm90"] + m6["K3a sm90"]
             + draft["K3a sm90"] + jax_dirs["K3a sm90"], k3["fwd"]),
      _entry("xent_dx", "automl_tpu_torch/csrc/xent_sm90.cu",
             "automl_tpu/ops/xent.py:113",
             runs["fused"]["K3b sm90"] + m6["K3b sm90"]
             + draft["K3b sm90"] + jax_dirs["K3b sm90"], k3["dx"]),
      _entry("xent_dw", "automl_tpu_torch/csrc/xent_sm90.cu",
             "automl_tpu/ops/xent.py:138",
             runs["fused"]["K3c sm90"] + m6["K3c sm90"]
             + draft["K3c sm90"] + jax_dirs["K3c sm90"], k3["dw"]),
      _entry("depthwise_filter_grad",
             "automl_tpu_torch/csrc/depthwise_sm90.cu",
             "automl_tpu/ops/depthwise.py:37",
             k6_launches + cls_k6_launches + sqs["K6"] + m10b["K6"],
             k6["[16,32,256,256] k3"]),
  ]}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())

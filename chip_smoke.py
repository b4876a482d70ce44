"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device       -- requires CUDA; the card's name and power limit
                     (nvidia-smi).
  2. build        -- builds the six kernel libraries with nvcc from this
                     checkout's csrc/ (sm_90a), and the instrumented copies
                     of the spatial source (spatial_phase_split) and of the
                     projection's serving source
                     (projection_fwd_phase_split), in parallel; their ptxas
                     summaries; that the temporal forward's products are
                     tensor-core code (its three GEMM entries and no
                     CUDA-core GEMM among the library's entries, and each
                     entry's HMMA instructions in the SASS, by cuobjdump).
  3. kernel       -- the serving kernel against its plain PyTorch version
                     and against its algorithm in plain PyTorch
                     (fused_projection_fwd_algorithm) on the card, on seeded
                     random rotations: B in {1024, 1000, 5} at L=16, B=1024
                     at L=1 and 81, B=3 at L=81 (FWD_SHAPES: clips longer
                     than one chunk), and views off a 16-byte boundary
                     (VIEW_SHAPE). Bounds: 1e-3 px on x and y, 1e-4 on
                     depth.
  4. kernel_train -- the training forward kernel against its plain version
                     and its algorithm (1e-3 px, 1e-4 depth, 1e-5 abs_loc;
                     the states' error printed) and the backward
                     kernel against autograd of the plain version with
                     seeded cotangents and against its own plain version
                     (the kernel's algorithm: per-frame tree terms, then the
                     carry; each gradient over its largest magnitude: rtol
                     1e-4, atol 1e-5), at FWD_SHAPES, B=5 with L=2 and
                     VIEW_SHAPE's views; two
                     backward launches give the same bits.
  5. serve        -- the port's serving path at full width: Carla2D3D test
                     batches (B=1024, L=16) -> LinearAE (seeded init) ->
                     PoseLiftingFlow(projection_kernel="fused") ->
                     make_inference_fn, 8 requests; one kernel launch per
                     request; outputs finite and equal to the "plain" flow's;
                     eval_step's loc_2d_3d loss equal to the plain flow's.
  6. train        -- the port's training path at full width: Trainer.fit of
                     PoseLiftingFlow(projection_kernel="fused_train") on
                     Carla2D3D train batches (B=1024, L=16), LinearAE (seeded
                     init), loc_2d_3d, AdamW lr 1e-3: 20 steps and 2
                     validation batches. 22 forward and 20 backward launches;
                     every logged loss finite and the last 5 train losses
                     below the first; metrics.jsonl, best.json and the last
                     checkpoint written, and restoring it gives back the
                     trained params. Then 3 training_steps of the
                     "fused_train" and the "plain" flow from the same params
                     on the same batches: losses equal to rtol 1e-4.
  7. timing       -- CUDA-event medians: the kernels (L2 cold and warm; the
                     forwards also at B=1024 for L in {1, 16, 81}, beside
                     their bounds), their plain versions, the eager plane
                     path; then projection_fwd_phase_split: the serving
                     kernel's phases (staging, carry, FK and projection,
                     copy out) at those shapes, from the clock64() cycles
                     of an instrumented copy of its source (the same output
                     bits), as shares of its time; host-clock
                     medians: a serving request of both flows, a
                     training_step of both flows, and a standalone call of
                     the plane outputs the "fused_train" step computes (its
                     ratio to the step estimates the plane path's share; it
                     is not measured inside the step).
  8. kernel_spatial  -- PoseFormer's spatial-stack kernel against its plain
                     version on seeded weights (LayerNorms away from ones
                     and zeros): J=26, E=32, 8 heads, depth 4, N in {4096,
                     4093, 5}; E=32 with 1 head (head width 32), E=64 with
                     hidden 128 and E=20 with 5 heads, hidden 40 (widths 4
                     mod 8: the products' zero-padded k-edge) at N in
                     {1024, 1021}; at the edge of its shared memory (J=32,
                     E=12, 3 heads and hidden 864, 1 head and hidden 860; X
                     and Y rows at stride E) at N=67, serving and the
                     training forward the same output; the library's
                     shared-memory sizes against the wrapper's copies at
                     all these shapes. Bar: max |kernel -
                     plain| <= 1e-5 x max |plain| (the card shows under
                     1e-6).
  9. kernel_temporal -- the forward GEMM's shared memory, the library's
                     against the wrapper's copy (FORWARD_GEMM); the
                     temporal-block kernel against its plain version
                     through fused_temporal_block: T=9, D=832, 8 heads,
                     hidden 1664, N in {2048, 2045, 3}, two launches the
                     same bits; its training forward (keep): the output and
                     the kept scratch (stats, qkv, attn, x2, h, mlp) against
                     temporal_block_keep_reference, the same bits twice;
                     the depth-4 fused_temporal_stack against 4 plain
                     blocks; T=27 and T=81 at N in {256, 253}, keep too.
                     Same bar.
 10. serve_poseformer -- Carla2D3D test batches (B=256, L=16) ->
                     PoseFormer(clip_length=16) (seeded init, published
                     widths, both stage switches "auto") ->
                     PoseLiftingFlow(loc_2d_3d) -> make_inference_fn, 8
                     requests; 1 spatial and 4 temporal launches per request
                     and no fused-projection launch; outputs finite over the
                     eval slice and equal to the same model on its plain
                     route (both switches "plain"; 1e-3 px on x, y; 1e-4
                     elsewhere); eval_step's loc_2d_3d equal to rtol 1e-4;
                     no backward kernel launched.
 11. timing_poseformer -- CUDA-event medians of both kernels (L2 cold and
                     warm; row 8's training forward too), their plain
                     versions and their library yardsticks
                     (torch.nn.TransformerEncoderLayer stacks, first held to
                     the plain versions within the kernel bar); row 8 and
                     its yardstick in 10 alternating pairs; row 8's seven
                     launches split by a torch.profiler trace; the
                     host-clock and CUDA-event medians of a request and the
                     device time of its spatial and temporal kernels and
                     the rest (a profiled run); each kernel's bound at the
                     3xTF32 rate, and with all of it at the fp32 peak (row
                     4: also with its attention there, where it runs). Then
                     spatial_phase_split: row 4's phases (load, waiting,
                     staging, LN1, qkv, attention, proj, LN2, fc1, fc2,
                     final LayerNorm, store) from the clock64() stamps of
                     an instrumented copy of its source (built with the
                     libraries; the same output bits), as shares of its
                     time.
     f6_poseformer -- fault F6: PoseFormer(drop_rate=0.1) under "auto"
                     takes 2 training steps (B=256) on the plain blocks (no
                     kernel launched, losses finite), "fused" refuses such a
                     step, and an eval step launches both kernels and
                     agrees with the plain route's; a shape that the
                     temporal kernel refuses (1 head) and one that both
                     refuse (embeddings 6 in 3 heads) run eval steps under
                     "auto" (the spatial kernel in the first, no kernel in
                     the second) that agree with the plain route's, and
                     "fused" raises on them.
 12. kernel_spatial_bwd -- the spatial stack's backward kernels against
                     autograd of its plain version, seeded weights and
                     cotangents, N in {16384, 16381, 5} and the two F1
                     shapes of phase 8, from the residuals the training
                     forward keeps: dx and each weight gradient over
                     its largest magnitude within rtol 1e-4 / atol 1e-5;
                     two launches give the same bits.
 13. kernel_temporal_bwd -- the same checks for the temporal block's
                     backward (T=9, D=832, 8 heads, N in {8192, 8189, 3};
                     T=27 and 81 at N in {256, 253}) and for autograd
                     through the depth-4 fused_temporal_stack.
 14. train_poseformer -- Trainer.fit of PoseLiftingFlow(PoseFormer(
                     clip_length=16), loc_2d_3d), AdamW lr 1e-3, on Carla2D3D
                     (B=1024, L=16): 10 steps and 2 validation batches; per
                     step 1 spatial + 4 temporal forward and 1 spatial + 4
                     temporal backward launches, no projection kernel;
                     logged losses finite, the last 3 train losses below the
                     first; the last checkpoint restores exactly. Then the
                     fit's 10 training_steps again, of the kernel flow and
                     of the same model on its plain route,
                     from the same params on the same batches: losses equal
                     to rtol 1e-4 at every step.
 15. timing_poseformer_train -- CUDA-event medians of both backward kernels
                     (L2 cold and warm), autograd of their plain versions and
                     the backward of TransformerEncoderLayer yardsticks;
                     each kernel's bound (row 9's at the 3xTF32 rate its
                     products run at); each backward kernel and its
                     library yardstick in 10 alternating pairs (medians of
                     each and of their ratio); row 9's 13 launches split by
                     a torch.profiler trace; row 4's training forward
                     (keep) at B=1024 beside its bound (the residuals it
                     writes); the host-clock median of a B=1024
                     training_step and a CUDA-event split of it (forward,
                     spatial backward, temporal backward, the rest).
     profile_poseformer_train -- a torch.profiler trace of 3 such steps:
                     the device busy share of the traced window, the top
                     device operations, the share of rows 5, 8 and 9.
     poseformer_rf81 -- PoseFormer(clip_length=81, receptive_frames=81) on
                     Carla2D3D (B=64): 2 requests (1 spatial + 4 temporal
                     launches each, outputs finite, eval_step's loc_2d_3d
                     equal to the plain route's to rtol 1e-4) and 2
                     training steps (launch counts, losses equal to the
                     plain route's to rtol 1e-4).
 16. kernel_graph_gru, kernel_graph_lstm -- the graph-GRU and graph-LSTM
                     scan kernels against their plain versions on seeded
                     inputs: B in {256, 253, 5} at L=16, J=26, H=128, k=2;
                     k=1; k=3 with H=3; L=1; the dense form (J=1, H=64, no
                     graph matrices); wider shapes (GRU_WIDE_*,
                     LSTM_WIDE_*: the LSTM at the widest hidden the earlier
                     graph-form kernels trained and ran at each k, and at
                     J=1, H=128 and 256), every weight ring and tiling run;
                     the training forward (keep) too, its outputs and
                     residuals against the plain forward with residuals,
                     each line with its launch plan. The dense LSTM kernels (k=1,
                     csrc/fused_dense_lstm.cu) at DENSE_LSTM_SHAPES: the
                     dense form, B in {253, 5}, L=1, J=26, H=36; their
                     training forward (ys, cs, gates) against the plain one,
                     the same bits twice, the weight also read as a stacked
                     weight's transpose. Bar: max |kernel - plain| <= 1e-5.
 17. kernel_graph_gru_bwd, kernel_graph_lstm_bwd -- their backward kernels
                     against autograd of the plain versions with seeded
                     cotangents, from the residuals of their training
                     forward kernels (the LSTM with and without the cell
                     states' cotangent, and also against its plain backward
                     from the same residuals; at the wider shapes too); the
                     dense LSTM kernels from
                     their training forward's residuals at
                     DENSE_LSTM_SHAPES): each gradient over its largest
                     magnitude within rtol 1e-4 / atol 1e-5; two launches
                     give the same bits. The route's boundary through
                     graph_lstm_scan: H=64 launches the dense kernels, H=65
                     the graph-form ones, both against the plain version.
 18. train_classification -- Trainer.fit of ClassificationFlow(GConvGRU())
                     (H=128, k=2, dropout 0.2, graph_kernel="auto"), AdamW lr
                     1e-3, Carla2D3D B=256, L=16: 20 steps and 2 validation
                     batches; 2 forward scan entries per step and validation
                     batch, 2 backward entries per step; logged losses
                     finite, validation metrics present, the last checkpoint
                     restores exactly. 20 steps on one repeated batch
                     (dropout off, lr 1e-4) lower the loss. With dropout off, "fused" and "plain" flows
                     step by step from the same params: losses to rtol 1e-4.
                     Short fits of GConvLSTM (the graph-form LSTM kernels)
                     and LSTM(rnn_kernel="fused") (the dense kernels) count
                     their launches.
 19. serve_classification -- 8 eval_steps at B=256: 2 forward entries each,
                     no backward launch, logits equal to the plain model's
                     within 1e-5.
     f6_graph     -- fault F6: GConvGRU at hidden 384 and GConvLSTM at
                     hidden 320 (k=2, J=26: widths whose forward the scan
                     kernels' launch plans take but whose reverse scan they
                     refuse, checked from the plans) train a step under
                     "auto" with no scan kernel launched, serve an eval step
                     on the forward kernel (logits equal to the plain
                     route's within 1e-5), and "fused" raises before any
                     launch.
 20. timing_classification -- CUDA-event medians (L2 cold and warm) of the
                     four scan kernels at the main path's shape (and the
                     graph-form LSTM pair at the dense form), their training
                     forwards (keep), rows 10 to 13 beside their earlier
                     design's times, their plain versions, each kernel's
                     bound from ops/flops.py (at the 3xTF32 rate and the
                     fp32 peak); the graph-form LSTM kernels at k=1 past
                     the dense width (J=1, H=128) and the dense LSTM
                     kernels at the dense form
                     (forward, training forward, backward) with
                     torch.nn.LSTM (cuDNN) as their library yardstick, first
                     held to the plain version, alone and in 10 alternating
                     pairs; the identity input products that yardstick
                     runs beyond the kernels, alone; one LSTM layer at the
                     classifier's input widths (hidden 64: 52 and 64; hidden
                     128: 52 and 128), the port's layer against cuDNN's in
                     10 alternating pairs; host-clock medians of a
                     training_step and an eval_step, of the LSTM
                     classifier's (hidden 64, 2 layers) on the dense kernels
                     and on the plain loop, and of GConvLSTM's (hidden 128,
                     k=2) on the graph-form kernels and on the plain loop;
                     a CUDA-event
                     split of the step (input convolutions, scans forward,
                     scans backward, AdamW, the rest).
     profile_classification_train -- a torch.profiler trace of 3 such
                     steps: device busy share, top device operations, the
                     shares of rows 10 and 11, row 11 split into its reverse
                     scan and its weight-gradient products.
 21. serve_autoencoder -- BASELINE config 2 (bench.py:685-696):
                     Seq2SeqEmbeddings (hidden 64, 2 layers, dropout 0.2,
                     embeddings 64, no_force; seeded init), pose_2d outputs,
                     AutoencoderFlow(loc_2d), Carla2D3D test batches (B=256,
                     L=16) -> make_inference_fn, 8 requests with
                     rnn_kernel="fused": 2 dense LSTM forward launches a
                     request (the encoder's layers), none else; outputs
                     finite and equal to the rnn_kernel="plain" model's on
                     the same weights within 1e-5 of max |plain|; eval_step's
                     loc_2d and metrics equal to rtol 1e-4.
 22. train_autoencoder -- Trainer.fit of config 2 (AdamW lr 1e-3), 10 steps
                     and 2 validation batches, fused and plain from the same
                     weights and generator seed (the dropout masks the
                     same), the fused fit twice: 2 dense forward (keep) and
                     2 dense backward launches a step (the top layer's
                     backward fed the decoder's cotangents of its final c
                     and h alone), 2 forward launches a validation batch,
                     none on the plain route; losses equal to rtol 1e-4,
                     the fused fit's the same bits twice; val MSE, PCKhn@01,
                     PCK@005 and the baseline's MJR equal within 1e-5; the
                     last checkpoint restores params and AdamW state
                     exactly; one training_step's gradients through the
                     kernels against the plain route's (rtol 1e-4 / atol
                     1e-5 of each leaf's largest).
 23. timing_autoencoder -- host-clock and CUDA-event medians of config 2's
                     training_step and request, fused and plain; a
                     CUDA-event split of each step (the encoder: its
                     input products and scans; the scans alone; the decoder
                     loop; the rest of the forward; the scans' backward;
                     the rest of the backward; AdamW) and request; the dense
                     LSTM kernels at this shape (training forward and
                     backward with the cell states' cotangent) beside their
                     bounds from ops/flops.py.
 24. train_options -- LinearAE (config 1, B=1024, L=16), loc_2d_loc_rot_3d,
                     gradient_clip_val 1.0, the movements optimizer on
                     StepLR (step_size 1, gamma 0.5) over 2-step epochs:
                     Trainer.fit of 2 epochs with projection_kernel
                     "fused_train" and "plain" from the same weights; the
                     losses, the lrs current_lrs reports (they move at the
                     epoch's edge) and the validation pose metrics (MPJPE,
                     MRPE, FB_*) equal to rtol 1e-4; rows 2 and 3 launched
                     (4 + 2 forward, 4 backward), none on the plain route.
     cli_options  -- the CLI (modeling.main) on the card, 2 steps and a
                     validation batch each at B=64, L=16, clipped, the
                     three LR schedules in turn: config 2 on both encoder
                     routes, LinearAE with each new loss mode on both
                     projection routes; finite losses and metrics.
Then group_lifters (no kernel on its path; every count stays 0):
 25. serve_videopose3d -- BASELINE config 4 (bench.py:673-682):
                     VideoPose3D (filter widths (3, 3, 3, 3), 1024
                     channels, dropout 0.25; seeded init, running
                     statistics drawn away from 0 / 1), PoseLiftingFlow
                     (loc_2d), Carla2D3D test batches (B=64, L=81) ->
                     make_inference_fn, 8 requests under torch's default
                     TF32 flags (cuDNN TF32 on, matmul TF32 off; this
                     run's flags restored after): each request's
                     locations and projections within 1e-4 of max |ref|
                     of the same model and weights in float64 on the CPU.
 26. train_videopose3d -- Trainer.fit of config 4 (AdamW lr 1e-3), 10 steps
                     and 2 validation batches: finite losses, every running
                     statistic moved and without grad, the eval output
                     unlike the train-mode output on the same batch, the
                     last checkpoint restoring params and running
                     statistics exactly and the same eval bits after it.
 27. timing_videopose3d -- host-clock and CUDA-event medians of config 4's
                     training_step and a request; a torch.profiler trace of
                     3 steps (device busy share, top five device
                     operations); the step's and the forward's FLOPs
                     (ops/flops.py::video_pose_3d_flops) and bounds (at the
                     CUDA cores' 67 TFLOP/s, or the bytes if larger), and
                     each time over its bound.
 28. lifters_coverage -- a 3-step fit (and a validation batch) of each
                     other new movements model at its published widths,
                     B=256, L=16: Baseline3DPose, Baseline3DPoseRot,
                     LinearAEResidual, LinearAEResidualLeaky on
                     PoseLiftingFlow (loc_2d_3d), LinearAE2D,
                     SimpleTransformer, SpatialGnn, GNNLinearAutoencoder,
                     VariationalGcn on AutoencoderFlow (loc_2d): finite
                     losses, one eval_step twice the same bits.
Then group_openpose (BASELINE config 3 on real-format labels): OpenPose
BODY_25 clips made in numpy from the reference projections (mapped CARLA ->
BODY_25 with map_pose, a walking motion, seeded noise, undetected joints;
labelled by whether the legs swing), held in the port's Hdf5DataModule
through add_subset (the card's machine has no h5py, pandas, PyYAML or
matplotlib) on the card, remapped to the CARLA skeleton:
 29. preprocess_card -- process_batch on the card against the CPU for a
                     deterministic configuration (hips_neck, BODY_25 ->
                     CARLA, the confidence channel; atol 1e-5 beside rtol
                     1e-6 for pixels, masks exact); with flip, rotation,
                     noise and a dropped joint: the dropped joint zero with
                     confidence 0, the clean targets without the noise,
                     invert of the augmentation gets the pose back, the
                     same bits twice; its time (CUDA events, host clock)
                     and launches (torch.profiler) at B=256, L=16.
 30. train_openpose -- Trainer.fit of GConvGRU (hidden 128, k=2, 2 layers,
                     dropout 0.2), flip and rotation on, 4 epochs of 16
                     steps and 2 validation batches at B=256, L=16: rows 10
                     and 11 counted (2 + 2 a step, 2 a validation batch),
                     the fit-start baseline in hparams.json, finite losses,
                     the last validation loss below ln 2 / 2 and below the
                     first, an exact restore; then 3 training_steps of the
                     fused and plain routes from the same weights on the
                     same batches: losses to rtol 1e-4.
 31. serve_openpose -- 8 eval_steps, twice: 2 forward launches each, the
                     same bits.
 32. gcn_coverage -- GCNBestPaper and GCNBestPaperTransformer: 3-step fits
                     and a validation batch, an eval_step twice the same
                     bits; no kernel launched.
 33. timing_openpose -- host-clock and CUDA-event medians of the step with
                     its batch (slice, copies, process_batch), the
                     training_step alone, the batch alone and an eval_step;
                     process_batch's share of the step.
Then group_serving (serving export, serving.py): each artifact exported
on the card (export_inference, torch.export), loaded back (load_inference)
and served at full width, with the seconds of its export:
 34. serve_artifacts -- LinearAE on "fused" (B=1024, L=16), on "fused"
                     with output_keys ("projection_2d",) and on
                     "fused_train", PoseFormer config 5 ("auto", B=256),
                     GConvGRU config 3, GConvLSTM and config 2's
                     Seq2SeqEmbeddings on "fused" (B=256): 2 requests
                     through each artifact, its kernels' counts (rows 1 /
                     2 once, row 4 once and row 8 four times, rows 10 and
                     12 twice a request; no other kernel) and its pv2c ops
                     and node count in the program, outputs within 1e-6 of
                     max |out| of make_inference_fn's on the same weights;
                     the host-clock request through the artifact against
                     the closure in 10 alternating pairs, with Python's
                     garbage collections in them counted and timed, then
                     10 more with the process's objects frozen out of the
                     collector (a full collection of them takes a few
                     hundred ms).
 35. serve_artifact_cpu -- a LinearAE "fused" artifact exported on the card
                     at B=8, loaded with device="cpu" (the ops' plain
                     versions): its outputs against the card's (1e-3 px,
                     1e-5 elsewhere), no kernel launched.
 36. cli_serving -- modeling.main on the card in a temporary directory:
                     a 2-step train, then --mode=predict and --mode=export
                     from its checkpoint, for config 1 (LinearAE, "fused")
                     and GConvGRU: finite predictions, an artifact that
                     loads and serves what the closure does.
Between group_poseformer and group_classification, group_bf16 (bf16 mixed
precision: rows 4, 5, 8 and 9 in bf16, BASELINE config 5 with
precision="bf16"):
 37. kernel_bf16 -- the bf16 kernels against their bf16 plain versions
                     (which round where the kernels round) on the card:
                     row 4 at B=256 and 1024 (L=16), row 8 at B=256 and
                     1024 (rf 9) and at rf 81 (B=64), their training
                     forwards' kept scratch, rows 5 and 9 at B=1024 from
                     those residuals (dx and every weight gradient): each
                     within 2e-2 of max |plain| (of its own largest for a
                     gradient), the same bits twice; the bf16 forwards
                     within 5e-2 of max |fp32| of the fp32 kernels on the
                     same values; the bf16 GEMM's shared memory against
                     the wrapper's copy.
 38. serve_poseformer_bf16 -- config 5 in bf16 (seed 22742), 8 requests at
                     B=256 through make_inference_fn: 1 bf16 row-4 and 4
                     bf16 row-8 launches a request and no other, float32
                     outputs within 5e-2 of max |fp32| of the fp32 flow on
                     the same weights; request time beside fp32's, host
                     clock, 20 alternating pairs.
 39. serve_artifact_poseformer_bf16 -- the bf16 flow exported on the card
                     (the casts inside the program, float32 in and out): 2
                     requests with the same launches, the closure's bits;
                     the request against the closure in pairs.
 40. train_poseformer_bf16 -- Trainer.fit of the bf16 flow, 10 steps and 2
                     validation batches at B=1024, L=16: per step 1 + 4
                     bf16 forward and 1 + 4 bf16 backward launches, finite
                     losses that fall, float32 params and AdamW state; the
                     step beside fp32's in 10 alternating pairs, and both
                     steps' CUDA-event splits.
 41. timing_bf16 -- rows 4 and 8 at B=256, 5 and 9 at B=1024 in bf16:
                     kernel (cold L2), bf16 plain version, bf16
                     TransformerEncoderLayer yardstick and the kernel
                     against it in 10 alternating pairs, row 9's launch
                     split; bounds at bf16's dense 989 TFLOP/s against each
                     tensor's bytes at its element size (row 5 also at the
                     fp32 peak of the CUDA cores it runs on).
 42. coverage_bf16 -- 3 bf16 steps of config 4 (VideoPose3D, B=64, L=81;
                     running statistics float32 and moved) and config 2 on
                     rnn_kernel="auto" (the loop): finite losses, no
                     kernel launched; rows 10-13 each refusing a bf16 CUDA
                     tensor with a TypeError naming ROADMAP M5b step 4.
Then group_recorded (the recorded data and the resident epoch):
 43. resident_batches -- BASELINE config 1's data (LinearAE, B=1024, L=16)
                     as CarlaRecorded-format subsets made in memory
                     (recorded_subset: Carla2D3D's random poses through the
                     port's FK and projection; 32,768 train and 2,000
                     validation clips, 64 KB a clip), fed through
                     add_subset: 4 train batches and both validation
                     batches (the second padded by wrap-around) of the
                     resident per-batch gather equal to the streamed ones
                     bit for bit; the hoisted deterministic path within
                     1e-6 (+ 1e-7 relative).
 44. epoch_config1 -- one epoch (32 steps, 2 validation batches) of config
                     1 on fused_train by five routes from one initial state:
                     (a) streamed, (b) through the prefetcher (host
                     batches copied and preprocessed on its side stream),
                     (c) through the native gather, (d) resident eager,
                     (e) resident as CUDA graphs; (e) equal to (d) and
                     (a)-(c) to one another bit for bit (final params,
                     every step's logs, dropout 0.5 on); (d) equal bit for
                     bit to (a) with the capturable AdamW, one capturable
                     AdamW step within CAPTURABLE_BAR (1e-6 of each
                     parameter's largest magnitude) of the host step, and
                     (d) over the epoch within EPOCH_PARAM_BAR (2.8e-5) and
                     EPOCH_LOSS_BAR (1.75e-5) of (a); each route's
                     launches; then a
                     2-epoch fit of each route logging once an epoch: the
                     second epoch's ms a step, clips/s and seconds (host
                     clock to the epoch's last logs read); torch.profiler
                     traces of 4 steps of (a) and (e): busy share, rows 2-3
                     kernels by name against replays x captured.
 45. epoch_config3 -- GConvGRU (B=256, L=16) on config 3's OpenPose subsets
                     with flip and rotation, resident: 16 steps eager
                     against graphed, bit for bit (params and logs, flip,
                     rotation and dropout drawing); ms a step streamed,
                     resident eager and resident graphed; rows 10-11's
                     graphed launches against the profiler's kernel names.
 46. m7_cli_logs_profile -- BASELINE config 1 (LinearAE, fused_train,
                     B=1024, L=16) through modeling.main: 2 epochs of 4
                     steps with --lr, --logs_dir, --check_val_every_n_epoch
                     2, --skip_initial_metrics, --logger wandb and -v,
                     in 3 alternating pairs without and with --profile.
                     The AdamW groups at --lr; no fit-start pass and no
                     epoch-1 validation (hparams.json, metrics.jsonl, 9
                     and 8 launches of rows 2 and 3 a fit); the W&B
                     files parse (config.yaml as JSON: no PyYAML here);
                     the trace's kernels of rows 2 and 3 by name equal
                     the counted launches. Then the profiled fit with
                     --device_resident on CarlaRecorded-format subsets in
                     memory: what its trace shows of the graph replays
                     (kernels by name, graph launches) beside the counts,
                     printed and not checked. ms a step of each fit
                     (the median gap between an epoch's step records). The
                     video renderers need cv2, which the card's machine
                     lacks: a line says they are tested on the CPU only.
 47. train_pose_estimation -- group_pose_estimation: UniPoseLSTM at the
                     JAX defaults (ResNet-101, output stride 16, heatmaps
                     at stride 8, sigma 3, 64 ConvLSTM features; 256 x 256
                     frames, 27 maps of 32 x 32), seeded weights drawn on
                     the card: Trainer.fit of 10 steps (B=2, L=16) with
                     the heatmaps loss on clips made on the card
                     (CardClips: frames, keypoints, their heatmaps by the
                     port's gaussian_heatmaps); finite losses, every
                     parameter with a gradient and every running
                     statistic moved; the step's ms; a validation
                     batch's loss.
 48. serve_pose_estimation -- 8 requests of B=4 x L=16 frames through
                     make_inference_fn: keypoints finite and in the frame;
                     host-clock ms each and their median, the median
                     under cuDNN TF32, and a CUDA-event split of one
                     request (backbone; WASP, decoder and resizes; the
                     ConvLSTM loop; head and argmax); the convolutions'
                     FLOPs (unipose_conv_flops) and their rate.
 49. pe_card_vs_cpu -- one B=1 x L=2 batch through UniPoseLSTM on the
                     card and on the CPU, at the seeded init and at the
                     fit's weights: each output's deviation over max |CPU
                     float64| (the card with cuDNN's TF32 off, cuDNN off,
                     torch's default flags; the CPU in float32). Held: at
                     the init the card's float32 within 1e-4 of the CPU's
                     float32; the fit's (ill-conditioned: maps of 1e5,
                     every float32 1e-4 to 1e-3 from float64) printed.
 50. pe_coverage  -- 3-step fits of P0, AvPedestrianPoseTransformer and
                     Linear (B=2, L=8, loc_2d), an eval_step twice the
                     same bits. The group's line: no pv2c kernel launched
                     (no TPU kernel lies on this path) and its peak
                     memory.
 51-54. group_smpl_mixed -- the SMPL body model and AMASS's subsets on the
                     card against the CPU, config 2 on CarlaRecAMASS (rows
                     12-13) and GConvGRU on JAADCarlaRec (rows 10-11).
 55. carla_control_request -- group_carla_control: BASELINE config 1's
                     request (LinearAE, B=1024, L=16, "fused": one row-1
                     launch); its relative_pose_rot as CARLA rotations by
                     the batched conversion on the card against the CPU
                     (the gap in degrees printed; the round trip to
                     matrices within CARLA_RT_BAR); the batched conversion
                     and copy against one a frame, host clock.
 56. carla_fake_world -- CarlaRenderer.render_clip of 4 of those clips on
                     a fake world (FakeWorld: it records set_bones,
                     set_transform and tick, its camera gives seeded
                     frames) from the card's tensors and from their CPU
                     copies: the same bones, teleports and frames; each
                     frame's bones the clip's rotations; the CARLA route's
                     points (PoseProjection on the card) against the
                     kernel's projection_2d within CARLA_PX_BAR.
 57. sensitivity  -- missing_joints_sensitivity.main with --joints
                     crl_hand__L: two CLI fits of config 3's GConvGRU
                     (B=256, L=16, H=128, k=2, 3 steps): rows 10-11's
                     launches, finite metrics, the joint missing.
 58. sweep_compare -- a 2-trial sweep of configs/sweep/carla2d3d_linear_ae
                     .yaml (cut: 1 epoch, sets of 256 clips, 4 steps) in
                     process, the trials' parameters the sampler's on the
                     CPU, finite objectives; the first variant of
                     configs/compare/carla2d3d_models.yaml (cut the same
                     way) through compare.work, a CLI subprocess started
                     before phase 55 and run beside phases 55-58, whose
                     output holds its metrics.
 59. parallel_nccl_world1 -- group_parallel: config 1's resident epoch (8
                     steps of B=1024, L=16 on CarlaRecorded-format
                     subsets), graphed, in a process group of one over
                     NCCL (parallel/: the gradient all-reduce captured in
                     the graphs) against the same epoch with no group: the
                     same bits; the gradient all-reduce called eagerly in
                     the 2 warm-up steps, then once under the capture;
                     rows 2-3 launched from the replays; two profiled
                     replays; the all-reduce's time.
 60. parallel_gloo_two_ranks -- two processes on the one card over gloo
                     (parallel.launch on cards [0, 0]), each on its half
                     of LinearAE's fused_train batch (B=1024) and of
                     GConvGRU's (B=256, fused): rank 0's loss, gradients
                     and parameters after a step against one process's on
                     the whole batch (PAR_*: rel 1e-5, 1e-4, 1e-5), the
                     ranks' parameters equal, each rank's launches one
                     process's; the steps' and the gradient all-reduce's
                     times.
Then the card line, the kernels line (config 2's, the train-options
phase's, group_openpose's, group_serving's, group_recorded's and phase
46's, the mixed modules', group_carla_control's and group_parallel's
launches beside the
dense LSTM, projection-training, graph-GRU and the other forward
entries; the
four bf16 rows as entries of their own, row4_bf16 ... row9_bf16, their
launches those of the bf16 path of phases 38-40), and the contract line
last. Any failure raises and ends the run with a
non-zero exit.
"""
import ctypes
import functools
import glob
import json
import os
import re
import shutil
import statistics
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 22742
BATCH, CLIP = 1024, 16
REQUESTS = 8
TIMING_RUNS = 30
XY_TOL_PX, DEPTH_TOL = 1e-3, 1e-4
LOSS_RTOL = 1e-4
ABS_TOL = 1e-5                          # abs_loc, metres
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5       # gradients over their largest value
TRAIN_STEPS, VAL_BATCHES, PARITY_STEPS = 20, 2, 3
PF_TIMING_RUNS = 10
LR = 1e-3
#: PoseFormer serving: the JAX bench's serving shape (bench.py:753), the
#: published widths, and the bar of both transformer kernels against their
#: plain versions (sums over K <= 1664 in another order than cuBLAS's; the
#: card shows under 1e-6)
PF_BATCH = 256
PF_JOINTS, PF_EMB, PF_HEADS, PF_DEPTH, PF_RF = 26, 32, 8, 4, 9
PF_DIM = PF_JOINTS * PF_EMB
KERNEL_BAR = 1e-5
#: kernel-check sizes: the main path's N (B*L frames, B*W windows) and
#: ragged ones
SPATIAL_NS, TEMPORAL_NS = (4096, 4093, 5), (2048, 2045, 3)
#: PoseFormer training: the JAX bench's train shape (bench.py:645-662,
#: B=1024, L=16), its steps, and the backward kernels' check sizes (the
#: train step's N and ragged ones)
PF_TRAIN_STEPS = 10
SPATIAL_BWD_NS, TEMPORAL_BWD_NS = (16384, 16381, 5), (8192, 8189, 3)
#: F1 coverage: the temporal kernels at PoseFormer's published receptive
#: fields 27 and 81 (D=832, 8 heads) at a main-path and a ragged number of
#: windows; the spatial kernels at E=32 with one head (head width 32) and at
#: E=64 with hidden 128, main-path and ragged frames; a short PoseFormer path
#: at rf 81 (Carla2D3D, B=64, clips of 81 frames: one window a clip)
WIDE_TS, WIDE_NS = (27, 81), (256, 253)
SPATIAL_WIDE = ((32, 1), (64, 8), (20, 5))  # (E, heads), hidden 2E
SPATIAL_WIDE_NS = (1024, 1021)
#: shapes at the edge of row 4's shared memory (J, E, heads, hidden): one
#: frame a thread block in the layout without the padding (X and Y rows at
#: stride E), at a ragged number of frames
SPATIAL_EDGE, SPATIAL_EDGE_N = ((32, 12, 3, 864), (32, 12, 1, 860)), 67
#: row 4's phase split: a copy of a forward source with a clock64() stamp by
#: lane 0 of each warp at the forward kernel's start, after every barrier of
#: block_fwd and of the kernel, and at its end (instrument_spatial_forward);
#: the phases that a depth block's stamps end, by the forward's design
#: ("warp": a warp a frame, warp barriers; "block": the earlier CUDA-core
#: design, thread-block barriers only) and by keep, between "load" and
#: "final_ln", "store"
SPLIT_SLOTS = 64
SPLIT_PHASES = {
    "warp": dict.fromkeys((False, True), (
        "wait", "stage", "ln1", "qkv", "attention", "proj", "ln2", "fc1",
        "fc2")),
    "block": {False: ("stage", "ln1", "qkv", "attention", "proj", "ln2",
                      "fc1_gelu", "fc2"),
              True: ("stage", "ln1", "qkv", "attention", "proj", "ln2",
                     "fc1", "gelu_h", "fc2", "xs")}}
_SPLIT_SECTION = (
    "__device__ void block_fwd(",
    "// ---------------------------------------------------------------------------\n// Backward")
_SPLIT_TOP = "  extern __shared__ __align__(16) float smem[];\n"
_SPLIT_HELPERS = """
__device__ long long* g_split_clk = nullptr;
__shared__ int g_split_i[32];
__device__ __forceinline__ void split_stamp() {
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0 && g_split_clk != nullptr)
    g_split_clk[(blockIdx.x * 32 + w) * %d + g_split_i[w]++] = clock64();
}
""" % SPLIT_SLOTS
_SPLIT_SET = """
extern "C" int pv2c_split_set(long long* clk) {
  return static_cast<int>(cudaMemcpyToSymbol(g_split_clk, &clk, sizeof(clk)));
}
"""
RF81_BATCH, RF81_CLIP, RF81_RF, RF81_STEPS, RF81_REQUESTS = 64, 81, 81, 2, 2
#: the projection forwards' (rows 1 and 2) check shapes: the main path's,
#: ragged batches, one frame a clip and clips longer than one of the
#: kernels' chunks; and the clip lengths they are timed at, B=1024
FWD_SHAPES = ((BATCH, CLIP), (1000, CLIP), (5, CLIP), (BATCH, 1),
              (BATCH, 81), (3, 81))
FWD_TIMED_CLIPS = (1, CLIP, 81)
#: and a batch of views that start off a 16-byte boundary (the kernels
#: stage with 16-byte copies; their wrappers copy such views)
VIEW_SHAPE = (4, 1)
#: rows 1 and 2's phase split: the cycles that thread 0 of each thread
#: block of an instrumented copy of the serving source (PV2C_FK_SPLIT) adds
#: up by phase (csrc/fk_forward.cuh)
FK_SPLIT_PHASES = ("stage", "carry", "fk", "copy_out")
#: fault F6 on the card: PoseFormer training steps with dropout under
#: "auto", and shapes a stage's kernel refuses (name, model arguments, the
#: launches of one evaluation step): one head (the temporal head width 832
#: is past 128) and embeddings of 6 in 3 heads (widths that are not
#: multiples of 4 and 8); graph classifiers at widths the scan kernels
#: run forward but do not train at J=26 (name, hidden, k, the plan
#: function, the forward entry's counter)
F6_PF_STEPS = 2
F6_PF_SHAPES = (
    ("heads1", dict(num_heads=1), dict(fused_spatial_stack=1)),
    ("emb6", dict(single_joint_embeddings_size=6, num_heads=3), {}))
F6_GRAPH_SHAPES = (("GConvGRU", 384, 2, "graph_gru_plan", "graph_gru_scan"),
                   ("GConvLSTM", 320, 2, "graph_lstm_plan",
                    "graph_lstm_scan"))
#: kernel-vs-library timing pairs (rows 5 and 9), and the steps of the
#: profiler trace of PoseFormer's training_step
TIMING_PAIRS, PROFILE_STEPS = 10, 3
SPATIAL_NAMES = ("x", "ln1_s", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
                 "ln2_s", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b",
                 "lnf_s", "lnf_b")
#: crossing classification: the JAX bench's shape (bench.py:699-750: B=256,
#: L=16), GConvGRU's widths, and the (B, L, J, H, k) of the scan kernels'
#: checks: the main path's and ragged ones, k=1, k=3 with H=3, one frame,
#: and the dense LSTM form (J=1, H=64)
CLS_BATCH, CLS_J, CLS_H, CLS_K = 256, 26, 128, 2
CLS_TRAIN_STEPS, CLS_SHORT_STEPS, CLS_PARITY_STEPS = 20, 3, 5
REPEAT_LR = 1e-4
CLS_MAIN = (CLS_BATCH, CLIP, CLS_J, CLS_H, CLS_K)
CLS_DENSE = (CLS_BATCH, CLIP, 1, 64, 1)
GRAPH_SHAPES = (CLS_MAIN, (253, CLIP, CLS_J, CLS_H, CLS_K),
                (5, CLIP, CLS_J, CLS_H, CLS_K), (CLS_BATCH, CLIP, CLS_J, CLS_H, 1),
                (CLS_BATCH, CLIP, CLS_J, 3, 3), (CLS_BATCH, 1, CLS_J, CLS_H, CLS_K),
                CLS_DENSE)
#: the GRU kernels past the main path's widths: hidden 256 at k=2 and 128
#: at k=3 (one clip a thread block), hidden 320 (the reverse scan on the
#: 128-column weight ring); hidden 448 for the forward alone (its
#: 128-column ring; the reverse scan does not fit there)
GRU_WIDE_SHAPES = ((CLS_BATCH, CLIP, CLS_J, 256, 2),
                   (CLS_BATCH, CLIP, CLS_J, 128, 3), (64, CLIP, CLS_J, 320, 2))
GRU_WIDE_FORWARD_SHAPES = ((32, CLIP, CLS_J, 448, 2),)
GRU_RINGS = {128, 256}
#: the graph-form LSTM kernels past the main path's widths: the widest
#: hidden that the earlier graph-form kernels trained at J=26 for k = 1, 2,
#: 3 (308, 266, 233: the reverse scan on its 64-column ring), and, forward
#: alone, the widest they ran (718, 532, 420: the narrow tiling); J=1 at
#: hidden 128 and 256 (the few-rows tiling, k = 1 past the dense kernels).
#: Every tiling of each kernel must run: (ring width, rows of a block tile)
LSTM_WIDE_SHAPES = ((64, CLIP, CLS_J, 308, 1), (64, CLIP, CLS_J, 266, 2),
                    (64, CLIP, CLS_J, 233, 3), (CLS_BATCH, CLIP, 1, 128, 1),
                    (CLS_BATCH, CLIP, 1, 256, 1))
LSTM_WIDE_FORWARD_SHAPES = ((16, CLIP, CLS_J, 718, 1),
                            (16, CLIP, CLS_J, 532, 2),
                            (16, CLIP, CLS_J, 420, 3))
LSTM_TILINGS = {"fwd": {(256, 64), (128, 64), (512, 16)},
                "bwd": {(128, 64), (64, 64), (128, 16)}}
#: k = 1 past the dense kernels' width (J=1, hidden 128: the LSTM
#: classifier or a Seq2Seq layer at --hidden_size 128), where torch.nn.LSTM
#: (cuDNN) computes the same recurrence, and the input widths of the layer
#: comparison there
CLS_WIDE = (CLS_BATCH, CLIP, 1, 128, 1)
WIDE_LAYER_INPUTS = (2 * CLS_J, CLS_WIDE[3])
SCAN_BAR = 1e-5
#: the dense LSTM kernels (k = 1, csrc/fused_dense_lstm.cu) at the dense
#: form, ragged B, one frame, k = 1 at GConvLSTM's J = 26 and a width that
#: pads to 8 units; H = 64 is the widest the dense route takes and H = 65
#: the next (the graph-form kernels run it, through the same entry)
DENSE_LSTM_SHAPES = (CLS_DENSE, (253, CLIP, 1, 64, 1), (5, CLIP, 1, 64, 1),
                     (CLS_BATCH, 1, 1, 64, 1), (CLS_BATCH, CLIP, CLS_J, 64, 1),
                     (CLS_BATCH, CLIP, 1, 36, 1))
DENSE_LSTM_MAX_H = 64
DENSE_LSTM_PAST = (CLS_BATCH, CLIP, 1, DENSE_LSTM_MAX_H + 1, 1)
#: the LSTM classifier's layer input widths (26 joints x 2 coordinates,
#: then the hidden width), at which one layer on the dense kernels meets
#: torch.nn.LSTM; the two layers' outputs agree within LAYER_BAR (two fp32
#: input products summed in different orders)
DENSE_LAYER_INPUTS = (2 * CLS_J, CLS_DENSE[3])
LAYER_BAR = 1e-4
#: BASELINE config 2 (bench.py:685-696): Seq2SeqEmbeddings at its published
#: widths, pose_2d outputs, loc_2d, B=256, L=16; its fit's steps and
#: validation batches; the bar of the fused route's outputs and metrics
#: against the plain route's (of max |plain|)
AE_BATCH, AE_TRAIN_STEPS, AE_VAL_BATCHES, AE_LAYERS = 256, 10, 2, 2
AE_BAR = 1e-5
#: the training-options phase: config 1 over 2-step epochs, 2 epochs
OPT_EPOCH_STEPS, OPT_EPOCHS = 2, 2
#: BASELINE config 4 (bench.py:673-682): VideoPose3D at its published
#: widths, loc_2d, B=64 clips of 81 frames; the serving bar against the same
#: model in float64 on the CPU, of max |float64|
VP_BATCH, VP_CLIP, VP_TRAIN_STEPS, VP_VAL_BATCHES = 64, 81, 10, 2
VP_BAR = 1e-4
#: the other new movements models' coverage fits: B=256, L=16, 3 steps
LIFTERS_BATCH, LIFTERS_STEPS = 256, 3
LIFTERS_AUTOENCODERS = ("LinearAE2D", "SimpleTransformer", "SpatialGnn",
                        "GNNLinearAutoencoder", "VariationalGcn")
LIFTERS_POSE = ("Baseline3DPose", "Baseline3DPoseRot", "LinearAEResidual",
                "LinearAEResidualLeaky")
#: BASELINE config 3 on real-format labels (group_openpose): OpenPose
#: BODY_25 clips made from the reference projections (B=256, L=16) with a
#: walking motion, seeded noise (px) and undetected joints (their share),
#: labelled by whether the legs swing: the ankles' x distance over the
#: clip, its standard deviation over the hips-neck length, above
#: OP_SWING_THRESHOLD. A clip's swing amplitude over that length is drawn
#: in OP_SWING_LOW or OP_SWING_HIGH, which the threshold parts with a
#: margin. The subsets' sizes in batches, the fit's epochs, the parity
#: steps and the bars: the card against the CPU (atol 1e-5 beside rtol
#: 1e-6 for pixel values), the last validation loss below ln 2 / 2
OP_SWING_LOW, OP_SWING_HIGH, OP_SWING_THRESHOLD = (0.0, 0.15), (0.5, 1.0), 0.4
OP_NOISE_PX, OP_UNDETECTED = 1.5, 0.05
OP_TRAIN_BATCHES, OP_VAL_BATCHES, OP_TEST_BATCHES = 16, 2, REQUESTS
OP_EPOCHS, OP_PARITY_STEPS, OP_GCN_STEPS = 4, 3, 3
OP_ATOL, OP_RTOL = 1e-5, 1e-6
OP_LOSS_BAR = float(np.log(2.0) / 2)
#: H100 memory rates (NVIDIA data sheets), bytes/s, and the float32 (non
#: tensor-core) peak of the SXM part, FLOP/s
HBM_RATE = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}
FP32_PEAK = 67e12
#: the rate the transformer kernels' dense products run at: 3xTF32 in the
#: tensor cores (495 TFLOP/s dense TF32, NVIDIA's data sheet; three TF32
#: products for each fp32 one)
TF32X3_PEAK = 495e12 / 3


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; phase lines carry the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "t": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    name = torch.cuda.get_device_name(0)
    rate_key = next((k for k in ("PCIe", "NVL") if k in name), "SXM")
    emit({"phase": "device", "name": name, "card": card,
          "count": torch.cuda.device_count(),
          "hbm_bytes_per_s": HBM_RATE[rate_key], "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return card, HBM_RATE[rate_key]


def phase_build():
    from pedestrians_video_2_carla_torch.ops import cuda_build
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG
    from pedestrians_video_2_carla_torch.ops import fused_projection as FP
    from pedestrians_video_2_carla_torch.ops import \
        fused_spatial_transformer as FS
    from pedestrians_video_2_carla_torch.ops import \
        fused_temporal_transformer as FT

    t0 = time.perf_counter()
    sources = (FP._SOURCE, FP._TRAIN_SOURCE, FS._SOURCE, FT._SOURCE,
               FG._SOURCE, FG._DENSE_SOURCE,
               spatial_split_source(FS._SOURCE)[0],  # row 4's phase split
               fk_split_source(FP._SOURCE))          # row 1's

    def build(source):
        t = time.perf_counter()
        path = cuda_build.build_library(source)
        return path, time.perf_counter() - t
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        built = list(pool.map(build, sources))
    libraries, seconds = {}, {}
    for path, secs in built:
        seconds[path.name] = secs
        log = path.with_suffix(".log")
        log = log.read_text() if log.exists() else ""
        libraries[path.name] = [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln
                                or "Compiling entry" in ln]
    temporal = next(p for p, _ in built if p.name.startswith(
        FT._SOURCE.stem + "-"))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "seconds_each": seconds, "ptxas": libraries,
          "temporal_forward_tensor_cores": forward_gemm_sass(temporal)})


def forward_gemm_sass(library):
    """That the temporal forward's products run on the tensor cores: its
    library holds the forward GEMM's entries and no CUDA-core GEMM
    (ptxas's entry list), and, where the toolkit has cuobjdump, each
    forward GEMM entry's count of tensor-core instructions (HMMA) in the
    built SASS."""
    log = library.with_suffix(".log").read_text()
    entries = re.findall(r"Compiling entry function '(\w+)'", log)
    # the fp32 GEMM's three epilogues, and the bf16 GEMM's
    fwd = [e for e in entries if "gemm_fwd_kernel" in e
           or "gemm_fwd_bf16_kernel" in e]
    if len(fwd) != 6 or any("gemm_kernel" in e for e in entries):
        raise AssertionError(f"temporal library entries: {entries}")
    from pedestrians_video_2_carla_torch.ops import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {"gemm_fwd_entries": len(fwd), "hmma": "no cuobjdump"}
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    hmma, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
        elif current in fwd and "HMMA" in line:
            hmma[current] = hmma.get(current, 0) + 1
    if sorted(hmma) != sorted(fwd):
        raise AssertionError(f"forward GEMM entries without HMMA: {hmma}")
    return {"gemm_fwd_entries_fp32_and_bf16": len(fwd),
            "hmma_per_entry": sorted(hmma.values())}


def kernel_wrappers():
    """Every kernel wrapper that counts its launches, by name: the
    registry the wrappers enter where they are defined."""
    from pedestrians_video_2_carla_torch.ops import (  # noqa: F401
        fused_graph_gru, fused_projection, fused_spatial_transformer,
        fused_temporal_transformer)
    from pedestrians_video_2_carla_torch.ops.cuda_build import COUNTED
    return dict(COUNTED)


def kernel_counts():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def expected_counts(**launched):
    """Every wrapper's count at 0 but the named ones."""
    return {**dict.fromkeys(kernel_wrappers(), 0), **launched}


def reset_kernel_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "bf16_launches"):
            fn.bf16_launches = 0


#: the wrappers whose kernels also run bf16 (rows 4, 8, 5, 9), by the name
#: of their bf16 entry on the kernels line
BF16_ROWS = {"row4_bf16": "fused_spatial_stack",
             "row8_bf16": "fused_temporal_block",
             "row5_bf16": "fused_spatial_stack_bwd",
             "row9_bf16": "fused_temporal_block_bwd"}


def bf16_counts(rows=None):
    """The bf16 launches of rows 4, 8, 5 and 9, or of ``rows`` (row ->
    wrapper name): a part of each wrapper's ``launches``."""
    fns = kernel_wrappers()
    return {row: fns[name].bf16_launches
            for row, name in (rows or BF16_ROWS).items()}


def random_rotations(rng, shape):
    """Uniform random rotation matrices from normalized gaussian quaternions."""
    q = rng.standard_normal(shape + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    m = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                  2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                  2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                 axis=-1)
    return m.reshape(shape + (3, 3)).astype(np.float32)


def kernel_inputs(rng, B, L, device):
    from pedestrians_video_2_carla_torch.ops.projection import \
        projection_state_for

    changes = torch.from_numpy(random_rotations(rng, (B, L, 26))).to(device)
    agi = torch.from_numpy(rng.integers(0, 4, size=B)).to(device)
    state = projection_state_for(agi)
    return changes, state.rel_loc, state.rel_rot


def proj_errs(out, ref):
    """max |out - ref| on x and y (pixels) and on depth."""
    err = (out - ref).abs()
    return float(err[..., :2].max()), float(err[..., 2].max())


def fwd_cases(extra=()):
    """The projection kernels' check cases: (B, L, views) for FWD_SHAPES
    and ``extra``, then VIEW_SHAPE as views."""
    return [(B, L, False) for B, L in FWD_SHAPES + extra] + [
        (*VIEW_SHAPE, True)]


def fwd_inputs(rng, B, L, views):
    """kernel_inputs on the card, or views of a batch one clip larger that
    start one clip in (936 and 312 bytes: off a 16-byte boundary)."""
    if not views:
        return kernel_inputs(rng, B, L, "cuda")
    return tuple(t[1:] for t in kernel_inputs(rng, B + 1, L, "cuda"))


def phase_kernel(camera):
    from pedestrians_video_2_carla_torch.ops import fused_projection as FP

    rng = np.random.default_rng(SEED)
    worst = 0.0
    for B, L, views in fwd_cases():
        args = fwd_inputs(rng, B, L, views)
        out = FP.fused_projection_cuda(*args, camera)
        ref = FP.fused_projection_reference(*args, camera)
        # and the kernel's algorithm in plain PyTorch
        algo = FP.fused_projection_fwd_algorithm(*args, camera)
        torch.cuda.synchronize()
        err_xy, err_z = proj_errs(out, ref)
        algo_xy, algo_z = proj_errs(out, algo)
        finite = bool(torch.isfinite(out).all())
        emit({"phase": "kernel", "B": B, "L": L, "views": views,
              "max_abs_err_xy_px": err_xy,
              "max_abs_err_depth": err_z,
              "vs_algorithm_max_abs_err_xy_px": algo_xy,
              "vs_algorithm_max_abs_err_depth": algo_z, "finite": finite})
        if not (max(err_xy, algo_xy) <= XY_TOL_PX
                and max(err_z, algo_z) <= DEPTH_TOL and finite):
            raise AssertionError(
                f"kernel disagrees with its plain version or its algorithm "
                f"at B={B}, L={L}: xy {err_xy} / {algo_xy} px, depth "
                f"{err_z} / {algo_z}")
        worst = max(worst, err_xy, err_z)
    return worst


def scaled_err(got, ref):
    """max |got - ref| / max |ref|, and whether every element is within
    rtol 1e-4 and atol 1e-5 of the reference on that scale."""
    scale = max(float(ref.abs().max()), 1e-8)
    diff = (got - ref).abs() / scale
    ok = bool((diff <= GRAD_ATOL + GRAD_RTOL * ref.abs() / scale).all())
    return float(diff.max()), ok


def phase_kernel_train(camera):
    from pedestrians_video_2_carla_torch.ops import fused_projection as FP
    from pedestrians_video_2_carla_torch.ops import kinematics as K

    rng = np.random.default_rng(SEED + 1)
    worst_fwd = worst_bwd = 0.0
    for B, L, views in fwd_cases(((5, 2),)):
        args = fwd_inputs(rng, B, L, views)
        proj, abs_loc, states = FP.fused_projection_train_cuda_fwd(
            *args, camera)
        inputs = [t.clone().requires_grad_(True) for t in args]
        ref_proj, ref_abs = FP.fused_projection_train_reference(
            *inputs, camera)
        ref = (ref_proj.detach(), ref_abs.detach())
        err_xy, err_z = proj_errs(proj, ref[0])
        err_abs = float((abs_loc - ref[1]).abs().max())
        err_state = float((states.reshape(B, L, 26, 3, 3)
                           - K.accumulate_pose_changes(*args[::2])
                           ).abs().max())
        # and the kernel's algorithm in plain PyTorch
        algo = FP.fused_projection_fwd_algorithm(*args, camera, train=True)
        algo_xy, algo_z = proj_errs(proj, algo[0])
        algo_abs = float((abs_loc - algo[1]).abs().max())
        algo_state = float((states - algo[2]).abs().max())

        g_proj, g_abs = (torch.from_numpy(rng.standard_normal(
            (B, L, 26, 3)).astype(np.float32)).cuda() for _ in range(2))
        grads = FP.fused_projection_train_cuda_bwd(
            *args, states, g_proj, g_abs, camera)
        again = FP.fused_projection_train_cuda_bwd(
            *args, states, g_proj, g_abs, camera)
        refs = torch.autograd.grad((ref_proj, ref_abs), inputs,
                                   (g_proj, g_abs))
        # and its plain version: the kernel's algorithm (per-frame tree
        # terms, then the carry) on the same states
        algo = FP.fused_projection_train_bwd_reference(
            *args, states, g_proj, g_abs, camera)
        torch.cuda.synchronize()
        bwd = {}
        for name, g, r in zip(("pose_changes", "rel_loc", "rel_rot"),
                              grads, refs):
            bwd[name] = scaled_err(g, r) + (float((g - r).abs().max()),)
        for name, g, r in zip(("pose_changes", "rel_loc", "rel_rot"),
                              grads, algo):
            bwd[name + "_vs_algorithm"] = scaled_err(g, r) + (
                float((g - r).abs().max()),)
        same_bits = all(torch.equal(a, b) for a, b in zip(grads, again))
        finite = all(bool(torch.isfinite(t).all())
                     for t in (proj, abs_loc, states, *grads))
        emit({"phase": "kernel_train", "B": B, "L": L, "views": views,
              "fwd_max_abs_err_xy_px": err_xy,
              "fwd_max_abs_err_depth": err_z,
              "fwd_max_abs_err_abs_loc": err_abs,
              "fwd_max_abs_err_states": err_state,
              "fwd_vs_algorithm_max_abs_err": {
                  "xy_px": algo_xy, "depth": algo_z, "abs_loc": algo_abs,
                  "states": algo_state},
              "bwd_max_scaled_err": {k: v[0] for k, v in bwd.items()},
              "bwd_max_abs_err": {k: v[2] for k, v in bwd.items()},
              "bwd_same_bits_twice": same_bits, "finite": finite})
        if not (max(err_xy, algo_xy) <= XY_TOL_PX
                and max(err_z, algo_z) <= DEPTH_TOL
                and max(err_abs, algo_abs) <= ABS_TOL and finite):
            raise AssertionError(
                f"training forward kernel disagrees with its plain version "
                f"or its algorithm at B={B}, L={L}: xy {err_xy} / {algo_xy} "
                f"px, depth {err_z} / {algo_z}, abs_loc {err_abs} / "
                f"{algo_abs}")
        bad = [k for k, v in bwd.items() if not v[1]]
        if bad or not same_bits:
            raise AssertionError(
                f"training backward kernel at B={B}, L={L}: {bad} outside "
                f"rtol {GRAD_RTOL} / atol {GRAD_ATOL} of autograd of the "
                f"plain version ({bwd}); same bits twice: {same_bits}")
        worst_fwd = max(worst_fwd, err_xy, err_z, err_abs)
        worst_bwd = max([worst_bwd] + [v[2] for v in bwd.values()])
    return worst_fwd, worst_bwd


def make_flows():
    from pedestrians_video_2_carla_torch.flows.pose_lifting import \
        PoseLiftingFlow
    from pedestrians_video_2_carla_torch.models.movements.linear_ae import \
        LinearAE

    def flow(kernel):
        model = LinearAE(generator=torch.Generator().manual_seed(SEED))
        return PoseLiftingFlow(model, loss_modes=["loc_2d_3d"],
                               projection_kernel=kernel)
    return flow("fused"), flow("plain")


def phase_serve(flow_f, flow_p, batches):
    from pedestrians_video_2_carla_torch.ops import fused_projection as FP
    from pedestrians_video_2_carla_torch.serving import make_inference_fn

    params = flow_f.init_params()
    infer_f = make_inference_fn(flow_f, params)
    infer_p = make_inference_fn(flow_p, params)

    reset_kernel_counts()
    served = []
    for i, (inputs, _, meta) in enumerate(batches):
        served.append(infer_f(inputs, meta["age_gender_idx"]))
        if FP.fused_projection_cuda.launches != i + 1:
            raise AssertionError(
                f"request {i}: kernel launches "
                f"{FP.fused_projection_cuda.launches}, expected {i + 1}")
    torch.cuda.synchronize()
    counts = kernel_counts()
    launches = counts["fused_projection"]
    if counts["fused_projection_train_fwd"] or \
            counts["fused_projection_train_bwd"]:
        raise AssertionError(f"serving launched a training kernel: {counts}")

    worst_xy = worst_z = 0.0
    for preds, (inputs, _, meta) in zip(served, batches):
        for k, v in preds.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"non-finite output {k}")
        ref = infer_p(inputs, meta["age_gender_idx"])
        p, r = preds["projection_2d"], ref["projection_2d"]
        if p.shape != (BATCH, CLIP, 26, 3):
            raise AssertionError(f"projection_2d shape {tuple(p.shape)}")
        worst_xy = max(worst_xy, float((p[..., :2] - r[..., :2]).abs().max()))
        worst_z = max(worst_z, float((p[..., 2] - r[..., 2]).abs().max()))
    if worst_xy > XY_TOL_PX or worst_z > DEPTH_TOL:
        raise AssertionError(f"fused flow vs plain flow: xy {worst_xy} px, "
                             f"depth {worst_z}")

    losses = []
    for batch in batches[:2]:
        lf, _, _ = flow_f.eval_step(params, batch)
        lp, _, _ = flow_p.eval_step(params, batch)
        a, b = float(lf["loc_2d_3d"]), float(lp["loc_2d_3d"])
        if not (np.isfinite(a) and abs(a - b) <= LOSS_RTOL * abs(b)):
            raise AssertionError(f"loc_2d_3d fused {a} vs plain {b}")
        losses.append((a, b))
    emit({"phase": "serve", "requests": len(batches), "launches": launches,
          "max_abs_err_xy_px_vs_plain": worst_xy,
          "max_abs_err_depth_vs_plain": worst_z,
          "loc_2d_3d_fused_vs_plain": losses})
    return params, launches


def make_train_flow(kernel):
    from pedestrians_video_2_carla_torch.flows.pose_lifting import \
        PoseLiftingFlow
    from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
    from pedestrians_video_2_carla_torch.models.movements.linear_ae import \
        LinearAE

    model = LinearAE(generator=torch.Generator().manual_seed(SEED))
    return PoseLiftingFlow(model, loss_modes=["loc_2d_3d"],
                           movements_optimizer=OptimizerSettings(lr=LR),
                           projection_kernel=kernel)


def phase_train(dm):
    """The training path through the port's Trainer, then the per-step
    agreement of the fused_train and plain flows."""
    from pedestrians_video_2_carla_torch.training.trainer import (
        Trainer, TrainerConfig)

    flow = make_train_flow("fused_train")
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(flow, dm, TrainerConfig(
            max_epochs=1, limit_train_batches=TRAIN_STEPS,
            limit_val_batches=VAL_BATCHES, log_every_n_steps=1, seed=SEED,
            logs_dir=tmp, run_name="smoke"))
        reset_kernel_counts()
        t0 = time.perf_counter()
        state = trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = kernel_counts()
        expected = expected_counts(
            fused_projection_train_fwd=TRAIN_STEPS + VAL_BATCHES,
            fused_projection_train_bwd=TRAIN_STEPS)
        if counts != expected:
            raise AssertionError(f"train launches {counts}, expected "
                                 f"{expected}")

        run = os.path.join(tmp, "smoke")
        ckpts = os.path.join(run, "checkpoints")
        for path in (os.path.join(run, "metrics.jsonl"),
                     os.path.join(ckpts, "best.json"),
                     os.path.join(ckpts, "last.pt")):
            if not os.path.exists(path):
                raise AssertionError(f"fit wrote no {path}")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        losses = {k: v for r in records for k, v in r.items()
                  if "_loss/" in k and not np.isfinite(v)}
        if losses:
            raise AssertionError(f"non-finite logged losses {losses}")
        steps = [r["train_loss/primary"] for r in records
                 if "lr-movements" in r]
        if len(steps) != TRAIN_STEPS:
            raise AssertionError(f"{len(steps)} step records, expected "
                                 f"{TRAIN_STEPS}")
        if not np.mean(steps[-5:]) < steps[0]:
            raise AssertionError(f"train loss did not fall: {steps}")
        val = records[-1]["val_loss/primary"]

        restored = flow.init_state()
        trainer.checkpoints.restore(restored, os.path.join(ckpts, "last"))
        same = all(torch.equal(restored.params[n][k], v)
                   for n, tree in state.params.items()
                   for k, v in tree.items())
        if not (same and restored.step == state.step == TRAIN_STEPS):
            raise AssertionError("the last checkpoint does not restore the "
                                 "trained params")

    # the fused_train and plain flows, step by step from the same params
    plain = make_train_flow("plain")
    params = flow.init_params()
    states = {"fused_train": flow.init_state(params),
              "plain": plain.init_state(params)}
    stream = dm.train_batches(SEED)
    worst, per_step = 0.0, []
    for _ in range(PARITY_STEPS):
        batch = next(stream)
        _, logs_f = flow.training_step(states["fused_train"], batch)
        _, logs_p = plain.training_step(states["plain"], batch)
        row = {}
        for k in logs_p:
            a, b = float(logs_f[k]), float(logs_p[k])
            rel = abs(a - b) / abs(b)
            if not rel <= LOSS_RTOL:
                raise AssertionError(f"{k}: fused_train {a} vs plain {b}")
            worst = max(worst, rel)
            row[k] = [a, b]
        per_step.append(row)
    emit({"phase": "train", "B": BATCH, "L": CLIP, "steps": TRAIN_STEPS,
          "val_batches": VAL_BATCHES, "launches": counts,
          "fit_seconds": fit_s, "train_loss_primary": steps,
          "val_loss_primary": val, "restored_equal": same,
          "fused_train_vs_plain_losses": per_step,
          "fused_train_vs_plain_max_rel": worst})
    return counts


def cuda_call_ms(fn, flush=None):
    """One call between two CUDA events; ``flush`` (if given) runs first. A
    ~1 ms device sleep ahead of the call keeps the card busy while the host
    enqueues it, so a call whose launches outrun the host is timed on the
    device alone; a host-bound call still shows its host time."""
    torch.cuda._sleep(2_000_000)
    if flush is not None:
        flush()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def cuda_median_ms(fn, runs=TIMING_RUNS, flush=None):
    """Median over ``runs`` single calls (``cuda_call_ms``) after a
    warm-up."""
    for _ in range(3):
        fn()
    return statistics.median(cuda_call_ms(fn, flush) for _ in range(runs))


def paired_ms(kernel, library, flush, pairs=TIMING_PAIRS):
    """Kernel and library yardstick in alternating single calls (kernel,
    library, library, kernel, ...) within one process on one card: the
    median of each and of their ratio."""
    for fn in (kernel, library):
        for _ in range(3):
            fn()
    k, lib = [], []
    for i in range(pairs):
        order = ((kernel, k), (library, lib)) if i % 2 == 0 else \
            ((library, lib), (kernel, k))
        for fn, out in order:
            out.append(cuda_call_ms(fn, flush))
    return {"pairs": pairs, "kernel_ms_median": statistics.median(k),
            "library_ms_median": statistics.median(lib),
            "ratio_median": statistics.median(a / b for a, b in zip(k, lib))}


def host_median_ms(fn, runs=TIMING_RUNS):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_timing(flow_f, flow_p, params, batches, card, hbm_rate):
    from pedestrians_video_2_carla_torch.ops import fused_projection as FP
    from pedestrians_video_2_carla_torch.ops import kinematics as K
    from pedestrians_video_2_carla_torch.ops.kinematics import _unpack9
    from pedestrians_video_2_carla_torch.ops.projection import \
        projection_state_for
    from pedestrians_video_2_carla_torch.serving import make_inference_fn

    camera = flow_f.projection.camera
    inputs, _, meta = batches[0]
    with torch.no_grad():
        pose_changes = flow_f._apply_model(
            flow_f.movements_model, params["movements"], inputs, None, False)
        state = projection_state_for(meta["age_gender_idx"])
    args = (pose_changes, state.rel_loc, state.rel_rot)
    B, L, J = pose_changes.shape[:3]
    bound = serve_bound(B, L, J, hbm_rate)
    nbytes, nflop = bound["bytes"], bound["flop"]
    bound_ms, bound_by = bound["bound_ms"], bound["bound_by"]

    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def flush_l2():  # 256 MB write: far more than the 50 MB L2
        scratch.zero_()

    with torch.no_grad():
        kernel_cold = cuda_median_ms(
            lambda: FP.fused_projection_cuda(*args, camera), flush=flush_l2)
        kernel_warm = cuda_median_ms(
            lambda: FP.fused_projection_cuda(*args, camera))
        plain = cuda_median_ms(
            lambda: FP.fused_projection_reference(*args, camera))

        def plane_path():  # what the eager fused flow still computes
            rel9 = K.accumulate9(_unpack9(pose_changes),
                                 _unpack9(state.rel_rot[:, None]))
            loc = tuple(state.rel_loc[:, None, :, i].expand(B, L, J)
                        for i in range(3))
            K.fk_planes(loc, rel9)
        plane = cuda_median_ms(plane_path)

        shapes = time_forward_shapes(FP.fused_projection_cuda, camera,
                                     flush_l2, hbm_rate, train=False)
    projection_fwd_phase_split(camera, shapes)

    infer_f = make_inference_fn(flow_f, params)
    infer_p = make_inference_fn(flow_p, params)
    agi = meta["age_gender_idx"]
    request_fused = host_median_ms(lambda: infer_f(inputs, agi))
    request_plain = host_median_ms(lambda: infer_p(inputs, agi))
    emit({"phase": "timing", "card": card, "B": B, "L": L,
          "kernel_ms_cold_l2": kernel_cold, "kernel_ms_warm_l2": kernel_warm,
          "plain_ms": plain, "bound_us": bound_ms * 1e3,
          "bound_by": bound_by, "bytes": nbytes, "flop": nflop,
          "eager_plane_path_ms": plane, **shapes,
          "request_ms_fused": request_fused,
          "request_ms_plain": request_plain,
          "method": "CUDA events, median of %d single calls after 3 warm-up "
                    "calls; cold = 256 MB scratch write before each call; "
                    "requests: host clock to torch.cuda.synchronize()"
                    % TIMING_RUNS})
    return {"ms": kernel_cold, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by, **shapes}


def serve_bound(B, L, J, hbm_rate):
    """The least time of the serving kernel (row 1) at (B, L, J): each input
    read once and the output written once over the memory rate, against its
    float32 operations over the fp32 peak."""
    nbytes = 4 * (B * L * J * 9 + B * J * 3 + B * J * 9 + B * L * J * 3)
    # per (clip, frame): compose 26 x 27 FMAs, FK 25 x 36 FMAs, projection
    # 26 x (9 FMAs + 3 adds + 1 div + 6 ops); an FMA counts as 2 operations
    nflop = B * L * (2 * (J * 27 + (J - 1) * 36 + J * 9) + J * 10)
    t_bytes, t_flop = nbytes / hbm_rate, nflop / FP32_PEAK
    return {"bytes": nbytes, "flop": nflop,
            "bound_ms": max(t_bytes, t_flop) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_flop else "operations"}


def time_forward_shapes(fn, camera, flush, hbm_rate, train):
    """Row 1 (``fused_projection_cuda``) or row 2
    (``fused_projection_train_cuda_fwd``, ``train``) on seeded rotations at
    B=1024 and each of FWD_TIMED_CLIPS: CUDA-event medians, L2 cold and
    warm, beside the bound."""
    rng = np.random.default_rng(SEED + 5)
    out = {}
    for L in FWD_TIMED_CLIPS:
        args = kernel_inputs(rng, BATCH, L, "cuda")
        J = args[0].shape[2]
        bound = train_bounds(BATCH, L, J, hbm_rate)["fwd"] if train \
            else serve_bound(BATCH, L, J, hbm_rate)
        out[f"shape_B{BATCH}_L{L}"] = {
            "ms_cold_l2": cuda_median_ms(lambda: fn(*args, camera),
                                         flush=flush),
            "ms_warm_l2": cuda_median_ms(lambda: fn(*args, camera)),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
    return out


def fk_split_source(source):
    """The instrumented copy of row 1's ``source`` (PV2C_FK_SPLIT defined:
    csrc/fk_forward.cuh), with the headers it includes, under
    build/fk_split/."""
    from pedestrians_video_2_carla_torch.ops import cuda_build

    d = cuda_build.BUILD_DIR.parent / "fk_split"
    d.mkdir(parents=True, exist_ok=True)
    copy = d / source.name
    copy.write_text("#define PV2C_FK_SPLIT\n" + source.read_text())
    for header in cuda_build._local_headers(source):
        shutil.copy(header, d / header.name)
    return copy


def projection_fwd_phase_split(camera, shapes):
    """Row 1's phases at B=1024 and each of FWD_TIMED_CLIPS: one launch of
    the instrumented copy (fk_split_source) with its counter on, each
    phase's share of the thread blocks' cycles, and that share of the
    kernel's cold-L2 time in ``shapes``. The copy's output must be the
    kernel's, bit for bit."""
    from pedestrians_video_2_carla_torch.ops import cuda_build
    from pedestrians_video_2_carla_torch.ops import fused_projection as FP

    lib = ctypes.CDLL(str(cuda_build.build_library(
        fk_split_source(FP._SOURCE))))
    entry = lib.pv2c_fused_projection
    entry.argtypes = FP._SIGNATURES["serve"]["pv2c_fused_projection"]
    lib.pv2c_fk_split_set.argtypes = [cuda_build.PTR]
    rng = np.random.default_rng(SEED + 6)
    split = {}
    for L in FWD_TIMED_CLIPS:
        args = kernel_inputs(rng, BATCH, L, "cuda")
        out = torch.empty(args[0].shape[:3] + (3,), device="cuda")
        cycles = torch.zeros(len(FK_SPLIT_PHASES), dtype=torch.int64,
                             device="cuda")
        cuda_build.check_launch(lib.pv2c_fk_split_set(cycles.data_ptr()),
                                "pv2c_fk_split_set")
        FP._launch(entry, out.device, *args, out, BATCH, L, camera)
        torch.cuda.synchronize()
        cuda_build.check_launch(lib.pv2c_fk_split_set(None),
                                "pv2c_fk_split_set")
        same = torch.equal(out, FP.fused_projection_cuda(*args, camera))
        total = float(cycles.sum())
        ms = shapes[f"shape_B{BATCH}_L{L}"]["ms_cold_l2"]
        blocks = -(-BATCH // FP.fwd_plan(L)[0])
        split[f"L{L}"] = {
            "share": {k: c / total for k, c in zip(FK_SPLIT_PHASES,
                                                   cycles.tolist())},
            "cycles_a_thread_block": {
                k: c / blocks for k, c in zip(FK_SPLIT_PHASES,
                                              cycles.tolist())},
            "us": {k: 1e3 * ms * c / total for k, c in zip(
                FK_SPLIT_PHASES, cycles.tolist())},
            "same_bits": same}
        if not same:
            raise AssertionError(f"the instrumented copy of row 1 differs "
                                 f"from the kernel at L={L}")
    emit({"phase": "projection_fwd_phase_split", "B": BATCH, **split,
          "method": "clock64() cycles by thread 0 of each thread block, "
                    "summed by phase over the thread blocks of one launch "
                    "of an instrumented copy, as shares of the sum; us = "
                    "share x the kernel's cold-L2 median"})


def train_bounds(B, L, J, hbm_rate):
    """The least time of each training kernel at (B, L, J): each input read
    once and each output written once over the memory rate, against its
    float32 operations over the fp32 peak (an FMA counts as 2)."""
    frames, clips = B * L * J, B * J
    fwd_bytes = 4 * (frames * 9 + clips * 3 + clips * 9       # reads
                     + frames * 3 + frames * 3 + frames * 9)  # proj, abs, S
    # per (clip, frame), as the serving kernel: compose J x 27 FMAs, FK
    # (J-1) x 36 FMAs, projection J x (9 FMAs + 10 other operations)
    fwd_flop = B * L * (2 * (J * 27 + (J - 1) * 36 + J * 9) + J * 10)
    bwd_bytes = 4 * (frames * 9 + clips * 3 + clips * 9 + frames * 9
                     + frames * 3 + frames * 3                 # reads
                     + frames * 9 + clips * 3 + clips * 9)     # writes
    # per (clip, frame): FK replay (J-1) x 36 FMAs; projection transpose
    # J x (18 FMAs + 16 other); tree transpose (J-1) x (9 + 27 + 27 FMAs,
    # 9 products, 12 adds into the parent) and 3 adds at the root; the
    # carry J x (9 adds + 27 + 27 FMAs) and d_rel_loc J x 3 adds
    bwd_flop = B * L * (2 * ((J - 1) * 36 + J * 18 + (J - 1) * 63 + J * 54)
                        + J * 16 + (J - 1) * 21 + 3 + J * 12)
    out = {}
    for name, nbytes, nflop in (("fwd", fwd_bytes, fwd_flop),
                                ("bwd", bwd_bytes, bwd_flop)):
        t_bytes, t_flop = nbytes / hbm_rate, nflop / FP32_PEAK
        out[name] = {"bytes": nbytes, "flop": nflop,
                     "bound_ms": max(t_bytes, t_flop) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_flop
                     else "operations"}
    return out


def phase_timing_train(dm, card, hbm_rate):
    from pedestrians_video_2_carla_torch.ops import fused_projection as FP
    from pedestrians_video_2_carla_torch.ops import kinematics as K
    from pedestrians_video_2_carla_torch.ops.kinematics import (_pack9,
                                                                _unpack9)
    from pedestrians_video_2_carla_torch.ops.projection import \
        projection_state_for

    flow = make_train_flow("fused_train")
    plain = make_train_flow("plain")
    camera = flow.projection.camera
    batch = next(dm.train_batches(SEED + 7))
    inputs, _, meta = batch
    params = flow.init_params()
    with torch.no_grad():
        pose_changes = flow._apply_model(
            flow.movements_model, params["movements"], inputs, None, False)
        state = projection_state_for(meta["age_gender_idx"])
    args = (pose_changes.contiguous(), state.rel_loc, state.rel_rot)
    B, L, J = pose_changes.shape[:3]
    bounds = train_bounds(B, L, J, hbm_rate)
    rng = np.random.default_rng(SEED + 2)
    g_proj, g_abs = (torch.from_numpy(rng.standard_normal(
        (B, L, J, 3)).astype(np.float32)).cuda() for _ in range(2))
    _, _, states = FP.fused_projection_train_cuda_fwd(*args, camera)

    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def flush_l2():  # 256 MB write: far more than the 50 MB L2
        scratch.zero_()

    def fwd():
        FP.fused_projection_train_cuda_fwd(*args, camera)

    def bwd():
        FP.fused_projection_train_cuda_bwd(*args, states, g_proj, g_abs,
                                           camera)
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    outs = FP.fused_projection_train_reference(*leaves, camera)

    def plain_fwd():
        with torch.no_grad():
            FP.fused_projection_train_reference(*args, camera)

    def plain_bwd():
        torch.autograd.grad(outs, leaves, (g_proj, g_abs), retain_graph=True)

    def plain_fwd_bwd():
        x = [t.detach().requires_grad_(True) for t in args]
        o = FP.fused_projection_train_reference(*x, camera)
        torch.autograd.grad(o, x, (g_proj, g_abs))

    shapes = time_forward_shapes(FP.fused_projection_train_cuda_fwd, camera,
                                 flush_l2, hbm_rate, train=True)
    times = {"fwd_ms_cold_l2": cuda_median_ms(fwd, flush=flush_l2),
             "fwd_ms_warm_l2": cuda_median_ms(fwd),
             "bwd_ms_cold_l2": cuda_median_ms(bwd, flush=flush_l2),
             "bwd_ms_warm_l2": cuda_median_ms(bwd),
             "plain_fwd_ms": cuda_median_ms(plain_fwd),
             "plain_bwd_ms": cuda_median_ms(plain_bwd),
             "plain_fwd_bwd_ms": cuda_median_ms(plain_fwd_bwd)}

    def plane_outputs():
        # what the eager "fused_train" projection still computes besides
        # the kernel: the rotation outputs through the plane path, with
        # autograd recording as in a train step
        x = args[0].detach().requires_grad_(True)
        rel9 = K.accumulate9(_unpack9(x), _unpack9(state.rel_rot[:, None]))
        loc = tuple(state.rel_loc[:, None, :, i].expand(B, L, J)
                    for i in range(3))
        abs_loc, abs_rot9 = K.fk_planes(loc, rel9)
        return _pack9(rel9), _pack9(abs_rot9), torch.stack(abs_loc, dim=-1)

    step_states = {"fused_train": flow.init_state(params),
                   "plain": plain.init_state(params)}
    steps = {}
    for name, f in (("fused_train", flow), ("plain", plain)):
        st = step_states[name]
        steps[name] = host_median_ms(lambda: f.training_step(st, batch))
    plane = host_median_ms(plane_outputs)
    emit({"phase": "timing_train", "card": card, "B": B, "L": L, **times,
          "bounds": bounds, "fwd_shapes": shapes,
          "train_step_ms_fused_train": steps["fused_train"],
          "train_step_ms_plain": steps["plain"],
          "eager_plane_path_ms_standalone": plane,
          "eager_plane_path_share_estimate": plane / steps["fused_train"],
          "method": "kernels and plain versions: CUDA events, median of %d "
                    "single calls after 3 warm-up calls, cold = 256 MB "
                    "scratch write before each call; train steps and a "
                    "standalone call of the plane path: host clock to "
                    "torch.cuda.synchronize(), median of %d each; the share "
                    "is the ratio of the two medians, an estimate, not a "
                    "measurement inside the step" % (TIMING_RUNS,
                                                     TIMING_RUNS)})
    return {"fwd": {"ms": times["fwd_ms_cold_l2"],
                    "plain_ms": times["plain_fwd_ms"], **bounds["fwd"],
                    **shapes},
            "bwd": {"ms": times["bwd_ms_cold_l2"],
                    "plain_ms": times["plain_bwd_ms"], **bounds["bwd"]}}


def random_block_weights(rng, dim, lead=(), hidden=None):
    """One transformer block's weights in nn.Linear layout (each with the
    leading ``lead`` axes; hidden 2 dim unless given), LayerNorm scales and
    biases away from ones and zeros, on the card."""
    hidden = 2 * dim if hidden is None else hidden

    def w(*shape, scale, shift=0.0):
        return torch.from_numpy((shift + scale * rng.standard_normal(
            lead + shape)).astype(np.float32)).cuda()
    return [w(dim, scale=0.2, shift=1.0), w(dim, scale=0.2),
            w(3 * dim, dim, scale=dim ** -0.5), w(3 * dim, scale=0.1),
            w(dim, dim, scale=dim ** -0.5), w(dim, scale=0.1),
            w(dim, scale=0.2, shift=1.0), w(dim, scale=0.2),
            w(hidden, dim, scale=dim ** -0.5), w(hidden, scale=0.1),
            w(dim, hidden, scale=hidden ** -0.5), w(dim, scale=0.1)]


def random_spatial_weights(rng, emb=PF_EMB, hidden=None):
    """The spatial stack's 14 weights (depth PF_DEPTH, hidden 2 emb unless
    given), LayerNorms away from ones and zeros, on the card."""
    return random_block_weights(rng, emb, lead=(PF_DEPTH,),
                                hidden=hidden) + [
        torch.from_numpy((1 + 0.2 * rng.standard_normal(emb)).astype(
            np.float32)).cuda(),
        torch.from_numpy((0.2 * rng.standard_normal(emb)).astype(
            np.float32)).cuda()]


def spatial_cases(main_ns, wide_ns):
    """(N, E, heads) of the spatial checks: the main path's widths at
    ``main_ns``, then each SPATIAL_WIDE shape at ``wide_ns``."""
    return [(n, PF_EMB, PF_HEADS) for n in main_ns] + [
        (n, e, h) for e, h in SPATIAL_WIDE for n in wide_ns]


def check_spatial_layouts():
    """The wrapper's copies of the kernels' shared-memory layouts against
    the library's, at every shape the checks run; returns the tiles."""
    from pedestrians_video_2_carla_torch.ops import \
        fused_spatial_transformer as FS

    lib, tiles = FS._library(), {}
    for J, emb, heads, hid in [(PF_JOINTS, e, h, 2 * e) for e, h in (
            (PF_EMB, PF_HEADS),) + SPATIAL_WIDE] + list(SPATIAL_EDGE):
        fwd, rows, frames = FS.kernel_tiles(J, emb, heads, hid)
        pairs = ((lib.pv2c_spatial_stack_smem_bytes(J, emb, heads, hid, fwd),
                  FS.forward_smem_bytes(J, emb, hid, fwd)),
                 (lib.pv2c_spatial_mlp_bwd_smem_bytes(emb, hid, rows),
                  FS.mlp_bwd_smem_bytes(emb, hid, rows)),
                 (lib.pv2c_spatial_attn_bwd_smem_bytes(J, emb, heads,
                                                       frames),
                  FS.attn_bwd_smem_bytes(J, emb, heads, frames)))
        if any(a != b for a, b in pairs):
            raise AssertionError(f"J={J}, E={emb}, {heads} heads, hidden "
                                 f"{hid}: shared memory library vs wrapper "
                                 f"{pairs}")
        tiles[f"J{J}_E{emb}_H{heads}_hidden{hid}"] = {
            "forward_frames": fwd, "mlp_bwd_rows": rows,
            "attn_bwd_frames": frames, "smem_bytes": [a for a, _ in pairs]}
    return tiles


def bar_err(out, ref):
    """(max |out - ref|, that over max |ref|)."""
    err = float((out - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def phase_kernel_spatial():
    from pedestrians_video_2_carla_torch.ops import \
        fused_spatial_transformer as FS

    emit({"phase": "kernel_spatial", "tiles": check_spatial_layouts()})
    rng = np.random.default_rng(SEED + 3)
    weights = {}
    worst = 0.0
    for n, emb, heads in spatial_cases(SPATIAL_NS, SPATIAL_WIDE_NS):
        if emb not in weights:
            weights[emb] = random_spatial_weights(rng, emb)
        x = torch.from_numpy(rng.standard_normal(
            (n, PF_JOINTS, emb)).astype(np.float32)).cuda()
        out = FS.fused_spatial_stack_cuda(x, weights[emb], heads)
        ref = FS.spatial_stack_reference(x, weights[emb], heads)
        torch.cuda.synchronize()
        err, scaled = bar_err(out, ref)
        finite = bool(torch.isfinite(out).all())
        emit({"phase": "kernel_spatial", "N": n, "E": emb, "heads": heads,
              "max_abs_err": err, "max_abs_err_over_max_abs_plain": scaled,
              "finite": finite})
        if not (scaled <= KERNEL_BAR and finite):
            raise AssertionError(f"spatial kernel disagrees with its plain "
                                 f"version at N={n}, E={emb}, {heads} heads: "
                                 f"{scaled} of max |plain|")
        if emb == PF_EMB and heads == PF_HEADS:
            worst = max(worst, err)
    # the edge shapes, serving and the training forward (the same output)
    for J, emb, heads, hid in SPATIAL_EDGE:
        ws = random_spatial_weights(rng, emb, hid)
        x = torch.from_numpy(rng.standard_normal(
            (SPATIAL_EDGE_N, J, emb)).astype(np.float32)).cuda()
        out = FS.fused_spatial_stack_cuda(x, ws, heads)
        kept, _ = FS.fused_spatial_stack_cuda(x, ws, heads, keep=True)
        ref = FS.spatial_stack_reference(x, ws, heads)
        torch.cuda.synchronize()
        err, scaled = bar_err(out, ref)
        finite, same = bool(torch.isfinite(out).all()), torch.equal(out, kept)
        emit({"phase": "kernel_spatial", "N": SPATIAL_EDGE_N, "J": J,
              "E": emb, "heads": heads, "hidden": hid, "max_abs_err": err,
              "max_abs_err_over_max_abs_plain": scaled, "finite": finite,
              "keep_same_output": same})
        if not (scaled <= KERNEL_BAR and finite and same):
            raise AssertionError(f"spatial kernel at J={J}, E={emb}, hidden "
                                 f"{hid}: {scaled} of max |plain|, finite "
                                 f"{finite}, keep's output the same {same}")
    return worst


def phase_kernel_temporal():
    from pedestrians_video_2_carla_torch.ops import \
        fused_temporal_transformer as FT

    smem = (FT._library().pv2c_temporal_fwd_gemm_smem_bytes(4),
            FT.forward_gemm_smem_bytes(4))
    emit({"phase": "kernel_temporal", "forward_gemm": FT.FORWARD_GEMM,
          "smem_bytes_library_vs_wrapper": smem})
    if smem[0] != smem[1]:
        raise AssertionError(f"forward GEMM shared memory: library vs "
                             f"wrapper {smem}")
    rng = np.random.default_rng(SEED + 4)
    blocks = [random_block_weights(rng, PF_DIM) for _ in range(PF_DEPTH)]
    worst = 0.0

    def check(what, n, out, ref):
        torch.cuda.synchronize()
        err, scaled = bar_err(out, ref)
        finite = bool(torch.isfinite(out).all())
        emit({"phase": "kernel_temporal", "entry": what, "N": n,
              "max_abs_err": err, "max_abs_err_over_max_abs_plain": scaled,
              "finite": finite})
        if not (scaled <= KERNEL_BAR and finite):
            raise AssertionError(f"temporal {what} disagrees with its plain "
                                 f"version at N={n}: {scaled} of max |plain|")
        return err

    def check_keep(T, n):
        """The training forward: its output and each tensor of its kept
        scratch against the plain version's, the same bits twice."""
        x = torch.from_numpy(rng.standard_normal(
            (n, T, PF_DIM)).astype(np.float32)).cuda()
        out, saved = FT.fused_temporal_block_cuda(x, blocks[0], PF_HEADS,
                                                  keep=True)
        again = FT.fused_temporal_block_cuda(x, blocks[0], PF_HEADS,
                                             keep=True)
        ref, ref_saved = FT.temporal_block_keep_reference(x, blocks[0],
                                                          PF_HEADS)
        torch.cuda.synchronize()
        errs = {}
        for name, got, want in zip(("out",) + FT_SAVED, (out, *saved),
                                   (ref, *ref_saved)):
            errs[name] = bar_err(got, want)[1]
        same = torch.equal(out, again[0]) and all(
            torch.equal(a, b) for a, b in zip(saved, again[1]))
        emit({"phase": "kernel_temporal", "entry": "keep", "T": T, "N": n,
              "max_abs_err_over_max_abs_plain": errs, "same_bits": same})
        if max(errs.values()) > KERNEL_BAR or not same:
            raise AssertionError(f"temporal keep forward at T={T}, N={n}: "
                                 f"{errs}, same bits {same}")
        return bar_err(out, ref)[0]

    with torch.no_grad():
        for n in TEMPORAL_NS:
            x = torch.from_numpy(rng.standard_normal(
                (n, PF_RF, PF_DIM)).astype(np.float32)).cuda()
            out = FT.fused_temporal_block(x, blocks[0], PF_HEADS)
            again = FT.fused_temporal_block(x, blocks[0], PF_HEADS)
            ref = FT.temporal_block_reference(x, blocks[0], PF_HEADS)
            worst = max(worst, check("fused_temporal_block", n, out, ref))
            if not torch.equal(out, again):
                raise AssertionError(f"temporal forward at N={n}: two "
                                     f"launches differ")
            worst = max(worst, check_keep(PF_RF, n))
        n = TEMPORAL_NS[0]
        x = torch.from_numpy(rng.standard_normal(
            (n, PF_RF, PF_DIM)).astype(np.float32)).cuda()
        out = FT.fused_temporal_stack(x, blocks, PF_HEADS)
        ref = x
        for weights in blocks:
            ref = FT.temporal_block_reference(ref, weights, PF_HEADS)
        worst = max(worst, check("fused_temporal_stack", n, out, ref))
        # PoseFormer's published receptive fields (F1)
        for T in WIDE_TS:
            for n in WIDE_NS:
                x = torch.from_numpy(rng.standard_normal(
                    (n, T, PF_DIM)).astype(np.float32)).cuda()
                out = FT.fused_temporal_block(x, blocks[0], PF_HEADS)
                ref = FT.temporal_block_reference(x, blocks[0], PF_HEADS)
                check(f"fused_temporal_block T={T}", n, out, ref)
                check_keep(T, n)
    return worst


def plain_temporal_stack(x, weights_list, num_heads):
    from pedestrians_video_2_carla_torch.ops import \
        fused_temporal_transformer as FT
    for weights in weights_list:
        x = FT.temporal_block_reference(x, weights, num_heads)
    return x


class stage_routes:
    """Set both stage switches of a PoseFormer (``spatial_kernel``,
    ``temporal_kernel``) to ``route`` for the block, then restore them."""

    def __init__(self, model, route):
        self.model, self.route = model, route

    def __enter__(self):
        self.saved = (self.model.spatial_kernel, self.model.temporal_kernel)
        self.model.spatial_kernel = self.model.temporal_kernel = self.route

    def __exit__(self, *exc):
        self.model.spatial_kernel, self.model.temporal_kernel = self.saved


#: the device kernels of rows 8 (the temporal forward, in launch order) and
#: 9 (its backward), names as the profiler shows them (substrings)
ROW8_STEPS = ("ln1", "qkv", "attention", "proj", "ln2", "fc1", "fc2")
#: the scratch the training forward keeps for row 9
FT_SAVED = ("stats", "qkv", "attn", "x2", "h", "mlp")
#: the card's idle time (us) between two kernels that cuts a profiled run
#: of synchronised calls into calls (a call's launches run back to back)
LAUNCH_GAP_US = 20.0
ROW8_KERNELS = ("ln_fwd_kernel", "gemm_fwd_kernel", "attention_kernel")
ROW9_STEPS = ("ln_apply", "dh", "dW2", "dy2", "dW1", "ln2_bwd", "do", "dWp",
              "attention_bwd", "dy1", "dWqkv", "ln1_bwd", "reduce")


def launch_split(fn, steps, calls=PF_TIMING_RUNS):
    """A torch.profiler trace of ``calls`` calls of ``fn`` (after 2 warm-up
    calls; a synchronisation after each), whose device kernels come in
    launch order ``len(steps)`` a call: the trace is cut into calls where
    the card idles between two kernels for more than LAUNCH_GAP_US, and per
    step of the calls traced whole, the kernel's name and the median of its
    device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
    kernels = sorted(
        (e for e in prof.events()
         if getattr(e, "device_type", None) is not None
         and e.device_type.name == "CUDA" and "emcpy" not in e.name
         and "emset" not in e.name),
        key=lambda e: e.time_range.start)
    runs, run = [], []
    for e in kernels:
        if run and e.time_range.start - run[-1].time_range.end > \
                LAUNCH_GAP_US:
            runs.append(run)
            run = []
        run.append(e)
    runs.append(run)
    whole = [r for r in runs if len(r) == len(steps)]
    if len(whole) < calls // 2:
        raise AssertionError(
            f"{len(whole)} of {calls} calls traced whole ({len(steps)} "
            f"kernels a call): {[len(r) for r in runs]}")
    return {"calls_traced_whole": len(whole), **{
        step: {"kernel": whole[0][i].name[:90],
               "ms": statistics.median((r[i].time_range.end
                                        - r[i].time_range.start) / 1e3
                                       for r in whole)}
        for i, step in enumerate(steps)}}


def phase_serve_poseformer(batches):
    from pedestrians_video_2_carla_torch.flows.pose_lifting import \
        PoseLiftingFlow
    from pedestrians_video_2_carla_torch.models.movements.pose_former import \
        PoseFormer
    from pedestrians_video_2_carla_torch.serving import make_inference_fn

    model = PoseFormer(clip_length=CLIP,
                       generator=torch.Generator().manual_seed(SEED))
    flow = PoseLiftingFlow(model, loss_modes=["loc_2d_3d"])
    params = flow.init_params()
    infer = make_inference_fn(flow, params)

    reset_kernel_counts()
    served = []
    for i, (inputs, _, meta) in enumerate(batches):
        served.append(infer(inputs, meta["age_gender_idx"]))
        counts = kernel_counts()
        if (counts["fused_spatial_stack"], counts["fused_temporal_block"]) \
                != (i + 1, PF_DEPTH * (i + 1)):
            raise AssertionError(f"request {i}: launches {counts}")
    torch.cuda.synchronize()
    counts = kernel_counts()
    if any(v for k, v in counts.items()
           if k.startswith(("fused_projection", "graph_"))
           or k.endswith("_bwd")):
        raise AssertionError(f"PoseFormer serving launched a projection or "
                             f"a backward kernel: {counts}")

    keep = model.eval_slice
    W = keep.stop - keep.start
    worst_xy = worst_other = 0.0
    with stage_routes(model, "plain"):
        for preds, (inputs, _, meta) in zip(served, batches):
            for k in ("absolute_pose_loc", "projection_2d"):
                if preds[k].shape[:2] != (PF_BATCH, W) or \
                        not torch.isfinite(preds[k]).all():
                    raise AssertionError(
                        f"{k}: shape {tuple(preds[k].shape)} or not finite")
            ref = infer(inputs, meta["age_gender_idx"])
            for k, v in preds.items():
                if k == "projection_2d":
                    worst_xy = max(worst_xy, float(
                        (v[..., :2] - ref[k][..., :2]).abs().max()))
                    worst_other = max(worst_other, float(
                        (v[..., 2] - ref[k][..., 2]).abs().max()))
                else:
                    worst_other = max(worst_other,
                                      float((v - ref[k]).abs().max()))
        plain_losses = [float(flow.eval_step(params, b)[0]["loc_2d_3d"])
                        for b in batches[:2]]
    if worst_xy > XY_TOL_PX or worst_other > DEPTH_TOL:
        raise AssertionError(f"kernel stages vs plain stages: xy {worst_xy} "
                             f"px, other {worst_other}")
    losses = []
    for batch, b in zip(batches[:2], plain_losses):
        a = float(flow.eval_step(params, batch)[0]["loc_2d_3d"])
        if not (np.isfinite(a) and abs(a - b) <= LOSS_RTOL * abs(b)):
            raise AssertionError(f"loc_2d_3d kernels {a} vs plain {b}")
        losses.append((a, b))

    emit({"phase": "serve_poseformer", "B": PF_BATCH, "L": CLIP,
          "requests": len(batches), "launches": counts,
          "eval_slice": [keep.start, keep.stop],
          "max_abs_err_xy_px_vs_plain": worst_xy,
          "max_abs_err_other_vs_plain": worst_other,
          "loc_2d_3d_kernels_vs_plain": losses})
    return flow, params, counts


def phase_f6_poseformer(dm):
    """Fault F6 on the card: PoseFormer's "auto" takes a stage's kernels
    only where they take the step. With drop_rate 0.1, training steps run
    the plain blocks (no kernel launched) and evaluation the kernels;
    "fused" refuses the training step; shapes a stage's kernel refuses run
    that stage on the plain blocks, and the outputs agree with the plain
    route's."""
    from pedestrians_video_2_carla_torch.flows.pose_lifting import \
        PoseLiftingFlow
    from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
    from pedestrians_video_2_carla_torch.models.movements.pose_former import \
        PoseFormer

    def make(**kw):
        model = PoseFormer(clip_length=CLIP,
                           generator=torch.Generator().manual_seed(SEED),
                           **kw)
        return model, PoseLiftingFlow(
            model, loss_modes=["loc_2d_3d"],
            movements_optimizer=OptimizerSettings(lr=LR), seed=SEED)

    stream = dm.train_batches(SEED)
    batches = [next(stream) for _ in range(F6_PF_STEPS)]
    model, flow = make(drop_rate=0.1)
    state = flow.init_state()
    reset_kernel_counts()
    losses = [float(flow.training_step(state, b)[1]["train_loss/primary"])
              for b in batches]
    torch.cuda.synchronize()
    train_counts = kernel_counts()
    if train_counts != expected_counts() or not np.all(np.isfinite(losses)):
        raise AssertionError(f"dropout training under auto: launches "
                             f"{train_counts}, losses {losses}")
    with stage_routes(model, "fused"):
        try:
            flow.training_step(state, batches[0])
            raise AssertionError("fused trained with dropout")
        except ValueError as e:
            refusal = str(e)
    params = {k: {n: v.detach() for n, v in tree.items()}
              for k, tree in state.params.items()}
    reset_kernel_counts()
    loss = float(flow.eval_step(params, batches[0])[0]["loc_2d_3d"])
    eval_counts = kernel_counts()
    with stage_routes(model, "plain"):
        plain = float(flow.eval_step(params, batches[0])[0]["loc_2d_3d"])
    if eval_counts != expected_counts(fused_spatial_stack=1,
                                      fused_temporal_block=PF_DEPTH) or \
            not abs(loss - plain) <= LOSS_RTOL * abs(plain):
        raise AssertionError(f"dropout eval under auto: launches "
                             f"{eval_counts}, loss {loss} vs plain {plain}")
    refused = {}
    for name, kw, launched in F6_PF_SHAPES:
        model, flow = make(**kw)
        params = flow.init_params()
        reset_kernel_counts()
        a = float(flow.eval_step(params, batches[0])[0]["loc_2d_3d"])
        counts = kernel_counts()
        with stage_routes(model, "plain"):
            b = float(flow.eval_step(params, batches[0])[0]["loc_2d_3d"])
        with stage_routes(model, "fused"):
            try:
                flow.eval_step(params, batches[0])
                raise AssertionError(f"fused took the shape {kw}")
            except ValueError:
                pass
        want = expected_counts(**launched)
        if counts != want or not abs(a - b) <= LOSS_RTOL * abs(b):
            raise AssertionError(f"{name} under auto: launches {counts} "
                                 f"(expected {want}), loss {a} vs plain {b}")
        refused[name] = {"launches": {k: v for k, v in counts.items() if v},
                         "loc_2d_3d_auto_vs_plain": [a, b]}
    emit({"phase": "f6_poseformer", "B": dm.batch_size, "L": CLIP,
          "dropout_train_losses": losses,
          "dropout_train_launches": {k: v for k, v in train_counts.items()
                                     if v},
          "dropout_eval_launches": {k: v for k, v in eval_counts.items()
                                    if v},
          "dropout_eval_loc_2d_3d_vs_plain": [loss, plain],
          "fused_refuses": refusal[:80], "refused_shapes": refused})


def phase_f6_graph(dm):
    """Fault F6 on the card: a graph classifier whose width the scan
    kernels' training launch plans refuse trains under "auto" on the plain
    route (no scan kernel launched) and serves on the forward kernel where
    its plan takes the width; "fused" raises before any launch."""
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG

    batch = next(dm.train_batches(SEED))
    rows = {}
    for name, H, k, plan, entry in F6_GRAPH_SHAPES:
        B, J = dm.batch_size, CLS_J
        fwd, bwd = (getattr(FG, plan)(B, J, H, k, backward)[0]
                    for backward in (False, True))
        if not (fwd > 0 and bwd == 0):
            raise AssertionError(f"{name} H={H} k={k}: plans {fwd}, {bwd}; "
                                 f"the phase wants a width only the "
                                 f"forward takes")
        flow = make_cls_flow(name, hidden_size=H, k=k)
        state = flow.init_state()
        reset_kernel_counts()
        _, logs = flow.training_step(state, batch)
        loss = float(logs["train_loss/primary"])
        torch.cuda.synchronize()
        train_counts = kernel_counts()
        params = {k_: {n: v.detach() for n, v in tree.items()}
                  for k_, tree in state.params.items()}
        logits = flow.eval_step(params, batch)[1]["crossing_logits"]
        eval_counts = kernel_counts()
        ref = make_cls_flow(name, hidden_size=H, k=k, graph_kernel="plain"
                            ).eval_step(params, batch)[1]["crossing_logits"]
        err = float((logits - ref).abs().max())
        fused = make_cls_flow(name, hidden_size=H, k=k, graph_kernel="fused")
        reset_kernel_counts()
        try:
            fused.training_step(fused.init_state(), batch)
            raise AssertionError(f"{name} H={H}: fused trained past its "
                                 f"plan")
        except ValueError:
            pass
        if train_counts != expected_counts() or not np.isfinite(loss) or \
                eval_counts != expected_counts(**{entry: 2}) or \
                err > SCAN_BAR or kernel_counts() != expected_counts():
            raise AssertionError(
                f"{name} H={H} k={k} under auto: train launches "
                f"{train_counts}, loss {loss}, eval launches {eval_counts}, "
                f"logits vs plain {err}")
        rows[f"{name}_H{H}_k{k}"] = {
            "plan_fwd_bwd": [fwd, bwd], "train_loss": loss,
            "eval_launches": eval_counts[entry],
            "max_abs_err_logits_vs_plain": err}
    emit({"phase": "f6_graph", "B": dm.batch_size, "L": CLIP, **rows})


def encoder_layer(dim, weights):
    """torch.nn.TransformerEncoderLayer loaded with one block's weights: it
    computes the same pre-norm block (the library yardstick). It runs in
    training mode, which with dropout 0 is the same function: the eval-mode
    fast path (torch._transformer_encoder_layer_fwd) on the H100 is 3.2e-4
    of max |out| away from a float64 reference of the spatial stack, the
    kernel, the plain version and the training-mode layer under 1e-6."""
    (ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b,
     ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b) = weights
    layer = torch.nn.TransformerEncoderLayer(
        dim, nhead=PF_HEADS, dim_feedforward=fc1_w.shape[0], dropout=0.0,
        activation="gelu", layer_norm_eps=1e-5, batch_first=True,
        norm_first=True).cuda().train()
    with torch.no_grad():
        for p, w in ((layer.self_attn.in_proj_weight, qkv_w),
                     (layer.self_attn.in_proj_bias, qkv_b),
                     (layer.self_attn.out_proj.weight, proj_w),
                     (layer.self_attn.out_proj.bias, proj_b),
                     (layer.linear1.weight, fc1_w), (layer.linear1.bias, fc1_b),
                     (layer.linear2.weight, fc2_w), (layer.linear2.bias, fc2_b),
                     (layer.norm1.weight, ln1_s), (layer.norm1.bias, ln1_b),
                     (layer.norm2.weight, ln2_s), (layer.norm2.bias, ln2_b)):
            p.copy_(w)
    return layer


def spatial_encoder_stack(ws):
    """The spatial stack's library yardstick: PF_DEPTH
    TransformerEncoderLayers and a LayerNorm loaded with its 14 weights."""
    stack = torch.nn.Sequential(
        *(encoder_layer(PF_EMB, [w[d] for w in ws[:12]])
          for d in range(PF_DEPTH)),
        torch.nn.LayerNorm(PF_EMB, eps=1e-5).cuda())
    with torch.no_grad():
        stack[-1].weight.copy_(ws[12])
        stack[-1].bias.copy_(ws[13])
    return stack


def phase_timing_poseformer(flow, params, batches, card, hbm_rate):
    from pedestrians_video_2_carla_torch.ops import flops as F
    from pedestrians_video_2_carla_torch.ops import \
        fused_spatial_transformer as FS
    from pedestrians_video_2_carla_torch.ops import \
        fused_temporal_transformer as FT
    from pedestrians_video_2_carla_torch.serving import make_inference_fn

    model = flow.movements_model
    inputs, _, meta = batches[0]
    B, L = inputs.shape[:2]
    W = L - PF_RF + 1
    with torch.no_grad():
        xs = (model.Spatial_patch_to_embedding(inputs[..., :2])
              + model.Spatial_pos_embed).reshape(B * L, PF_JOINTS, PF_EMB)
        ws = [w.detach().contiguous() for w in model.spatial_weights()]
        s = FS.fused_spatial_stack_cuda(xs, ws, PF_HEADS)
        xt = (s.reshape(B, L, PF_DIM).unfold(1, PF_RF, 1).transpose(2, 3)
              + model.Temporal_pos_embed).reshape(B * W, PF_RF, PF_DIM)
        xt = xt.contiguous()
        wt = [w.detach() for w in model.temporal_weights()[0]]

        spatial_lib = spatial_encoder_stack(ws)
        temporal_lib = encoder_layer(PF_DIM, wt)
        # the yardsticks compute the kernels' function: held to the plain
        # versions within the kernel bar before they are timed
        for name, lib, plain in (
                ("spatial", spatial_lib(xs),
                 FS.spatial_stack_reference(xs, ws, PF_HEADS)),
                ("temporal", temporal_lib(xt),
                 FT.temporal_block_reference(xt, wt, PF_HEADS))):
            _, scaled = bar_err(lib, plain)
            if scaled > KERNEL_BAR:
                raise AssertionError(f"{name} TransformerEncoderLayer vs the "
                                     f"plain version: {scaled}")

        scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                              device="cuda")

        def flush_l2():  # 256 MB write: far more than the 50 MB L2
            scratch.zero_()

        cases = {
            "spatial": (lambda: FS.fused_spatial_stack_cuda(xs, ws, PF_HEADS),
                        lambda: FS.spatial_stack_reference(xs, ws, PF_HEADS),
                        lambda: spatial_lib(xs)),
            "temporal": (lambda: FT.fused_temporal_block_cuda(xt, wt,
                                                              PF_HEADS),
                         lambda: FT.temporal_block_reference(xt, wt,
                                                             PF_HEADS),
                         lambda: temporal_lib(xt))}
        times = {}
        for name, (kernel, plain, lib) in cases.items():
            times[name] = {"ms_cold_l2": cuda_median_ms(kernel, flush=flush_l2),
                           "ms_warm_l2": cuda_median_ms(kernel),
                           "plain_ms": cuda_median_ms(plain),
                           "library_ms": cuda_median_ms(lib)}

        # row 8 against its library yardstick in alternating pairs, its
        # training forward (keep), and where a block's time goes
        pairs = paired_ms(cases["temporal"][0], cases["temporal"][2],
                          flush_l2)
        times["temporal"]["keep_ms"] = cuda_median_ms(
            lambda: FT.fused_temporal_block_cuda(xt, wt, PF_HEADS, keep=True),
            flush=flush_l2)
        split8 = launch_split(
            lambda: FT.fused_temporal_block_cuda(xt, wt, PF_HEADS), ROW8_STEPS)
        # row 4's phases: the stamps of its instrumented copy, which
        # computes the same bits
        split4, stamped = spatial_phase_split(
            *spatial_split_source(FS._SOURCE), xs, ws, PF_HEADS,
            FS.kernel_tiles(PF_JOINTS, PF_EMB, PF_HEADS, 2 * PF_EMB)[0],
            False, times["spatial"]["ms_cold_l2"])
        if not torch.equal(stamped, s):
            raise AssertionError("row 4's instrumented copy computes other "
                                 "bits than the kernel")
        del cases, spatial_lib, temporal_lib, stamped
    emit({"phase": "spatial_phase_split", "card": card, "N": xs.shape[0],
          **split4, "method": "clock64() of lane 0 of each warp at the "
          "kernel's start, after each barrier and at its end, in an "
          "instrumented copy of the source (instrument_spatial_forward), "
          "summed over the warps of live frames; each phase's share of the "
          "sum times the kernel's cold-L2 time"})

    # bounds: each input read once and each output written once, against
    # the matmul FLOPs (ops/flops.py, attention included) at the card's
    # rate for fp32-accurate products, 3xTF32 on the tensor cores; beside
    # it, each kernel's bound with all of it at the fp32 peak, and row 4's
    # with its attention at the fp32 peak (the CUDA cores it runs on)
    n_weights_s = sum(w.numel() for w in ws)
    n_weights_t = sum(w.numel() for w in wt)
    dense_s, attn_s = spatial_flops(xs.shape[0], F)
    work = {"spatial": (4 * (2 * xs.numel() + n_weights_s), dense_s + attn_s),
            "temporal": (4 * (2 * xt.numel() + n_weights_t),
                         F.transformer_block_matmul_flops(
                             xt.shape[0] * PF_RF, PF_DIM, 2.0, PF_RF))}
    for name, (nbytes, nflop) in work.items():
        t_bytes, t_flop = nbytes / hbm_rate, nflop / TF32X3_PEAK
        times[name].update(
            bytes=nbytes, flop=nflop,
            bound_ms=max(t_bytes, t_flop) * 1e3,
            bound_by="bytes" if t_bytes >= t_flop else "operations",
            bound_ms_fp32_peak=max(t_bytes, nflop / FP32_PEAK) * 1e3)
    times["spatial"].update(
        dense_flop=dense_s, attention_flop=attn_s,
        bound_ms_by_unit=max(work["spatial"][0] / hbm_rate,
                             dense_s / TF32X3_PEAK
                             + attn_s / FP32_PEAK) * 1e3)
    times["temporal"]["paired_with_library"] = pairs
    times["temporal"]["launch_split"] = split8

    infer = make_inference_fn(flow, params)
    agi = meta["age_gender_idx"]
    request = host_median_ms(lambda: infer(inputs, agi))
    request_ms = cuda_median_ms(lambda: infer(inputs, agi))

    # where a request's device time goes: the stages' kernels (a profiler
    # trace of requests), the rest (glue, LayerNorms, head, projection)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PF_TIMING_RUNS):
            infer(inputs, agi)
        torch.cuda.synchronize()
    by_stage = {"spatial": 0.0, "temporal": 0.0, "rest": 0.0}
    for e in prof.events():
        if getattr(e, "device_type", None) is None or \
                e.device_type.name != "CUDA":
            continue
        stage = "spatial" if "spatial_stack_kernel" in e.name else \
            "temporal" if any(k in e.name for k in ROW8_KERNELS) else "rest"
        by_stage[stage] += (e.time_range.end - e.time_range.start) / 1e3
    split = {"request_ms": request_ms,
             **{f"{k}_kernels_ms": v / PF_TIMING_RUNS
                for k, v in by_stage.items()}}
    emit({"phase": "timing_poseformer", "card": card, "B": B, "L": L,
          "kernels": times, "request_ms_host": request,
          "request_split": split,
          "method": "kernels, plain versions and TransformerEncoderLayer "
                    "yardsticks: CUDA events, median of %d single calls "
                    "after 3 warm-up calls, cold = 256 MB scratch write "
                    "before each call; pairs: kernel and library "
                    "alternating, cold, medians of %d each and of their "
                    "ratio; launch split: torch.profiler device times, "
                    "medians of %d calls; request: host clock to "
                    "torch.cuda.synchronize(), median of %d, and CUDA "
                    "events; split: device time of the stages' kernels "
                    "over %d profiled requests, per request"
                    % (TIMING_RUNS, TIMING_PAIRS, PF_TIMING_RUNS,
                       TIMING_RUNS, PF_TIMING_RUNS)})
    return {name: {"ms": t["ms_cold_l2"], "plain_ms": t["plain_ms"],
                   "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
                   "bound_by": t["bound_by"],
                   **{k: v for k, v in t.items()
                      if k in ("keep_ms", "bound_ms_fp32_peak",
                               "bound_ms_by_unit", "paired_with_library")}}
            for name, t in times.items()}


def spatial_flops(frames, F):
    """The spatial stack's forward FLOPs at ``frames`` frames: its dense
    products and its attention products (ops/flops.py)."""
    tokens = frames * PF_JOINTS
    dense = PF_DEPTH * F.transformer_block_matmul_flops(tokens, PF_EMB, 2.0)
    total = PF_DEPTH * F.transformer_block_matmul_flops(tokens, PF_EMB, 2.0,
                                                        PF_JOINTS)
    return dense, total - dense


def instrument_spatial_forward(text):
    """A row 4 source (this one or an earlier design's) with the phase
    stamps (SPLIT_PHASES); returns it and the forward's design."""
    for anchor in _SPLIT_SECTION + ("namespace {\n",):
        if text.count(anchor) != 1:
            raise ValueError(f"{anchor!r} is not one place of the source")
    head, rest = text.split(_SPLIT_SECTION[0])
    fwd, tail = rest.split(_SPLIT_SECTION[1])
    if fwd.count(_SPLIT_TOP) != 1:
        raise ValueError("the forward kernel's start is not one place")
    design = "warp" if "__syncwarp();" in fwd else "block"
    for barrier in ("__syncthreads();", "__syncwarp();"):
        fwd = fwd.replace(barrier, barrier + " split_stamp();")
    fwd = fwd.replace(_SPLIT_TOP, _SPLIT_TOP + (
        "  if ((threadIdx.x & 31) == 0) g_split_i[threadIdx.x >> 5] = 0;\n"
        "  split_stamp();\n"))
    end = fwd.rindex("\n}")
    fwd = fwd[:end] + "\n  split_stamp();" + fwd[end:]
    head = head.replace("namespace {\n", "namespace {\n" + _SPLIT_HELPERS)
    return (head + _SPLIT_SECTION[0] + fwd + _SPLIT_SECTION[1] + tail
            + _SPLIT_SET, design)


def spatial_split_source(source):
    """The instrumented copy of row 4's ``source`` (with the headers it
    includes) under build/spatial_split/; returns its path and the
    forward's design."""
    from pedestrians_video_2_carla_torch.ops import cuda_build

    text, design = instrument_spatial_forward(source.read_text())
    d = cuda_build.BUILD_DIR.parent / "spatial_split"
    d.mkdir(parents=True, exist_ok=True)
    copy = d / source.name
    copy.write_text(text)
    for header in cuda_build._local_headers(source):
        shutil.copy(header, d / header.name)
    return copy, design


def spatial_library(source):
    """ctypes handle of the library built from a row 4 source (this one,
    an earlier design's or an instrumented copy; their C entry is the
    same)."""
    from pedestrians_video_2_carla_torch.ops import cuda_build
    from pedestrians_video_2_carla_torch.ops import \
        fused_spatial_transformer as FS

    lib = ctypes.CDLL(str(cuda_build.build_library(source)))
    lib.pv2c_fused_spatial_stack.argtypes = FS._SIGNATURES[
        "pv2c_fused_spatial_stack"]
    return lib


def spatial_launch(lib, x, ws, heads, frames, keep):
    """One launch of a row 4 library's C entry at ``frames`` frames a
    thread block (with ``keep``, into fresh residuals); returns the
    output."""
    from pedestrians_video_2_carla_torch.ops import cuda_build
    from pedestrians_video_2_carla_torch.ops import \
        fused_spatial_transformer as FS

    N, J, E = x.shape
    depth, hidden = ws[0].shape[0], ws[8].shape[1]
    out = torch.empty_like(x)
    saved = [torch.empty(s, dtype=torch.float32, device="cuda")
             for s in FS.saved_shapes(depth, N * J, E, hidden)] if keep \
        else [None] * 6
    cuda_build.check_launch(lib.pv2c_fused_spatial_stack(
        x.data_ptr(), out.data_ptr(), *(w.data_ptr() for w in ws),
        *(t if t is None else t.data_ptr() for t in saved), N, J, E, heads,
        hidden, depth, frames, float(E // heads) ** -0.5,
        torch.cuda.current_stream().cuda_stream), "pv2c_fused_spatial_stack")
    return out


def spatial_phase_split(copy, design, x, ws, heads, frames, keep, ms):
    """Row 4's phases: one launch of the library of the instrumented
    ``copy`` (spatial_split_source) with the stamps on; each phase's cycles
    summed over the warps of live frames and over depth blocks, its share
    of all, and that share of ``ms``. Returns that and the launch's
    output."""
    from pedestrians_video_2_carla_torch.ops import cuda_build

    lib = spatial_library(copy)
    lib.pv2c_split_set.argtypes = [cuda_build.PTR]
    grid = (x.shape[0] + frames - 1) // frames
    clk = torch.zeros((grid * 32, SPLIT_SLOTS), dtype=torch.int64,
                      device="cuda")
    cuda_build.check_launch(lib.pv2c_split_set(clk.data_ptr()),
                            "pv2c_split_set")
    out = spatial_launch(lib, x, ws, heads, frames, keep)
    torch.cuda.synchronize()
    cuda_build.check_launch(lib.pv2c_split_set(None), "pv2c_split_set")
    names = (["load"] + list(SPLIT_PHASES[design][keep]) * ws[0].shape[0]
             + ["final_ln", "store"])
    stamps = len(names) + 1
    if bool((clk[:, stamps:] != 0).any()):
        raise AssertionError(f"more than {stamps} stamps a warp: "
                             f"SPLIT_PHASES does not match {copy}")
    full = clk[(clk[:, :stamps] != 0).all(1), :stamps]
    cycles = {}
    for name, c in zip(names, torch.diff(full, dim=1).sum(0).tolist()):
        cycles[name] = cycles.get(name, 0) + c
    total = sum(cycles.values())
    return {"design": design, "keep": keep, "warps": full.shape[0],
            "cycles": cycles,
            "share": {k: c / total for k, c in cycles.items()},
            "ms": {k: ms * c / total for k, c in cycles.items()}}, out


def check_grads(phase, what, n, names, got, again, ref, **extra):
    """Each gradient against autograd of the plain version (over its
    largest magnitude: rtol 1e-4, atol 1e-5) and a second launch's bits;
    emits the worst (with ``extra``) and returns the largest absolute
    error."""
    torch.cuda.synchronize()
    scaled, errs, bad = {}, {}, []
    for name, a, r in zip(names, got, ref):
        scaled[name], ok = scaled_err(a, r)
        errs[name] = float((a - r).abs().max())
        if not (ok and torch.isfinite(a).all()):
            bad.append(name)
    same = again is None or all(torch.equal(a, b) for a, b in zip(got, again))
    emit({"phase": phase, "entry": what, "N": n,
          "max_scaled_err": max(scaled.values()),
          "worst": max(scaled, key=scaled.get),
          "max_abs_err": max(errs.values()), "scaled_err": scaled,
          "same_bits_twice": same, **extra})
    if bad or not same:
        raise AssertionError(
            f"{what} backward at N={n}: {bad} outside rtol {GRAD_RTOL} / "
            f"atol {GRAD_ATOL} of autograd of the plain version ({scaled}); "
            f"same bits twice: {same}")
    return max(errs.values())


def plain_grads(fn, inputs, g):
    """Autograd of ``fn`` over fresh leaves of ``inputs``, cotangent g."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    return torch.autograd.grad(fn(leaves), leaves, g)


def phase_kernel_spatial_bwd():
    from pedestrians_video_2_carla_torch.ops import \
        fused_spatial_transformer as FS

    rng = np.random.default_rng(SEED + 5)
    weights = {}
    worst = 0.0
    for n, emb, heads in spatial_cases(SPATIAL_BWD_NS, SPATIAL_WIDE_NS):
        if emb not in weights:
            weights[emb] = random_spatial_weights(rng, emb)
        ws = weights[emb]
        x, g = (torch.from_numpy(rng.standard_normal(
            (n, PF_JOINTS, emb)).astype(np.float32)).cuda()
            for _ in range(2))
        # from the residuals the training forward keeps
        _, saved = FS.fused_spatial_stack_cuda(x, ws, heads, keep=True)
        dx, dws = FS.fused_spatial_stack_cuda_bwd(x, ws, saved, g, heads)
        dx2, dws2 = FS.fused_spatial_stack_cuda_bwd(x, ws, saved, g, heads)
        del saved
        ref = plain_grads(lambda t: FS.spatial_stack_reference(
            t[0], t[1:], heads), [x, *ws], g)
        err = check_grads(
            "kernel_spatial_bwd", f"fused_spatial_stack_cuda_bwd E={emb} "
            f"heads={heads}", n, SPATIAL_NAMES, [dx, *dws], [dx2, *dws2],
            ref)
        if emb == PF_EMB and heads == PF_HEADS:
            worst = max(worst, err)
    return worst


def phase_kernel_temporal_bwd():
    from pedestrians_video_2_carla_torch.ops import \
        fused_temporal_transformer as FT

    rng = np.random.default_rng(SEED + 6)
    blocks = [random_block_weights(rng, PF_DIM) for _ in range(PF_DEPTH)]
    names = SPATIAL_NAMES[:13]
    worst = 0.0
    for n in TEMPORAL_BWD_NS:
        x, g = (torch.from_numpy(rng.standard_normal(
            (n, PF_RF, PF_DIM)).astype(np.float32)).cuda() for _ in range(2))
        _, saved = FT.fused_temporal_block_cuda(x, blocks[0], PF_HEADS,
                                                keep=True)
        dx, dws = FT.fused_temporal_block_cuda_bwd(x, blocks[0], saved, g,
                                                   PF_HEADS)
        dx2, dws2 = FT.fused_temporal_block_cuda_bwd(x, blocks[0], saved, g,
                                                     PF_HEADS)
        del saved
        ref = plain_grads(lambda t: FT.temporal_block_reference(
            t[0], t[1:], PF_HEADS), [x, *blocks[0]], g)
        worst = max(worst, check_grads(
            "kernel_temporal_bwd", "fused_temporal_block_cuda_bwd", n, names,
            [dx, *dws], [dx2, *dws2], ref))
        del ref
    # PoseFormer's published receptive fields (F1)
    for T in WIDE_TS:
        for n in WIDE_NS:
            x, g = (torch.from_numpy(rng.standard_normal(
                (n, T, PF_DIM)).astype(np.float32)).cuda() for _ in range(2))
            _, saved = FT.fused_temporal_block_cuda(x, blocks[0], PF_HEADS,
                                                    keep=True)
            dx, dws = FT.fused_temporal_block_cuda_bwd(x, blocks[0], saved, g,
                                                       PF_HEADS)
            dx2, dws2 = FT.fused_temporal_block_cuda_bwd(x, blocks[0], saved,
                                                         g, PF_HEADS)
            del saved
            ref = plain_grads(lambda t: FT.temporal_block_reference(
                t[0], t[1:], PF_HEADS), [x, *blocks[0]], g)
            check_grads("kernel_temporal_bwd",
                        f"fused_temporal_block_cuda_bwd T={T}", n, names,
                        [dx, *dws], [dx2, *dws2], ref)
    # autograd through the depth-4 stack: kernel forward and backward
    n = TEMPORAL_BWD_NS[0]
    x, g = (torch.from_numpy(rng.standard_normal(
        (n, PF_RF, PF_DIM)).astype(np.float32)).cuda() for _ in range(2))
    flat = [x] + [w for ws in blocks for w in ws]

    def unflat(t):
        return t[0], [t[1 + 12 * b:13 + 12 * b] for b in range(PF_DEPTH)]
    got = plain_grads(lambda t: FT.fused_temporal_stack(*unflat(t),
                                                        PF_HEADS), flat, g)
    ref = plain_grads(lambda t: plain_temporal_stack(*unflat(t), PF_HEADS),
                      flat, g)
    stack_names = ["x"] + [f"{b}.{k}" for b in range(PF_DEPTH)
                           for k in names[1:]]
    worst = max(worst, check_grads(
        "kernel_temporal_bwd", "fused_temporal_stack (autograd)", n,
        stack_names, got, None, ref))
    return worst


def make_pf_train_flow(precision="32"):
    from pedestrians_video_2_carla_torch.flows.pose_lifting import \
        PoseLiftingFlow
    from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
    from pedestrians_video_2_carla_torch.models.movements.pose_former import \
        PoseFormer

    model = PoseFormer(clip_length=CLIP,
                       generator=torch.Generator().manual_seed(SEED))
    return PoseLiftingFlow(model, loss_modes=["loc_2d_3d"],
                           movements_optimizer=OptimizerSettings(lr=LR),
                           precision=precision)


def phase_train_poseformer(dm):
    """PoseFormer's training path through the port's Trainer, then the
    per-step agreement of the kernel stages and the plain ones."""
    from pedestrians_video_2_carla_torch.training.trainer import (
        Trainer, TrainerConfig)

    flow = make_pf_train_flow()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(flow, dm, TrainerConfig(
            max_epochs=1, limit_train_batches=PF_TRAIN_STEPS,
            limit_val_batches=VAL_BATCHES, log_every_n_steps=1, seed=SEED,
            logs_dir=tmp, run_name="pf"))
        reset_kernel_counts()
        t0 = time.perf_counter()
        state = trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = kernel_counts()
        batches = PF_TRAIN_STEPS + VAL_BATCHES
        expected = expected_counts(
            fused_spatial_stack=batches,
            fused_temporal_block=PF_DEPTH * batches,
            fused_spatial_stack_bwd=PF_TRAIN_STEPS,
            fused_temporal_block_bwd=PF_DEPTH * PF_TRAIN_STEPS)
        if counts != expected:
            raise AssertionError(f"PoseFormer train launches {counts}, "
                                 f"expected {expected}")
        run = os.path.join(tmp, "pf")
        ckpts = os.path.join(run, "checkpoints")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        bad = {k: v for r in records for k, v in r.items()
               if "_loss/" in k and not np.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite logged losses {bad}")
        steps = [r["train_loss/primary"] for r in records
                 if "lr-movements" in r]
        if len(steps) != PF_TRAIN_STEPS:
            raise AssertionError(f"{len(steps)} step records, expected "
                                 f"{PF_TRAIN_STEPS}")
        if not max(steps[-3:]) < steps[0]:
            raise AssertionError(f"train loss did not fall: {steps}")
        val = records[-1]["val_loss/primary"]
        restored = flow.init_state()
        trainer.checkpoints.restore(restored, os.path.join(ckpts, "last"))
        opt, opt_back = (st.optimizer.state_dict()["state"]
                         for st in (state, restored))
        same = all(torch.equal(restored.params[n][k], v)
                   for n, tree in state.params.items()
                   for k, v in tree.items()) and all(
            torch.equal(torch.as_tensor(v), torch.as_tensor(opt_back[i][k]))
            for i, st in opt.items() for k, v in st.items())
        if not (same and restored.step == state.step == PF_TRAIN_STEPS):
            raise AssertionError("the last checkpoint does not restore the "
                                 "trained params and AdamW state")
        del state, restored, trainer

    # the kernel stages and the plain ones, step by step from the same params
    # over the fit's batches
    params = flow.init_params()
    states = {"kernels": flow.init_state(params),
              "plain": flow.init_state(params)}
    stream = dm.train_batches(SEED)
    worst, per_step = 0.0, []
    for _ in range(PF_TRAIN_STEPS):
        batch = next(stream)
        _, logs_k = flow.training_step(states["kernels"], batch)
        with stage_routes(flow.movements_model, "plain"):
            _, logs_p = flow.training_step(states["plain"], batch)
        row = {}
        for k in logs_p:
            a, b = float(logs_k[k]), float(logs_p[k])
            rel = abs(a - b) / abs(b)
            if not rel <= LOSS_RTOL:
                raise AssertionError(f"{k}: kernels {a} vs plain {b}")
            worst = max(worst, rel)
            row[k] = [a, b]
        per_step.append(row)
    emit({"phase": "train_poseformer", "B": BATCH, "L": CLIP,
          "steps": PF_TRAIN_STEPS, "val_batches": VAL_BATCHES,
          "launches": counts, "fit_seconds": fit_s,
          "train_loss_primary": steps, "val_loss_primary": val,
          "restored_equal": same, "kernels_vs_plain_losses": per_step,
          "kernels_vs_plain_max_rel": worst})
    return counts


def train_step_split(flow, state, batch, runs=PF_TIMING_RUNS):
    """A CUDA-event split of a PoseFormer step: the body of
    BaseFlow.training_step with events between its parts, and around the
    stages' autograd backward; medians of ``runs``."""
    from pedestrians_video_2_carla_torch.losses import primary_loss
    from pedestrians_video_2_carla_torch.ops import \
        fused_spatial_transformer as FS
    from pedestrians_video_2_carla_torch.ops import \
        fused_temporal_transformer as FT

    marks = {"spatial": [], "temporal": []}

    def timed(name, fn):
        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            marks[name].append((start, end))
            return out
        return run
    classes = (FS.FusedSpatialStack, FT.FusedTemporalBlock)
    saved_fns = [cls.backward for cls in classes]
    for cls, name, fn in zip(classes, ("spatial", "temporal"), saved_fns):
        cls.backward = staticmethod(timed(name, fn))
    splits = []
    try:
        for _ in range(runs):
            for v in marks.values():
                v.clear()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            sliced = flow._inner_step(state.params, batch, training=True)
            losses = flow._compute_losses(sliced, sliced["targets"])
            _, primary = primary_loss(losses, flow.requested_loss_modes)
            ev[1].record()
            state.optimizer.zero_grad(set_to_none=True)
            primary.backward()
            ev[2].record()
            state.optimizer.step()
            ev[3].record()
            ev[3].synchronize()
            sp = sum(a.elapsed_time(b) for a, b in marks["spatial"])
            tp = sum(a.elapsed_time(b) for a, b in marks["temporal"])
            total = ev[0].elapsed_time(ev[3])
            fwd = ev[0].elapsed_time(ev[1])
            splits.append((total, fwd, sp, tp, total - fwd - sp - tp,
                           ev[1].elapsed_time(ev[2]) - sp - tp,
                           ev[2].elapsed_time(ev[3])))
    finally:
        for cls, fn in zip(classes, saved_fns):
            cls.backward = staticmethod(fn)
    return dict(zip(("step_ms", "forward_ms", "spatial_backward_ms",
                     "temporal_backward_ms", "rest_ms",
                     "rest_of_backward_ms", "adamw_ms"),
                    (statistics.median(c) for c in zip(*splits))))


def phase_timing_poseformer_train(dm, card, hbm_rate):
    from pedestrians_video_2_carla_torch.ops import flops as F
    from pedestrians_video_2_carla_torch.ops import \
        fused_spatial_transformer as FS
    from pedestrians_video_2_carla_torch.ops import \
        fused_temporal_transformer as FT

    flow = make_pf_train_flow()
    model = flow.movements_model
    batch = next(dm.train_batches(SEED + 7))
    inputs = batch[0]
    B, L = inputs.shape[:2]
    W = L - PF_RF + 1
    rng = np.random.default_rng(SEED + 8)

    def randn(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()

    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def flush_l2():  # 256 MB write: far more than the 50 MB L2
        scratch.zero_()

    with torch.no_grad():
        xs = (model.Spatial_patch_to_embedding(inputs[..., :2])
              + model.Spatial_pos_embed).reshape(B * L, PF_JOINTS, PF_EMB)
        ws = [w.detach().contiguous() for w in model.spatial_weights()]
        # row 4's training forward, which writes the backward's residuals
        keep_ms = cuda_median_ms(lambda: FS.fused_spatial_stack_cuda(
            xs, ws, PF_HEADS, keep=True), flush=flush_l2)
        s, saved_s = FS.fused_spatial_stack_cuda(xs, ws, PF_HEADS, keep=True)
        xt = (s.reshape(B, L, PF_DIM).unfold(1, PF_RF, 1).transpose(2, 3)
              + model.Temporal_pos_embed).reshape(B * W, PF_RF, PF_DIM)
        xt = xt.contiguous()
        wt = [w.detach() for w in model.temporal_weights()[0]]
        _, saved = FT.fused_temporal_block_cuda(xt, wt, PF_HEADS, keep=True)
    # its bound: the residuals it writes, against its FLOPs at the 3xTF32
    # rate
    dense_s, attn_s = spatial_flops(xs.shape[0], F)
    keep_bytes = 4 * (2 * xs.numel() + sum(w.numel() for w in ws)
                      + sum(t.numel() for t in saved_s))
    keep_t = (keep_bytes / hbm_rate, (dense_s + attn_s) / TF32X3_PEAK)
    keep = {"ms": keep_ms, "bytes": keep_bytes, "flop": dense_s + attn_s,
            "bound_ms": max(keep_t) * 1e3,
            "bound_by": "bytes" if keep_t[0] >= keep_t[1] else "operations"}
    gs, gt = randn(tuple(xs.shape)), randn(tuple(xt.shape))

    def graph(fn, inputs):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        return fn(leaves), leaves
    plain_s = graph(lambda t: FS.spatial_stack_reference(t[0], t[1:],
                                                         PF_HEADS), [xs, *ws])
    plain_t = graph(lambda t: FT.temporal_block_reference(t[0], t[1:],
                                                          PF_HEADS), [xt, *wt])
    spatial_lib = spatial_encoder_stack(ws)
    temporal_lib = encoder_layer(PF_DIM, wt)
    lib_s = graph(lambda t: spatial_lib(t[0]), [xs])
    lib_t = graph(lambda t: temporal_lib(t[0]), [xt])
    lib_s = (lib_s[0], lib_s[1] + list(spatial_lib.parameters()))
    lib_t = (lib_t[0], lib_t[1] + list(temporal_lib.parameters()))

    def backward_of(out_leaves, g):
        out, leaves = out_leaves
        return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)
    cases = {
        "spatial": (lambda: FS.fused_spatial_stack_cuda_bwd(xs, ws, saved_s,
                                                            gs, PF_HEADS),
                    backward_of(plain_s, gs), backward_of(lib_s, gs)),
        "temporal": (lambda: FT.fused_temporal_block_cuda_bwd(
            xt, wt, saved, gt, PF_HEADS),
                     backward_of(plain_t, gt), backward_of(lib_t, gt))}
    times = {}
    for name, (kernel, plain, lib) in cases.items():
        times[name] = {"ms_cold_l2": cuda_median_ms(kernel, flush=flush_l2),
                       "ms_warm_l2": cuda_median_ms(kernel),
                       "plain_ms": cuda_median_ms(plain),
                       "library_ms": cuda_median_ms(lib)}
    # kernel and library yardstick in alternating pairs (ROADMAP K0)
    pairs = {name: paired_ms(kernel, lib, flush_l2)
             for name, (kernel, _, lib) in cases.items()}
    times["temporal"]["launch_split"] = launch_split(cases["temporal"][0],
                                                     ROW9_STEPS)
    del cases, plain_s, plain_t, lib_s, lib_t

    # bounds: inputs read once (x, g, the weights, the saved residuals of
    # the forward), outputs written once (dx, the weight gradients), against
    # the backward's matmul FLOPs (ops/flops.py) at the peak of the units
    # the products run on: the fp32 CUDA cores (spatial), 3xTF32 in the
    # tensor cores (temporal)
    n_ws = sum(w.numel() for w in ws)
    n_wt = sum(w.numel() for w in wt)
    work = {"spatial": (4 * (3 * xs.numel() + sum(t.numel() for t in saved_s)
                             + 2 * n_ws),
                        PF_DEPTH * F.transformer_block_backward_flops(
                            xs.shape[0] * PF_JOINTS, PF_EMB, 2.0, PF_JOINTS)),
            "temporal": (4 * (3 * xt.numel() + sum(t.numel() for t in saved)
                              + 2 * n_wt),
                         F.transformer_block_backward_flops(
                             xt.shape[0] * PF_RF, PF_DIM, 2.0, PF_RF))}
    peaks = {"spatial": FP32_PEAK, "temporal": TF32X3_PEAK}
    for name, (nbytes, nflop) in work.items():
        t_bytes, t_flop = nbytes / hbm_rate, nflop / peaks[name]
        times[name].update(
            bytes=nbytes, flop=nflop, peak_flop_per_s=peaks[name],
            bound_ms=max(t_bytes, t_flop) * 1e3,
            bound_by="bytes" if t_bytes >= t_flop else "operations")
    del saved, saved_s

    state = flow.init_state()
    step_ms = host_median_ms(lambda: flow.training_step(state, batch),
                             runs=PF_TIMING_RUNS)

    split = train_step_split(flow, state, batch)
    emit({"phase": "timing_poseformer_train", "card": card, "B": B, "L": L,
          "backward_kernels": times, "kernel_vs_library_pairs": pairs,
          "spatial_forward_keep": keep,
          "train_step_ms_host": step_ms,
          "train_step_split_cuda_events": split,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "method": "backward kernels, autograd of the plain versions and "
                    "of TransformerEncoderLayer yardsticks (timed around "
                    "torch.autograd.grad alone): CUDA events, median of %d "
                    "single calls after 3 warm-up calls, cold = 256 MB "
                    "scratch write before each call; train step: host clock "
                    "to torch.cuda.synchronize(), median of %d; split: the "
                    "body of training_step with CUDA events between its "
                    "parts and around each stage's autograd backward, "
                    "medians of %d; pairs: kernel and library alternating, "
                    "cold, medians of %d each and of their ratio"
                    % (TIMING_RUNS, PF_TIMING_RUNS, PF_TIMING_RUNS,
                       TIMING_PAIRS)})
    out = {name: {"ms": t["ms_cold_l2"], "plain_ms": t["plain_ms"],
                  "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
                  "bound_by": t["bound_by"]} for name, t in times.items()}
    out["spatial_keep"] = keep
    return out


def phase_poseformer_rf81():
    """PoseFormer at its published receptive field of 81 frames (fault F1 of
    the temporal kernels' 16-token limit): requests and training steps
    through the kernels, held to the plain route."""
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule
    from pedestrians_video_2_carla_torch.flows.pose_lifting import \
        PoseLiftingFlow
    from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
    from pedestrians_video_2_carla_torch.models.movements.pose_former import \
        PoseFormer
    from pedestrians_video_2_carla_torch.serving import make_inference_fn

    model = PoseFormer(clip_length=RF81_CLIP, receptive_frames=RF81_RF,
                       generator=torch.Generator().manual_seed(SEED))
    flow = PoseLiftingFlow(model, loss_modes=["loc_2d_3d"],
                           movements_optimizer=OptimizerSettings(lr=LR))
    dm = Carla2D3DDataModule(batch_size=RF81_BATCH, clip_length=RF81_CLIP,
                             test_set_size=RF81_REQUESTS * RF81_BATCH,
                             seed=SEED)
    batches = list(dm.test_batches())
    params = flow.init_params()
    infer = make_inference_fn(flow, params)
    reset_kernel_counts()
    served = [infer(inputs, meta["age_gender_idx"])
              for inputs, _, meta in batches]
    torch.cuda.synchronize()
    serve_counts = kernel_counts()
    expected = expected_counts(
        fused_spatial_stack=RF81_REQUESTS,
        fused_temporal_block=PF_DEPTH * RF81_REQUESTS)
    if serve_counts != expected:
        raise AssertionError(f"rf 81 serving launches {serve_counts}, "
                             f"expected {expected}")
    # outputs finite over the eval slice (one frame a clip), their distance
    # to the plain stages' reported; eval_step's losses held to rtol 1e-4
    errs = {}
    with stage_routes(model, "plain"):
        for preds, (inputs, _, meta) in zip(served, batches):
            ref = infer(inputs, meta["age_gender_idx"])
            for k, v in preds.items():
                if v.shape[:2] != (RF81_BATCH, 1) or \
                        not torch.isfinite(v).all():
                    raise AssertionError(f"rf 81 {k}: shape "
                                         f"{tuple(v.shape)} or not finite")
                errs[k] = max(errs.get(k, 0.0),
                              float((v - ref[k]).abs().max()))
        plain_losses = [float(flow.eval_step(params, b)[0]["loc_2d_3d"])
                        for b in batches]
    eval_losses = []
    for batch, b in zip(batches, plain_losses):
        a = float(flow.eval_step(params, batch)[0]["loc_2d_3d"])
        if not (np.isfinite(a) and abs(a - b) <= LOSS_RTOL * abs(b)):
            raise AssertionError(f"rf 81 eval loc_2d_3d kernels {a} vs plain "
                                 f"{b}")
        eval_losses.append([a, b])

    states = {"kernels": flow.init_state(params),
              "plain": flow.init_state(params)}
    stream = dm.train_batches(SEED)
    reset_kernel_counts()
    per_step, worst = [], 0.0
    for _ in range(RF81_STEPS):
        batch = next(stream)
        _, logs_k = flow.training_step(states["kernels"], batch)
        with stage_routes(model, "plain"):
            _, logs_p = flow.training_step(states["plain"], batch)
        row = {}
        for k in logs_p:
            a, b = float(logs_k[k]), float(logs_p[k])
            rel = abs(a - b) / abs(b)
            if not (np.isfinite(a) and rel <= LOSS_RTOL):
                raise AssertionError(f"rf 81 {k}: kernels {a} vs plain {b}")
            worst = max(worst, rel)
            row[k] = [a, b]
        per_step.append(row)
    torch.cuda.synchronize()
    train_counts = kernel_counts()
    expected = expected_counts(
        fused_spatial_stack=RF81_STEPS,
        fused_temporal_block=PF_DEPTH * RF81_STEPS,
        fused_spatial_stack_bwd=RF81_STEPS,
        fused_temporal_block_bwd=PF_DEPTH * RF81_STEPS)
    if train_counts != expected:
        raise AssertionError(f"rf 81 training launches {train_counts}, "
                             f"expected {expected}")
    emit({"phase": "poseformer_rf81", "B": RF81_BATCH, "L": RF81_CLIP,
          "receptive_frames": RF81_RF, "requests": RF81_REQUESTS,
          "serve_launches": serve_counts, "max_abs_err_vs_plain": errs,
          "eval_loc_2d_3d_kernels_vs_plain": eval_losses,
          "steps": RF81_STEPS, "train_launches": train_counts,
          "kernels_vs_plain_losses": per_step,
          "kernels_vs_plain_max_rel": worst})


#: kernel names (substrings of the profiler's) of rows 5 and 9
ROW5_KERNELS = ("spatial_final_ln_bwd_kernel", "spatial_mlp_bwd_kernel",
                "spatial_attn_bwd_kernel", "reduce_partials_kernel")
ROW9_KERNELS = ("gemm_bwd_kernel", "ln_apply_kernel", "ln_bwd_rows_kernel",
                "attention_bwd_kernel", "reduce_segments_kernel")


def profile_steps(step):
    """A torch.profiler trace of PROFILE_STEPS calls of ``step`` after 2
    warm-up calls: the traced window, the device busy share (the union of
    the device kernels' intervals over the window from the first to the
    last event), the device time by operation name, and a function giving
    the share of the window taken by the operations whose names hold any
    of the given strings."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
    events = list(prof.events())
    device = [e for e in events
              if getattr(e, "device_type", None) is not None
              and e.device_type.name == "CUDA"]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    window_us = t1 - t0
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]

    def share(names):
        return sum(v for k, v in by_name.items()
                   if any(n in k for n in names)) / max(window_us, 1e-9)
    return {"steps": PROFILE_STEPS, "window_ms": window_us / 1e3,
            "device_events": len(device),
            "device_busy_share": busy / window_us if device else None,
            "device_ms": sum(by_name.values()) / 1e3,
            "top_device_ops_ms": [[k[:80], v / 1e3] for k, v in top],
            "method": "torch.profiler (CPU and CUDA activities) around %d "
                      "steps after 2 warm-up steps; busy share: union of the "
                      "device events' intervals over the window from the "
                      "first to the last event; row shares: their kernels' "
                      "device time over that window" % PROFILE_STEPS}, share


def phase_profile_poseformer_train(dm, card):
    """A torch.profiler trace of PoseFormer training_steps at B=1024, L=16:
    busy share, top device operations, the share of rows 5 and 9."""
    flow = make_pf_train_flow()
    state = flow.init_state()
    batch = next(dm.train_batches(SEED + 9))
    trace, share = profile_steps(lambda: flow.training_step(state, batch))
    emit({"phase": "profile_poseformer_train", "card": card, "B": BATCH,
          "L": CLIP, **trace,
          "row5_spatial_bwd_share": share(ROW5_KERNELS),
          "row8_temporal_fwd_share": share(ROW8_KERNELS),
          "row9_temporal_bwd_share": share(ROW9_KERNELS)})


def graph_case(rng, cell, shape):
    """Seeded inputs of one scan call on the card: xg, the Chebyshev
    matrices of GConvGRU's operator (none for k=1 or the dense form), the
    hidden-side weights, and one cotangent per output."""
    from pedestrians_video_2_carla_torch.models.classification.gnn import \
        laplacian_op
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG
    from pedestrians_video_2_carla_torch.skeletons.carla import CARLA_SKELETON

    B, L, J, H, k = shape
    op = laplacian_op(CARLA_SKELETON) if J == CLS_J else np.zeros((J, J))
    cheb = torch.from_numpy(FG.cheb_matrices(op, k)).cuda()

    def randn(*s, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(s)).astype(
            np.float32)).cuda()
    gates, groups = (3, (2, 1)) if cell == "gru" else (4, (4,))
    xg = randn(L, B, J, gates * H)
    weights = [randn(H, k * g * H, scale=H ** -0.5) for g in groups]
    cots = [randn(L, B, J, H) for _ in range(1 if cell == "gru" else 2)]
    return xg, cheb, weights, cots


def scan_functions(cell):
    """(kernel forward -> tuple of outputs, plain version -> tuple)."""
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG
    if cell == "gru":
        return (lambda xg, cheb, *w: (FG.graph_gru_scan_cuda_fwd(
                    xg, cheb, *w),),
                lambda xg, cheb, *w: (FG.graph_gru_scan_reference(
                    xg, cheb, *w),))
    return FG.graph_lstm_scan_cuda_fwd, FG.graph_lstm_scan_reference


def gru_plan(shape, backward, rings):
    """The GRU kernel's launch plan at ``shape`` (clips a thread block,
    weight ring width, shared memory bytes); its ring width goes into
    ``rings``."""
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG

    B, _, J, H, k = shape
    plan = FG.graph_gru_plan(B, J, H, k, backward)
    rings.add(plan[1])
    return {"plan_clips_ring_smem": plan}


def check_gru_rings(phase, rings):
    if rings != GRU_RINGS:
        raise AssertionError(f"{phase} ran the weight rings {sorted(rings)}, "
                             f"expected {sorted(GRU_RINGS)}")


def lstm_plan(shape, backward, tilings):
    """The graph-form LSTM kernel's launch plan at ``shape`` (clips a thread
    block, ring width, shared memory bytes, rows of a block tile); its
    tiling (ring width, rows) goes into ``tilings``."""
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG

    B, _, J, H, k = shape
    plan = FG.graph_lstm_plan(B, J, H, k, backward)
    tilings.add((plan[1], plan[3]))
    return {"plan_clips_ring_smem_rows": plan}


def check_lstm_tilings(phase, which, tilings):
    if tilings != LSTM_TILINGS[which]:
        raise AssertionError(f"{phase} ran the tilings {sorted(tilings)}, "
                             f"expected {sorted(LSTM_TILINGS[which])}")


def phase_kernel_graph(cell):
    """The forward kernels against their plain versions at every
    GRAPH_SHAPES entry and at wider shapes (every weight ring, every
    tiling), and the training forward (``keep``): its outputs and its
    residuals against the plain forward with residuals."""
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG

    rng = np.random.default_rng(SEED + (9 if cell == "gru" else 10))
    kernel, plain = scan_functions(cell)
    worst, tilings = 0.0, set()
    wide = (GRU_WIDE_SHAPES + GRU_WIDE_FORWARD_SHAPES if cell == "gru" else
            LSTM_WIDE_SHAPES + LSTM_WIDE_FORWARD_SHAPES)
    for shape in GRAPH_SHAPES + wide:
        xg, cheb, weights, _ = graph_case(rng, cell, shape)
        with torch.no_grad():
            outs = kernel(xg, cheb, *weights)
            refs = plain(xg, cheb, *weights)
            if cell == "gru":
                ys, res = FG.graph_gru_scan_cuda_fwd(xg, cheb, *weights,
                                                     keep=True)
                ref_ys, ref_res = FG.graph_gru_scan_keep_reference(
                    xg, cheb, *weights)
                outs, refs = (*outs, ys, *res), (*refs, ref_ys, *ref_res)
                plan = gru_plan(shape, False, tilings)
            else:
                *kept, res = FG.graph_lstm_scan_cuda_fwd(xg, cheb, *weights,
                                                         keep=True)
                *ref_kept, ref_res = FG.graph_lstm_scan_keep_reference(
                    xg, cheb, *weights)
                outs = (*outs, *kept, *res)
                refs = (*refs, *ref_kept, *ref_res)
                plan = lstm_plan(shape, False, tilings)
        torch.cuda.synchronize()
        errs = [float((o - r).abs().max()) for o, r in zip(outs, refs)]
        err = max(errs)
        finite = all(bool(torch.isfinite(o).all()) for o in outs)
        kept_names = "ys_gates_sa_sb" if cell == "gru" else "ys_cs_gates_sa"
        emit({"phase": f"kernel_graph_{cell}", "B_L_J_H_k": shape,
              "max_abs_err": err, "finite": finite,
              f"keep_{kept_names}_err": errs[1 if cell == "gru" else 2:],
              **plan})
        if not (err <= SCAN_BAR and finite):
            raise AssertionError(f"graph-{cell} scan kernel disagrees with "
                                 f"its plain version at {shape}: {errs}")
        worst = max(worst, err)
    if cell == "gru":
        check_gru_rings("kernel_graph_gru", tilings)
    else:
        check_lstm_tilings("kernel_graph_lstm", "fwd", tilings)
    return worst


def phase_kernel_graph_bwd(cell):
    """The backward kernels, from the residuals of the training forward
    kernel, against autograd of the plain versions (the LSTM with and
    without the cell states' cotangent, and also against its plain backward
    from the same residuals), at GRAPH_SHAPES and the wider shapes."""
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG

    rng = np.random.default_rng(SEED + (11 if cell == "gru" else 12))
    _, plain = scan_functions(cell)
    worst, tilings = 0.0, set()
    wide = GRU_WIDE_SHAPES if cell == "gru" else LSTM_WIDE_SHAPES
    for shape in GRAPH_SHAPES + wide:
        xg, cheb, weights, cots = graph_case(rng, cell, shape)
        with torch.no_grad():
            if cell == "gru":
                _, res = FG.graph_gru_scan_cuda_fwd(xg, cheb, *weights,
                                                    keep=True)
                plan = gru_plan(shape, True, tilings)
            else:
                _, cs, res = FG.graph_lstm_scan_cuda_fwd(xg, cheb, *weights,
                                                         keep=True)
                plan = lstm_plan(shape, True, tilings)
        for used in ((1,) if cell == "gru" else (2, 1)):
            dcs = cots[1] if used == 2 else None

            def launch():
                if cell == "gru":
                    return FG.graph_gru_scan_cuda_bwd(cheb, *weights, res,
                                                      cots[0])
                return FG.graph_lstm_scan_cuda_bwd(cheb, *weights, res, cs,
                                                   cots[0], dcs)
            got, again = launch(), launch()
            ref = plain_grads(lambda t: plain(t[0], cheb, *t[1:])[:used],
                              [xg, *weights], cots[:used])
            names = ("dxg", "dwzr", "dwh") if cell == "gru" else ("dxg", "dw")
            extra = dict(plan)
            if cell == "lstm":  # the same residuals through the plain backward
                from_res = FG.graph_lstm_scan_bwd_reference(
                    cheb, *weights, res, cs, cots[0], dcs)
                extra["vs_plain_from_residuals_scaled_err"] = {
                    n: scaled_err(a, r)[0]
                    for n, a, r in zip(names, got, from_res)}
                if not all(scaled_err(a, r)[1]
                           for a, r in zip(got, from_res)):
                    raise AssertionError(
                        f"graph_lstm_scan_cuda_bwd at {shape} vs the plain "
                        f"backward from its residuals: {extra}")
            what = f"graph_{cell}_scan_cuda_bwd" + (
                " (ys and cs cotangents)" if used == 2 else "")
            worst = max(worst, check_grads(
                f"kernel_graph_{cell}_bwd", what, list(shape), names, got,
                again, ref, **extra))
    if cell == "gru":
        check_gru_rings("kernel_graph_gru_bwd", tilings)
    else:
        check_lstm_tilings("kernel_graph_lstm_bwd", "bwd", tilings)
    return worst


def phase_kernel_dense_lstm():
    """The dense LSTM kernels' training forward (ys, cs, gates) and plain
    forward against the plain training forward at DENSE_LSTM_SHAPES, the
    plain forward reading the weight as a stacked weight's transpose; two
    launches give the same bits."""
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG

    rng = np.random.default_rng(SEED + 14)
    worst = 0.0
    for shape in DENSE_LSTM_SHAPES:
        B, _, J, H, _ = shape
        xg, _, (w,), _ = graph_case(rng, "lstm", shape)
        with torch.no_grad():
            refs = FG.dense_lstm_scan_keep_reference(xg, w)
            keep = FG.dense_lstm_scan_cuda_fwd(xg, w, keep=True)
            again = FG.dense_lstm_scan_cuda_fwd(xg, w, keep=True)
            plain = FG.dense_lstm_scan_cuda_fwd(xg, w.t().contiguous().t())
        torch.cuda.synchronize()
        errs = [float((o - r).abs().max())
                for o, r in zip((*keep, *plain), (*refs, *refs[:2]))]
        same = all(torch.equal(a, b) for a, b in zip(keep, again))
        finite = all(bool(torch.isfinite(o).all()) for o in (*keep, *plain))
        emit({"phase": "kernel_graph_lstm", "entry": "dense_lstm_scan_cuda_fwd",
              "B_L_J_H_k": shape, "max_abs_err": max(errs),
              "keep_ys_cs_gates_err": errs[:3],
              "transposed_weight_ys_cs_err": errs[3:], "same_bits_twice": same,
              "finite": finite,
              "plan_fwd_bwd_rows_smem_blocks": FG.dense_lstm_plan(B, J, H)})
        if not (max(errs) <= SCAN_BAR and same and finite):
            raise AssertionError(f"dense LSTM forward at {shape}: {errs}, "
                                 f"same bits {same}, finite {finite}")
        worst = max(worst, max(errs))
    return worst


def check_dense_route():
    """The route's boundary through the autograd entry graph_lstm_scan:
    H = DENSE_LSTM_MAX_H on the dense kernels, the next H on the
    graph-form kernels; outputs and gradients against the plain version."""
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG

    rng = np.random.default_rng(SEED + 15)
    worst = 0.0
    for shape, route in ((CLS_DENSE, "dense"), (DENSE_LSTM_PAST, "graph")):
        B, _, J, H, _ = shape
        taken = FG.dense_lstm_plan(B, J, H)[0] > 0
        if taken != (route == "dense"):
            raise AssertionError(f"H={H}: dense route taken {taken}")
        xg, cheb, (w,), cots = graph_case(rng, "lstm", shape)
        leaves = [t.clone().requires_grad_(True) for t in (xg, w)]
        reset_kernel_counts()
        outs = FG.graph_lstm_scan(leaves[0], cheb, leaves[1], with_c=True)
        got = torch.autograd.grad(outs, leaves, cots)
        counts = {k: v for k, v in kernel_counts().items() if v}
        if counts != {f"{route}_lstm_scan": 1, f"{route}_lstm_scan_bwd": 1}:
            raise AssertionError(f"H={H} launched {counts}")
        refs = FG.graph_lstm_scan_reference(xg, cheb, w)
        err = max(float((o.detach() - r).abs().max())
                  for o, r in zip(outs, refs))
        if not err <= SCAN_BAR:
            raise AssertionError(f"graph_lstm_scan at H={H}: {err}")
        ref = plain_grads(lambda t: FG.graph_lstm_scan_reference(
            t[0], cheb, t[1]), [xg, w], cots)
        worst = max(worst, check_grads(
            "kernel_graph_lstm_bwd", f"graph_lstm_scan ({route} route)",
            list(shape), ("dxg", "dw"), got, None, ref, launches=counts,
            forward_max_abs_err=err))
    return worst


def phase_kernel_dense_lstm_bwd():
    """The dense LSTM's backward kernels from the training forward
    kernel's residuals against autograd of the plain version, with and
    without the cell states' cotangent, the same bits twice (and with the
    weight read as a stacked weight's transpose at the dense form); then
    the route's boundary."""
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG

    rng = np.random.default_rng(SEED + 16)
    worst = 0.0
    for shape in DENSE_LSTM_SHAPES:
        xg, cheb, (w,), cots = graph_case(rng, "lstm", shape)
        with torch.no_grad():
            ys, cs, gates = FG.dense_lstm_scan_cuda_fwd(xg, w, keep=True)
        for used in (2, 1):
            dcs = cots[1] if used == 2 else None

            def launch(weight=w):
                return FG.dense_lstm_scan_cuda_bwd(weight, gates, ys, cs,
                                                   cots[0], dcs)
            got = launch()
            again = launch(w.t().contiguous().t()) if shape == CLS_DENSE \
                else launch()
            ref = plain_grads(lambda t: FG.graph_lstm_scan_reference(
                t[0], cheb, t[1])[:used], [xg, w], cots[:used])
            what = "dense_lstm_scan_cuda_bwd" + (
                " (ys and cs cotangents)" if used == 2 else "")
            worst = max(worst, check_grads(
                "kernel_graph_lstm_bwd", what, list(shape), ("dxg", "dw"),
                got, again, ref))
    return max(worst, check_dense_route())


def make_cls_flow(name="GConvGRU", lr=LR, precision="32", **model_kwargs):
    from pedestrians_video_2_carla_torch.flows.classification import \
        ClassificationFlow
    from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
    from pedestrians_video_2_carla_torch.models.classification import \
        CLASSIFICATION_MODELS

    model = CLASSIFICATION_MODELS[name](
        generator=torch.Generator().manual_seed(SEED), **model_kwargs)
    return ClassificationFlow(
        model, classification_optimizer=OptimizerSettings(lr=lr), seed=SEED,
        precision=precision)


def fit_classifier(flow, dm, steps, val_batches, run_name, expected,
                   epochs=1):
    """Trainer.fit of a classification flow, ``epochs`` of ``steps`` steps
    and ``val_batches`` validation batches: counted launches, finite
    logged losses, validation metrics, an exact restore. Returns (counts,
    the step records' losses, the epoch records, seconds, hparams.json)."""
    from pedestrians_video_2_carla_torch.training.trainer import (
        Trainer, TrainerConfig)

    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(flow, dm, TrainerConfig(
            max_epochs=epochs, limit_train_batches=steps,
            limit_val_batches=val_batches, log_every_n_steps=1, seed=SEED,
            logs_dir=tmp, run_name=run_name))
        reset_kernel_counts()
        t0 = time.perf_counter()
        state = trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = kernel_counts()
        if counts != expected_counts(**expected):
            raise AssertionError(f"{run_name} launches {counts}, expected "
                                 f"{expected}")
        run = os.path.join(tmp, run_name)
        with open(os.path.join(run, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        bad = {k: v for r in records for k, v in r.items()
               if "_loss/" in k and not np.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite logged losses {bad}")
        losses = [r["train_loss/primary"] for r in records
                  if "lr-classification" in r]
        if len(losses) != steps * epochs:
            raise AssertionError(f"{len(losses)} step records, expected "
                                 f"{steps * epochs}")
        with open(os.path.join(run, "hparams.json")) as f:
            hparams = json.load(f)
        last = records[-1]
        missing = [k for k in ("val_loss/primary", "val_Accuracy",
                               "val_Precision", "val_Recall", "val_F1Score",
                               "val_ConfusionMatrix", "val_AUROC")
                   if k not in last]
        if missing or int(np.sum(last["val_ConfusionMatrix"])) \
                != val_batches * dm.batch_size:
            raise AssertionError(f"validation metrics: missing {missing}, "
                                 f"matrix {last.get('val_ConfusionMatrix')}")
        restored = flow.init_state()
        trainer.checkpoints.restore(
            restored, os.path.join(run, "checkpoints", "last"))
        opt, opt_back = (st.optimizer.state_dict()["state"]
                         for st in (state, restored))
        same = all(torch.equal(restored.params[n][k], v)
                   for n, tree in state.params.items()
                   for k, v in tree.items()) and all(
            torch.equal(torch.as_tensor(v), torch.as_tensor(opt_back[i][k]))
            for i, st in opt.items() for k, v in st.items())
        if not (same and restored.step == state.step == steps * epochs):
            raise AssertionError("the last checkpoint does not restore the "
                                 "trained params and AdamW state")
    return (counts, losses, [r for r in records if "epoch" in r], fit_s,
            hparams)


def phase_train_classification(dm):
    """The classification training path through the port's Trainer; then a
    repeated batch, the fused and plain routes step by step, and short fits
    of the two models that run the LSTM kernels."""
    flow = make_cls_flow()
    model = flow.classification_model
    if (model.hidden_size, model.k, model.p_dropout, model.graph_kernel) \
            != (CLS_H, CLS_K, 0.2, "auto"):
        raise AssertionError("GConvGRU's defaults changed")
    batches = CLS_TRAIN_STEPS + VAL_BATCHES
    counts, losses, epochs, fit_s, _ = fit_classifier(
        flow, dm, CLS_TRAIN_STEPS, VAL_BATCHES, "cls",
        {"graph_gru_scan": 2 * batches,
         "graph_gru_scan_bwd": 2 * CLS_TRAIN_STEPS})
    last = epochs[-1]

    # the labels are coin flips, so a stream of fresh batches teaches
    # nothing; one repeated batch is learnt. Dropout off and lr 1e-4, so
    # that Adam's first steps (about lr a parameter, whatever the gradient)
    # do not overshoot: the loss then falls from the first step on
    learner = make_cls_flow(p_dropout=0.0, lr=REPEAT_LR)
    state = learner.init_state()
    batch = next(dm.train_batches(SEED + 3))
    repeated = [float(learner.training_step(state, batch)[1][
        "train_loss/primary"]) for _ in range(CLS_TRAIN_STEPS)]
    if not (np.isfinite(repeated).all()
            and np.mean(repeated[-3:]) < repeated[0]):
        raise AssertionError(f"a repeated batch was not learnt: {repeated}")

    # dropout off: the fused and plain routes from the same params
    routes = {r: make_cls_flow(p_dropout=0.0, graph_kernel=r)
              for r in ("fused", "plain")}
    params = routes["fused"].init_params()
    states = {r: f.init_state(params) for r, f in routes.items()}
    stream = dm.train_batches(SEED)
    worst, per_step = 0.0, []
    reset_kernel_counts()
    for _ in range(CLS_PARITY_STEPS):
        batch = next(stream)
        a, b = (float(routes[r].training_step(states[r], batch)[1][
            "train_loss/primary"]) for r in ("fused", "plain"))
        rel = abs(a - b) / abs(b)
        if not rel <= LOSS_RTOL:
            raise AssertionError(f"fused {a} vs plain {b}")
        worst = max(worst, rel)
        per_step.append([a, b])
    if kernel_counts() != expected_counts(
            graph_gru_scan=2 * CLS_PARITY_STEPS,
            graph_gru_scan_bwd=2 * CLS_PARITY_STEPS):
        raise AssertionError(f"the plain route launched a kernel: "
                             f"{kernel_counts()}")

    # the LSTM kernels on real paths: GConvLSTM's two layers (k=2: the
    # graph-form kernels), and the LSTM classifier's two dense layers (the
    # dense kernels)
    lstm_counts, lstm_total = {}, {}
    for run_name, short, entry in (
            ("GConvLSTM", make_cls_flow("GConvLSTM"), "graph_lstm_scan"),
            ("LSTM", make_cls_flow("LSTM", rnn_kernel="fused"),
             "dense_lstm_scan")):
        expected = {entry: 2 * (CLS_SHORT_STEPS + 1),
                    f"{entry}_bwd": 2 * CLS_SHORT_STEPS}
        c, short_losses, _, _, _ = fit_classifier(
            short, dm, CLS_SHORT_STEPS, 1, run_name, expected)
        lstm_counts[run_name] = {k: v for k, v in c.items() if v}
        lstm_counts[run_name]["train_loss_primary"] = short_losses
        lstm_total.update({k: c[k] for k in expected})
    emit({"phase": "train_classification", "B": dm.batch_size, "L": CLIP,
          "steps": CLS_TRAIN_STEPS, "val_batches": VAL_BATCHES,
          "launches": {k: v for k, v in counts.items() if v},
          "fit_seconds": fit_s, "train_loss_primary": losses,
          "val": {k: v for k, v in last.items()
                  if k.startswith("val_") and not isinstance(v, list)},
          "val_confusion_matrix": last["val_ConfusionMatrix"],
          "restored_equal": True, "repeated_batch_losses": repeated,
          "fused_vs_plain_losses": per_step,
          "fused_vs_plain_max_rel": worst, "lstm_fits": lstm_counts})
    return {**counts, **lstm_total}


def phase_serve_classification(dm):
    """Eval steps of the default flow (eval_step is what serves a
    classifier: clips in, logits out) against the plain route's."""
    flow = make_cls_flow()
    plain = make_cls_flow(graph_kernel="plain")
    params = flow.init_params()
    batches = list(dm.test_batches())
    reset_kernel_counts()
    served = []
    for i, batch in enumerate(batches):
        served.append(flow.eval_step(params, batch))
        counts = kernel_counts()
        if counts != expected_counts(graph_gru_scan=2 * (i + 1)):
            raise AssertionError(f"request {i}: launches {counts}")
    torch.cuda.synchronize()
    worst, losses = 0.0, []
    for (loss, preds, _), batch in zip(served, batches):
        ref_loss, ref, _ = plain.eval_step(params, batch)
        logits = preds["crossing_logits"]
        if logits.shape != (dm.batch_size, 2) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"logits {tuple(logits.shape)} or not "
                                 f"finite")
        worst = max(worst, float(
            (logits - ref["crossing_logits"]).abs().max()))
        losses.append((float(loss["primary"]), float(ref_loss["primary"])))
    if worst > SCAN_BAR:
        raise AssertionError(f"fused vs plain logits: {worst}")
    emit({"phase": "serve_classification", "B": dm.batch_size, "L": CLIP,
          "requests": len(batches), "launches": counts["graph_gru_scan"],
          "max_abs_err_logits_vs_plain": worst,
          "loss_fused_vs_plain": losses[:2]})
    return counts["graph_gru_scan"]


def scan_bound(cell, shape, hbm_rate, backward=False, with_dcs=False,
               keep=False, dense=False, element_size=4, peak=None):
    """The scan's bound from ops/flops.py at the rate its products run at
    (``peak``: the 3xTF32 rate unless given; ``bound_ms``, which the
    kernels line takes), bytes at ``element_size`` (the kept residuals
    float32), and at the fp32 peak beside it."""
    from pedestrians_video_2_carla_torch.ops import flops as F

    B, L, J, H, k = shape
    nflop = F.graph_scan_flops(cell, B, L, J, H, k, backward)
    nbytes = F.graph_scan_bytes(cell, B, L, J, H, k, backward, with_dcs, keep,
                                dense, element_size)
    t_bytes = nbytes / hbm_rate
    t_tc, t_fp32 = nflop / (peak or TF32X3_PEAK), nflop / FP32_PEAK
    return {"bytes": nbytes, "flop": nflop,
            "bound_ms": max(t_bytes, t_tc) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_tc else "operations",
            "bound_ms_fp32_peak": max(t_bytes, t_fp32) * 1e3}


#: rows 10 to 13 at CLS_MAIN as recorded for their earlier design (fp32 on
#: the CUDA cores, a backward that recomputed the forward; NVIDIA H100 80GB
#: HBM3 at 700 W, cold L2; PERF.md): not measured by this script, so they go
#: on the timing_classification line beside this run's times, never on the
#: kernels line
RECORDED_MS = {"gru": {"fwd": 2.217, "bwd": 5.562},
               "lstm": {"fwd": 2.478, "bwd": 5.878}}


def time_scan(cell, shape, flush, hbm_rate, rng):
    """CUDA-event medians of one cell's forward kernel, its training
    forward (``keep``) and its backward from that forward's residuals at
    ``shape``, of the plain version and autograd of it, and the bounds."""
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG

    kernel, plain = scan_functions(cell)
    fwd_entry = FG.graph_gru_scan_cuda_fwd if cell == "gru" else \
        FG.graph_lstm_scan_cuda_fwd
    xg, cheb, weights, cots = graph_case(rng, cell, shape)
    with torch.no_grad():
        kept = fwd_entry(xg, cheb, *weights, keep=True)
    leaves = [t.detach().clone().requires_grad_(True) for t in (xg, *weights)]
    graph = plain(leaves[0], cheb, *leaves[1:])

    def fwd():
        with torch.no_grad():
            kernel(xg, cheb, *weights)

    def fwd_keep():
        fwd_entry(xg, cheb, *weights, keep=True)

    def bwd():
        if cell == "gru":
            FG.graph_gru_scan_cuda_bwd(cheb, *weights, kept[1], cots[0])
        else:
            FG.graph_lstm_scan_cuda_bwd(cheb, *weights, kept[2], kept[1],
                                        *cots)

    def plain_fwd():
        with torch.no_grad():
            plain(xg, cheb, *weights)

    def plain_bwd():
        torch.autograd.grad(graph, leaves, cots, retain_graph=True)
    with_dcs = cell == "lstm"
    out = {
        "fwd": {"ms_cold_l2": cuda_median_ms(fwd, flush=flush),
                "ms_warm_l2": cuda_median_ms(fwd),
                "plain_ms": cuda_median_ms(plain_fwd),
                **scan_bound(cell, shape, hbm_rate)},
        "fwd_keep": {"ms_cold_l2": cuda_median_ms(fwd_keep, flush=flush),
                     "ms_warm_l2": cuda_median_ms(fwd_keep),
                     **scan_bound(cell, shape, hbm_rate, keep=True)},
        "bwd": {"ms_cold_l2": cuda_median_ms(bwd, flush=flush),
                "ms_warm_l2": cuda_median_ms(bwd),
                "plain_ms": cuda_median_ms(plain_bwd),
                **scan_bound(cell, shape, hbm_rate, True, with_dcs)}}
    if tuple(shape) == CLS_MAIN:
        for key, was in RECORDED_MS[cell].items():
            out[key]["earlier_design_recorded_ms"] = was
    return out


def library_lstm(xg, cheb, w, cots):
    """torch.nn.LSTM (cuDNN, one layer) in xg's dtype as the dense LSTM
    form's library yardstick: fed the scan's own input, the gate
    pre-activations, through an identity input weight (its gate order is
    the scan's, i|f|g|o), the scan's hidden weights, zero biases. Held to
    the plain version within the scan's bar (bf16: within BF16_VS_FP32 of
    max |plain|, cuDNN rounding where it rounds); returns its forward and
    its backward (torch.autograd.grad alone, both cotangents) as calls,
    and the error."""
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG

    H = w.shape[0]
    lib = torch.nn.LSTM(4 * H, H, num_layers=1).cuda().to(xg.dtype)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(torch.eye(4 * H))
        lib.weight_hh_l0.copy_(w.t())
        lib.bias_ih_l0.zero_()
        lib.bias_hh_l0.zero_()
    x = xg[:, :, 0].contiguous().requires_grad_(True)
    out, _ = lib(x)
    ref, _ = FG.graph_lstm_scan_reference(xg, cheb, w)
    if xg.dtype == torch.bfloat16:
        err = bar_err(out.detach().float(), ref[:, :, 0].float())[1]
        bar = BF16_VS_FP32
    else:
        err, bar = float((out.detach() - ref[:, :, 0]).abs().max()), SCAN_BAR
    if err > bar:
        raise AssertionError(f"torch.nn.LSTM vs the plain version: {err}")
    leaves = [x, lib.weight_hh_l0]
    g = cots[0][:, :, 0].contiguous()

    def fwd():
        with torch.no_grad():
            lib(x)

    def bwd():
        torch.autograd.grad(out, leaves, g, retain_graph=True)
    return fwd, bwd, err


def time_lstm_vs_cudnn(shape, dense, flush, hbm_rate, rng, layer_inputs):
    """The LSTM kernels of one route at a J=1, k=1 ``shape`` (``dense``:
    csrc/fused_dense_lstm.cu; else the graph form): CUDA-event medians of
    the forward, the training forward (``keep``) and the backward from its
    residuals (both cotangents), L2 cold and warm; the plain version and
    autograd of it; the bounds at the 3xTF32 rate; torch.nn.LSTM (cuDNN),
    alone and in TIMING_PAIRS alternating pairs with each kernel; the
    products of that yardstick's identity input weight alone (its forward's
    x W_ih^T, its backward's dx and dW_ih: (L B, 4H) x (4H, 4H) each),
    which the kernels do not run; the layer comparison of
    ``time_lstm_layers`` at ``layer_inputs``."""
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG

    B, _, J, H, k = shape
    xg, cheb, (w,), cots = graph_case(rng, "lstm", shape)
    with torch.no_grad():
        if dense:
            ys, cs, gates = FG.dense_lstm_scan_cuda_fwd(xg, w, keep=True)
        else:
            _, cs, res = FG.graph_lstm_scan_cuda_fwd(xg, cheb, w, keep=True)
    leaves = [t.detach().clone().requires_grad_(True) for t in (xg, w)]
    graph = FG.graph_lstm_scan_reference(leaves[0], cheb, leaves[1])
    lib_fwd, lib_bwd, lib_err = library_lstm(xg, cheb, w, cots)

    def fwd(keep=False):
        if dense:
            FG.dense_lstm_scan_cuda_fwd(xg, w, keep=keep)
        else:
            FG.graph_lstm_scan_cuda_fwd(xg, cheb, w, keep=keep)

    def bwd():
        if dense:
            FG.dense_lstm_scan_cuda_bwd(w, gates, ys, cs, *cots)
        else:
            FG.graph_lstm_scan_cuda_bwd(cheb, w, res, cs, *cots)

    def plain_fwd():
        with torch.no_grad():
            FG.graph_lstm_scan_reference(xg, cheb, w)

    def plain_bwd():
        torch.autograd.grad(graph, leaves, cots, retain_graph=True)

    a = xg.reshape(-1, 4 * H)
    eye = torch.eye(4 * H, device=a.device)

    def input_fwd():
        torch.mm(a, eye)

    def input_bwd():
        torch.mm(a, eye)
        torch.mm(a.t(), a)
    plan = {"plan_fwd_bwd_rows_smem_blocks": FG.dense_lstm_plan(B, J, H)} \
        if dense else {"plan_fwd": FG.graph_lstm_plan(B, J, H, k),
                       "plan_bwd": FG.graph_lstm_plan(B, J, H, k, True)}
    return {
        "B_L_J_H_k": shape, **plan,
        "fwd": {"ms_cold_l2": cuda_median_ms(fwd, flush=flush),
                "ms_warm_l2": cuda_median_ms(fwd),
                "plain_ms": cuda_median_ms(plain_fwd),
                "library_ms": cuda_median_ms(lib_fwd, flush=flush),
                "paired_vs_library": paired_ms(fwd, lib_fwd, flush),
                **scan_bound("lstm", shape, hbm_rate, dense=dense)},
        "fwd_keep": {"ms_cold_l2": cuda_median_ms(lambda: fwd(True),
                                                  flush=flush),
                     "ms_warm_l2": cuda_median_ms(lambda: fwd(True)),
                     **scan_bound("lstm", shape, hbm_rate, keep=True,
                                  dense=dense)},
        "bwd": {"ms_cold_l2": cuda_median_ms(bwd, flush=flush),
                "ms_warm_l2": cuda_median_ms(bwd),
                "plain_ms": cuda_median_ms(plain_bwd),
                "library_ms": cuda_median_ms(lib_bwd, flush=flush),
                "paired_vs_library": paired_ms(bwd, lib_bwd, flush),
                **scan_bound("lstm", shape, hbm_rate, True, True,
                             dense=dense)},
        "library_identity_input_products_ms": {
            "fwd": cuda_median_ms(input_fwd, flush=flush),
            "bwd": cuda_median_ms(input_bwd, flush=flush)},
        "library_max_abs_err_vs_plain": lib_err,
        "layer_vs_library": time_lstm_layers(shape, layer_inputs, flush,
                                             rng)}


def time_lstm_layers(shape, widths, flush, rng):
    """One LSTM layer at ``shape``'s B, L and H for each input width in
    ``widths``: HoistedLSTM(kernel="fused") (the hoisted input product with
    the biases, the scan kernels of the route its width takes) against
    torch.nn.LSTM (cuDNN, no TF32) holding the same weights, both at the
    layer's real input width, so that neither runs work the other does not.
    Forward under no_grad, backward torch.autograd.grad to the input and
    every weight, each in TIMING_PAIRS alternating pairs; the outputs held
    within LAYER_BAR."""
    from pedestrians_video_2_carla_torch.models.rnn import HoistedLSTM

    B, L, _, H, _ = shape
    out = {}
    for width in widths:
        gen = torch.Generator().manual_seed(SEED + width)
        layer = HoistedLSTM(width, H, kernel="fused", generator=gen).cuda()
        lib = torch.nn.LSTM(width, H, batch_first=True).cuda()
        with torch.no_grad():
            lib.weight_ih_l0.copy_(layer._stacked("i"))
            lib.weight_hh_l0.copy_(layer._stacked("h"))
            lib.bias_ih_l0.zero_()
            lib.bias_hh_l0.copy_(torch.cat(
                [getattr(layer, f"h{g}").bias for g in layer.GATES]))
        x = torch.from_numpy(rng.standard_normal((B, L, width)).astype(
            np.float32)).cuda().requires_grad_(True)
        g = torch.from_numpy(rng.standard_normal((B, L, H)).astype(
            np.float32)).cuda()
        ys = layer(x)[1]
        ref = lib(x)[0]
        err = float((ys.detach() - ref.detach()).abs().max())
        if err > LAYER_BAR:
            raise AssertionError(f"LSTM layer vs torch.nn.LSTM at hidden {H}"
                                 f", input width {width}: {err}")
        ours = [x, *layer.parameters()]
        theirs = [x, *lib.parameters()]

        def fwd():
            with torch.no_grad():
                layer(x)

        def lib_fwd():
            with torch.no_grad():
                lib(x)

        def bwd():
            torch.autograd.grad(ys, ours, g, retain_graph=True)

        def lib_bwd():
            torch.autograd.grad(ref, theirs, g, retain_graph=True)
        out[width] = {"fwd": paired_ms(fwd, lib_fwd, flush),
                      "bwd": paired_ms(bwd, lib_bwd, flush),
                      "max_abs_err_vs_library": err}
    return out


def cls_step_split(flow, state, batch, runs=TIMING_RUNS):
    """A CUDA-event split of a GConvGRU ``training_step``: the body of
    training_step with events between its parts, around each layer (input
    convolutions + scan), each scan entry, and each scan's autograd
    backward; medians of ``runs``."""
    from pedestrians_video_2_carla_torch.models.classification import \
        gnn as TG
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG

    marks = {"layer": [], "scan": [], "scan_bwd": []}

    def timed(name, fn):
        def run(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            marks[name].append((start, end))
            return out
        return run
    model_cls = type(flow.classification_model)
    saved = (model_cls._layer_fused, TG.graph_gru_scan,
             FG.GraphGRUScan.backward)
    model_cls._layer_fused = timed("layer", saved[0])
    TG.graph_gru_scan = timed("scan", saved[1])
    FG.GraphGRUScan.backward = staticmethod(timed("scan_bwd", saved[2]))
    splits = []
    try:
        for _ in range(runs):
            for v in marks.values():
                v.clear()
            inputs, targets, _ = batch
            torch.cuda._sleep(2_000_000)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            loss = flow._loss(flow._apply(state.params, inputs, True),
                              targets)
            ev[1].record()
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            ev[2].record()
            state.optimizer.step()
            ev[3].record()
            ev[3].synchronize()
            spent = {k: sum(a.elapsed_time(b) for a, b in v)
                     for k, v in marks.items()}
            total = ev[0].elapsed_time(ev[3])
            adamw = ev[2].elapsed_time(ev[3])
            convs = spent["layer"] - spent["scan"]
            splits.append((total, ev[0].elapsed_time(ev[1]),
                           ev[1].elapsed_time(ev[2]), convs, spent["scan"],
                           spent["scan_bwd"], adamw,
                           total - convs - spent["scan"] - spent["scan_bwd"]
                           - adamw))
    finally:
        model_cls._layer_fused, TG.graph_gru_scan = saved[:2]
        FG.GraphGRUScan.backward = staticmethod(saved[2])
    split = dict(zip(("step_ms", "forward_ms", "backward_ms",
                      "input_convs_forward_ms", "scans_forward_ms",
                      "scans_backward_ms", "adamw_ms", "rest_ms"),
                     (statistics.median(c) for c in zip(*splits))))
    return split


def phase_timing_classification(dm, card, hbm_rate):
    rng = np.random.default_rng(SEED + 13)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def flush_l2():  # 256 MB write: far more than the 50 MB L2
        scratch.zero_()

    times = {"gru": time_scan("gru", CLS_MAIN, flush_l2, hbm_rate, rng),
             "lstm": time_scan("lstm", CLS_MAIN, flush_l2, hbm_rate, rng),
             "lstm_dense": time_scan("lstm", CLS_DENSE, flush_l2, hbm_rate,
                                     rng)}
    dense = time_lstm_vs_cudnn(CLS_DENSE, True, flush_l2, hbm_rate, rng,
                               DENSE_LAYER_INPUTS)
    wide = time_lstm_vs_cudnn(CLS_WIDE, False, flush_l2, hbm_rate, rng,
                              WIDE_LAYER_INPUTS)
    torch.cuda.empty_cache()

    flow = make_cls_flow()
    batch = next(dm.train_batches(SEED + 7))
    state = flow.init_state()
    params = flow.init_params()
    step_ms = host_median_ms(lambda: flow.training_step(state, batch))
    eval_ms = host_median_ms(lambda: flow.eval_step(params, batch))

    # the LSTM classifier (published widths: hidden 64, 2 layers, dropout
    # 0.25) on the dense kernels and on the plain loop
    lstm_path = {}
    for route in ("fused", "plain"):
        lstm_flow = make_cls_flow("LSTM", rnn_kernel=route)
        model = lstm_flow.classification_model
        if (model.hidden_size, model.num_layers, model.p_dropout) \
                != (64, 2, 0.25):
            raise AssertionError("the LSTM classifier's defaults changed")
        lstm_state = lstm_flow.init_state()
        lstm_params = lstm_flow.init_params()
        lstm_path[route] = {
            "train_step_ms_host": host_median_ms(
                lambda: lstm_flow.training_step(lstm_state, batch)),
            "eval_step_ms_host": host_median_ms(
                lambda: lstm_flow.eval_step(lstm_params, batch))}

    # GConvLSTM (hidden 128, k=2, 2 layers: the graph-form LSTM kernels)
    # on the kernels and on the plain loop
    gconv_lstm = {}
    for route in ("fused", "plain"):
        gl_flow = make_cls_flow("GConvLSTM", graph_kernel=route)
        gl_state, gl_params = gl_flow.init_state(), gl_flow.init_params()
        gconv_lstm[route] = {
            "train_step_ms_host": host_median_ms(
                lambda: gl_flow.training_step(gl_state, batch)),
            "eval_step_ms_host": host_median_ms(
                lambda: gl_flow.eval_step(gl_params, batch))}

    split = cls_step_split(flow, state, batch)
    emit({"phase": "timing_classification", "card": card,
          "B_L_J_H_k": CLS_MAIN, "dense_B_L_J_H_k": CLS_DENSE,
          "kernels": times, "dense_lstm": dense, "graph_lstm_k1": wide,
          "train_step_ms_host": step_ms, "eval_step_ms_host": eval_ms,
          "lstm_classifier_steps": lstm_path,
          "gconv_lstm_steps": gconv_lstm,
          "train_step_split_cuda_events": split,
          "method": "kernels, plain versions (autograd of them for the "
                    "backward, timed around torch.autograd.grad alone) and "
                    "torch.nn.LSTM: CUDA events, median of %d single calls "
                    "after 3 warm-up calls, cold = 256 MB scratch write "
                    "before each call; steps: host clock to "
                    "torch.cuda.synchronize(), median of %d; split: the "
                    "body of training_step with CUDA events between its "
                    "parts, around each layer and scan entry and each "
                    "scan's autograd backward, medians of %d"
                    % ((TIMING_RUNS,) * 3)})

    def entry(t, library_ms=None, **extra):
        return {"ms": t["ms_cold_l2"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": library_ms, **extra}
    graph, gru = times["lstm"], times["gru"]

    def k1_entry(t):
        return {"k1_shape_B_L_J_H_k": CLS_WIDE, "k1_ms": t["ms_cold_l2"],
                "k1_bound_ms": t["bound_ms"], "k1_library_ms": t["library_ms"],
                "k1_paired_ratio_vs_library": t["paired_vs_library"][
                    "ratio_median"]}
    return {"gru_fwd": entry(gru["fwd"],
                             bound_ms_fp32_peak=gru["fwd"][
                                 "bound_ms_fp32_peak"],
                             keep_ms=gru["fwd_keep"]["ms_cold_l2"],
                             keep_bound_ms=gru["fwd_keep"]["bound_ms"]),
            "gru_bwd": entry(gru["bwd"],
                             bound_ms_fp32_peak=gru["bwd"][
                                 "bound_ms_fp32_peak"]),
            # the graph-form LSTM pair at GConvLSTM's layer (no PyTorch call
            # computes it), with its time at the dense shape and, at k = 1
            # past the dense width, beside cuDNN's
            "lstm_fwd": entry(
                graph["fwd"], shape_B_L_J_H_k=CLS_MAIN,
                bound_ms_fp32_peak=graph["fwd"]["bound_ms_fp32_peak"],
                keep_ms=graph["fwd_keep"]["ms_cold_l2"],
                keep_bound_ms=graph["fwd_keep"]["bound_ms"],
                graph_form_dense_shape_ms=times["lstm_dense"]["fwd"][
                    "ms_cold_l2"], **k1_entry(wide["fwd"])),
            "lstm_bwd": entry(
                graph["bwd"], shape_B_L_J_H_k=CLS_MAIN,
                bound_ms_fp32_peak=graph["bwd"]["bound_ms_fp32_peak"],
                graph_form_dense_shape_ms=times["lstm_dense"]["bwd"][
                    "ms_cold_l2"], **k1_entry(wide["bwd"])),
            # the dense pair, with cuDNN as the library call
            "dense_lstm_fwd": entry(
                dense["fwd"], dense["fwd"]["library_ms"],
                shape_B_L_J_H_k=CLS_DENSE,
                bound_ms_fp32_peak=dense["fwd"]["bound_ms_fp32_peak"],
                keep_ms=dense["fwd_keep"]["ms_cold_l2"],
                keep_bound_ms=dense["fwd_keep"]["bound_ms"],
                paired_ratio_vs_library=dense["fwd"]["paired_vs_library"][
                    "ratio_median"]),
            "dense_lstm_bwd": entry(
                dense["bwd"], dense["bwd"]["library_ms"],
                shape_B_L_J_H_k=CLS_DENSE,
                bound_ms_fp32_peak=dense["bwd"]["bound_ms_fp32_peak"],
                paired_ratio_vs_library=dense["bwd"]["paired_vs_library"][
                    "ratio_median"])}


#: the device kernels of rows 10 and 11 (names as the profiler shows them);
#: row 11 split into its reverse scan and its weight-gradient products
ROW10_KERNELS = ("gru_scan_fwd",)
ROW11_SCAN_KERNELS = ("gru_scan_bwd",)
ROW11_DW_KERNELS = ("dw_tf32", "reduce_two")


def phase_profile_classification_train(dm, card):
    """A torch.profiler trace of GConvGRU training_steps at B=256, L=16:
    busy share, top device operations, the share of rows 10 and 11, and
    row 11 split into its reverse scan and its dW products."""
    flow = make_cls_flow()
    state = flow.init_state()
    batch = next(dm.train_batches(SEED + 7))
    trace, share = profile_steps(lambda: flow.training_step(state, batch))
    emit({"phase": "profile_classification_train", "card": card,
          "B_L_J_H_k": CLS_MAIN, **trace,
          "row10_scan_fwd_share": share(ROW10_KERNELS),
          "row11_scan_bwd_share": share(ROW11_SCAN_KERNELS + ROW11_DW_KERNELS),
          "row11_reverse_scan_share": share(ROW11_SCAN_KERNELS),
          "row11_dw_share": share(ROW11_DW_KERNELS)})


def make_ae_flow(kernel, precision="32"):
    """BASELINE config 2's flow with the encoder on ``kernel``'s route."""
    from pedestrians_video_2_carla_torch.flows.autoencoder import \
        AutoencoderFlow
    from pedestrians_video_2_carla_torch.flows.output_types import \
        MovementsModelOutputType
    from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
    from pedestrians_video_2_carla_torch.models.movements.seq2seq import \
        Seq2SeqEmbeddings

    model = Seq2SeqEmbeddings(
        movements_output_type=MovementsModelOutputType.pose_2d,
        rnn_kernel=kernel, generator=torch.Generator().manual_seed(SEED))
    if (model.hidden_size, model.num_layers, model.p_dropout,
            model.single_joint_embeddings_size, model.teacher_mode) \
            != (64, AE_LAYERS, 0.2, 64, "no_force"):
        raise AssertionError("Seq2SeqEmbeddings' defaults changed")
    return AutoencoderFlow(model, loss_modes=["loc_2d"],
                           movements_optimizer=OptimizerSettings(lr=LR),
                           seed=SEED, precision=precision)


def phase_serve_autoencoder(batches):
    from pedestrians_video_2_carla_torch.serving import make_inference_fn

    t0 = time.perf_counter()
    flow, plain = make_ae_flow("fused"), make_ae_flow("plain")
    params = flow.init_params()
    infer, infer_p = (make_inference_fn(f, params) for f in (flow, plain))
    reset_kernel_counts()
    served = []
    for i, (inputs, _, meta) in enumerate(batches):
        served.append(infer(inputs, meta["age_gender_idx"]))
        if kernel_counts() != expected_counts(
                dense_lstm_scan=AE_LAYERS * (i + 1)):
            raise AssertionError(f"request {i}: launches {kernel_counts()}")
    torch.cuda.synchronize()
    launches = kernel_counts()["dense_lstm_scan"]
    key = flow.outputs_key
    worst = 0.0
    for preds, (inputs, _, meta) in zip(served, batches):
        out = preds[key]
        if out.shape != (AE_BATCH, CLIP, 26, 2) or \
                not torch.isfinite(out).all():
            raise AssertionError(f"{key}: {tuple(out.shape)} or not finite")
        worst = max(worst, bar_err(
            out, infer_p(inputs, meta["age_gender_idx"])[key])[1])
    if worst > AE_BAR:
        raise AssertionError(f"fused vs plain outputs: {worst}")
    rows = []
    for batch in batches[:2]:
        row = {}
        for route, f in (("fused", flow), ("plain", plain)):
            loss, preds, targets = f.eval_step(params, batch)
            metrics = f.metrics.compute(f.metrics.update(
                f.metrics.init_state(f.device), preds, targets))
            row[route] = {"loc_2d": float(loss["loc_2d"]),
                          **{k: float(v) for k, v in metrics.items()}}
        for k, b in row["plain"].items():
            a = row["fused"][k]
            if not (np.isfinite(a) and abs(a - b) <= LOSS_RTOL * abs(b)):
                raise AssertionError(f"{k}: fused {a} vs plain {b}")
        rows.append(row)
    emit({"phase": "serve_autoencoder", "B": AE_BATCH, "L": CLIP,
          "requests": len(batches), "launches": launches,
          "max_err_over_max_plain": worst,
          "eval_fused_vs_plain": rows, "seconds": time.perf_counter() - t0})
    return launches


def fit_autoencoder(flow, dm, run_name, expected):
    """Trainer.fit of config 2: counted launches, the step losses, the last
    epoch record, the baseline's metrics, and an exact restore."""
    from pedestrians_video_2_carla_torch.training.trainer import (
        Trainer, TrainerConfig)

    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(flow, dm, TrainerConfig(
            max_epochs=1, limit_train_batches=AE_TRAIN_STEPS,
            limit_val_batches=AE_VAL_BATCHES, log_every_n_steps=1,
            seed=SEED, logs_dir=tmp, run_name=run_name))
        reset_kernel_counts()
        t0 = time.perf_counter()
        state = trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = kernel_counts()
        if counts != expected_counts(**expected):
            raise AssertionError(f"{run_name} launches {counts}, expected "
                                 f"{expected}")
        run = os.path.join(tmp, run_name)
        with open(os.path.join(run, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        with open(os.path.join(run, "hparams.json")) as f:
            initial = {k: v for k, v in json.load(f).items()
                       if k.startswith("initial_")}
        losses = [r["train_loss/primary"] for r in records
                  if "lr-movements" in r]
        last = records[-1]
        bad = [k for r in records for k, v in r.items()
               if "_loss/" in k and not np.isfinite(v)]
        if bad or len(losses) != AE_TRAIN_STEPS or "initial_MJR" \
                not in initial or any(f"val_{m}" not in last for m in (
                    "MSE", "PCKhn@01", "PCK@005")):
            raise AssertionError(f"{run_name}: non-finite {bad}, {len(losses)}"
                                 f" steps, initial {initial}, last {last}")
        restored = flow.init_state()
        trainer.checkpoints.restore(restored,
                                    os.path.join(run, "checkpoints", "last"))
        opt, opt_back = (st.optimizer.state_dict()["state"]
                         for st in (state, restored))
        same = all(torch.equal(restored.params[n][k], v)
                   for n, tree in state.params.items()
                   for k, v in tree.items()) and all(
            torch.equal(torch.as_tensor(v), torch.as_tensor(opt_back[i][k]))
            for i, st in opt.items() for k, v in st.items())
        if not (same and restored.step == state.step == AE_TRAIN_STEPS):
            raise AssertionError(f"{run_name}: the last checkpoint does not "
                                 f"restore the params and AdamW state")
    return {"counts": {k: v for k, v in counts.items() if v},
            "losses": losses, "initial": initial, "fit_s": fit_s,
            "val": {k: v for k, v in last.items() if k.startswith("val_")}}


def phase_train_autoencoder(dm):
    t0 = time.perf_counter()
    batches = AE_TRAIN_STEPS + AE_VAL_BATCHES
    fused = {"dense_lstm_scan": AE_LAYERS * batches,
             "dense_lstm_scan_bwd": AE_LAYERS * AE_TRAIN_STEPS}
    fits = {"fused": fit_autoencoder(make_ae_flow("fused"), dm, "ae", fused),
            "fused_again": fit_autoencoder(make_ae_flow("fused"), dm,
                                           "ae_again", fused),
            "plain": fit_autoencoder(make_ae_flow("plain"), dm, "ae_plain",
                                     {})}
    if fits["fused"]["losses"] != fits["fused_again"]["losses"]:
        raise AssertionError("the fused fit did not repeat its losses")
    worst = 0.0
    for a, b in zip(fits["fused"]["losses"], fits["plain"]["losses"]):
        worst = max(worst, abs(a - b) / abs(b))
    if worst > LOSS_RTOL:
        raise AssertionError(f"fused vs plain losses {worst}")
    # losses to rtol 1e-4, the metrics (MSE, the PCKs, MJR) within 1e-5
    metric_err = 0.0
    for group in ("val", "initial"):
        for k, b in fits["plain"][group].items():
            a = fits["fused"][group][k]
            if "_loss/" in k:
                ok = abs(a - b) <= LOSS_RTOL * abs(b)
            else:
                metric_err = max(metric_err, abs(a - b))
                ok = abs(a - b) <= AE_BAR
            if not (ok and np.isfinite(a)):
                raise AssertionError(f"{k}: fused {a} vs plain {b}")

    # one training_step's gradients through the kernels and the plain loop,
    # from the same weights, batch and dropout masks
    routes = {r: make_ae_flow(r) for r in ("fused", "plain")}
    params = routes["fused"].init_params()
    states = {r: f.init_state(params) for r, f in routes.items()}
    batch = next(dm.train_batches(SEED + 5))
    for r, f in routes.items():
        f.training_step(states[r], batch)
    grads = {}
    for k, p in states["fused"].params["movements"].items():
        grads[k], ok = scaled_err(
            p.grad, states["plain"].params["movements"][k].grad)
        if not ok:
            raise AssertionError(f"gradient {k}: {grads[k]}")
    emit({"phase": "train_autoencoder", "B": AE_BATCH, "L": CLIP,
          "steps": AE_TRAIN_STEPS, "val_batches": AE_VAL_BATCHES,
          "launches": fits["fused"]["counts"],
          "fit_seconds": {r: v["fit_s"] for r, v in fits.items()},
          "train_loss_primary": {r: fits[r]["losses"]
                                 for r in ("fused", "plain")},
          "fused_vs_plain_max_rel": worst, "same_bits_twice": True,
          "val": {r: fits[r]["val"] for r in ("fused", "plain")},
          "initial": fits["fused"]["initial"],
          "metrics_max_err": metric_err, "restored_equal": True,
          "step_grad_max_scaled_err": max(grads.values()),
          "seconds": time.perf_counter() - t0})
    return fits["fused"]["counts"]


def ae_step_split(flow, state, batch, params, fused):
    """CUDA-event split of config 2's training_step (its body with events
    between forward, backward and AdamW) and of a request (the model's
    forward under no_grad), around the encoder (input products and
    scans), each scan entry, each decoder step and, on the fused route,
    each scan's backward. Medians of TIMING_RUNS."""
    from pedestrians_video_2_carla_torch.models import rnn as R
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG

    model = flow.movements_model
    marks = {"encoder": [], "scan": [], "decoder": [], "scan_bwd": []}

    def timed(name, fn):
        def run(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            marks[name].append((start, end))
            return out
        return run
    saved = (R.graph_lstm_scan, FG.GraphLSTMScan.backward)
    model._encode = timed("encoder", model._encode)
    model.decoder.step = timed("decoder", model.decoder.step)
    R.graph_lstm_scan = timed("scan", saved[0])
    FG.GraphLSTMScan.backward = staticmethod(timed("scan_bwd", saved[1]))
    steps, requests = [], []
    try:
        for _ in range(TIMING_RUNS):
            for v in marks.values():
                v.clear()
            torch.cuda._sleep(2_000_000)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            sliced = flow._inner_step(state.params, batch, training=True)
            loss = flow._compute_losses(sliced, sliced["targets"])["loc_2d"]
            ev[1].record()
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            ev[2].record()
            state.optimizer.step()
            ev[3].record()
            ev[3].synchronize()
            spent = {k: sum(a.elapsed_time(b) for a, b in v)
                     for k, v in marks.items()}
            forward = ev[0].elapsed_time(ev[1])
            backward = ev[1].elapsed_time(ev[2])
            steps.append((ev[0].elapsed_time(ev[3]), forward,
                          spent["encoder"], spent["scan"], spent["decoder"],
                          forward - spent["encoder"] - spent["decoder"],
                          backward, spent["scan_bwd"],
                          backward - spent["scan_bwd"],
                          ev[2].elapsed_time(ev[3])))
            for v in marks.values():
                v.clear()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with torch.no_grad():
                flow._inner_step(params, batch, training=False)
            end.record()
            end.synchronize()
            spent = {k: sum(a.elapsed_time(b) for a, b in v)
                     for k, v in marks.items()}
            total = start.elapsed_time(end)
            requests.append((total, spent["encoder"], spent["scan"],
                             spent["decoder"],
                             total - spent["encoder"] - spent["decoder"]))
    finally:
        del model._encode, model.decoder.step
        R.graph_lstm_scan = saved[0]
        FG.GraphLSTMScan.backward = staticmethod(saved[1])
    step = dict(zip(("step_ms", "forward_ms", "encoder_ms",
                     "encoder_scans_ms", "decoder_loop_ms",
                     "forward_rest_ms", "backward_ms", "scans_backward_ms",
                     "backward_rest_ms", "adamw_ms"),
                    (statistics.median(c) for c in zip(*steps))))
    request = dict(zip(("request_ms", "encoder_ms", "encoder_scans_ms",
                        "decoder_loop_ms", "rest_ms"),
                       (statistics.median(c) for c in zip(*requests))))
    if not fused:
        # the plain route's scans are the loop's ops inside the encoder,
        # their backward autograd of them inside the rest of the backward
        for split in (step, request):
            del split["encoder_scans_ms"]
        del step["scans_backward_ms"]
    return step, request


def paired_host_ms(fns, pairs=2 * TIMING_PAIRS):
    """Two callables (a dict of two) in alternating single calls (a, b, b,
    a, ...), host clock to torch.cuda.synchronize(): each one's median,
    the median of the first's time over the second's, and the share of
    pairs the first won."""
    (name_a, a), (name_b, b) = fns.items()
    for fn in (a, b):
        for _ in range(3):
            fn()
    times = {name_a: [], name_b: []}
    for i in range(pairs):
        for name, fn in ((name_a, a), (name_b, b))[::1 if i % 2 == 0 else -1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    ratios = [x / y for x, y in zip(times[name_a], times[name_b])]
    return {"pairs": pairs,
            **{f"{k}_ms_median": statistics.median(v)
               for k, v in times.items()},
            f"{name_a}_over_{name_b}_median": statistics.median(ratios),
            f"{name_a}_wins": sum(r < 1 for r in ratios) / pairs}


def phase_timing_autoencoder(dm, card, hbm_rate):
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG
    from pedestrians_video_2_carla_torch.serving import make_inference_fn

    t0 = time.perf_counter()
    batch = next(dm.train_batches(SEED + 9))
    inputs, _, meta = next(dm.test_batches())
    routes, steps, requests = {}, {}, {}
    for route in ("fused", "plain"):
        flow = make_ae_flow(route)
        state, params = flow.init_state(), flow.init_params()
        infer = make_inference_fn(flow, params)
        steps[route] = functools.partial(flow.training_step, state, batch)
        requests[route] = functools.partial(infer, inputs,
                                            meta["age_gender_idx"])
        split_step, split_request = ae_step_split(flow, state, batch,
                                                  params, route == "fused")
        trace, share = profile_steps(steps[route])
        routes[route] = {
            "train_step_ms_host": host_median_ms(steps[route]),
            "train_step_ms_cuda_events": cuda_median_ms(steps[route]),
            "request_ms_host": host_median_ms(requests[route]),
            "request_ms_cuda_events": cuda_median_ms(requests[route]),
            "train_step_split_cuda_events": split_step,
            "request_split_cuda_events": split_request,
            "train_step_profile": {**trace,
                                   "dense_kernels_share": share(
                                       ("dense_lstm", "dw_tf32",
                                        "reduce_two"))}}
    pairs = {"train_step": paired_host_ms(steps),
             "request": paired_host_ms(requests)}

    # the dense kernels at this path's shape (its encoder layers: J=1,
    # H=64, B=256, L=16), beside their bounds
    rng = np.random.default_rng(SEED + 17)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    xg, _, (w,), cots = graph_case(rng, "lstm", CLS_DENSE)
    with torch.no_grad():
        ys, cs, gates = FG.dense_lstm_scan_cuda_fwd(xg, w, keep=True)
    dense = {
        "fwd_keep": {"ms_cold_l2": cuda_median_ms(
            lambda: FG.dense_lstm_scan_cuda_fwd(xg, w, keep=True),
            flush=scratch.zero_),
            **scan_bound("lstm", CLS_DENSE, hbm_rate, keep=True,
                         dense=True)},
        "bwd_with_dcs": {"ms_cold_l2": cuda_median_ms(
            lambda: FG.dense_lstm_scan_cuda_bwd(w, gates, ys, cs, *cots),
            flush=scratch.zero_),
            **scan_bound("lstm", CLS_DENSE, hbm_rate, True, True,
                         dense=True)}}
    emit({"phase": "timing_autoencoder", "card": card, "B": AE_BATCH,
          "L": CLIP, "routes": routes, "fused_vs_plain_pairs": pairs,
          "dense_kernels_B_L_J_H_k": CLS_DENSE, "dense_kernels": dense,
          "method": "steps and requests: host clock to "
                    "torch.cuda.synchronize() and CUDA events around one "
                    "call, medians of %d after 3 warm-ups, and the two "
                    "routes in %d alternating pairs (host clock); splits: "
                    "CUDA events around the encoder, each scan entry, each "
                    "decoder step and each scan backward, medians of %d "
                    "(a host-bound stretch shows its host time); profile: "
                    "torch.profiler over %d steps; kernels: CUDA events, "
                    "cold L2 (256 MB scratch write before each call)"
                    % (TIMING_RUNS, 2 * TIMING_PAIRS, TIMING_RUNS,
                       PROFILE_STEPS), "seconds": time.perf_counter() - t0})
    return routes, pairs


def phase_train_options(card):
    """LinearAE with the training options on both projection routes."""
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule
    from pedestrians_video_2_carla_torch.flows.pose_lifting import \
        PoseLiftingFlow
    from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
    from pedestrians_video_2_carla_torch.models.movements.linear_ae import \
        LinearAE
    from pedestrians_video_2_carla_torch.training.trainer import (
        Trainer, TrainerConfig)

    t0 = time.perf_counter()
    dm = Carla2D3DDataModule(batch_size=BATCH, clip_length=CLIP,
                             val_set_size=BATCH, seed=SEED)
    steps = OPT_EPOCH_STEPS * OPT_EPOCHS
    runs, counts = {}, {}
    for route in ("fused_train", "plain"):
        flow = PoseLiftingFlow(
            LinearAE(generator=torch.Generator().manual_seed(SEED)),
            loss_modes=["loc_2d_loc_rot_3d"], gradient_clip_val=1.0,
            movements_optimizer=OptimizerSettings(
                lr=LR, enable_lr_scheduler=True, scheduler_type="StepLR",
                scheduler_step_size=1, scheduler_gamma=0.5),
            projection_kernel=route, seed=SEED)
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(flow, dm, TrainerConfig(
                max_epochs=OPT_EPOCHS, limit_train_batches=OPT_EPOCH_STEPS,
                limit_val_batches=1, log_every_n_steps=1, seed=SEED,
                logs_dir=tmp, run_name=route))
            reset_kernel_counts()
            trainer.fit()
            torch.cuda.synchronize()
            counts[route] = {k: v for k, v in kernel_counts().items() if v}
            with open(os.path.join(tmp, route, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
        if flow.steps_per_epoch != OPT_EPOCH_STEPS:
            raise AssertionError(f"steps_per_epoch {flow.steps_per_epoch}")
        runs[route] = {
            "losses": [{k: v for k, v in r.items() if "_loss/" in k}
                       for r in records if "lr-movements" in r],
            "lrs": [r["lr-movements"] for r in records
                    if "lr-movements" in r],
            "val": [{k: v for k, v in r.items() if k.startswith("val_")}
                    for r in records if "epoch" in r]}
    expected = {"fused_train": {"fused_projection_train_fwd": steps
                                + OPT_EPOCHS,
                                "fused_projection_train_bwd": steps},
                "plain": {}}
    if counts != expected:
        raise AssertionError(f"launches {counts}, expected {expected}")
    a, b = runs["fused_train"], runs["plain"]
    if a["lrs"] != b["lrs"] or a["lrs"] != [
            LR * 0.5 ** (i // OPT_EPOCH_STEPS) for i in range(steps)]:
        raise AssertionError(f"lrs {a['lrs']} vs {b['lrs']}")
    worst = 0.0
    for got, ref in zip(a["losses"] + a["val"], b["losses"] + b["val"]):
        if set(got) != set(ref):
            raise AssertionError(f"keys {sorted(got)} vs {sorted(ref)}")
        for k, v in ref.items():
            if not np.isfinite(got[k]):
                raise AssertionError(f"{k} not finite")
            worst = max(worst, abs(got[k] - v) / max(abs(v), 1e-30))
    missing = [k for k in ("val_MPJPE", "val_MRPE", "val_FB_MPJPE",
                           "val_FB_WeightedMPJPE", "val_FB_PA_MPJPE",
                           "val_FB_N_MPJPE", "val_FB_MPJVE")
               if k not in a["val"][-1]]
    if worst > LOSS_RTOL or missing:
        raise AssertionError(f"fused_train vs plain {worst}, missing "
                             f"{missing}")
    emit({"phase": "train_options", "card": card, "B": BATCH, "L": CLIP,
          "steps": steps, "epoch_steps": OPT_EPOCH_STEPS,
          "launches": counts["fused_train"], "lrs": a["lrs"],
          "train_loss_primary": {r: [x["train_loss/primary"]
                                     for x in v["losses"]]
                                 for r, v in runs.items()},
          "val_last": {r: v["val"][-1] for r, v in runs.items()},
          "fused_train_vs_plain_max_rel": worst,
          "seconds": time.perf_counter() - t0})
    return counts["fused_train"]


#: the CLI's new loss modes; a short CLI fit each on both projection routes
CLI_LOSS_MODES = ("common_loc_2d", "rot_3d", "cum_pose_changes",
                  "pose_changes", "loc_2d_loc_rot_3d",
                  "weighted_loc_2d_loc_rot_3d", "loc_rot_3d",
                  "per_joint_loc_2d")
CLI_BATCH = 64


def phase_cli_options():
    """The CLI (``modeling.main``) on the card: config 2 on both encoder
    routes, and LinearAE with each new loss mode on both projection routes,
    each run clipped (``--gradient_clip_val``) and on one of the three LR
    schedules in turn: 2 steps and a validation batch, B=64, L=16; finite
    losses and metrics, the scheduled lr logged."""
    from pedestrians_video_2_carla_torch import modeling
    from pedestrians_video_2_carla_torch.models.base import SCHEDULER_TYPES

    t0 = time.perf_counter()
    common = [f"--batch_size={CLI_BATCH}", f"--clip_length={CLIP}",
              f"--val_set_size={CLI_BATCH}", "--max_epochs=1",
              "--limit_train_batches=2", "--log_every_n_steps=1",
              "--gradient_clip_val=1.0", "--movements_enable_lr_scheduler"]
    runs = [(f"config2_{route}", [
        "--flow=autoencoder", "--movements_model_name=Seq2SeqEmbeddings",
        "--movements_output_type=pose_2d", "--loss_modes", "loc_2d",
        "--rnn_kernel", route], "val_MSE") for route in ("fused", "plain")]
    runs += [(f"{mode}_{route}", [
        "--movements_model_name=LinearAE", "--loss_modes", mode,
        f"--projection_kernel={route}", "--loss_weights", "rot_3d=3.0",
        "--loss_params_0=2.0", "--loss_params_25=1.0"], "val_MPJPE")
        for mode in CLI_LOSS_MODES for route in ("fused_train", "plain")]
    done = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, flags, metric) in enumerate(runs):
            kind = SCHEDULER_TYPES[i % len(SCHEDULER_TYPES)]
            out = modeling.main(common + flags + [
                f"--movements_scheduler_type={kind}", f"--root_dir={tmp}",
                f"--run_name={name}", f"--seed={SEED}"])
            flow, val = out["flow"], out["val_metrics"]
            lr = flow.current_lrs(out["trainer"].state)["lr-movements"]
            if not (np.isfinite(val["val_loss/primary"])
                    and np.isfinite(val[metric]) and lr > 0
                    and out["trainer"].state.step == 2
                    and flow.gradient_clip_val == 1.0):
                raise AssertionError(f"CLI run {name}: {val}, lr {lr}")
            done[name] = {"scheduler": kind, "lr": lr,
                          "val_loss_primary": val["val_loss/primary"],
                          metric: val[metric]}
    emit({"phase": "cli_options", "B": CLI_BATCH, "L": CLIP,
          "runs": done, "seconds": time.perf_counter() - t0})


def group_autoencoder(card, hbm_rate):
    """BASELINE config 2 on the dense LSTM kernels, and the training
    options on config 1: -> extra keys for the kernels line's entries of
    the kernels they launched."""
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule

    dm = Carla2D3DDataModule(batch_size=AE_BATCH, clip_length=CLIP,
                             test_set_size=REQUESTS * AE_BATCH,
                             val_set_size=AE_VAL_BATCHES * AE_BATCH,
                             seed=SEED)
    t0 = time.perf_counter()
    serve = phase_serve_autoencoder(list(dm.test_batches()))
    train = phase_train_autoencoder(dm)
    _, pairs = phase_timing_autoencoder(dm, card, hbm_rate)
    options = phase_train_options(card)
    phase_cli_options()
    emit({"phase": "group_autoencoder", "seconds": time.perf_counter() - t0})
    steps = {"config2_train_step_ms_fused": pairs["train_step"][
                 "fused_ms_median"],
             "config2_train_step_ms_plain": pairs["train_step"][
                 "plain_ms_median"]}
    return {"dense_lstm_scan": {
                "launches_config2_serve": serve,
                "launches_config2_train": train["dense_lstm_scan"], **steps},
            "dense_lstm_scan_bwd": {
                "launches_config2_serve": 0,
                "launches_config2_train": train["dense_lstm_scan_bwd"],
                **steps},
            "fused_projection_train_fwd": {
                "launches_train_options": options[
                    "fused_projection_train_fwd"]},
            "fused_projection_train_bwd": {
                "launches_train_options": options[
                    "fused_projection_train_bwd"]}}


def make_vp_flow(device=None, dtype=torch.float32, precision="32"):
    """BASELINE config 4's flow: VideoPose3D (filter widths (3, 3, 3, 3),
    1024 channels, dropout 0.25; seeded init) in PoseLiftingFlow with
    loc_2d."""
    from pedestrians_video_2_carla_torch.flows.pose_lifting import \
        PoseLiftingFlow
    from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
    from pedestrians_video_2_carla_torch.models.movements.video_pose_3d \
        import VideoPose3D

    model = VideoPose3D(generator=torch.Generator().manual_seed(SEED))
    if (model.filter_widths, model.channels, model.p_dropout,
            model.receptive_field) != ((3, 3, 3, 3), 1024, 0.25, VP_CLIP):
        raise AssertionError("VideoPose3D's defaults changed")
    return PoseLiftingFlow(model.to(dtype), loss_modes=["loc_2d"],
                           movements_optimizer=OptimizerSettings(lr=LR),
                           seed=SEED, device=device, precision=precision)


def vp_params(flow):
    """The flow's seeded params with running statistics drawn away from 0
    and 1 (means N(0, 0.2), variances U(0.5, 2))."""
    gen = torch.Generator().manual_seed(SEED + 23)
    params = flow.init_params()
    for k, v in params["movements"].items():
        if k.endswith("running_mean"):
            v.copy_(0.2 * torch.randn(v.shape, generator=gen))
        elif k.endswith("running_var"):
            v.copy_(0.5 + 1.5 * torch.rand(v.shape, generator=gen))
    return params


def phase_serve_videopose3d(batches):
    """8 requests of config 4 under torch's default TF32 flags (cuDNN
    TF32 on, matmul TF32 off), each held to the same model and weights in
    float64 on the CPU."""
    from pedestrians_video_2_carla_torch.serving import make_inference_fn

    t0 = time.perf_counter()
    flow = make_vp_flow()
    params = vp_params(flow)
    ref_flow = make_vp_flow("cpu", torch.float64)
    ref_params = {n: {k: v.cpu().double() for k, v in tree.items()}
                  for n, tree in params.items()}
    infer = make_inference_fn(flow, params)
    infer_ref = make_inference_fn(ref_flow, ref_params)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False    # torch's defaults
    torch.backends.cudnn.allow_tf32 = True
    try:
        reset_kernel_counts()
        served = [infer(inputs, meta["age_gender_idx"])
                  for inputs, _, meta in batches]
        torch.cuda.synchronize()
        counts = kernel_counts()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    if counts != expected_counts():
        raise AssertionError(f"config 4 launched kernels: {counts}")
    worst = {}
    for preds, (inputs, _, meta) in zip(served, batches):
        ref = infer_ref(inputs.cpu().double(), meta["age_gender_idx"].cpu())
        for key in ("absolute_pose_loc", "projection_2d",
                    "projection_2d_transformed"):
            out = preds[key]
            if out.shape[:2] != (VP_BATCH, VP_CLIP) \
                    or not torch.isfinite(out).all():
                raise AssertionError(f"{key}: {tuple(out.shape)} or not "
                                     f"finite")
            err = float((out.cpu().double() - ref[key]).abs().max()
                        / ref[key].abs().max())
            worst[key] = max(worst.get(key, 0.0), err)
    if max(worst.values()) > VP_BAR:
        raise AssertionError(f"config 4 vs float64: {worst}")
    emit({"phase": "serve_videopose3d", "B": VP_BATCH, "L": VP_CLIP,
          "requests": len(batches),
          "tf32_flags": {"cuda.matmul.allow_tf32": False,
                         "cudnn.allow_tf32": True},
          "max_err_over_max_f64": worst, "bar": VP_BAR,
          "seconds": time.perf_counter() - t0})
    return flow, params


def vp_stats(tree):
    return {k: v for k, v in tree.items() if "running_" in k}


def phase_train_videopose3d(dm):
    """Trainer.fit of config 4: finite losses, moved running statistics,
    eval output against train-mode output, an exact checkpoint round
    trip (running statistics included) and the same eval bits after it."""
    from pedestrians_video_2_carla_torch.training.trainer import (
        Trainer, TrainerConfig)

    t0 = time.perf_counter()
    flow = make_vp_flow()
    start = vp_stats(flow.init_params()["movements"])
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(flow, dm, TrainerConfig(
            max_epochs=1, limit_train_batches=VP_TRAIN_STEPS,
            limit_val_batches=VP_VAL_BATCHES, log_every_n_steps=1,
            seed=SEED, logs_dir=tmp, run_name="vp"))
        reset_kernel_counts()
        state = trainer.fit()
        torch.cuda.synchronize()
        if kernel_counts() != expected_counts():
            raise AssertionError(f"config 4 launched {kernel_counts()}")
        run = os.path.join(tmp, "vp")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        losses = [r["train_loss/primary"] for r in records
                  if "lr-movements" in r]
        bad = [k for r in records for k, v in r.items()
               if "_loss/" in k and not np.isfinite(v)]
        if bad or len(losses) != VP_TRAIN_STEPS:
            raise AssertionError(f"config 4 fit: non-finite {bad}, "
                                 f"{len(losses)} steps")
        tree = state.params["movements"]
        stats = vp_stats(tree)
        moved = {k: float((v - start[k]).abs().max())
                 for k, v in stats.items()}
        if len(stats) != 14 or min(moved.values()) <= 0.0 or any(
                v.requires_grad for v in stats.values()):
            raise AssertionError(f"running statistics: {moved}")
        batch = next(dm.val_batches())
        with torch.no_grad():
            copy = {n: {k: v.detach().clone() for k, v in t.items()}
                    for n, t in state.params.items()}
            train_out = flow._inner_step(copy, batch, training=True)[
                "absolute_pose_loc"]
        loss, preds, _ = flow.eval_step(state.params, batch)
        eval_vs_train = float((preds["absolute_pose_loc"]
                               - train_out).abs().max())
        if not eval_vs_train > 0.0:
            raise AssertionError("eval and train-mode outputs are the same")
        restored = flow.init_state()
        trainer.checkpoints.restore(restored,
                                    os.path.join(run, "checkpoints", "last"))
        same = all(torch.equal(restored.params[n][k], v)
                   for n, t in state.params.items() for k, v in t.items())
        again, preds_again, _ = flow.eval_step(restored.params, batch)
        if not (same and restored.step == VP_TRAIN_STEPS
                and torch.equal(preds_again["absolute_pose_loc"],
                                preds["absolute_pose_loc"])
                and torch.equal(again["loc_2d"], loss["loc_2d"])):
            raise AssertionError("config 4's checkpoint does not restore "
                                 "exactly")
    emit({"phase": "train_videopose3d", "B": VP_BATCH, "L": VP_CLIP,
          "steps": VP_TRAIN_STEPS, "losses": losses,
          "val": {k: v for k, v in records[-1].items()
                  if k.startswith("val_")},
          "running_stats_moved_min": min(moved.values()),
          "eval_vs_train_max_abs": eval_vs_train,
          "restore_exact": True, "seconds": time.perf_counter() - t0})


def phase_timing_videopose3d(dm, flow, params, card, hbm_rate):
    """Config 4's training_step and request, host clock and CUDA events;
    a profiled window of 3 steps; the step's products against the fp32
    peak."""
    from torch.func import functional_call

    from pedestrians_video_2_carla_torch.ops.flops import video_pose_3d_flops
    from pedestrians_video_2_carla_torch.serving import make_inference_fn

    t0 = time.perf_counter()
    state = flow.init_state(params)
    batch = next(dm.train_batches(SEED + 9))
    inputs, _, meta = next(dm.test_batches())
    infer = make_inference_fn(flow, params)
    step = functools.partial(flow.training_step, state, batch)
    request = functools.partial(infer, inputs, meta["age_gender_idx"])
    model = flow.movements_model

    def forward():       # the model alone, as a request runs it
        with torch.no_grad():
            functional_call(model, params["movements"], (inputs,))

    def forward_backward():  # the model alone, as a step runs it
        out = functional_call(model, state.params["movements"], (batch[0],),
                              {"training": True, "generator": flow.generator})
        out.sum().backward()
    times = {"train_step_ms_host": host_median_ms(step),
             "train_step_ms_cuda_events": cuda_median_ms(step),
             "request_ms_host": host_median_ms(request),
             "request_ms_cuda_events": cuda_median_ms(request),
             "model_forward_ms_host": host_median_ms(forward),
             "model_forward_ms_cuda_events": cuda_median_ms(forward),
             "model_forward_backward_ms_host": host_median_ms(
                 forward_backward),
             "model_forward_backward_ms_cuda_events": cuda_median_ms(
                 forward_backward),
             "adamw_ms_cuda_events": cuda_median_ms(state.optimizer.step)}
    profiles = {}
    for name, fn in (("train_step", step), ("request", request)):
        trace, _ = profile_steps(fn)
        trace["top_device_ops_ms"] = trace["top_device_ops_ms"][:5]
        trace["device_events_per_call"] = trace["device_events"] \
            / PROFILE_STEPS
        profiles[name] = trace
    shape = (VP_BATCH, VP_CLIP, len(model.input_nodes), model.filter_widths,
             model.channels)
    flops = {"train_step": video_pose_3d_flops(*shape, train=True),
             "forward": video_pose_3d_flops(*shape)}
    # bytes: each input read and each output written once (the request:
    # weights, clips in, locations out; the step: weights and AdamW's two
    # moments read and written, clips in)
    n_params = sum(p.numel() for p in model.parameters())
    clips = VP_BATCH * VP_CLIP * len(model.input_nodes)
    moved = {"train_step": 4 * (6 * n_params + 2 * clips),
             "forward": 4 * (n_params + 2 * clips + 3 * clips)}
    bounds = {k: max(v / FP32_PEAK, moved[k] / hbm_rate) * 1e3
              for k, v in flops.items()}
    emit({"phase": "timing_videopose3d", "card": card, "B": VP_BATCH,
          "L": VP_CLIP, **times, "profiles": profiles, "gflop": {
              k: v / 1e9 for k, v in flops.items()},
          "bound_ms": bounds, "bound_by": "operations" if all(
              flops[k] / FP32_PEAK > moved[k] / hbm_rate for k in flops)
          else "bytes", "parameters": n_params,
          "train_step_over_bound": times["train_step_ms_cuda_events"]
          / bounds["train_step"],
          "request_over_bound": times["request_ms_cuda_events"]
          / bounds["forward"],
          "tflops_train_step": flops["train_step"]
          / times["train_step_ms_cuda_events"] / 1e9,
          "method": "host clock to torch.cuda.synchronize() and CUDA events "
                    "around one call, medians of %d after 3 warm-ups (the "
                    "model alone through functional_call: a no-grad "
                    "forward; a training forward and the backward of its "
                    "sum; AdamW's step alone); profiles: torch.profiler "
                    "over 3 calls; bounds: the larger of the dense products "
                    "(ops/flops.py) at the CUDA cores' 67 TFLOP/s fp32 and "
                    "the bytes over the memory rate" % TIMING_RUNS,
          "seconds": time.perf_counter() - t0})
    return times


def phase_lifters_coverage():
    """A 3-step fit of each other new movements model at B=256, L=16 (the
    published widths): finite losses; one eval_step twice, the same
    bits."""
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule
    from pedestrians_video_2_carla_torch.flows.autoencoder import \
        AutoencoderFlow
    from pedestrians_video_2_carla_torch.flows.pose_lifting import \
        PoseLiftingFlow
    from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
    from pedestrians_video_2_carla_torch.models.movements import \
        MOVEMENTS_MODELS
    from pedestrians_video_2_carla_torch.training.trainer import (
        Trainer, TrainerConfig)

    t0 = time.perf_counter()
    dm = Carla2D3DDataModule(batch_size=LIFTERS_BATCH, clip_length=CLIP,
                             val_set_size=LIFTERS_BATCH, seed=SEED)
    batch = next(dm.val_batches())
    models = {}
    for name in LIFTERS_POSE + LIFTERS_AUTOENCODERS:
        model = MOVEMENTS_MODELS[name](
            generator=torch.Generator().manual_seed(SEED))
        pose = name in LIFTERS_POSE
        flow = (PoseLiftingFlow if pose else AutoencoderFlow)(
            model, loss_modes=["loc_2d_3d" if pose else "loc_2d"],
            movements_optimizer=OptimizerSettings(lr=LR), seed=SEED)
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(flow, dm, TrainerConfig(
                max_epochs=1, limit_train_batches=LIFTERS_STEPS,
                limit_val_batches=1, log_every_n_steps=1, seed=SEED,
                logs_dir=tmp, run_name=name))
            t = time.perf_counter()
            state = trainer.fit()
            torch.cuda.synchronize()
            with open(os.path.join(tmp, name, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
        losses = [r["train_loss/primary"] for r in records
                  if "lr-movements" in r]
        first, _, _ = flow.eval_step(state.params, batch)
        second, _, _ = flow.eval_step(state.params, batch)
        if len(losses) != LIFTERS_STEPS or not all(
                np.isfinite(v) for r in records for k, v in r.items()
                if "_loss/" in k) or any(
                not torch.equal(first[k], second[k]) for k in first):
            raise AssertionError(f"{name}: losses {losses}, eval "
                                 f"{first} / {second}")
        models[name] = {"losses": losses, "fit_s": time.perf_counter() - t,
                        "params": flow.param_counts(state)["movements"],
                        "running_stats": sum(
                            not v.requires_grad for v in
                            state.params["movements"].values())}
    emit({"phase": "lifters_coverage", "B": LIFTERS_BATCH, "L": CLIP,
          "models": models, "seconds": time.perf_counter() - t0})


def group_lifters(card, hbm_rate):
    """BASELINE config 4 (VideoPose3D at rf 81, no kernel on its path) and
    the other new movements models."""
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule

    t0 = time.perf_counter()
    dm = Carla2D3DDataModule(batch_size=VP_BATCH, clip_length=VP_CLIP,
                             test_set_size=REQUESTS * VP_BATCH,
                             val_set_size=VP_VAL_BATCHES * VP_BATCH,
                             seed=SEED)
    flow, params = phase_serve_videopose3d(list(dm.test_batches()))
    phase_train_videopose3d(dm)
    phase_timing_videopose3d(dm, flow, params, card, hbm_rate)
    del flow, params, dm
    torch.cuda.empty_cache()
    phase_lifters_coverage()
    emit({"phase": "group_lifters", "seconds": time.perf_counter() - t0})


def openpose_clips(rng, n):
    """``n`` OpenPose BODY_25 clips (CLIP frames) in pixels, in numpy: a
    reference skeleton's projection (``ops/reference_skeletons.py``) mapped
    CARLA -> BODY_25 with ``map_pose``, scaled, placed on a 1920 x 1080
    frame and walked across it, its legs (and, against them, its arms)
    swinging; seeded noise, undetected joints (zeros, confidence 0) and
    the joints BODY_25 has and CARLA does not (ears, heels) at zero.
    Returns (detections (n, L, 25, 3), the clean clips (n, L, 25, 2)
    before noise and dropouts, targets {bboxes, crossing}, meta): the label
    is whether the clip's legs swing (OP_SWING_THRESHOLD)."""
    from pedestrians_video_2_carla_torch.ops.reference_skeletons import \
        reference_projections
    from pedestrians_video_2_carla_torch.skeletons import (
        AGE_GENDER_KEYS, BODY_25_SKELETON as B25, CARLA_SKELETON, map_pose)

    refs = map_pose(reference_projections()[..., :2], CARLA_SKELETON, B25)
    detected = np.any(refs[0] != 0, axis=-1)              # (25,)
    kind = rng.integers(0, len(AGE_GENDER_KEYS), n)
    base = refs[kind]
    hips, neck = base[:, int(B25.MidHip)], base[:, int(B25.Neck)]
    scale = rng.uniform(0.5, 1.5, n)
    length = np.linalg.norm(neck - hips, axis=-1) * scale  # hips-neck, px
    swings = rng.uniform(size=n) < 0.5
    amplitude = np.where(swings, rng.uniform(*OP_SWING_HIGH, n),
                         rng.uniform(*OP_SWING_LOW, n)) * length
    t = np.arange(CLIP)
    swing = amplitude[:, None] * np.sin(
        2 * np.pi * rng.uniform(0.05, 0.12, n)[:, None] * t
        + rng.uniform(0, 2 * np.pi, n)[:, None])            # (n, L)
    pose = np.repeat(((base - hips[:, None]) * scale[:, None, None])[:, None],
                     CLIP, axis=1)                          # (n, L, 25, 2)
    for side, sign in (("R", 1.0), ("L", -1.0)):
        pose[..., int(B25[f"{side}Knee"]), 0] += 0.5 * sign * swing
        for joint in ("Ankle", "BigToe", "SmallToe", "Heel"):
            pose[..., int(B25[f"{side}{joint}"]), 0] += sign * swing
        pose[..., int(B25[f"{side}Elbow"]), 0] -= 0.2 * sign * swing
        pose[..., int(B25[f"{side}Wrist"]), 0] -= 0.4 * sign * swing
    pose += rng.uniform((300.0, 300.0), (1620.0, 700.0), (n, 2))[:, None,
                                                                 None]
    pose[..., 0] += rng.uniform(-3.0, 3.0, n)[:, None, None] * t[:, None]
    pose *= detected[:, None]
    ankles = pose[..., int(B25.RAnkle), 0] - pose[..., int(B25.LAnkle), 0]
    labels = (ankles.std(axis=1) / length > OP_SWING_THRESHOLD)
    clean = pose.astype(np.float32)

    seen = detected & (rng.uniform(size=pose.shape[:-1]) >= OP_UNDETECTED)
    noisy = pose + rng.normal(0.0, OP_NOISE_PX, pose.shape)
    confidence = rng.uniform(0.4, 1.0, pose.shape[:-1])
    detections = np.concatenate([noisy, confidence[..., None]], axis=-1)
    detections = (detections * seen[..., None]).astype(np.float32)
    inf = np.where(seen[..., None], 0.0, np.inf)
    bboxes = np.stack([(detections[..., :2] + inf).min(axis=-2),
                       (detections[..., :2] - inf).max(axis=-2)], axis=-2)
    ages, genders = zip(*(k.split("_") for k in AGE_GENDER_KEYS))
    meta = {"age": np.asarray(ages)[kind], "gender": np.asarray(genders)[kind],
            "clip_width": np.full(n, 1920, np.int32),
            "clip_height": np.full(n, 1080, np.int32)}
    targets = {"bboxes": bboxes.astype(np.float32),
               "crossing": labels.astype(np.int32)}
    return detections, clean, targets, meta


def openpose_datamodule(device_resident=False):
    """The port's Hdf5DataModule on the card with in-memory subsets
    (add_subset; the card's machine has no h5py): BODY_25 detections
    remapped to the CARLA skeleton, hips_neck, flip and rotation in
    training; the subsets on the card with ``device_resident``. Returns it
    and the test subset's clean clips."""
    from pedestrians_video_2_carla_torch.data.base.hdf5_datamodule import \
        Hdf5DataModule
    from pedestrians_video_2_carla_torch.skeletons import (BODY_25_SKELETON,
                                                           CARLA_SKELETON)

    dm = Hdf5DataModule(batch_size=CLS_BATCH, clip_length=CLIP,
                        data_nodes=BODY_25_SKELETON,
                        input_nodes=CARLA_SKELETON, augment_flip=True,
                        augment_rotate=True, seed=SEED,
                        device_resident=device_resident,
                        outputs_dir=tempfile.gettempdir())
    rng = np.random.default_rng(SEED + 16)
    for name, batches in (("train", OP_TRAIN_BATCHES),
                          ("val", OP_VAL_BATCHES),
                          ("test", OP_TEST_BATCHES)):
        detections, clean, targets, meta = openpose_clips(
            rng, batches * CLS_BATCH)
        dm.add_subset(name, detections, targets, meta)
    return dm, clean


def device_launches(fn):
    """The device kernels and copies of one call of ``fn`` (after a
    warm-up), from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if getattr(e, "device_type", None) is not None
             and e.device_type.name == "CUDA"]
    copies = sum("emcpy" in n or "emset" in n for n in names)
    return {"kernels": len(names) - copies, "copies_and_sets": copies}


def preprocessing_close(got, ref):
    """Max |a - b| of two outputs of process_batch and whether they agree
    (OP_ATOL beside OP_RTOL); the presence or confidence channel exactly."""
    worst, ok = 0.0, True
    for a, b in zip(got, ref):
        a, b = a.cpu().double(), b.cpu().double()
        worst = max(worst, float((a - b).abs().max()))
        ok &= bool(((a - b).abs() <= OP_ATOL + OP_RTOL * b.abs()).all())
    return worst, ok


def phase_preprocess_card(dm, clean):
    """process_batch on the card: a deterministic configuration against the
    same call on the CPU; flip, rotation, noise and missing joints by their
    properties; its time and launches at B=256, L=16."""
    from pedestrians_video_2_carla_torch.ops import augmentation as A
    from pedestrians_video_2_carla_torch.ops import preprocessing as P
    from pedestrians_video_2_carla_torch.skeletons import (BODY_25_SKELETON,
                                                           CARLA_SKELETON)

    projection_2d, targets, _ = dm._subsets["test"]
    raw = torch.from_numpy(projection_2d[:CLS_BATCH])
    det = P.PreprocessingConfig(data_nodes=BODY_25_SKELETON,
                                input_nodes=CARLA_SKELETON,
                                needs_confidence=True)
    out, masks = {}, {}
    for where, device in (("card", "cuda"), ("host", "cpu")):
        inputs, tg = P.process_batch(None, raw.to(device), det)
        out[where] = [inputs[..., :2]] + [tg[k] for k in sorted(tg)]
        masks[where] = inputs[..., 2].cpu()
    err, ok = preprocessing_close(out["card"], out["host"])
    if not ok or not torch.equal(masks["card"], masks["host"]):
        raise AssertionError(f"process_batch on the card vs the CPU: {err}")

    # flip, rotation, noise and a joint that is always dropped (RWrist ->
    # crl_hand__R), on the clean clips (no missing joints to move)
    probs = [0.0] * len(BODY_25_SKELETON)
    probs[int(BODY_25_SKELETON.RWrist)] = 1.0
    rnd = P.PreprocessingConfig(
        data_nodes=BODY_25_SKELETON, input_nodes=CARLA_SKELETON,
        noise="gaussian", noise_param=3.0,
        missing_joint_probabilities=tuple(probs), augment_flip=0.5,
        augment_rotate=10.0, needs_confidence=True)
    pose = torch.from_numpy(clean[:CLS_BATCH]).cuda()
    bboxes = torch.from_numpy(targets["bboxes"][:CLS_BATCH]).cuda()
    size = torch.tensor([[1920.0, 1080.0]], device="cuda").expand(
        CLS_BATCH, 2)

    def run(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return P.process_batch(gen, pose, rnd, True, bboxes=bboxes,
                               clip_size=size)
    inputs, tg = run(SEED)
    again, _ = run(SEED)
    hand = int(CARLA_SKELETON.crl_hand__R)
    deformed = tg["projection_2d_deformed"]
    present = (deformed != 0).any(-1)
    aug = A.AugmentPose(BODY_25_SKELETON, flip=0.5, rotate=10.0)
    augmented, aug_bb, drawn = aug(
        torch.Generator(device="cuda").manual_seed(SEED), pose,
        bboxes=bboxes, clip_size=size)
    back = aug.invert(augmented, drawn, bboxes=aug_bb, clip_size=size)
    invert_err = float((back - pose).abs().max())
    clean_err = float((tg["projection_2d"]
                       - P.remap_nodes(augmented, rnd)).abs().max())
    noise = (deformed - tg["projection_2d"])[present]
    checks = {
        "same_bits_twice": torch.equal(inputs, again),
        "dropped_joint_confidence_0": bool((inputs[..., hand, 2] == 0).all()),
        "dropped_joint_zero": bool((deformed[..., hand, :] == 0).all()),
        "presence_channel": torch.equal(inputs[..., 2], present.float()),
        "flips_drawn": torch.equal(drawn.is_flipped, tg["is_flipped"]),
        "clean_targets_without_noise": clean_err <= 1e-3,
        "invert_gets_pose_back": invert_err <= 1e-2,
        "noise_std_near_3px": 2.5 < float(noise.std()) < 3.5,
        "flip_rate": float(tg["is_flipped"].float().mean()),
        "rotation_range": [float(tg["rotation"].min()),
                           float(tg["rotation"].max())]}
    failed = [k for k, v in checks.items() if v is False]
    if failed or not 0.3 < checks["flip_rate"] < 0.7 or not (
            -10 <= checks["rotation_range"][0] < -5
            and 5 < checks["rotation_range"][1] <= 10):
        raise AssertionError(f"random preprocessing: {checks}")

    # time and launches: the fit's training and evaluation configurations
    raw_d = raw.cuda()
    bb_d = torch.from_numpy(targets["bboxes"][:CLS_BATCH]).cuda()
    timed = {}
    for name, training in (("train_flip_rotate", True), ("eval", False)):
        def call():
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            P.process_batch(gen, raw_d, dm.preprocessing, training,
                            bboxes=bb_d, clip_size=size)
        timed[name] = {"cuda_event_ms": cuda_median_ms(call),
                       "host_ms": host_median_ms(call),
                       "launches": device_launches(call)}
    emit({"phase": "preprocess_card", "B": CLS_BATCH, "L": CLIP,
          "card_vs_cpu_max_abs": err, "masks_equal": True,
          "invert_max_abs_px": invert_err, "clean_vs_augmented_max_abs_px":
          clean_err, "noise_std_px": float(noise.std()), **checks,
          "process_batch": timed})
    return timed


def phase_train_openpose(dm):
    """Config 3's classifier fit on the labelled clips, with flip and
    rotation; then the fused and plain routes step by step from the same
    weights."""
    flow = make_cls_flow()
    steps = OP_TRAIN_BATCHES
    expected = {"graph_gru_scan": 2 * OP_EPOCHS * (steps + OP_VAL_BATCHES),
                "graph_gru_scan_bwd": 2 * OP_EPOCHS * steps}
    counts, losses, epochs, fit_s, hparams = fit_classifier(
        flow, dm, steps, OP_VAL_BATCHES, "openpose", expected,
        epochs=OP_EPOCHS)
    val = [e["val_loss/primary"] for e in epochs]
    initial = {k: v for k, v in hparams.items() if k.startswith("initial_")
               and not isinstance(v, list)}
    if "initial_Accuracy" not in initial or int(np.sum(hparams[
            "initial_ConfusionMatrix"])) != OP_VAL_BATCHES * CLS_BATCH:
        raise AssertionError(f"the fit-start baseline: {hparams}")
    if not (val[-1] < OP_LOSS_BAR and val[-1] < val[0]):
        raise AssertionError(f"the classifier did not learn: validation "
                             f"losses {val}")

    routes = {r: make_cls_flow(graph_kernel=r) for r in ("fused", "plain")}
    params = routes["fused"].init_params()
    states = {r: f.init_state(params) for r, f in routes.items()}
    stream = dm.train_batches(SEED + 1)
    batches = [next(stream) for _ in range(OP_PARITY_STEPS)]
    reset_kernel_counts()
    per_step, worst = [], 0.0
    for batch in batches:
        a, b = (float(routes[r].training_step(states[r], batch)[1][
            "train_loss/primary"]) for r in ("fused", "plain"))
        rel = abs(a - b) / abs(b)
        if not rel <= LOSS_RTOL:
            raise AssertionError(f"fused {a} vs plain {b}")
        worst = max(worst, rel)
        per_step.append([a, b])
    parity = kernel_counts()
    if parity != expected_counts(graph_gru_scan=2 * OP_PARITY_STEPS,
                                 graph_gru_scan_bwd=2 * OP_PARITY_STEPS):
        raise AssertionError(f"parity steps' launches {parity}")
    last = epochs[-1]
    emit({"phase": "train_openpose", "B": CLS_BATCH, "L": CLIP,
          "epochs": OP_EPOCHS, "steps_per_epoch": steps,
          "val_batches": OP_VAL_BATCHES,
          "train_clips_crossing_share": float(
              dm._subsets["train"][1]["crossing"].mean()),
          "launches": {k: v for k, v in counts.items() if v},
          "fit_seconds": fit_s, "train_loss_primary": losses,
          "val_loss_by_epoch": val, "loss_bar": OP_LOSS_BAR,
          "initial": initial,
          "val": {k: v for k, v in last.items()
                  if k.startswith("val_") and not isinstance(v, list)},
          "val_confusion_matrix": last["val_ConfusionMatrix"],
          "restored_equal": True, "fused_vs_plain_losses": per_step,
          "fused_vs_plain_max_rel": worst})
    return counts


def phase_serve_openpose(dm):
    """eval_step (a classifier's serving call) on the test batches, twice:
    2 forward launches each, the same bits both times."""
    flow = make_cls_flow()
    params = flow.init_params()
    batches = list(dm.test_batches())
    reset_kernel_counts()
    runs = [[flow.eval_step(params, b)[1]["crossing_logits"]
             for b in batches] for _ in range(2)]
    torch.cuda.synchronize()
    counts = kernel_counts()
    if counts != expected_counts(graph_gru_scan=2 * 2 * len(batches)):
        raise AssertionError(f"serving launches {counts}")
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    finite = all(bool(torch.isfinite(a).all()) and tuple(a.shape)
                 == (CLS_BATCH, 2) for a in runs[0])
    if not (same and finite):
        raise AssertionError(f"serving: same bits {same}, finite {finite}")
    emit({"phase": "serve_openpose", "B": CLS_BATCH, "L": CLIP,
          "requests": len(batches), "passes": 2,
          "launches": counts["graph_gru_scan"], "same_bits": True})
    return counts["graph_gru_scan"]


def phase_gcn_coverage(dm):
    """GCNBestPaper and GCNBestPaperTransformer (no kernel on their path):
    3-step fits and a validation batch at B=256, L=16, an eval_step twice
    the same bits."""
    out = {}
    for name in ("GCNBestPaper", "GCNBestPaperTransformer"):
        flow = make_cls_flow(name)
        _, losses, epochs, fit_s, _ = fit_classifier(
            flow, dm, OP_GCN_STEPS, 1, name, {})
        params = flow.init_params()
        batch = next(dm.val_batches())
        a, b = (flow.eval_step(params, batch)[1]["crossing_logits"]
                for _ in range(2))
        if not (torch.equal(a, b) and tuple(a.shape) == (CLS_BATCH, 1)):
            raise AssertionError(f"{name}: eval_step {tuple(a.shape)}, "
                                 f"same bits {torch.equal(a, b)}")
        out[name] = {"train_loss_primary": losses,
                     "val_loss": epochs[-1]["val_loss/primary"],
                     "fit_seconds": fit_s}
    emit({"phase": "gcn_coverage", "B": CLS_BATCH, "L": CLIP,
          "steps": OP_GCN_STEPS, "same_bits": True, **out})


def phase_timing_openpose(dm, card, process_batch_times):
    """Host-clock and CUDA-event medians of config 3's step (the batch made
    from the subset, preprocessed on the card, and the training step) and
    of an eval_step, with process_batch's share of the step."""
    flow = make_cls_flow()
    state = flow.init_state()
    params = flow.init_params()
    stream = iter(())

    def next_batch():
        nonlocal stream
        try:
            return next(stream)
        except StopIteration:
            stream = dm.train_batches(SEED + 2)
            return next(stream)
    batch = next_batch()
    eval_batch = next(dm.val_batches())
    step = {
        "step_with_batch": lambda: flow.training_step(state, next_batch()),
        "training_step": lambda: flow.training_step(state, batch),
        "make_batch": next_batch,
        "eval_step": lambda: flow.eval_step(params, eval_batch)}
    times = {k: {"host_ms": host_median_ms(fn),
                 "cuda_event_ms": cuda_median_ms(fn)}
             for k, fn in step.items()}
    pb = process_batch_times["train_flip_rotate"]
    emit({"phase": "timing_openpose", "card": card, "B": CLS_BATCH,
          "L": CLIP, **times,
          "process_batch_share_of_step_host": pb["host_ms"]
          / times["step_with_batch"]["host_ms"],
          "process_batch_share_of_step_cuda_event": pb["cuda_event_ms"]
          / times["step_with_batch"]["cuda_event_ms"],
          "method": "medians of %d calls after 3 warm-ups; host clock with a "
                    "synchronize after each call, CUDA events around one "
                    "call after a device sleep; step_with_batch takes the "
                    "next batch of the train stream (numpy slice, copies to "
                    "the card, process_batch with flip and rotation) and "
                    "trains on it" % TIMING_RUNS})
    return times


def group_openpose(card, hbm_rate):
    """BASELINE config 3 on real-format labels: OpenPose BODY_25 clips in
    the HDF5 datamodule's in-memory subsets, preprocessed on the card into
    GConvGRU (rows 10-11) and the two GCN classifiers -> extra keys for
    rows 10 and 11 of the kernels line."""
    t0 = time.perf_counter()
    dm, clean = openpose_datamodule()
    pb = phase_preprocess_card(dm, clean)
    counts = phase_train_openpose(dm)
    served = phase_serve_openpose(dm)
    phase_gcn_coverage(dm)
    times = phase_timing_openpose(dm, card, pb)
    emit({"phase": "group_openpose", "seconds": time.perf_counter() - t0})
    step = {"config3_openpose_step_ms": times["step_with_batch"]["host_ms"],
            "config3_process_batch_ms": pb["train_flip_rotate"]["host_ms"]}
    return {"graph_gru_scan": {
                "launches_openpose_train": counts["graph_gru_scan"],
                "launches_openpose_serve": served, **step},
            "graph_gru_scan_bwd": {
                "launches_openpose_train": counts["graph_gru_scan_bwd"],
                "launches_openpose_serve": 0, **step}}


SERVE_REQUESTS = 2
SERVE_BAR = 1e-6
CPU_LOAD_BATCH = 8


def artifact_cases():
    """(name, flow, B, output_keys, launches a request by wrapper) of the
    artifacts group_serving exports."""
    from pedestrians_video_2_carla_torch.flows.pose_lifting import \
        PoseLiftingFlow
    from pedestrians_video_2_carla_torch.models.movements.pose_former import \
        PoseFormer

    flow_f, _ = make_flows()
    pf = PoseLiftingFlow(PoseFormer(
        clip_length=CLIP, generator=torch.Generator().manual_seed(SEED)),
        loss_modes=["loc_2d_3d"])
    return [
        ("linear_ae_fused", flow_f, BATCH, None, {"fused_projection": 1}),
        ("linear_ae_fused_projection_2d", flow_f, BATCH,
         ("projection_2d",), {"fused_projection": 1}),
        ("linear_ae_fused_train", make_train_flow("fused_train"), BATCH,
         None, {"fused_projection_train_fwd": 1}),
        ("poseformer", pf, PF_BATCH, None,
         {"fused_spatial_stack": 1, "fused_temporal_block": PF_DEPTH}),
        ("gconvgru", make_cls_flow(), CLS_BATCH, None,
         {"graph_gru_scan": 2}),
        ("gconvlstm", make_cls_flow("GConvLSTM"), CLS_BATCH, None,
         {"graph_lstm_scan": 2}),
        ("config2_seq2seq", make_ae_flow("fused"), AE_BATCH, None,
         {"dense_lstm_scan": AE_LAYERS})]


def program_ops(path):
    """(node count, the pv2c ops by name) of an exported program."""
    nodes = list(torch.export.load(path).graph.nodes)
    ops = {}
    for n in nodes:
        if n.op == "call_function" and str(n.target).startswith("pv2c."):
            name = str(n.target).split(".")[1]
            ops[name] = ops.get(name, 0) + 1
    return len(nodes), ops


class GcWatch:
    """Python's garbage collections while it is entered: how many, how
    many full (generation 2), and their milliseconds."""

    def __enter__(self):
        import gc
        self.count, self.full, self.ms, self._t = 0, 0, 0.0, 0.0
        gc.callbacks.append(self._callback)
        return self

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
            return
        self.count += 1
        self.full += info["generation"] == 2
        self.ms += (time.perf_counter() - self._t) * 1e3

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._callback)

    def stats(self):
        return {"collections": self.count, "full": self.full,
                "ms": self.ms}


def paired_gc(fns):
    """``paired_host_ms`` of two callables in 10 pairs twice: as the
    process stands (its collections counted), then with every object that
    exists frozen out of the collector (``gc.freeze``), so that no full
    collection of the process's few hundred thousand objects lands in a
    call."""
    import gc
    with GcWatch() as watch:
        pairs = paired_host_ms(fns, pairs=TIMING_PAIRS)
    gc.collect()
    gc.freeze()
    try:
        frozen = paired_host_ms(fns, pairs=TIMING_PAIRS)
    finally:
        gc.unfreeze()
    return {**pairs, "gc": watch.stats(),
            **{f"frozen_{k}": v for k, v in frozen.items() if k != "pairs"},
            "objects": len(gc.get_objects())}


def max_rel_err(got, ref):
    """max |got - ref| over max |ref|, over the keys of ``ref``."""
    if set(got) != set(ref):
        raise AssertionError(f"keys {sorted(got)} vs {sorted(ref)}")
    return max(float((got[k] - ref[k]).abs().max())
               / max(float(ref[k].abs().max()), 1e-30) for k in ref)


def phase_serve_artifacts(tmp):
    """Each artifact of ``artifact_cases``: exported on the card, loaded,
    its requests' launches and outputs checked, its request timed against
    the closure's. -> launches through the artifacts by wrapper."""
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule
    from pedestrians_video_2_carla_torch.serving import (export_inference,
                                                         load_inference,
                                                         make_inference_fn)

    t0 = time.perf_counter()
    through = dict.fromkeys(kernel_wrappers(), 0)
    results = {}
    for name, flow, B, keys, per_request in artifact_cases():
        batches = list(Carla2D3DDataModule(
            batch_size=B, clip_length=CLIP, seed=SEED,
            test_set_size=SERVE_REQUESTS * B).test_batches())
        params = flow.init_params()
        infer = make_inference_fn(flow, params, output_keys=keys)
        inputs, _, meta = batches[0]
        agi = meta["age_gender_idx"]
        path = os.path.join(tmp, f"{name}.pt2")
        t = time.perf_counter()
        export_inference(flow, params, inputs, agi, path, output_keys=keys)
        export_s = time.perf_counter() - t
        call, info = load_inference(path)
        nodes, ops = program_ops(path)
        reset_kernel_counts()
        served = [call(x, m["age_gender_idx"]) for x, _, m in batches]
        torch.cuda.synchronize()
        counts = kernel_counts()
        want = expected_counts(**{k: v * len(batches)
                                  for k, v in per_request.items()})
        if counts != want:
            raise AssertionError(f"{name}: launches {counts}, want {want}")
        for k, v in counts.items():
            through[k] += v
        err = max(max_rel_err(out, infer(x, m["age_gender_idx"]))
                  for out, (x, _, m) in zip(served, batches))
        for out in served:
            if not all(torch.isfinite(v).all() for v in out.values()):
                raise AssertionError(f"{name}: non-finite output")
        if err > SERVE_BAR:
            raise AssertionError(f"{name}: artifact vs closure {err}")
        pairs = paired_gc({"artifact": lambda: call(inputs, agi),
                           "closure": lambda: infer(inputs, agi)})
        results[name] = {
            "B": B, "L": CLIP, "output_keys": info["output_keys"],
            "export_s": export_s, "nodes": nodes, "ops": ops,
            "launches": {k: v for k, v in counts.items() if v},
            "max_err_over_max_out": err, **pairs}
        del flow, params, infer, call, batches
        torch.cuda.empty_cache()
    emit({"phase": "serve_artifacts", "requests": SERVE_REQUESTS,
          "artifacts": results, "seconds": time.perf_counter() - t0})
    return through


def phase_serve_artifact_cpu(tmp):
    """A card-made artifact served on the CPU (``device="cpu"``: its ops'
    plain versions) against the card's outputs."""
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule
    from pedestrians_video_2_carla_torch.serving import (export_inference,
                                                         load_inference)

    flow, _ = make_flows()
    params = flow.init_params()
    inputs, _, meta = next(iter(Carla2D3DDataModule(
        batch_size=CPU_LOAD_BATCH, clip_length=CLIP, seed=SEED,
        test_set_size=CPU_LOAD_BATCH).test_batches()))
    path = export_inference(flow, params, inputs, meta["age_gender_idx"],
                            os.path.join(tmp, "cpu_load.pt2"))
    card_call, info = load_inference(path)
    cpu_call, _ = load_inference(path, device="cpu")
    card = card_call(inputs, meta["age_gender_idx"])
    reset_kernel_counts()
    cpu = cpu_call(inputs.cpu(), meta["age_gender_idx"].cpu())
    if any(kernel_counts().values()):
        raise AssertionError(f"the CPU program launched {kernel_counts()}")
    worst_xy = worst = 0.0
    for k, v in cpu.items():
        if v.device.type != "cpu":
            raise AssertionError(f"{k} on {v.device}")
        d = (card[k].cpu() - v).abs()
        if k == "projection_2d":
            worst_xy = max(worst_xy, float(d[..., :2].max()))
            d = d[..., 2:]
        worst = max(worst, float(d.max()) / max(float(v.abs().max()), 1e-30))
    if worst_xy > XY_TOL_PX or worst > KERNEL_BAR:
        raise AssertionError(f"CPU vs card: xy {worst_xy} px, {worst}")
    emit({"phase": "serve_artifact_cpu", "B": CPU_LOAD_BATCH, "L": CLIP,
          "platforms": info["platforms"], "output_keys": info["output_keys"],
          "max_abs_err_xy_px_vs_card": worst_xy,
          "max_err_over_max_out_vs_card": worst})


def phase_cli_serving(tmp):
    """``modeling.main``'s predict and export modes on the card, from a
    2-step fit's checkpoint, for config 1 and GConvGRU."""
    from pedestrians_video_2_carla_torch import modeling
    from pedestrians_video_2_carla_torch.serving import (load_inference,
                                                         make_inference_fn)

    t0 = time.perf_counter()
    runs = {"config1": ["--movements_model_name=LinearAE", "--loss_modes",
                        "loc_2d_3d", "--projection_kernel=fused"],
            "gconvgru": ["--flow=classification",
                         "--classification_model_name=GConvGRU"]}
    done = {}
    for name, flags in runs.items():
        common = flags + [f"--batch_size={CLI_BATCH}", f"--clip_length={CLIP}",
                          f"--val_set_size={CLI_BATCH}",
                          f"--test_set_size={CLI_BATCH}", "--max_epochs=1",
                          "--limit_train_batches=2", f"--root_dir={tmp}",
                          f"--seed={SEED}"]
        modeling.main(common + ["--mode=train", f"--run_name={name}"])
        ckpt = os.path.join(tmp, "logs", "classification" if name ==
                            "gconvgru" else "pose_lifting", name,
                            "checkpoints", "last")
        pred = modeling.main(common + [
            "--mode=predict", f"--ckpt_path={ckpt}", "--predict_sets", "val",
            "test", f"--run_name={name}-predict"])
        for set_name, outputs in pred["predictions"].items():
            if not outputs or not all(
                    np.isfinite(v).all() for p, _, _ in outputs
                    for v in p.values() if v is not None):
                raise AssertionError(f"{name} {set_name}: predictions")
        exp = modeling.main(common + ["--mode=export", f"--ckpt_path={ckpt}",
                                      f"--run_name={name}-export"])
        call, info = load_inference(exp["export_path"])
        inputs, _, meta = next(iter(exp["dm"].val_batches()))
        err = max_rel_err(
            call(inputs, meta["age_gender_idx"]),
            make_inference_fn(exp["flow"], exp["trainer"].state.params)(
                inputs, meta["age_gender_idx"]))
        if err > SERVE_BAR:
            raise AssertionError(f"{name}: CLI artifact vs closure {err}")
        done[name] = {"predict_batches": {k: len(v) for k, v in
                                          pred["predictions"].items()},
                      "export_output_keys": info["output_keys"],
                      "max_err_over_max_out": err}
    emit({"phase": "cli_serving", "B": CLI_BATCH, "L": CLIP, "runs": done,
          "seconds": time.perf_counter() - t0})


def group_serving(card, hbm_rate):
    """Serving export on the card: -> the forward kernels' launches
    through the artifacts, by kernels-line entry."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        through = phase_serve_artifacts(tmp)
        phase_serve_artifact_cpu(tmp)
        phase_cli_serving(tmp)
    emit({"phase": "group_serving", "seconds": time.perf_counter() - t0})
    return {name: {"launches_serving_artifacts": n}
            for name, n in through.items() if n}


# -- bf16: config 5 and rows 4, 5, 8, 9 in bf16 --------------------------------

#: the bf16 kernels against their bf16 plain versions (which round where
#: the kernels round, and then differ by the order of fp32 sums and the
#: bf16 roundings that order moves): outputs and dx within BF16_BAR of max
#: |plain|, each weight gradient within it of its own largest; the bf16
#: kernels against the fp32 kernels on the same (bf16) values within
#: BF16_VS_FP32 of max |fp32|, the JAX bf16 kernel tests' bar
#: (tests/ops/test_pallas_spatial.py:103-111)
BF16_BAR, BF16_VS_FP32 = 2e-2, 5e-2
#: bf16's dense tensor-core rate on an H100 SXM (NVIDIA's data sheet)
BF16_PEAK = 989e12
BF16_COVERAGE_STEPS = 3
BF16_EXPORT_REQUESTS = 2


def to_bf16(tensors):
    return [t.to(torch.bfloat16).contiguous() for t in tensors]


def bf16_randn(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).cuda().to(torch.bfloat16)


def bf16_check(report, worst, row, what, got, ref, again=None,
               bar=BF16_BAR):
    """got against ref over max |ref| (both as float32), finite, and the
    same bits as ``again``; records into ``report`` and ``worst``."""
    err, scaled = bar_err(got.float(), ref.float())
    same = again is None or torch.equal(got, again)
    finite = bool(torch.isfinite(got.float()).all())
    report[f"{row} {what}"] = {"max_abs_err_over_max_abs_ref": scaled,
                               "same_bits_twice": same}
    if not (scaled <= bar and same and finite):
        raise AssertionError(f"{row} {what}: {scaled} of max |ref| (bar "
                             f"{bar}), same bits {same}, finite {finite}")
    worst[row] = max(worst.get(row, 0.0), err)


def phase_kernel_bf16():
    """Rows 4, 5, 8 and 9 in bf16 at the main path's shapes against their
    bf16 plain versions: outputs, dx and every weight gradient, the
    training forwards' kept scratch, the same bits twice; the bf16 forwards
    against the fp32 kernels on the same values. -> the largest absolute
    error of each row."""
    from pedestrians_video_2_carla_torch.ops import \
        fused_spatial_transformer as FS
    from pedestrians_video_2_carla_torch.ops import \
        fused_temporal_transformer as FT

    smem = (FT._library().pv2c_temporal_fwd_gemm_smem_bytes(2),
            FT.forward_gemm_smem_bytes(2))
    if smem[0] != smem[1]:
        raise AssertionError(f"bf16 forward GEMM shared memory: library vs "
                             f"wrapper {smem}")
    rng = np.random.default_rng(SEED + 40)
    ws = to_bf16(random_spatial_weights(rng))
    wt = to_bf16(random_block_weights(rng, PF_DIM))
    report, worst = {}, {}
    with torch.no_grad():
        # row 4: serving (B=256, L=16) and the training forward (B=1024)
        for n in (PF_BATCH * CLIP, BATCH * CLIP):
            x = bf16_randn(rng, (n, PF_JOINTS, PF_EMB))
            out = FS.fused_spatial_stack_cuda(x, ws, PF_HEADS)
            again = FS.fused_spatial_stack_cuda(x, ws, PF_HEADS)
            bf16_check(report, worst, "row4_bf16", f"N={n}", out,
                       FS.spatial_stack_reference(x, ws, PF_HEADS), again)
            out32 = FS.fused_spatial_stack_cuda(
                x.float(), [w.float() for w in ws], PF_HEADS)
            bf16_check(report, worst, "row4_bf16", f"N={n} vs fp32 kernel",
                       out, out32, bar=BF16_VS_FP32)
            keep, _ = FS.fused_spatial_stack_cuda(x, ws, PF_HEADS, keep=True)
            if not torch.equal(keep, out):
                raise AssertionError("row 4 bf16: the training forward's "
                                     "output differs from serving's")
        # row 8: B=256 and B=1024 (8 windows a clip), and rf 81 (B=64)
        for n, T in ((PF_BATCH * (CLIP - PF_RF + 1), PF_RF),
                     (BATCH * (CLIP - PF_RF + 1), PF_RF), (RF81_BATCH, 81)):
            x = bf16_randn(rng, (n, T, PF_DIM))
            out = FT.fused_temporal_block_cuda(x, wt, PF_HEADS)
            again = FT.fused_temporal_block_cuda(x, wt, PF_HEADS)
            bf16_check(report, worst, "row8_bf16", f"N={n} T={T}", out,
                       FT.temporal_block_reference(x, wt, PF_HEADS), again)
            out32 = FT.fused_temporal_block_cuda(
                x.float(), [w.float() for w in wt], PF_HEADS)
            bf16_check(report, worst, "row8_bf16",
                       f"N={n} T={T} vs fp32 kernel", out, out32,
                       bar=BF16_VS_FP32)
            out_k, saved = FT.fused_temporal_block_cuda(x, wt, PF_HEADS,
                                                        keep=True)
            ref_k, ref_saved = FT.temporal_block_keep_reference(x, wt,
                                                                PF_HEADS)
            for name, got, want in zip(("out",) + FT_SAVED, (out_k, *saved),
                                       (ref_k, *ref_saved)):
                bf16_check(report, worst, "row8_bf16",
                           f"N={n} T={T} keep {name}", got, want)
    # rows 5 and 9 at B=1024, L=16, from their training forwards' residuals
    x = bf16_randn(rng, (BATCH * CLIP, PF_JOINTS, PF_EMB))
    g = bf16_randn(rng, tuple(x.shape))
    with torch.no_grad():
        _, saved = FS.fused_spatial_stack_cuda(x, ws, PF_HEADS, keep=True)
        dx, dws = FS.fused_spatial_stack_cuda_bwd(x, ws, saved, g, PF_HEADS)
        dx2, dws2 = FS.fused_spatial_stack_cuda_bwd(x, ws, saved, g,
                                                    PF_HEADS)
    ref = plain_grads(lambda t: FS.spatial_stack_reference(
        t[0], t[1:], PF_HEADS), [x, *ws], g)
    for i, (a, b, r) in enumerate(zip((dx, *dws), (dx2, *dws2), ref)):
        bf16_check(report, worst, "row5_bf16", SPATIAL_NAMES[i], a, r, b)
    del saved, ref
    x = bf16_randn(rng, (BATCH * (CLIP - PF_RF + 1), PF_RF, PF_DIM))
    g = bf16_randn(rng, tuple(x.shape))
    with torch.no_grad():
        _, saved = FT.fused_temporal_block_cuda(x, wt, PF_HEADS, keep=True)
        dx, dws = FT.fused_temporal_block_cuda_bwd(x, wt, saved, g, PF_HEADS)
        dx2, dws2 = FT.fused_temporal_block_cuda_bwd(x, wt, saved, g,
                                                     PF_HEADS)
    ref = plain_grads(lambda t: FT.temporal_block_reference(
        t[0], t[1:], PF_HEADS), [x, *wt], g)
    for i, (a, b, r) in enumerate(zip((dx, *dws), (dx2, *dws2), ref)):
        bf16_check(report, worst, "row9_bf16", SPATIAL_NAMES[i], a, r, b)
    del saved, ref
    torch.cuda.synchronize()
    emit({"phase": "kernel_bf16", "bar": BF16_BAR,
          "bar_vs_fp32_kernel": BF16_VS_FP32, "checks": report,
          "worst_scaled": {row: max(v["max_abs_err_over_max_abs_ref"]
                                    for k, v in report.items()
                                    if k.startswith(row))
                           for row in BF16_ROWS},
          "smem_bytes_bf16_forward_gemm": smem})
    return worst


def phase_timing_bf16(card, hbm_rate):
    """Rows 4, 5, 8 and 9 in bf16 at the main path's shapes: the kernel
    (cold L2), its bf16 plain version, the bf16 TransformerEncoderLayer
    yardstick and the kernel against it in alternating pairs; bounds at
    bf16's dense tensor-core rate against each tensor's bytes."""
    from pedestrians_video_2_carla_torch.ops import flops as F
    from pedestrians_video_2_carla_torch.ops import \
        fused_spatial_transformer as FS
    from pedestrians_video_2_carla_torch.ops import \
        fused_temporal_transformer as FT

    rng = np.random.default_rng(SEED + 41)
    ws = to_bf16(random_spatial_weights(rng))
    wt = to_bf16(random_block_weights(rng, PF_DIM))
    spatial_lib = spatial_encoder_stack(ws).to(torch.bfloat16)
    temporal_lib = encoder_layer(PF_DIM, wt).to(torch.bfloat16)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def flush_l2():  # 256 MB write: far more than the 50 MB L2
        scratch.zero_()

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def graph(fn, inputs):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        return fn(leaves), leaves

    def backward_of(out_leaves, g):
        out, leaves = out_leaves
        return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)

    times = {}
    xs = bf16_randn(rng, (PF_BATCH * CLIP, PF_JOINTS, PF_EMB))
    xt = bf16_randn(rng, (PF_BATCH * (CLIP - PF_RF + 1), PF_RF, PF_DIM))
    with torch.no_grad():
        for name, lib, plain in (
                ("row4_bf16", spatial_lib(xs),
                 FS.spatial_stack_reference(xs, ws, PF_HEADS)),
                ("row8_bf16", temporal_lib(xt),
                 FT.temporal_block_reference(xt, wt, PF_HEADS))):
            scaled = bar_err(lib.float(), plain.float())[1]
            if scaled > BF16_VS_FP32:
                raise AssertionError(f"{name}: the bf16 yardstick vs the "
                                     f"plain version {scaled}")
        dense_s, attn_s = spatial_flops(xs.shape[0], F)
        forwards = {
            "row4_bf16": (lambda: FS.fused_spatial_stack_cuda(xs, ws,
                                                              PF_HEADS),
                          lambda: FS.spatial_stack_reference(xs, ws,
                                                             PF_HEADS),
                          lambda: spatial_lib(xs),
                          2 * nbytes(xs) + nbytes(*ws), dense_s + attn_s),
            "row8_bf16": (lambda: FT.fused_temporal_block_cuda(xt, wt,
                                                               PF_HEADS),
                          lambda: FT.temporal_block_reference(xt, wt,
                                                              PF_HEADS),
                          lambda: temporal_lib(xt),
                          2 * nbytes(xt) + nbytes(*wt),
                          F.transformer_block_matmul_flops(
                              xt.shape[0] * PF_RF, PF_DIM, 2.0, PF_RF))}
        for name, (kernel, plain, lib, nb, nflop) in forwards.items():
            times[name] = {"ms": cuda_median_ms(kernel, flush=flush_l2),
                           "ms_warm_l2": cuda_median_ms(kernel),
                           "plain_ms": cuda_median_ms(plain),
                           "library_ms": cuda_median_ms(lib),
                           "paired_with_library": paired_ms(kernel, lib,
                                                            flush_l2),
                           "bytes": nb, "flop": nflop}
        del forwards
    # the backwards at B=1024, L=16, from their training forwards' residuals
    xs = bf16_randn(rng, (BATCH * CLIP, PF_JOINTS, PF_EMB))
    xt = bf16_randn(rng, (BATCH * (CLIP - PF_RF + 1), PF_RF, PF_DIM))
    gs, gt = bf16_randn(rng, tuple(xs.shape)), bf16_randn(rng, tuple(xt.shape))
    with torch.no_grad():
        _, saved_s = FS.fused_spatial_stack_cuda(xs, ws, PF_HEADS, keep=True)
        _, saved_t = FT.fused_temporal_block_cuda(xt, wt, PF_HEADS, keep=True)
    plain_s = graph(lambda t: FS.spatial_stack_reference(t[0], t[1:],
                                                         PF_HEADS), [xs, *ws])
    plain_t = graph(lambda t: FT.temporal_block_reference(t[0], t[1:],
                                                          PF_HEADS), [xt, *wt])
    lib_s = graph(lambda t: spatial_lib(t[0]), [xs])
    lib_t = graph(lambda t: temporal_lib(t[0]), [xt])
    lib_s = (lib_s[0], lib_s[1] + list(spatial_lib.parameters()))
    lib_t = (lib_t[0], lib_t[1] + list(temporal_lib.parameters()))
    backwards = {
        "row5_bf16": (lambda: FS.fused_spatial_stack_cuda_bwd(
            xs, ws, saved_s, gs, PF_HEADS), backward_of(plain_s, gs),
            backward_of(lib_s, gs),
            3 * nbytes(xs) + nbytes(*saved_s) + 2 * nbytes(*ws),
            PF_DEPTH * F.transformer_block_backward_flops(
                xs.shape[0] * PF_JOINTS, PF_EMB, 2.0, PF_JOINTS)),
        "row9_bf16": (lambda: FT.fused_temporal_block_cuda_bwd(
            xt, wt, saved_t, gt, PF_HEADS), backward_of(plain_t, gt),
            backward_of(lib_t, gt),
            3 * nbytes(xt) + nbytes(*saved_t) + 2 * nbytes(*wt),
            F.transformer_block_backward_flops(xt.shape[0] * PF_RF, PF_DIM,
                                               2.0, PF_RF))}
    for name, (kernel, plain, lib, nb, nflop) in backwards.items():
        times[name] = {"ms": cuda_median_ms(kernel, flush=flush_l2),
                       "ms_warm_l2": cuda_median_ms(kernel),
                       "plain_ms": cuda_median_ms(plain),
                       "library_ms": cuda_median_ms(lib),
                       "paired_with_library": paired_ms(kernel, lib,
                                                        flush_l2),
                       "bytes": nb, "flop": nflop}
    times["row9_bf16"]["launch_split"] = launch_split(
        backwards["row9_bf16"][0], ROW9_STEPS)
    del backwards, plain_s, plain_t, lib_s, lib_t, saved_s, saved_t
    for name, t in times.items():
        t_bytes, t_flop = t["bytes"] / hbm_rate, t["flop"] / BF16_PEAK
        t.update(bound_ms=max(t_bytes, t_flop) * 1e3,
                 bound_by="bytes" if t_bytes >= t_flop else "operations")
    # row 4's attention runs on the CUDA cores in fp32: its bound with
    # that part at their peak, beside; row 5 runs all its products there,
    # as the JAX kernel's backward does: its bound at that peak, beside
    times["row4_bf16"].update(
        dense_flop=dense_s, attention_flop=attn_s,
        bound_ms_by_unit=max(times["row4_bf16"]["bytes"] / hbm_rate,
                             dense_s / BF16_PEAK + attn_s / FP32_PEAK) * 1e3)
    times["row5_bf16"]["bound_ms_fp32_cores"] = max(
        times["row5_bf16"]["bytes"] / hbm_rate,
        times["row5_bf16"]["flop"] / FP32_PEAK) * 1e3
    emit({"phase": "timing_bf16", "card": card, "kernels": times,
          "method": "bf16 kernels, their bf16 plain versions and bf16 "
                    "TransformerEncoderLayer yardsticks (norm_first, GELU, "
                    "dropout 0): CUDA events, median of %d single calls "
                    "after 3 warm-up calls, cold = 256 MB scratch write "
                    "before each call; pairs: kernel and library "
                    "alternating, cold, %d each; bounds: ops/flops.py's "
                    "FLOPs at %.0f TFLOP/s against each input read and "
                    "each output written once at its element size"
                    % (TIMING_RUNS, TIMING_PAIRS, BF16_PEAK / 1e12)})
    return times


def phase_config5_bf16(card):
    """BASELINE config 5 in bf16 end to end on the card: serving at B=256
    through the closure and an exported program, training at B=1024, L=16
    through Trainer.fit; launches, outputs, losses, dtypes, and times in
    alternating pairs with the fp32 flow. -> the bf16 launches of rows 4,
    8, 5 and 9 on this path."""
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule
    from pedestrians_video_2_carla_torch.flows.pose_lifting import \
        PoseLiftingFlow
    from pedestrians_video_2_carla_torch.models.movements.pose_former import \
        PoseFormer
    from pedestrians_video_2_carla_torch.serving import (
        export_inference, load_inference, make_inference_fn)
    from pedestrians_video_2_carla_torch.training.trainer import (
        Trainer, TrainerConfig)

    flows = {p: PoseLiftingFlow(
        PoseFormer(clip_length=CLIP,
                   generator=torch.Generator().manual_seed(SEED)),
        loss_modes=["loc_2d_3d"], precision=p) for p in ("bf16", "32")}
    params = flows["32"].init_params()
    infer = {p: make_inference_fn(f, params) for p, f in flows.items()}
    dm = Carla2D3DDataModule(batch_size=PF_BATCH, clip_length=CLIP,
                             test_set_size=REQUESTS * PF_BATCH, seed=SEED)
    batches = list(dm.test_batches())

    # serving: the main path's counts from 0
    reset_kernel_counts()
    served = []
    for i, (inputs, _, meta) in enumerate(batches):
        served.append(infer["bf16"](inputs, meta["age_gender_idx"]))
        b16 = bf16_counts()
        if (b16["row4_bf16"], b16["row8_bf16"]) != (i + 1, PF_DEPTH * (i + 1)):
            raise AssertionError(f"bf16 request {i}: launches {b16}")
    torch.cuda.synchronize()
    serve_counts, launches = kernel_counts(), bf16_counts()
    if serve_counts != expected_counts(
            fused_spatial_stack=len(batches),
            fused_temporal_block=PF_DEPTH * len(batches)):
        raise AssertionError(f"bf16 serving launched {serve_counts}")
    worst = 0.0
    for preds, (inputs, _, meta) in zip(served, batches):
        ref = infer["32"](inputs, meta["age_gender_idx"])
        for k, v in preds.items():
            if v.dtype != torch.float32 or not torch.isfinite(v).all():
                raise AssertionError(f"bf16 serving: {k} {v.dtype}, or not "
                                     f"finite")
        worst = max(worst, bar_err(preds["absolute_pose_loc"],
                                   ref["absolute_pose_loc"])[1])
    if worst > BF16_VS_FP32:
        raise AssertionError(f"bf16 serving vs fp32: {worst} of max |fp32|")
    inputs, _, meta = batches[0]
    agi = meta["age_gender_idx"]
    request_pairs = paired_host_ms(
        {"bf16": lambda: infer["bf16"](inputs, agi),
         "fp32": lambda: infer["32"](inputs, agi)})
    emit({"phase": "serve_poseformer_bf16", "card": card, "B": PF_BATCH,
          "L": CLIP, "requests": len(batches), "launches": serve_counts,
          "bf16_launches": launches,
          "absolute_pose_loc_vs_fp32_over_max": worst,
          "request_ms_host_pairs": request_pairs})

    # the exported bf16 program: the casts inside it, fp32 in and out
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = export_inference(flows["bf16"], params, inputs, agi,
                                os.path.join(tmp, "pf_bf16.pt2"))
        export_s = time.perf_counter() - t0
        served_art, meta_json = load_inference(path)
        program_ops_seen = program_ops(path)
        reset_kernel_counts()
        outs = [served_art(b[0], b[2]["age_gender_idx"])
                for b in batches[:BF16_EXPORT_REQUESTS]]
        torch.cuda.synchronize()
        art = bf16_counts()
        if (art["row4_bf16"], art["row8_bf16"]) != (
                BF16_EXPORT_REQUESTS, PF_DEPTH * BF16_EXPORT_REQUESTS) or \
                kernel_counts() != expected_counts(
                    fused_spatial_stack=BF16_EXPORT_REQUESTS,
                    fused_temporal_block=PF_DEPTH * BF16_EXPORT_REQUESTS):
            raise AssertionError(f"the bf16 program launched {art}")
        for k in launches:
            launches[k] += art[k]
        same = all(torch.equal(o[k], s[k]) for o, s in zip(outs, served)
                   for k in s)
        if not same or any(v.dtype != torch.float32 for o in outs
                           for v in o.values()):
            raise AssertionError("the bf16 program's outputs are not the "
                                 "closure's bits in float32")
        art_pairs = paired_host_ms(
            {"artifact": lambda: served_art(inputs, agi),
             "closure": lambda: infer["bf16"](inputs, agi)})
        del served_art
    emit({"phase": "serve_artifact_poseformer_bf16", "export_s": export_s,
          "input_dtypes": meta_json["input_dtypes"], "ops": program_ops_seen,
          "bf16_launches": art, "closure_bits": same,
          "request_ms_host_pairs": art_pairs})
    del served, outs, infer, batches, dm
    torch.cuda.empty_cache()

    # training at B=1024, L=16 through the Trainer
    dm = Carla2D3DDataModule(batch_size=BATCH, clip_length=CLIP,
                             val_set_size=VAL_BATCHES * BATCH, seed=SEED)
    flow = make_pf_train_flow("bf16")
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(flow, dm, TrainerConfig(
            max_epochs=1, limit_train_batches=PF_TRAIN_STEPS,
            limit_val_batches=VAL_BATCHES, log_every_n_steps=1, seed=SEED,
            logs_dir=tmp, run_name="pf_bf16"))
        reset_kernel_counts()
        t0 = time.perf_counter()
        state = trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts, train = kernel_counts(), bf16_counts()
        batches_run = PF_TRAIN_STEPS + VAL_BATCHES
        expected = {"row4_bf16": batches_run,
                    "row8_bf16": PF_DEPTH * batches_run,
                    "row5_bf16": PF_TRAIN_STEPS,
                    "row9_bf16": PF_DEPTH * PF_TRAIN_STEPS}
        if train != expected or counts != expected_counts(
                fused_spatial_stack=batches_run,
                fused_temporal_block=PF_DEPTH * batches_run,
                fused_spatial_stack_bwd=PF_TRAIN_STEPS,
                fused_temporal_block_bwd=PF_DEPTH * PF_TRAIN_STEPS):
            raise AssertionError(f"bf16 train launches {train} / {counts}, "
                                 f"expected {expected}")
        with open(os.path.join(tmp, "pf_bf16", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        steps = [r["train_loss/primary"] for r in records
                 if "lr-movements" in r]
        val = records[-1]["val_loss/primary"]
        if len(steps) != PF_TRAIN_STEPS or not np.isfinite(
                steps + [val]).all() or not max(steps[-3:]) < steps[0]:
            raise AssertionError(f"bf16 train losses {steps}, val {val}")
        dtypes = {str(v.dtype) for tree in state.params.values()
                  for v in tree.values()} | {
            str(v.dtype) for st in state.optimizer.state.values()
            for v in st.values() if torch.is_tensor(v) and v.numel() > 1}
        if dtypes != {"torch.float32"}:
            raise AssertionError(f"bf16 training state dtypes {dtypes}")
        del trainer
    for k in launches:
        launches[k] += train[k]
    # the step beside fp32's, host clock, alternating; and its split
    batch = next(dm.train_batches(SEED + 7))
    flow32 = make_pf_train_flow()
    state32 = flow32.init_state(params)
    state16 = flow.init_state(params)
    step_pairs = paired_host_ms(
        {"bf16": lambda: flow.training_step(state16, batch),
         "fp32": lambda: flow32.training_step(state32, batch)},
        pairs=TIMING_PAIRS)
    split = train_step_split(flow, state16, batch)
    split32 = train_step_split(flow32, state32, batch)
    emit({"phase": "train_poseformer_bf16", "card": card, "B": BATCH,
          "L": CLIP, "steps": PF_TRAIN_STEPS, "val_batches": VAL_BATCHES,
          "launches": counts, "bf16_launches": train, "fit_seconds": fit_s,
          "train_loss_primary": steps, "val_loss_primary": val,
          "state_dtypes": sorted(dtypes),
          "train_step_ms_host_pairs": step_pairs,
          "train_step_split_cuda_events_bf16": split,
          "train_step_split_cuda_events_fp32": split32,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, {"request": request_pairs, "artifact": art_pairs,
                      "step": step_pairs, "step_split": split}


# -- rows 10-13 in bf16 ------------------------------------------------------

#: rows 10-13's wrappers by the name of their bf16 entry on the kernels line
#: (the dense form's kernels as row 12's and 13's ``dense_`` fields)
SCAN_BF16_ROWS = {"row10_bf16": "graph_gru_scan",
                  "row11_bf16": "graph_gru_scan_bwd",
                  "row12_bf16": "graph_lstm_scan",
                  "row13_bf16": "graph_lstm_scan_bwd",
                  "row12_bf16_dense": "dense_lstm_scan",
                  "row13_bf16_dense": "dense_lstm_scan_bwd"}
#: the bf16 scan kernels' checks (B, L, J, H, k): config 3's layer, ragged
#: B, odd widths (H=3 at k=3; H=233 at k=3, the graph-form LSTM's reverse
#: scan on its 64-column ring), the GRU's 128-column ring (H=320: z parked
#: in its float32 scratch), the LSTM's few-rows tiling (J=1, H=128) and,
#: forward alone, its narrow tiling (H=420, k=3: h read back from bf16 ys)
GRU_BF16_SHAPES = (CLS_MAIN, (253, CLIP, CLS_J, CLS_H, CLS_K),
                   (CLS_BATCH, CLIP, CLS_J, 3, 3), (64, CLIP, CLS_J, 320, 2))
LSTM_BF16_SHAPES = (CLS_MAIN, (CLS_BATCH, CLIP, CLS_J, 3, 3),
                    (64, CLIP, CLS_J, 233, 3), CLS_WIDE)
LSTM_BF16_FORWARD_SHAPES = ((16, CLIP, CLS_J, 420, 3),)
#: the dense kernels in bf16: config 2's layer, ragged B, H=36 (4-byte
#: staging copies) and H=3 (odd: ordinary loads)
DENSE_BF16_SHAPES = (CLS_DENSE, (253, CLIP, 1, 64, 1),
                     (CLS_BATCH, CLIP, 1, 36, 1), (CLS_BATCH, CLIP, 1, 3, 1))
BF16_CLS_STEPS = 5


def bf16_graph_case(rng, cell, shape):
    """graph_case's inputs in bf16."""
    xg, cheb, weights, cots = graph_case(rng, cell, shape)
    return (xg.to(torch.bfloat16), cheb.to(torch.bfloat16),
            to_bf16(weights), to_bf16(cots))


def check_scan_outputs(report, worst, row, what, names, got, again, ref):
    for name, a, b, r in zip(names, got, again, ref):
        bf16_check(report, worst, row, f"{what} {name}", a, r, b)


def phase_kernel_scan_bf16():
    """Rows 10-13 in bf16 against their bf16 plain versions
    (ops/fused_graph_gru.py): the training forwards' outputs and kept
    residuals against the plain forward with residuals, the backwards from
    the kernels' residuals against the plain backward from the same (the
    LSTMs with and without the cell states' cotangent), the same bits
    twice, the serving forward the training forward's bits; each bf16
    forward against the fp32 kernel on the same values. -> the largest
    absolute error of each row against its plain version."""
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG

    rng = np.random.default_rng(SEED + 43)
    report, worst, vs_fp32, plans = {}, {}, {}, {}

    def fp32(*ts):
        return [t.float() for t in ts]

    with torch.no_grad():
        for shape in GRU_BF16_SHAPES:
            xg, cheb, w, cots = bf16_graph_case(rng, "gru", shape)
            what = "x".join(map(str, shape))
            plans[f"gru {what}"] = [FG.graph_gru_plan(shape[0], shape[2],
                                                      shape[3], shape[4], b)
                                    for b in (False, True)]
            ys, res = FG.graph_gru_scan_cuda_fwd(xg, cheb, *w, keep=True)
            again = FG.graph_gru_scan_cuda_fwd(xg, cheb, *w, keep=True)
            ref = FG.graph_gru_scan_keep_reference(xg, cheb, *w)
            check_scan_outputs(report, worst, "row10_bf16", what,
                               ("ys",) + FG.GRUResiduals._fields,
                               (ys, *res), (again[0], *again[1]),
                               (ref[0], *ref[1]))
            if not torch.equal(FG.graph_gru_scan_cuda_fwd(xg, cheb, *w), ys):
                raise AssertionError(f"row 10 bf16 at {shape}: the serving "
                                     f"forward differs from the training one")
            bf16_check(report, vs_fp32, "row10_bf16", f"{what} vs fp32 kernel",
                       ys, FG.graph_gru_scan_cuda_fwd(*fp32(xg, cheb, *w)),
                       bar=BF16_VS_FP32)
            got = FG.graph_gru_scan_cuda_bwd(cheb, *w, res, cots[0])
            again = FG.graph_gru_scan_cuda_bwd(cheb, *w, res, cots[0])
            ref = FG.graph_gru_scan_bwd_reference(cheb, *w, res, cots[0])
            check_scan_outputs(report, worst, "row11_bf16", what,
                               ("dxg", "dwzr", "dwh"), got, again, ref)
            del res, again, ref, got
        for shape in LSTM_BF16_SHAPES + LSTM_BF16_FORWARD_SHAPES:
            xg, cheb, (w,), cots = bf16_graph_case(rng, "lstm", shape)
            what = "x".join(map(str, shape))
            plans[f"lstm {what}"] = [FG.graph_lstm_plan(shape[0], shape[2],
                                                        shape[3], shape[4], b)
                                     for b in (False, True)]
            ys, cs, res = FG.graph_lstm_scan_cuda_fwd(xg, cheb, w, keep=True)
            again = FG.graph_lstm_scan_cuda_fwd(xg, cheb, w, keep=True)
            ref = FG.graph_lstm_scan_keep_reference(xg, cheb, w)
            check_scan_outputs(report, worst, "row12_bf16", what,
                               ("ys", "cs", "gates", "sa"), (ys, cs, *res),
                               (*again[:2], *again[2]), (*ref[:2], *ref[2]))
            if not all(torch.equal(a, b) for a, b in zip(
                    FG.graph_lstm_scan_cuda_fwd(xg, cheb, w), (ys, cs))):
                raise AssertionError(f"row 12 bf16 at {shape}: the serving "
                                     f"forward differs from the training one")
            bf16_check(report, vs_fp32, "row12_bf16", f"{what} vs fp32 kernel",
                       ys, FG.graph_lstm_scan_cuda_fwd(*fp32(xg, cheb, w))[0],
                       bar=BF16_VS_FP32)
            if shape in LSTM_BF16_FORWARD_SHAPES:
                continue
            for dcs in (cots[1], None):
                got = FG.graph_lstm_scan_cuda_bwd(cheb, w, res, cs, cots[0],
                                                  dcs)
                again = FG.graph_lstm_scan_cuda_bwd(cheb, w, res, cs,
                                                    cots[0], dcs)
                ref = FG.graph_lstm_scan_bwd_reference(cheb, w, res, cs,
                                                       cots[0], dcs)
                check_scan_outputs(
                    report, worst, "row13_bf16",
                    what + (" with dcs" if dcs is not None else ""),
                    ("dxg", "dw"), got, again, ref)
            del res, again, ref, got
        for shape in DENSE_BF16_SHAPES:
            xg, _, (w,), cots = bf16_graph_case(rng, "lstm", shape)
            what = "x".join(map(str, shape))
            plans[f"dense {what}"] = FG.dense_lstm_plan(shape[0], shape[2],
                                                        shape[3])
            kept = FG.dense_lstm_scan_cuda_fwd(xg, w, keep=True)
            again = FG.dense_lstm_scan_cuda_fwd(xg, w, keep=True)
            ref = FG.dense_lstm_scan_keep_reference(xg, w)
            check_scan_outputs(report, worst, "row12_bf16_dense", what,
                               ("ys", "cs", "gates"), kept, again, ref)
            served = FG.dense_lstm_scan_cuda_fwd(xg, w.t().contiguous().t())
            if not all(torch.equal(a, b) for a, b in zip(served, kept)):
                raise AssertionError(f"dense bf16 at {shape}: the serving "
                                     f"forward (a stacked weight's transpose)"
                                     f" differs from the training one")
            bf16_check(report, vs_fp32, "row12_bf16_dense",
                       f"{what} vs fp32 kernel", kept[0],
                       FG.dense_lstm_scan_cuda_fwd(*fp32(xg, w))[0],
                       bar=BF16_VS_FP32)
            ys, cs, gates = kept
            for dcs in (cots[1], None):
                got = FG.dense_lstm_scan_cuda_bwd(w, gates, ys, cs, cots[0],
                                                  dcs)
                again = FG.dense_lstm_scan_cuda_bwd(w, gates, ys, cs,
                                                    cots[0], dcs)
                ref = FG.dense_lstm_scan_bwd_reference(w, gates, ys, cs,
                                                       cots[0], dcs)
                check_scan_outputs(
                    report, worst, "row13_bf16_dense",
                    what + (" with dcs" if dcs is not None else ""),
                    ("dxg", "dw"), got, again, ref)
    torch.cuda.synchronize()
    emit({"phase": "kernel_scan_bf16", "bar": BF16_BAR,
          "bar_vs_fp32_kernel": BF16_VS_FP32, "checks": report,
          "worst_scaled": {row: max(v["max_abs_err_over_max_abs_ref"]
                                    for k, v in report.items()
                                    if k.startswith(row + " ")
                                    and "vs fp32" not in k)
                           for row in SCAN_BF16_ROWS},
          "worst_scaled_vs_fp32_kernel": {
              row: max(v["max_abs_err_over_max_abs_ref"]
                       for k, v in report.items()
                       if k.startswith(row + " ") and "vs fp32" in k)
              for row in ("row10_bf16", "row12_bf16", "row12_bf16_dense")},
          "plans": plans})
    return worst


def phase_timing_scan_bf16(card, hbm_rate):
    """Rows 10-13 in bf16: the forward (serving) and backward kernels at
    config 3's layer (the graph form) and config 2's (the dense form), the
    training forward too, the bf16 plain versions (autograd of them for
    the backward), and bf16 torch.nn.LSTM (cuDNN) at the dense form and at
    J=1, H=128 (the graph form at k = 1), alone and in alternating pairs;
    bounds at bf16's dense tensor-core rate against each tensor's bytes at
    its element size. -> the entries' times by row."""
    from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG

    rng = np.random.default_rng(SEED + 44)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def flush_l2():  # 256 MB write: far more than the 50 MB L2
        scratch.zero_()

    def bound(cell, shape, backward=False, keep=False, dense=False):
        return scan_bound(cell, shape, hbm_rate, backward,
                          backward and cell == "lstm", keep, dense,
                          element_size=2, peak=BF16_PEAK)

    times, libs = {}, {}
    for cell, shape, (fwd_row, bwd_row) in (
            ("gru", CLS_MAIN, ("row10_bf16", "row11_bf16")),
            ("lstm", CLS_MAIN, ("row12_bf16", "row13_bf16")),
            ("lstm", CLS_DENSE, ("row12_bf16_dense", "row13_bf16_dense")),
            ("lstm", CLS_WIDE, ("row12_bf16_k1", "row13_bf16_k1"))):
        xg, cheb, w, cots = bf16_graph_case(rng, cell, shape)
        dense = shape == CLS_DENSE
        if cell == "gru":
            def fwd(keep=False):
                return FG.graph_gru_scan_cuda_fwd(xg, cheb, *w, keep=keep)
            kept = fwd(True)

            def bwd():
                FG.graph_gru_scan_cuda_bwd(cheb, *w, kept[1], cots[0])
            plain = FG.graph_gru_scan_reference
            used = cots[:1]
        elif dense:
            def fwd(keep=False):
                return FG.dense_lstm_scan_cuda_fwd(xg, w[0], keep=keep)
            kept = fwd(True)

            def bwd():
                FG.dense_lstm_scan_cuda_bwd(w[0], kept[2], kept[0], kept[1],
                                            *cots)
            plain = FG.graph_lstm_scan_reference
            used = cots
        else:
            def fwd(keep=False):
                return FG.graph_lstm_scan_cuda_fwd(xg, cheb, w[0], keep=keep)
            kept = fwd(True)

            def bwd():
                FG.graph_lstm_scan_cuda_bwd(cheb, w[0], kept[2], kept[1],
                                            *cots)
            plain = FG.graph_lstm_scan_reference
            used = cots
        leaves = [t.detach().clone().requires_grad_(True) for t in (xg, *w)]
        outs = plain(leaves[0], cheb, *leaves[1:])
        outs = outs if isinstance(outs, tuple) else (outs,)

        def serve():
            with torch.no_grad():
                fwd()

        def plain_fwd():
            with torch.no_grad():
                plain(xg, cheb, *w)

        def plain_bwd():
            torch.autograd.grad(outs, leaves, used, retain_graph=True)
        times[fwd_row] = {"shape_B_L_J_H_k": shape,
                          "ms": cuda_median_ms(serve, flush=flush_l2),
                          "ms_warm_l2": cuda_median_ms(serve),
                          "plain_ms": cuda_median_ms(plain_fwd),
                          "keep_ms": cuda_median_ms(lambda: fwd(True),
                                                    flush=flush_l2),
                          "keep_bound_ms": bound(cell, shape, keep=True,
                                                 dense=dense)["bound_ms"],
                          **bound(cell, shape, dense=dense)}
        times[bwd_row] = {"shape_B_L_J_H_k": shape,
                          "ms": cuda_median_ms(bwd, flush=flush_l2),
                          "ms_warm_l2": cuda_median_ms(bwd),
                          "plain_ms": cuda_median_ms(plain_bwd),
                          **bound(cell, shape, True, dense=dense)}
        if cell == "lstm" and shape != CLS_MAIN:  # cuDNN computes it
            lib_fwd, lib_bwd, err = library_lstm(xg, cheb, w[0], cots)
            for row, kernel, lib in ((fwd_row, serve, lib_fwd),
                                     (bwd_row, bwd, lib_bwd)):
                times[row].update(
                    library_ms=cuda_median_ms(lib, flush=flush_l2),
                    paired_vs_library=paired_ms(kernel, lib, flush_l2),
                    library_vs_plain_over_max=err)
        del kept, leaves, outs
    torch.cuda.empty_cache()
    emit({"phase": "timing_scan_bf16", "card": card, "kernels": times,
          "method": "bf16 scan kernels, their bf16 plain versions (autograd "
                    "of them for the backward) and bf16 torch.nn.LSTM: CUDA "
                    "events, median of %d single calls after 3 warm-up "
                    "calls, cold = 256 MB scratch write before each call; "
                    "pairs: kernel and library alternating, cold, %d each; "
                    "bounds: ops/flops.py's FLOPs at %.0f TFLOP/s against "
                    "each input read and each output written once at its "
                    "element size" % (TIMING_RUNS, TIMING_PAIRS,
                                      BF16_PEAK / 1e12)})
    return times


def phase_config3_bf16(card):
    """BASELINE config 3 in bf16 end to end on the card: GConvGRU (hidden
    128, k=2, 2 layers, the default graph_kernel="auto") at B=256, L=16 on
    Carla2D3D through Trainer.fit, rows 10 and 11's bf16 launches counted;
    the eval logits against the fp32 flow's on the same parameters; the
    parameters and AdamW state float32; training_step and eval_step
    against fp32 in alternating pairs, and both steps' CUDA-event split.
    -> (rows 10 and 11's bf16 launches, the step times)."""
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule

    dm = Carla2D3DDataModule(batch_size=CLS_BATCH, clip_length=CLIP,
                             val_set_size=VAL_BATCHES * CLS_BATCH, seed=SEED)
    flows = {p: make_cls_flow(precision=p) for p in ("bf16", "32")}
    model = flows["bf16"].classification_model
    if (model.hidden_size, model.k, model.graph_kernel) != (CLS_H, CLS_K,
                                                           "auto"):
        raise AssertionError("GConvGRU's defaults changed")
    batches_run = BF16_CLS_STEPS + VAL_BATCHES
    expected = {"graph_gru_scan": 2 * batches_run,
                "graph_gru_scan_bwd": 2 * BF16_CLS_STEPS}
    counts, losses, epochs, fit_s, _ = fit_classifier(
        flows["bf16"], dm, BF16_CLS_STEPS, VAL_BATCHES, "cls_bf16", expected)
    b16 = bf16_counts(SCAN_BF16_ROWS)
    if (b16["row10_bf16"], b16["row11_bf16"]) != (
            expected["graph_gru_scan"], expected["graph_gru_scan_bwd"]):
        raise AssertionError(f"config 3 bf16: bf16 launches {b16}, "
                             f"expected {expected}")
    launches = dict(b16)

    batch = next(dm.train_batches(SEED + 7))
    params = flows["32"].init_params()
    logits = {p: f.eval_step(params, batch)[1][f.outputs_key]
              for p, f in flows.items()}
    err = bar_err(logits["bf16"], logits["32"])[1]
    if logits["bf16"].dtype != torch.float32 or err > BF16_VS_FP32 \
            or not torch.isfinite(logits["bf16"]).all():
        raise AssertionError(f"config 3 bf16 logits vs fp32: {err}")
    states = {p: f.init_state(params) for p, f in flows.items()}
    flows["bf16"].training_step(states["bf16"], batch)
    dtypes = {str(v.dtype) for tree in states["bf16"].params.values()
              for v in tree.values()} | {
        str(v.dtype) for st in states["bf16"].optimizer.state.values()
        for v in st.values() if torch.is_tensor(v) and v.numel() > 1}
    if dtypes != {"torch.float32"}:
        raise AssertionError(f"config 3 bf16 state dtypes {dtypes}")
    step_pairs = paired_host_ms(
        {"bf16": lambda: flows["bf16"].training_step(states["bf16"], batch),
         "fp32": lambda: flows["32"].training_step(states["32"], batch)})
    eval_pairs = paired_host_ms(
        {"bf16": lambda: flows["bf16"].eval_step(params, batch),
         "fp32": lambda: flows["32"].eval_step(params, batch)})
    split = {p: cls_step_split(f, states[p], batch)
             for p, f in flows.items()}
    out = {"train_step_ms_host_pairs": step_pairs,
           "eval_step_ms_host_pairs": eval_pairs,
           "train_step_split_cuda_events_bf16": split["bf16"],
           "train_step_split_cuda_events_fp32": split["32"]}
    emit({"phase": "config3_bf16", "card": card, "B": CLS_BATCH, "L": CLIP,
          "steps": BF16_CLS_STEPS, "val_batches": VAL_BATCHES,
          "launches": counts, "bf16_launches": b16, "fit_seconds": fit_s,
          "train_loss_primary": losses,
          "val_loss_primary": epochs[-1]["val_loss/primary"],
          "logits_vs_fp32_over_max": err, "state_dtypes": sorted(dtypes),
          **out})
    del flows, states, dm
    return launches, out


def phase_coverage_bf16(card):
    """bf16 beyond configs 5 and 3, a few steps each on the card: config 4
    (VideoPose3D, B=64, L=81; no hand-written kernel on its path, its
    products cuBLAS bf16) and config 2 on rnn_kernel="auto" (the loop), no
    launch; config 2 on rnn_kernel="fused" (its encoder on the dense bf16
    kernels), GConvLSTM (the graph-form LSTM kernels) and the LSTM
    classifier on rnn_kernel="fused" (the dense ones), launches counted; a
    bf16 GConvGRU exported and served through load_inference, the
    closure's bits; the CLI's --precision bf16 on a GConvGRU classifier
    with its default route. -> rows 12 and 13's bf16 launches (graph form
    and dense form) on these paths."""
    from pedestrians_video_2_carla_torch import modeling
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule
    from pedestrians_video_2_carla_torch.serving import (
        export_inference, load_inference, make_inference_fn)

    out = {}
    launches = dict.fromkeys(SCAN_BF16_ROWS, 0)
    cases = (("config4_videopose3d", lambda: make_vp_flow(
                  precision="bf16"), VP_BATCH, VP_CLIP, {}),
             ("config2_auto", lambda: make_ae_flow("auto", "bf16"),
              AE_BATCH, CLIP, {}),
             ("config2_fused", lambda: make_ae_flow("fused", "bf16"),
              AE_BATCH, CLIP,
              {"dense_lstm_scan": AE_LAYERS * BF16_COVERAGE_STEPS,
               "dense_lstm_scan_bwd": AE_LAYERS * BF16_COVERAGE_STEPS}))
    for name, make, B, L, expected in cases:
        flow = make()
        dm = Carla2D3DDataModule(batch_size=B, clip_length=L, seed=SEED)
        params = vp_params(flow) if name.startswith("config4") \
            else flow.init_params()
        state = flow.init_state(params)
        stats = {k: v.clone() for k, v in state.params["movements"].items()
                 if not v.requires_grad}
        reset_kernel_counts()
        stream = dm.train_batches(SEED)
        losses = []
        for _ in range(BF16_COVERAGE_STEPS):
            _, logs = flow.training_step(state, next(stream))
            losses.append(float(logs["train_loss/primary"]))
        torch.cuda.synchronize()
        counts, b16 = kernel_counts(), bf16_counts(SCAN_BF16_ROWS)
        dtypes = {str(v.dtype) for v in state.params["movements"].values()}
        moved = all(not torch.equal(state.params["movements"][k], v)
                    for k, v in stats.items())
        dense_b16 = (b16["row12_bf16_dense"], b16["row13_bf16_dense"])
        if not (np.isfinite(losses).all() and dtypes == {"torch.float32"}
                and moved and counts == expected_counts(**expected)
                and dense_b16 == (expected.get("dense_lstm_scan", 0),
                                  expected.get("dense_lstm_scan_bwd", 0))):
            raise AssertionError(f"bf16 {name}: losses {losses}, dtypes "
                                 f"{dtypes}, statistics moved {moved}, "
                                 f"launches {counts}, bf16 {b16}")
        for k in launches:
            launches[k] += b16[k]
        out[name] = {"losses": losses, "running_statistics": len(stats),
                     "launches": {k: v for k, v in counts.items() if v},
                     "statistics_moved": moved}
        del flow, state, dm
    # config 2's fused step in bf16 beside fp32's from the same weights,
    # alternating (host clock)
    flows = {p: make_ae_flow("fused", p) for p in ("bf16", "32")}
    params = flows["32"].init_params()
    states = {p: f.init_state(params) for p, f in flows.items()}
    batch = next(Carla2D3DDataModule(batch_size=AE_BATCH, clip_length=CLIP,
                                     seed=SEED).train_batches(SEED + 7))
    out["config2_fused"]["train_step_ms_host_pairs"] = paired_host_ms(
        {"bf16": lambda: flows["bf16"].training_step(states["bf16"], batch),
         "fp32": lambda: flows["32"].training_step(states["32"], batch)})
    del flows, states, batch

    # the classifiers on rows 12 and 13: GConvLSTM (graph form) and the
    # LSTM classifier on its fused route (dense form)
    dm = Carla2D3DDataModule(batch_size=CLS_BATCH, clip_length=CLIP,
                             val_set_size=CLS_BATCH, seed=SEED)
    steps, val = BF16_COVERAGE_STEPS, 1
    for name, kwargs, wrappers, rows in (
            ("gconv_lstm", dict(name="GConvLSTM"),
             ("graph_lstm_scan", "graph_lstm_scan_bwd"),
             ("row12_bf16", "row13_bf16")),
            ("lstm_classifier_fused", dict(name="LSTM", rnn_kernel="fused"),
             ("dense_lstm_scan", "dense_lstm_scan_bwd"),
             ("row12_bf16_dense", "row13_bf16_dense"))):
        expected = {wrappers[0]: 2 * (steps + val), wrappers[1]: 2 * steps}
        counts, losses, _, _, _ = fit_classifier(
            make_cls_flow(precision="bf16", **kwargs), dm, steps, val,
            f"{name}_bf16", expected)
        b16 = bf16_counts(SCAN_BF16_ROWS)
        if tuple(b16[r] for r in rows) != tuple(expected.values()):
            raise AssertionError(f"bf16 {name}: bf16 launches {b16}")
        for k in launches:
            launches[k] += b16[k]
        out[name] = {"losses": losses, "launches": expected}

    # a bf16 GConvGRU exported and served: the closure's bits, the bf16
    # kernel launched
    flow = make_cls_flow(precision="bf16")
    params = flow.init_params()
    inputs, _, meta = next(iter(dm.val_batches()))
    agi = meta["age_gender_idx"]
    closure = make_inference_fn(flow, params)(inputs, agi)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = export_inference(flow, params, inputs, agi,
                                os.path.join(tmp, "gconvgru_bf16.pt2"))
        export_s = time.perf_counter() - t0
        served, _ = load_inference(path)
        ops = program_ops(path)
        reset_kernel_counts()
        got = served(inputs, agi)
        torch.cuda.synchronize()
        b16 = bf16_counts(SCAN_BF16_ROWS)
        del served
    same = set(got) == set(closure) and all(
        torch.equal(got[k], v) and v.dtype == torch.float32
        for k, v in closure.items())
    if not same or b16["row10_bf16"] != 2 or kernel_counts() != \
            expected_counts(graph_gru_scan=2):
        raise AssertionError(f"bf16 GConvGRU program: closure bits {same}, "
                             f"bf16 launches {b16}")
    out["gconvgru_export"] = {"export_s": export_s, "ops": ops,
                              "closure_bits": same, "bf16_launches": b16}

    # the CLI's --precision bf16 on GConvGRU's default route
    with tempfile.TemporaryDirectory() as tmp:
        reset_kernel_counts()
        results = modeling.main([
            "--flow=classification", "--classification_model_name=GConvGRU",
            "--precision", "bf16", f"--batch_size={CLI_BATCH}",
            f"--clip_length={CLIP}", f"--val_set_size={CLI_BATCH}",
            "--max_epochs=1", "--limit_train_batches=2", f"--root_dir={tmp}",
            f"--seed={SEED}", "--run_name=cli_bf16"])
        torch.cuda.synchronize()
        b16 = bf16_counts(SCAN_BF16_ROWS)
        leaves = [v for tree in results["trainer"].state.params.values()
                  for v in tree.values()]
        val = [float(v) for k, v in results["val_metrics"].items()
               if "loss" in k]
        if not (b16["row10_bf16"] > 0 and b16["row11_bf16"] > 0
                and all(v.dtype == torch.float32 for v in leaves)
                and val and np.isfinite(val).all()):
            raise AssertionError(f"the CLI's bf16 GConvGRU: bf16 launches "
                                 f"{b16}, val losses {val}")
        out["cli_gconvgru"] = {"bf16_launches": b16, "val_losses": val}
    emit({"phase": "coverage_bf16", "card": card,
          "steps": BF16_COVERAGE_STEPS, **out, "bf16_launches": launches})
    return launches


def group_bf16(card, hbm_rate):
    """bf16 mixed precision on the card: rows 4, 5, 8 and 9 and rows 10-13
    in bf16 against their plain versions, configs 5 and 3 in bf16 end to
    end, the rows' times, and coverage. -> the eight bf16 rows'
    kernels-line entries."""
    t0 = time.perf_counter()
    errs = phase_kernel_bf16()
    torch.cuda.empty_cache()
    launches, e2e = phase_config5_bf16(card)
    torch.cuda.empty_cache()
    times = phase_timing_bf16(card, hbm_rate)
    torch.cuda.empty_cache()
    scan_errs = phase_kernel_scan_bf16()
    torch.cuda.empty_cache()
    scan_launches, config3 = phase_config3_bf16(card)
    torch.cuda.empty_cache()
    scan_times = phase_timing_scan_bf16(card, hbm_rate)
    torch.cuda.empty_cache()
    for k, v in phase_coverage_bf16(card).items():
        scan_launches[k] += v
    torch.cuda.empty_cache()
    emit({"phase": "group_bf16", "seconds": time.perf_counter() - t0})
    where = {"row4_bf16": ("fused_spatial_transformer.cu",
                           "fused_spatial_transformer.py:398"),
             "row8_bf16": ("fused_temporal_transformer.cu",
                           "fused_temporal_transformer.py:947 and :524"),
             "row5_bf16": ("fused_spatial_transformer.cu",
                           "fused_spatial_transformer.py:415"),
             "row9_bf16": ("fused_temporal_transformer.cu",
                           "fused_temporal_transformer.py:974 and :566")}
    entries = []
    for row, (source, replaces) in where.items():
        t = times[row]
        entry = kernel_entry(row, source, replaces, launches[row], errs[row],
                             {k: t[k] for k in ("ms", "plain_ms",
                                                "library_ms", "bound_ms",
                                                "bound_by")})
        entry["paired_with_library"] = t["paired_with_library"]
        entries.append(entry)
    entries[0]["config5_bf16"] = e2e
    entries += scan_bf16_entries(scan_times, scan_launches, scan_errs)
    entries[-4]["config3_bf16"] = config3
    return entries


def scan_bf16_entries(times, launches, errs):
    """Rows 10-13's bf16 entries of the kernels line: config 3's layer; rows
    12 and 13 with the dense form (config 2's layer, ``dense_`` fields) and
    the graph form at k = 1 (J=1, H=128, ``k1_`` fields) beside cuDNN."""
    where = {"row10_bf16": "fused_graph_gru.py:251",
             "row11_bf16": "fused_graph_gru.py:291",
             "row12_bf16": "fused_graph_gru.py:442",
             "row13_bf16": "fused_graph_gru.py:486"}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    entries = []
    for row, replaces in where.items():
        t = times[row]
        entry = kernel_entry(row, "fused_graph_gru.cu", replaces,
                             launches[row], errs[row],
                             {**{k: t.get(k) for k in keys},
                              "shape_B_L_J_H_k": t["shape_B_L_J_H_k"]})
        if "keep_ms" in t:
            entry.update(keep_ms=t["keep_ms"],
                         keep_bound_ms=t["keep_bound_ms"])
        if row in ("row12_bf16", "row13_bf16"):
            dense, k1 = times[f"{row}_dense"], times[f"{row}_k1"]
            entry.update(
                dense_source="pedestrians_video_2_carla_torch/csrc/"
                             "fused_dense_lstm.cu",
                dense_shape_B_L_J_H_k=dense["shape_B_L_J_H_k"],
                dense_launches=launches[f"{row}_dense"],
                dense_max_abs_err=errs[f"{row}_dense"],
                **{f"dense_{k}": dense[k] for k in keys},
                dense_paired_ratio_vs_library=dense["paired_vs_library"][
                    "ratio_median"],
                k1_shape_B_L_J_H_k=k1["shape_B_L_J_H_k"], k1_ms=k1["ms"],
                k1_bound_ms=k1["bound_ms"], k1_library_ms=k1["library_ms"],
                k1_paired_ratio_vs_library=k1["paired_vs_library"][
                    "ratio_median"])
        entries.append(entry)
    return entries


#: group_recorded: config 1's CarlaRecorded-format subsets (train batches,
#: validation clips: the second validation batch is padded)
REC_TRAIN_BATCHES, REC_VAL_CLIPS = 32, 2000
#: the train batches phase 43 compares
REC_CHECK_BATCHES = 4
#: the hoisted deterministic path's bar (numpy's assert_allclose)
HOIST_ATOL, HOIST_RTOL = 1e-6, 1e-7
#: the capturable AdamW's bar: one step of it from the host-stepped AdamW's
#: state, on the same batch and dropout draws, within this share of each
#: parameter's largest magnitude
CAPTURABLE_BAR = 1e-6
#: the steps at which phase 44 takes that step
CAPTURABLE_STEPS = 4
#: the resident eager epoch's drift from the streamed one (the two AdamW
#: forms' rounding compounding over REC_TRAIN_BATCHES steps): the largest
#: |difference| of a parameter over its largest magnitude, and of a logged
#: train loss over its value; between the sound route's readings and those
#: of routes known to be wrong (PERF.md section 2,
#: tools/resident_drift_bar.py)
EPOCH_PARAM_BAR, EPOCH_LOSS_BAR = 2.8e-5, 1.75e-5
#: the steps a profiled window of phases 44-45 runs
REC_PROFILE_STEPS = 4
ROUTES = ("streamed", "prefetched", "native", "resident_eager",
          "resident_graphed")
ROW2_KERNELS = ("fk_forward_kernel",)
ROW3_KERNELS = ("fused_projection_train_bwd_kernel",)


def recorded_clips(n, seed):
    """``n`` CarlaRecorded-format clips (``recorded_subset``): Carla2D3D's
    random poses (B=1024 at a time, on the card) through the port's FK
    and projection, with their relative, absolute and world targets, ages
    and genders."""
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule
    from pedestrians_video_2_carla_torch.data.carla.carla_recorded import \
        recorded_subset
    from pedestrians_video_2_carla_torch.skeletons import AGE_GENDER_KEYS

    keys = ("projection_2d", "relative_pose_loc", "relative_pose_rot",
            "absolute_pose_loc", "absolute_pose_rot", "world_loc",
            "world_rot", "crossing")
    stream = Carla2D3DDataModule(batch_size=BATCH, clip_length=CLIP,
                                 seed=seed).train_batches(seed)
    parts = []
    for _ in range(-(-n // BATCH)):
        _, targets, meta = next(stream)
        parts.append({**{k: targets[k].cpu().numpy() for k in keys},
                      "kind": meta["age_gender_idx"].cpu().numpy()})
    c = {k: np.concatenate([p[k] for p in parts])[:n] for k in parts[0]}
    ages, genders = zip(*(AGE_GENDER_KEYS[i].split("_") for i in c["kind"]))
    return recorded_subset(
        c["projection_2d"], (c["relative_pose_loc"], c["relative_pose_rot"]),
        (c["absolute_pose_loc"], c["absolute_pose_rot"]),
        world=(c["world_loc"], c["world_rot"]), crossing=c["crossing"],
        age=ages, gender=genders)


def recorded_datamodule(subsets, resident=False, native_dir=None):
    """CarlaRecordedDataModule (B=1024, L=16) over the in-memory subsets;
    the subsets on the card with ``resident``, the streamed batches
    gathered from flat binary caches under ``native_dir`` with it."""
    from pedestrians_video_2_carla_torch.data.carla.carla_recorded import \
        CarlaRecordedDataModule

    dm = CarlaRecordedDataModule(batch_size=BATCH, clip_length=CLIP,
                                 seed=SEED, device_resident=resident,
                                 outputs_dir=tempfile.gettempdir())
    for name, subset in subsets.items():
        dm.add_subset(name, *subset)
        if native_dir is not None:
            dm.build_native_cache(name, os.path.join(native_dir,
                                                     f"{name}.hdf5"))
            if name not in dm._native_caches:
                raise AssertionError("the native batch loader is not built")
    return dm


def batches_equal(a, b):
    """Whether two batches hold the same keys and the same bits."""
    return torch.equal(a[0], b[0]) and all(
        set(x) == set(y) and all(torch.equal(x[k], y[k]) for k in x)
        for x, y in zip(a[1:], b[1:]))


def phase_resident_batches(streamed, resident):
    """Resident batches (the per-batch gather and preprocessing) against
    the streamed ones, bit for bit; the hoisted deterministic path (what
    an epoch of config 1 gathers) within HOIST_ATOL + HOIST_RTOL."""
    worst = 0.0
    checked = {}
    for name, shuffle, training, count in (
            ("train", True, True, REC_CHECK_BATCHES),
            ("val", False, False, None)):
        spec = resident.resident_scan_inputs(name, shuffle, training, SEED)
        gather = resident._resident_gather(training)
        it = streamed._iter_subset(name, shuffle, training, SEED)
        count = count or spec.num_batches
        for b in range(count):
            ref = next(it)
            got = gather(None, spec.order, b, *resident._resident[name])
            if not batches_equal(ref, got):
                raise AssertionError(f"resident {name} batch {b} differs "
                                     f"from the streamed one")
            hoisted = spec.gather(None, spec.order, b, *spec.trees)
            for x, y in [(hoisted[0], ref[0])] + [
                    (hoisted[i][k], ref[i][k]) for i in (1, 2)
                    for k in ref[i]]:
                x, y = x.double(), y.double()
                if not bool(((x - y).abs() <= HOIST_ATOL
                             + HOIST_RTOL * y.abs()).all()):
                    raise AssertionError(f"hoisted {name} batch {b}")
                worst = max(worst, float((x - y).abs().max()))
        checked[name] = count
    emit({"phase": "resident_batches", "B": BATCH, "L": CLIP,
          "batches_checked": checked,
          "val_padded_clips": REC_VAL_CLIPS % BATCH and
          BATCH - REC_VAL_CLIPS % BATCH,
          "resident_equal_streamed_bits": True,
          "hoisted_max_abs_err": worst,
          "hoisted_bar": [HOIST_ATOL, HOIST_RTOL]})


def fit_route(route, dm, tmp, epochs=1, every=1, validate=True,
              make_flow=None, limit=None, capturable=False):
    """Trainer.fit of a fresh flow (make_train_flow("fused_train") unless
    given) by ``route``, its AdamW in the capturable form from the start
    with ``capturable``: (trainer, launches, step records, epoch
    records). The trainer's own choices are the prefetched and the
    resident graphed routes; the others patch its module for the fit: no
    prefetcher (``PREFETCH_DEPTH`` 0), the resident runner without graphs
    (``build_scan_runner(..., graphs=False)``)."""
    from pedestrians_video_2_carla_torch.models.base import set_capturable
    from pedestrians_video_2_carla_torch.runtime import resident_scan
    from pedestrians_video_2_carla_torch.training import trainer as T

    flow = make_flow() if make_flow else make_train_flow("fused_train")
    run = f"{route}-{epochs}-{every}-{int(capturable)}"
    trainer = T.Trainer(flow, dm, T.TrainerConfig(
        max_epochs=epochs, log_every_n_steps=every, seed=SEED,
        limit_train_batches=limit, logs_dir=tmp, run_name=run,
        check_val_every_n_epoch=1 if validate else 10 ** 6))
    if capturable:
        trainer._init_state()
        set_capturable(trainer.state.optimizer, True)
    reset_kernel_counts()
    saved = T.PREFETCH_DEPTH, T.build_scan_runner
    try:
        if route != "prefetched":
            T.PREFETCH_DEPTH = 0
        if route == "resident_eager":
            T.build_scan_runner = functools.partial(
                resident_scan.build_scan_runner, graphs=False)
        trainer.fit()
    finally:
        T.PREFETCH_DEPTH, T.build_scan_runner = saved
    torch.cuda.synchronize()
    counts = kernel_counts()
    with open(os.path.join(tmp, run, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    # a step record without its wall-clock time
    steps = [{k: v for k, v in r.items() if k != "time"} for r in records
             if any(k.startswith("lr-") for k in r)]
    epochs_ = [r for r in records if "epoch" in r]
    bad = {k: v for r in records for k, v in r.items()
           if "_loss/" in k and not np.isfinite(v)}
    if bad:
        raise AssertionError(f"{route}: non-finite logged losses {bad}")
    return trainer, counts, steps, epochs_


def params_equal(a, b):
    return all(torch.equal(a[n][k], v) for n, tree in b.items()
               for k, v in tree.items())


def epoch_drift(params, steps, ref_params, ref_steps):
    """How far an epoch (its final parameters and step records) is from a
    reference one: the largest |difference| of a parameter over its
    largest magnitude, and the largest relative difference of a logged
    train loss."""
    worst_param = max(
        float((params[n][k] - v).detach().abs().max())
        / max(float(v.detach().abs().max()), 1e-30)
        for n, tree in ref_params.items() for k, v in tree.items())
    worst_loss = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                     for a, b in zip(steps, ref_steps)
                     for k in b if k.startswith("train_loss/"))
    return worst_param, worst_loss


#: the host's pause between profile_window's guard call and its measured
#: one, seconds: the two calls' device records are told apart by time
PROFILE_GUARD_GAP_S = 0.01


def profile_window(fn):
    """One call of ``fn`` under torch.profiler, after a guard call of it
    in the same trace: the device busy share over the measured call's
    window (from its first to its last event), the device kernels' names,
    and the guard's count of device records. The guard is there because
    the profiler now and then loses a leading block of a trace's device
    records (about 150 records in 1 of 40 graphed windows, kineto's raw
    records too: PERF.md section 6, tools/phase45_profile_repeats.py);
    the measured call's records are those after the guard's, which end
    PROFILE_GUARD_GAP_S before it starts."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_GUARD_GAP_S)
        with record_function("profile_window_measured"):
            fn()
            torch.cuda.synchronize()
    events = list(prof.events())
    start = next(e for e in events
                 if e.name == "profile_window_measured").time_range.start
    # the range's own mirror on the device timeline is no device work
    all_device = [e for e in events
                  if getattr(e, "device_type", None) is not None
                  and e.device_type.name == "CUDA"
                  and e.name != "profile_window_measured"]
    device = [e for e in all_device if e.time_range.start >= start]
    events = [e for e in events if e.time_range.start >= start]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = max(e.time_range.end for e in events) \
        - min(e.time_range.start for e in events)
    return {"window_ms": window / 1e3, "device_events": len(device),
            "guard_device_events": len(all_device) - len(device),
            "device_busy_share": busy / window if device else None}, \
        [e.name for e in device]


def named(names, parts):
    return sum(any(p in n for p in parts) for n in names)


def profiled_launches(fn, rows):
    """A profiled window of ``fn`` and, per wrapper of ``rows`` (wrapper
    -> kernel name parts), its counted launches and its kernels in the
    trace."""
    trace, names = profile_window(fn)
    before = kernel_counts()
    fn()
    torch.cuda.synchronize()
    after = kernel_counts()
    # the counts of one call (the profiled call is the second of three)
    counted = {w: after[w] - before[w] for w in rows}
    return trace, {w: {"counted": counted[w],
                       "profiler": named(names, parts)}
                   for w, parts in rows.items()}


def capturable_step_move(dm):
    """How far the capturable AdamW moves a step from the host-stepped
    one: at each of CAPTURABLE_STEPS streamed steps, a copy of the state
    switched to the capturable form takes the same step (the same batch,
    the same dropout draws); the largest |difference| of a parameter over
    its largest magnitude, the worst over the steps."""
    import copy

    from pedestrians_video_2_carla_torch.models.base import set_capturable

    flow = make_train_flow("fused_train")
    state = flow.init_state()
    batches = dm.train_batches(SEED + 5)
    worst = []
    for _ in range(CAPTURABLE_STEPS):
        batch = next(batches)
        twin = copy.deepcopy(state)
        set_capturable(twin.optimizer, True)
        draws = flow.generator.get_state()
        flow.training_step(state, batch)
        flow.generator.set_state(draws)
        flow.training_step(twin, batch)
        worst.append(max(
            float((twin.params[n][k] - v).detach().abs().max())
            / max(float(v.detach().abs().max()), 1e-30)
            for n, tree in state.params.items() for k, v in tree.items()))
    return worst


def phase_epoch_config1(subsets, card):
    """Config 1 by the five routes (module docstring, phase 44)."""
    rows = {"fused_projection_train_fwd": ROW2_KERNELS,
            "fused_projection_train_bwd": ROW3_KERNELS}
    expected = expected_counts(
        fused_projection_train_fwd=REC_TRAIN_BATCHES + 2,
        fused_projection_train_bwd=REC_TRAIN_BATCHES)
    with tempfile.TemporaryDirectory() as tmp:
        dms = {"streamed": recorded_datamodule(subsets),
               "native": recorded_datamodule(subsets, native_dir=tmp),
               "resident": recorded_datamodule(subsets, resident=True)}
        dm_of = {"streamed": dms["streamed"], "prefetched": dms["streamed"],
                 "native": dms["native"],
                 "resident_eager": dms["resident"],
                 "resident_graphed": dms["resident"]}
        fits, graphed = {}, {}
        for route in ROUTES + ("streamed_capturable",):
            trainer, counts, steps, epochs = fit_route(
                route, dm_of.get(route, dms["streamed"]), tmp,
                capturable=route == "streamed_capturable")
            if counts != expected:
                raise AssertionError(f"{route} launches {counts}, expected "
                                     f"{expected}")
            if len(steps) != REC_TRAIN_BATCHES or "val_loss/primary" \
                    not in epochs[-1]:
                raise AssertionError(f"{route}: {len(steps)} step records")
            fits[route] = (trainer.state.params, steps,
                           epochs[-1]["val_loss/primary"], counts)
            if route == "resident_graphed":
                runner = trainer.runner
                graphed = {w: runner.replays * runner.captured.get(
                    (w, "launches"), 0) for w in rows}
                graphed_info = {"replays": runner.replays,
                                "warmup_steps": runner.warmup,
                                "captured": {w: runner.captured.get(
                                    (w, "launches"), 0) for w in rows}}
            del trainer
        ref_params, ref_steps = fits["streamed"][:2]
        for route in ("prefetched", "native"):
            if not (params_equal(fits[route][0], ref_params)
                    and fits[route][1] == ref_steps):
                raise AssertionError(f"{route} differs from streamed")
        eager_params, eager_steps = fits["resident_eager"][:2]
        if not (params_equal(fits["resident_graphed"][0], eager_params)
                and fits["resident_graphed"][1] == eager_steps):
            raise AssertionError("the graphed epoch differs from the "
                                 "resident eager one")
        # the resident epoch is the streamed one with the capturable AdamW,
        # bit for bit; the AdamW's form moves a step by CAPTURABLE_BAR at
        # most, and the epochs of the two forms drift apart from there
        if not (params_equal(fits["streamed_capturable"][0], eager_params)
                and fits["streamed_capturable"][1] == eager_steps):
            raise AssertionError("the resident eager epoch differs from the "
                                 "streamed one with the capturable AdamW")
        step_move = capturable_step_move(dms["streamed"])
        if not max(step_move) <= CAPTURABLE_BAR:
            raise AssertionError(f"a capturable AdamW step moves a parameter "
                                 f"{step_move} of its largest magnitude")
        worst_param, worst_loss = epoch_drift(eager_params, eager_steps,
                                              ref_params, ref_steps)
        if not (worst_param <= EPOCH_PARAM_BAR
                and worst_loss <= EPOCH_LOSS_BAR):
            raise AssertionError(
                f"the resident eager epoch drifts {worst_param} (params), "
                f"{worst_loss} (losses) from the streamed one; bars "
                f"{EPOCH_PARAM_BAR}, {EPOCH_LOSS_BAR}")
        if sum(graphed.values()) != 2 * (REC_TRAIN_BATCHES
                                         - graphed_info["warmup_steps"]):
            raise AssertionError(f"graphed launches {graphed}")

        # step time: a 2-epoch fit of each route logging once an epoch,
        # the second epoch timed
        timing, trainers = {}, {}
        for route in ROUTES:
            trainer, _, _, epochs = fit_route(
                route, dm_of[route], tmp, epochs=2, every=REC_TRAIN_BATCHES,
                validate=False)
            secs = epochs[-1]["epoch_time_s"]
            timing[route] = {"ms_per_step": 1e3 * secs / REC_TRAIN_BATCHES,
                             "clips_per_s": REC_TRAIN_BATCHES * BATCH / secs,
                             "epoch_s": secs}
            if route in ("streamed", "resident_graphed"):
                trainers[route] = trainer
        # busy share and rows 2-3 by name: 4 streamed steps, 4 replays
        st = trainers["streamed"]
        batches = st.dm.train_batches(SEED + 99)

        def streamed_steps():
            for _ in range(REC_PROFILE_STEPS):
                st.flow.training_step(st.state, next(batches))
        gt = trainers["resident_graphed"]
        profiles = {"streamed": profiled_launches(streamed_steps, rows),
                    "resident_graphed": profiled_launches(
                        lambda: gt.runner(gt.state, 0, REC_PROFILE_STEPS),
                        rows)}
        for route, (_, launches) in profiles.items():
            for w, n in launches.items():
                if n["counted"] != REC_PROFILE_STEPS \
                        or n["profiler"] != n["counted"]:
                    raise AssertionError(f"{route} {w}: {n}")
        del trainers, st, gt, dms, dm_of
    emit({"phase": "epoch_config1", "card": card, "B": BATCH, "L": CLIP,
          "steps": REC_TRAIN_BATCHES, "train_clips": REC_TRAIN_BATCHES * BATCH,
          "routes": list(ROUTES),
          "launches": {r: {k: v for k, v in f[3].items() if v}
                       for r, f in fits.items()},
          "graphed": graphed_info, "graphed_launches": graphed,
          "graphed_equal_eager_bits": True,
          "streamed_prefetched_native_equal_bits": True,
          "resident_eager_equal_streamed_capturable_bits": True,
          "capturable_step_move_max_param_share": step_move,
          "capturable_bar": CAPTURABLE_BAR,
          "resident_eager_vs_streamed_epoch_max_param_share": worst_param,
          "resident_eager_vs_streamed_epoch_max_loss_rel": worst_loss,
          "epoch_bars": [EPOCH_PARAM_BAR, EPOCH_LOSS_BAR],
          "val_loss_primary": {r: f[2] for r, f in fits.items()},
          "timing": timing,
          "profiles": {r: {**trace, "rows": launches}
                       for r, (trace, launches) in profiles.items()},
          "method": "ms a step and clips/s: the second epoch of a 2-epoch "
                    "Trainer.fit logging once an epoch, host clock from the "
                    "epoch's start to its last logs read (which waits for "
                    "the card); busy share: torch.profiler over 4 steps"})
    return graphed


def phase_epoch_config3(card):
    """GConvGRU resident on config 3's subsets (phase 45)."""
    rows = {"graph_gru_scan": ROW10_KERNELS,
            "graph_gru_scan_bwd": ROW11_SCAN_KERNELS}
    steps = OP_TRAIN_BATCHES
    resident, _ = openpose_datamodule(device_resident=True)
    streamed, _ = openpose_datamodule()
    with tempfile.TemporaryDirectory() as tmp:
        fits = {}
        for route in ("resident_eager", "resident_graphed"):
            trainer, counts, logs, _ = fit_route(
                route, resident, tmp, validate=False, make_flow=make_cls_flow)
            if counts != expected_counts(graph_gru_scan=2 * steps,
                                         graph_gru_scan_bwd=2 * steps):
                raise AssertionError(f"{route} launches {counts}")
            fits[route] = (trainer, logs, counts)
        (eager, eager_logs, _), (graph, graph_logs, _) = (
            fits["resident_eager"], fits["resident_graphed"])
        if not (params_equal(graph.state.params, eager.state.params)
                and graph_logs == eager_logs and len(eager_logs) == steps):
            raise AssertionError("config 3: the graphed epoch differs from "
                                 "the resident eager one")
        runner = graph.runner
        replays = runner.replays  # the fit's, before the profiled windows
        graphed = {w: replays * runner.captured.get((w, "launches"), 0)
                   for w in rows}
        profiles = {
            route: profiled_launches(
                lambda t=t: t.runner(t.state, 0, REC_PROFILE_STEPS), rows)
            for route, t in (("resident_eager", eager),
                             ("resident_graphed", graph))}
        for w in rows:
            e, g = (profiles[r][1][w] for r in ("resident_eager",
                                                "resident_graphed"))
            if e != g or g["profiler"] != g["counted"] or not g["counted"]:
                raise AssertionError(f"config 3 {w}: eager {e}, graphed {g}")
        del fits, eager, graph
        timing = {}
        for route, dm in (("streamed", streamed),
                          ("resident_eager", resident),
                          ("resident_graphed", resident)):
            _, _, _, epochs = fit_route(route, dm, tmp, epochs=2,
                                        every=steps, validate=False,
                                        make_flow=make_cls_flow)
            secs = epochs[-1]["epoch_time_s"]
            timing[route] = {"ms_per_step": 1e3 * secs / steps,
                             "epoch_s": secs}
    emit({"phase": "epoch_config3", "card": card, "B_L_J_H_k": CLS_MAIN,
          "steps": steps, "augment": ["flip", "rotate"],
          "graphed_equal_eager_bits": True,
          "graphed": {"replays": replays, "warmup_steps": runner.warmup,
                      "captured": {w: runner.captured.get((w, "launches"), 0)
                                   for w in rows}},
          "graphed_launches": graphed,
          "profiles": {r: {**trace, "rows": launches}
                       for r, (trace, launches) in profiles.items()},
          "timing": timing,
          "method": "ms a step: the second epoch of a 2-epoch Trainer.fit "
                    "logging once an epoch, host clock to its last logs "
                    "read"})
    return graphed


def group_recorded(card, hbm_rate):
    """The recorded data and the resident epoch (phases 43-45) -> the
    graphed launches of rows 2, 3, 10 and 11."""
    t0 = time.perf_counter()
    subsets = {"train": recorded_clips(REC_TRAIN_BATCHES * BATCH, SEED + 20),
               "val": recorded_clips(REC_VAL_CLIPS, SEED + 21)}
    phase_resident_batches(recorded_datamodule(subsets),
                           recorded_datamodule(subsets, resident=True))
    torch.cuda.empty_cache()
    config1 = phase_epoch_config1(subsets, card)
    del subsets
    torch.cuda.empty_cache()
    config3 = phase_epoch_config3(card)
    torch.cuda.empty_cache()
    emit({"phase": "group_recorded", "seconds": time.perf_counter() - t0})
    return {**{w: {"launches_recorded_graphed": n}
               for w, n in config1.items()},
            **{w: {"launches_recorded_graphed": n}
               for w, n in config3.items()}}


#: m7_cli_logs_profile: train batches an epoch (B=1024, L=16), the lr
#: the CLI's bare --lr sets, and the unprofiled-profiled pairs of fits
M7_STEPS, M7_LR, M7_PAIRS = 4, 3e-4, 3
#: the kernels of rows 2 and 3 by their names in a trace
M7_ROWS = {
    "fused_projection_train_fwd": ("fk_forward_kernel<true>",),
    "fused_projection_train_bwd": ("fused_projection_train_bwd_kernel",)}


def trace_kernel_names(path):
    """The CUDA kernels' names in a Chrome trace ``torch.profiler``
    wrote, and its count of CUDA graph launches."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    graph_launches = sum(e.get("cat") == "cuda_runtime"
                         and "GraphLaunch" in e.get("name", "")
                         for e in events)
    return kernels, graph_launches


def cli_fit(argv):
    """``modeling.main(argv)``'s trainer, and the launches of its fit: the
    counts after main less those of the evaluation main runs after the
    fit (measured by running it again)."""
    from pedestrians_video_2_carla_torch import modeling

    reset_kernel_counts()
    trainer = modeling.main(argv)["trainer"]
    torch.cuda.synchronize()
    after_main = kernel_counts()
    trainer.evaluate("val", trainer.config.limit_val_batches)
    torch.cuda.synchronize()
    again = kernel_counts()
    return trainer, {w: 2 * after_main[w] - again[w] for w in after_main}


def step_gap_ms(log_dir):
    """ms a step: the median gap between consecutive step records of one
    epoch in ``metrics.jsonl``. Each record's host time is taken after its
    step's logs are read, which waits for the card (``log_every_n_steps``
    1), so the gaps leave out each epoch's start-up (its first step, the
    prefetcher's start) and its validation."""
    gaps, prev = [], None
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for record in map(json.loads, f):
            if "epoch" in record or record["step"] < 0:
                prev = None
                continue
            if prev is not None:
                gaps.append(record["time"] - prev)
            prev = record["time"]
    return 1e3 * statistics.median(gaps)


def phase_m7_cli_logs_profile(card):
    """Phase 46: BASELINE config 1 through the CLI with the JAX CLI's
    flags the port used to drop and M7's logging and tracing flags (module
    docstring)."""
    from pedestrians_video_2_carla_torch import modeling
    from pedestrians_video_2_carla_torch.data.carla.carla_recorded import \
        CarlaRecordedDataModule

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        common = [
            "--flow=pose_lifting", "--movements_model_name=LinearAE",
            "--loss_modes", "loc_2d_3d", "--projection_kernel=fused_train",
            f"--batch_size={BATCH}", f"--clip_length={CLIP}",
            f"--val_set_size={BATCH}", "--max_epochs=2",
            f"--limit_train_batches={M7_STEPS}", "--log_every_n_steps=1",
            f"--lr={M7_LR}", f"--logs_dir={tmp}/logs",
            "--check_val_every_n_epoch=2", "--skip_initial_metrics=true",
            f"--seed={SEED}"]
        logged = common + ["--logger=wandb", "-v"]
        profiled = logged + ["--profile"]
        # no fit-start pass, validation at epoch 2 only: M7_STEPS x 2
        # steps and one validation batch
        want = expected_counts(fused_projection_train_fwd=2 * M7_STEPS + 1,
                               fused_projection_train_bwd=2 * M7_STEPS)
        # the profiler's cost: fits that differ only in --profile, in
        # alternating pairs
        steps = {"plain": [], "profiled": []}
        seconds = {"plain": [], "profiled": []}
        for pair in range(M7_PAIRS):
            for run, argv in (("plain", logged), ("profiled", profiled)):
                t = time.perf_counter()
                trainer, launches = cli_fit(argv
                                            + [f"--run_name={run}{pair}"])
                seconds[run].append(time.perf_counter() - t)
                steps[run].append(step_gap_ms(trainer.log_dir))
                if launches != want:
                    raise AssertionError(f"CLI fit launches {launches}, "
                                         f"expected {want}")
        log_dir = trainer.log_dir
        # the bare --lr reaches every AdamW group
        lrs = {g["name"]: g["lr"]
               for g in trainer.state.optimizer.param_groups}
        if set(lrs.values()) != {M7_LR}:
            raise AssertionError(f"--lr {M7_LR}: the AdamW groups' lrs {lrs}")
        with open(os.path.join(log_dir, "hparams.json")) as f:
            hparams = json.load(f)
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            epochs = [r for r in map(json.loads, f) if "epoch" in r]
        if any(k.startswith("initial_") for k in hparams) or [
                "val_loss/primary" in r for r in epochs] != [False, True]:
            raise AssertionError(f"a fit-start pass or an epoch-1 "
                                 f"validation ran: {sorted(hparams)}, "
                                 f"{epochs}")
        # the W&B offline run directory, read without PyYAML
        (files,) = [os.path.join(d, "files") for d in glob.glob(
            os.path.join(log_dir, "wandb", "offline-run-*"))]
        with open(os.path.join(files, "config.yaml")) as f:
            config = json.load(f)   # JSON text is YAML 1.2
        with open(os.path.join(files, "wandb-summary.json")) as f:
            summary = json.load(f)
        with open(os.path.join(files, "wandb-history.jsonl")) as f:
            history = [json.loads(line) for line in f]
        with open(os.path.join(files, "wandb-metadata.json")) as f:
            json.load(f)
        if not (config["batch_size"]["value"] == BATCH
                and summary["_step"] == 2 * M7_STEPS
                and len(history) == 2 * M7_STEPS + 2):
            raise AssertionError(f"W&B files: {config}, {summary}, "
                                 f"{len(history)} rows")
        # the trace's kernels of rows 2 and 3 against the counters
        kernels, graph_launches = trace_kernel_names(
            os.path.join(log_dir, "trace", "trace.json"))
        in_trace = {w: named(kernels, parts) for w, parts in M7_ROWS.items()}
        if in_trace != {w: launches[w] for w in M7_ROWS}:
            raise AssertionError(f"the trace's kernels {in_trace}, counted "
                                 f"{launches}")
        out["streamed"] = {
            "lrs": lrs, "launches": {w: launches[w] for w in M7_ROWS},
            "trace_kernels": in_trace, "trace_kernel_events": len(kernels),
            "trace_graph_launches": graph_launches,
            "trace_mb": os.path.getsize(os.path.join(
                log_dir, "trace", "trace.json")) / 1e6,
            "wandb_history_rows": len(history),
            "ms_per_step": steps,
            "profiled_over_plain": [p / q for p, q in zip(
                steps["profiled"], steps["plain"])],
            "fit_seconds": seconds}
        del trainer

        # the same fit with --device_resident: config 1's CarlaRecorded-
        # format subsets in memory, the epoch as CUDA graph replays
        subsets = {"train": recorded_clips(M7_STEPS * BATCH, SEED + 30),
                   "val": recorded_clips(BATCH, SEED + 31)}

        class InMemoryRecorded(CarlaRecordedDataModule):
            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                for name, subset in subsets.items():
                    self.add_subset(name, *subset)

            def prepare_data(self):
                pass
        saved = dict(modeling.DATA_MODULES)
        modeling.DATA_MODULES["CarlaRecorded"] = InMemoryRecorded
        t = time.perf_counter()
        try:
            trainer, launches = cli_fit(profiled + [
                "--data_module_name=CarlaRecorded", "--device_resident=true",
                f"--outputs_dir={tmp}", "--run_name=graphed"])
        finally:
            modeling.DATA_MODULES.clear()
            modeling.DATA_MODULES.update(saved)
        seconds = time.perf_counter() - t
        kernels, graph_launches = trace_kernel_names(
            os.path.join(trainer.log_dir, "trace", "trace.json"))
        runner = trainer.runner
        out["resident_graphed"] = {
            "launches": {w: launches[w] for w in M7_ROWS},
            "replays": runner.replays, "warmup_steps": runner.warmup,
            "captured": {w: runner.captured.get((w, "launches"), 0)
                         for w in M7_ROWS},
            "trace_kernels": {w: named(kernels, parts)
                              for w, parts in M7_ROWS.items()},
            "trace_kernel_events": len(kernels),
            "trace_graph_launches": graph_launches,
            "ms_per_step": step_gap_ms(trainer.log_dir),
            "fit_seconds": seconds}
        del trainer, runner, subsets
    emit({"phase": "m7_cli_logs_profile", "card": card, "B": BATCH,
          "L": CLIP, "steps_per_epoch": M7_STEPS, "epochs": 2, **out,
          "seconds": time.perf_counter() - t0,
          "method": "modeling.main with --lr, --logs_dir, "
                    "--check_val_every_n_epoch 2, --skip_initial_metrics, "
                    "--logger wandb and -v, in alternating pairs without "
                    "and with --profile (the last profiled fit's files "
                    "checked); ms a step: the median gap between "
                    "consecutive step records of an epoch (host clock, "
                    "each step's logs read)"})
    return {w: {"launches_cli_profiled": out["streamed"]["launches"][w]
                + out["resident_graphed"]["launches"][w]}
            for w in M7_ROWS}


def group_m7(card):
    """The CLI's repaired flags, its loggers and its trace (phase 46) ->
    rows 2 and 3's launches in its profiled fits. The video renderers draw
    with cv2, which the card's machine lacks: they are tested on the CPU
    only (tests/test_torch_loggers.py)."""
    emit({"phase": "m7_renderers", "on_card": False,
          "reason": "the renderers need cv2, which this machine lacks; "
                    "tests/test_torch_loggers.py holds them to the JAX "
                    "package's frames on the CPU"})
    return phase_m7_cli_logs_profile(card)


#: the pose-estimation flow (group_pose_estimation): UniPoseLSTM at the JAX
#: defaults (ResNet-101 at output stride 16, heatmaps at stride 8, sigma 3,
#: 64 ConvLSTM features) on 256 x 256 frames, J = 26 (27 maps of 32 x 32):
#: requests of B=4 x L=16, a fit of B=2 x L=16, the other models' fits at
#: B=2 x L=8, the card-against-CPU batch of B=1 x L=2 and its bar
PE_SIZE, PE_STRIDE, PE_SIGMA = 256, 8, 3.0
PE_BATCH, PE_CLIP, PE_REQUESTS = 4, 16, REQUESTS
PE_TRAIN_BATCH, PE_STEPS = 2, 10
PE_COVER_BATCH, PE_COVER_CLIP, PE_COVER_STEPS = 2, 8, 3
PE_CPU_BATCH, PE_CPU_CLIP, PE_BAR = 1, 2, 1e-4
PE_TIMING_RUNS = 10


class CardClips:
    """A data module of clips made on the card, for the pose-estimation
    flow without a video decode: frames N(0, 1) (B, L, 3, H, W), keypoints
    drawn in the frame's middle, their heatmaps at the model's canvas by
    the port's ``gaussian_heatmaps`` and their hips-neck normalised form."""

    def __init__(self, batch_size, clip_length, train, val, seed):
        from pedestrians_video_2_carla_torch.ops.heatmaps import \
            gaussian_heatmaps
        from pedestrians_video_2_carla_torch.ops.normalization import \
            normalize_with
        from pedestrians_video_2_carla_torch.skeletons.carla import \
            CARLA_SKELETON

        self.device = torch.device("cuda", torch.cuda.current_device())
        self.batch_size, self.clip_length = batch_size, clip_length
        gen = torch.Generator(device=self.device).manual_seed(seed)
        canvas = PE_SIZE // PE_STRIDE

        def batch():
            shape = (batch_size, clip_length)
            frames = torch.randn(shape + (3, PE_SIZE, PE_SIZE),
                                 generator=gen, device=self.device)
            kp = PE_SIZE * (0.25 + 0.5 * torch.rand(
                shape + (len(CARLA_SKELETON), 2), generator=gen,
                device=self.device))
            targets = {
                "projection_2d": kp,
                "projection_2d_transformed": normalize_with(
                    kp, CARLA_SKELETON, extractor="hips_neck")[0],
                "heatmaps": gaussian_heatmaps(kp / PE_STRIDE,
                                              (canvas, canvas), PE_SIGMA)}
            meta = {"age_gender_idx": torch.zeros(
                batch_size, dtype=torch.int64, device=self.device)}
            return frames, targets, meta
        self._train = [batch() for _ in range(train)]
        self._val = [batch() for _ in range(val)]
        self.train_set_size = train * batch_size
        self.val_set_size = val * batch_size
        self.hparams = {"card_clips": True}

    @staticmethod
    def uses_infinite_train_set():
        return False

    def train_batches(self, seed=0):
        return iter(self._train)

    def train_stream(self, seed=0):
        return self.train_batches(seed), None

    def val_batches(self):
        return iter(self._val)


def make_pe_flow(name="UniPoseLSTM", loss="heatmaps", device=None):
    """The pose-estimation flow of ``name`` at its defaults (Linear at the
    group's frame size), weights drawn on the card from the seed."""
    from pedestrians_video_2_carla_torch.flows.pose_estimation import \
        PoseEstimationFlow
    from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
    from pedestrians_video_2_carla_torch.models.pose_estimation import \
        POSE_ESTIMATION_MODELS

    kwargs = {"video_size": (PE_SIZE, PE_SIZE)} if name == "Linear" else {}
    model = POSE_ESTIMATION_MODELS[name](
        generator=torch.Generator(device="cuda").manual_seed(SEED), **kwargs)
    if name == "UniPoseLSTM" and (
            model.backbone, model.output_stride, model.stride, model.sigma,
            model.lstm_features) != ("resnet101", 16, PE_STRIDE, PE_SIGMA,
                                     64):
        raise AssertionError("UniPoseLSTM's defaults changed")
    return PoseEstimationFlow(model, loss_modes=[loss],
                              movements_optimizer=OptimizerSettings(lr=LR),
                              seed=SEED, device=device)


def pe_stats(tree):
    return {k: v for k, v in tree.items() if "running_" in k}


def phase_train_pose_estimation():
    """Trainer.fit of UniPoseLSTM with the heatmaps loss on card clips
    (no validation pass in the fit, so no checkpoint of its 0.6 GB is
    written): finite losses, every parameter whose gradient is not all
    zero moved, every running statistic moved; the step's ms (the median
    gap between the fit's step records) and a validation batch's loss."""
    from pedestrians_video_2_carla_torch.training.trainer import (
        Trainer, TrainerConfig)

    t0 = time.perf_counter()
    flow = make_pe_flow()
    dm = CardClips(PE_TRAIN_BATCH, PE_CLIP, PE_STEPS, 1, SEED + 31)
    start = {k: v.clone() for k, v in flow.init_params()["movements"]
             .items()}
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(flow, dm, TrainerConfig(
            max_epochs=1, limit_train_batches=PE_STEPS,
            check_val_every_n_epoch=2, log_every_n_steps=1, seed=SEED,
            logs_dir=tmp, run_name="pe", skip_initial_metrics=True))
        t_fit = time.perf_counter()
        state = trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t_fit
        run = os.path.join(tmp, "pe")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        step_ms = step_gap_ms(run)
    losses = [r["train_loss/heatmaps"] for r in records
              if "lr-movements" in r]
    val_loss = float(flow.eval_step(state.params, dm._val[0])[0][
        "heatmaps"])
    if len(losses) != PE_STEPS or not all(np.isfinite(losses)) \
            or not np.isfinite(val_loss):
        raise AssertionError(f"pose-estimation fit: losses {losses}, "
                             f"validation {val_loss}")
    tree = state.params["movements"]
    trained = {k for k, v in tree.items() if v.requires_grad}
    # a leaf whose gradient is exactly 0 (WASP's branch projections'
    # biases, whose constant the BatchNorm after the fusing conv takes
    # out) need not move; every other must
    unmoved = sorted(k for k in trained if torch.equal(tree[k], start[k])
                     and tree[k].grad is not None and tree[k].grad.any())
    zero_grad = sorted(k for k in trained if tree[k].grad is None
                       or not tree[k].grad.any())
    stats_moved = {k: float((v - start[k]).abs().max())
                   for k, v in pe_stats(tree).items()}
    if unmoved or len(zero_grad) > 4 \
            or min(stats_moved.values()) <= 0.0:
        raise AssertionError(f"unmoved parameters {unmoved[:5]}, zero "
                             f"gradients {zero_grad[:5]}, running "
                             f"statistics {min(stats_moved.values())}")
    emit({"phase": "train_pose_estimation", "B": PE_TRAIN_BATCH,
          "L": PE_CLIP, "frames": PE_TRAIN_BATCH * PE_CLIP, "steps": PE_STEPS,
          "losses": losses, "val_batch_loss": val_loss,
          "parameters": len(trained), "zero_gradient_leaves": zero_grad,
          "running_stats": len(stats_moved),
          "running_stats_moved_min": min(stats_moved.values()),
          "fit_s": fit_s, "train_step_ms_host": step_ms,
          "method": "the step: the median gap between the fit's step "
                    "records (host clock, each after its logs are read)",
          "seconds": time.perf_counter() - t0})
    return flow, state


def request_split(model, params, inputs):
    """CUDA events between a request's stages, medians over
    PE_TIMING_RUNS passes: the backbone; WASP, the decoder and the resizes;
    the ConvLSTM loop; the head and the argmax decode."""
    from torch.func import functional_call

    from pedestrians_video_2_carla_torch.models.pose_estimation import \
        unipose_lstm as U
    from pedestrians_video_2_carla_torch.ops.heatmaps import \
        keypoints_from_heatmaps

    names = ("backbone", "wasp_decoder_resizes", "conv_lstm",
             "head_argmax")
    B, L, C, H, W = inputs.shape
    hh, ww = H // model.stride, W // model.stride

    def sub(name):
        prefix = f"{name}."
        return {k[len(prefix):]: v for k, v in params.items()
                if k.startswith(prefix)}
    subs = {n: sub(n) for n in ("ResNet_0", "WASP_0", "Decoder_0",
                                "conv_lstm", "head")}

    def call(name, *args):
        return functional_call(getattr(model, name), subs[name], args)

    def stages():
        frames = inputs.reshape(B * L, C, H, W)
        centre = model.centermap(H, W, inputs.device)
        frames = torch.cat([frames, centre.expand(B * L, 1, H, W)], dim=1)
        high, low = call("ResNet_0", frames)
        yield
        maps = call("Decoder_0", call("WASP_0", high), low)
        maps = U.resize_bilinear(maps, (hh, ww))
        yield
        smoothed = call("conv_lstm", maps.reshape(B, L, -1, hh, ww))
        yield
        out = call("head", smoothed.reshape(B * L, -1, hh, ww))
        keypoints_from_heatmaps(out.reshape(B, L, -1, hh, ww))
        yield

    split = {n: [] for n in names}
    with torch.no_grad():
        for run in range(PE_TIMING_RUNS + 2):
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(len(names) + 1)]
            events[0].record()
            for i, _ in enumerate(stages()):
                events[i + 1].record()
            events[-1].synchronize()
            if run >= 2:
                for i, n in enumerate(names):
                    split[n].append(events[i].elapsed_time(events[i + 1]))
    return {n: statistics.median(v) for n, v in split.items()}


def unipose_conv_flops(model, run, B, L, H, W):
    """The FLOPs (2 x multiply-adds) of every convolution of one UniPoseLSTM
    forward over B x L frames of H x W: the ``nn.Conv2d`` modules ``run``
    calls, counted by forward hooks from their outputs' shapes, and the
    ConvLSTM's products (its input half and its hidden half over every
    frame), which call ``F.conv2d`` on slices of its weight. BatchNorm, the resizes and the gating are left out."""
    total = [0]

    def hook(module, inputs, out):
        kh, kw = module.kernel_size
        total[0] += 2 * out.numel() * module.in_channels // module.groups \
            * kh * kw

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d) and m is not
               model.conv_lstm.Conv_0]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    C = model.lstm_features
    hw = (H // model.stride) * (W // model.stride)
    lstm = 2 * 9 * C * 4 * C * hw * 2 * B * L
    return total[0] + lstm


def phase_serve_pose_estimation(flow, params, card, hbm_rate):
    """8 requests of B=4 x L=16 frames through make_inference_fn (the
    script's flags, TF32 off): keypoints in the frame, finite; the host
    clock's median, the same under torch's default flags (cuDNN TF32 on),
    and a CUDA-event split of one request."""
    from pedestrians_video_2_carla_torch.serving import make_inference_fn

    t0 = time.perf_counter()
    dm = CardClips(PE_BATCH, PE_CLIP, 0, PE_REQUESTS, SEED + 37)
    infer = make_inference_fn(flow, params)
    times = []
    for inputs, _, meta in dm.val_batches():
        t = time.perf_counter()
        preds = infer(inputs, meta["age_gender_idx"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        kp = preds["projection_2d"]
        if kp.shape != (PE_BATCH, PE_CLIP, 26, 2) \
                or not torch.isfinite(kp).all() or kp.min() < 0 \
                or kp.max() >= PE_SIZE \
                or set(preds) != {"projection_2d",
                                  "projection_2d_transformed"}:
            raise AssertionError(f"request: {tuple(kp.shape)}, "
                                 f"{sorted(preds)}")
    inputs, _, meta = dm._val[0]
    request = functools.partial(infer, inputs, meta["age_gender_idx"])
    flags = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True    # torch's default
    try:
        tf32_ms = host_median_ms(request, runs=PE_TIMING_RUNS)
    finally:
        torch.backends.cudnn.allow_tf32 = flags
    split = request_split(flow.movements_model, params["movements"], inputs)
    request_ms_cuda = cuda_median_ms(request, runs=PE_TIMING_RUNS)
    flops = unipose_conv_flops(flow.movements_model, request, PE_BATCH,
                               PE_CLIP, PE_SIZE, PE_SIZE)
    emit({"phase": "serve_pose_estimation", "card": card, "B": PE_BATCH,
          "L": PE_CLIP, "frames": PE_BATCH * PE_CLIP, "size": PE_SIZE,
          "requests": len(times), "request_ms_host_each": times,
          "request_ms_host_median": statistics.median(times),
          "request_ms_cuda_events": request_ms_cuda,
          "request_ms_host_median_cudnn_tf32": tf32_ms,
          "split_ms_cuda_events": split,
          "split_sum_ms": sum(split.values()),
          "conv_gflop_per_request": flops / 1e9,
          "conv_gflop_per_frame": flops / 1e9 / (PE_BATCH * PE_CLIP),
          "conv_tflops_fp32": flops / request_ms_cuda / 1e9,
          "conv_tflops_cudnn_tf32": flops / tf32_ms / 1e9,
          "bound_ms_fp32_peak": flops / FP32_PEAK * 1e3,
          "method": "host clock to torch.cuda.synchronize() around each "
                    "request; the TF32 time and the CUDA-event times are "
                    "medians of %d after warm-ups; the split records an "
                    "event after each stage of the model run stage by "
                    "stage; FLOPs: unipose_conv_flops; the TF32 rate over "
                    "the host clock's median" % PE_TIMING_RUNS,
          "seconds": time.perf_counter() - t0})


def phase_pe_card_vs_cpu(flow, weights):
    """One B=1 x L=2 batch through UniPoseLSTM on the card and on the CPU
    with the same weights, ``weights`` by name: the seeded init and the
    fit's. Each output's largest deviation over max |CPU float64|, on the
    card with cuDNN's TF32 off, with cuDNN off and under torch's default
    flags (cuDNN TF32 on), and on the CPU in float32. Held: at the init,
    the card's float32 within PE_BAR of the CPU's float32. Printed: the
    rest, and the fit's weights, whose evaluation is ill-conditioned (10
    steps leave the running statistics 90 % their init, the decoder's
    maps reach 1e5, and every float32 result lands 1e-4 to 1e-3 from
    float64, the CPU's too, by how the fit's steps fell)."""
    import copy

    from torch.func import functional_call

    t0 = time.perf_counter()
    model = flow.movements_model
    x = torch.randn(PE_CPU_BATCH, PE_CPU_CLIP, 3, PE_SIZE, PE_SIZE,
                    generator=torch.Generator().manual_seed(SEED + 41))
    cpu32 = copy.deepcopy(model).cpu()
    cpu64 = copy.deepcopy(model).cpu().double()
    report = {}
    with torch.no_grad():
        for wname, tree in weights.items():
            ref = functional_call(cpu64, {k: v.cpu().double() for k, v in
                                          tree.items()}, (x.double(),))
            outs = {"cpu_fp32": functional_call(
                cpu32, {k: v.cpu() for k, v in tree.items()}, (x,))}
            flags = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cudnn.enabled)
            try:
                for name, tf32, enabled in (
                        ("card_fp32", False, True),
                        ("card_fp32_cudnn_off", False, False),
                        ("card_torch_default_flags", True, True)):
                    torch.backends.cudnn.allow_tf32 = tf32
                    torch.backends.cudnn.enabled = enabled
                    outs[name] = functional_call(model, tree,
                                                 (x.cuda(),)).cpu()
            finally:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cudnn.enabled) = flags
            if not all(torch.isfinite(o).all() for o in outs.values()):
                raise AssertionError(f"{wname}: not finite")
            scale = float(ref.abs().max())
            errs = {n: float((o.double() - ref).abs().max()) / scale
                    for n, o in outs.items()}
            errs["card_fp32_vs_cpu_fp32"] = float(
                (outs["card_fp32"] - outs["cpu_fp32"]).abs().max()
                / outs["cpu_fp32"].abs().max())
            errs["max_abs_f64"] = scale
            report[wname] = errs
    if report["init"]["card_fp32_vs_cpu_fp32"] > PE_BAR:
        raise AssertionError(f"UniPoseLSTM card vs CPU: {report}")
    emit({"phase": "pe_card_vs_cpu", "B": PE_CPU_BATCH, "L": PE_CPU_CLIP,
          "size": PE_SIZE, "max_err_over_max_f64": report, "bar": PE_BAR,
          "held": "init: card_fp32_vs_cpu_fp32 <= bar; the rest printed",
          "seconds": time.perf_counter() - t0})


def phase_pe_coverage():
    """3-step fits of P0, AvPedestrianPoseTransformer and Linear at B=2 x
    L=8 on card clips with loc_2d: finite losses; an eval_step twice, the
    same bits."""
    t0 = time.perf_counter()
    models = {}
    for name in ("P0", "AvPedestrianPoseTransformer", "Linear"):
        t = time.perf_counter()
        flow = make_pe_flow(name, loss="loc_2d")
        dm = CardClips(PE_COVER_BATCH, PE_COVER_CLIP, PE_COVER_STEPS, 1,
                       SEED + 43)
        state = flow.init_state()
        losses = [float(flow.training_step(state, b)[1]["train_loss/loc_2d"])
                  for b in dm.train_batches()]
        batch = dm._val[0]
        first = flow.eval_step(state.params, batch)[1]
        second = flow.eval_step(state.params, batch)[1]
        if not all(np.isfinite(losses)) or any(
                not torch.equal(first[k], second[k]) for k in first
                if first[k] is not None):
            raise AssertionError(f"{name}: losses {losses}")
        models[name] = {"losses": losses,
                        "params": flow.param_counts(state)["movements"],
                        "seconds": time.perf_counter() - t}
        del flow, state, dm
        torch.cuda.empty_cache()
    emit({"phase": "pe_coverage", "B": PE_COVER_BATCH, "L": PE_COVER_CLIP,
          "size": PE_SIZE, "models": models,
          "seconds": time.perf_counter() - t0})


def group_pose_estimation(card, hbm_rate):
    """The pose-estimation flow (no TPU kernel on its path: the JAX
    package runs its convolutions, BatchNorms, resizes and ConvLSTM
    outside Pallas, and the port on cuDNN and PyTorch's ops): UniPoseLSTM
    at full width trained, served and held to the CPU, the other models'
    short fits; no pv2c kernel launches; the group's peak memory."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    flow, state = phase_train_pose_estimation()
    params = {n: {k: v.detach() for k, v in t.items()}
              for n, t in state.params.items()}
    del state
    torch.cuda.empty_cache()
    phase_serve_pose_estimation(flow, params, card, hbm_rate)
    phase_pe_card_vs_cpu(flow, {"init": flow.init_params()["movements"],
                                "fit": params["movements"]})
    del flow, params
    torch.cuda.empty_cache()
    phase_pe_coverage()
    torch.cuda.synchronize()
    counts = kernel_counts()
    if counts != expected_counts():
        raise AssertionError(f"the pose-estimation path launched {counts}")
    emit({"phase": "group_pose_estimation", "kernel_launches": counts,
          "max_memory_allocated_gib":
              torch.cuda.max_memory_allocated() / 2 ** 30,
          "seconds": time.perf_counter() - t0})


#: SMPL, AMASS and the mixed data modules (group_smpl_mixed): a synthetic
#: body model at SMPL-X's sizes (vertices, joints, faces; cut to the 22
#: body joints), the poses the body-model phase runs, the synthetic mocaps
#: (156-wide axis-angle poses at 60 fps) and their clips (MIX_MOCAP_FRAMES
#: = 2 * CLIP * 101: 100 clips a mocap at clip offset CLIP); the bars of
#: the card against the CPU: the body model within SMPL_BAR of max |out|,
#: the AMASS projections within XY_TOL_PX, the rest within SMPL_BAR
SMPL_VERTS, SMPL_JOINTS, SMPL_FACES, SMPL_KEPT = 10475, 55, 20908, 22
SMPL_POSES, SMPL_CPU_POSES, SMPL_BAR = 4096, 256, 1e-5
#: SMPL-X's first 22 parents (as the JAX package's AMASS test writes
#: them), then a chain
SMPLX_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                 16, 17, 18, 19) + tuple(range(20, 53))
MIX_MOCAPS, MIX_MOCAP_FRAMES = 32, 2 * 16 * 101
#: config 2 on CarlaRecAMASS: the CARLA member's clips, the AMASS member's
#: validation clips (the rest of phase 2's train), the proportions; GConvGRU
#: on JAADCarlaRec: each member's train and validation batches and its
#: fit's steps
MIX_CARLA_TRAIN, MIX_CARLA_VAL, MIX_AMASS_VAL = 4096, 512, 640
MIX_PROPORTIONS = [0.5, 0.5]
MIX_CLS_TRAIN_BATCHES, MIX_CLS_VAL_BATCHES, MIX_CLS_STEPS = 8, 2, 5


def smpl_body_model(tmp):
    """A seeded SMPL-X-sized ``model.npz`` written under ``tmp`` and loaded
    by the port's loader, cut to SMPL_KEPT joints: a template of
    SMPL_VERTS vertices, a sparse joint regressor (each joint the mean of
    8 vertices), Dirichlet skin weights over the 55 joints (folded into
    the kept ones by the loader) and SMPL_FACES random faces."""
    from pedestrians_video_2_carla_torch.data.smpl.body_model import \
        load_body_model_npz

    rng = np.random.default_rng(SEED + 30)
    v_template = rng.normal(scale=0.3, size=(SMPL_VERTS, 3))
    j_regressor = np.zeros((SMPL_JOINTS, SMPL_VERTS))
    for j in range(SMPL_JOINTS):
        j_regressor[j, rng.choice(SMPL_VERTS, 8, replace=False)] = 1 / 8
    kintree = np.zeros((2, SMPL_JOINTS), dtype=np.int64)
    kintree[0] = SMPLX_PARENTS
    path = os.path.join(tmp, "model.npz")
    np.savez(path, v_template=v_template, J_regressor=j_regressor,
             kintree_table=kintree,
             weights=rng.dirichlet(np.full(SMPL_JOINTS, 0.3), SMPL_VERTS),
             f=rng.integers(0, SMPL_VERTS, size=(SMPL_FACES, 3)))
    return load_body_model_npz(path, num_joints=SMPL_KEPT)


def phase_smpl_body_model(model):
    """Posed joints and skinned vertices of SMPL_POSES poses on the card:
    the same bits twice, the first SMPL_CPU_POSES within SMPL_BAR of max
    |out| of the CPU's (the CPU's vertices at the full count take tens of
    seconds), and each's time (CUDA events)."""
    from pedestrians_video_2_carla_torch.data.smpl.body_model import (
        joint_locations, vertex_locations)

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 31)
    body = rng.normal(scale=0.4, size=(SMPL_POSES, (SMPL_KEPT - 1) * 3))
    root = rng.normal(scale=0.4, size=(SMPL_POSES, 3))
    body, root = (torch.from_numpy(a.astype(np.float32)) for a in (body, root))
    body_d, root_d = body.cuda(), root.cuda()
    out = {}
    for name, fn in (("joint_locations", joint_locations),
                     ("vertex_locations", vertex_locations)):
        got = fn(model, body_d, root_d)
        again = fn(model, body_d, root_d)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: not the same bits twice")
        n = SMPL_CPU_POSES
        err, rel = bar_err(got[:n].cpu(), fn(model, body[:n], root[:n]))
        if not (torch.isfinite(got).all() and rel <= SMPL_BAR):
            raise AssertionError(f"{name}: card vs CPU {rel}")
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for _ in range(3):
            fn(model, body_d, root_d)
        end.record()
        torch.cuda.synchronize()
        out[name] = {"shape": list(got.shape), "max_err": err,
                     "max_err_over_max_cpu": rel,
                     "ms": start.elapsed_time(end) / 3}
        del got, again
    torch.cuda.empty_cache()
    emit({"phase": "smpl_body_model", "poses": SMPL_POSES,
          "vertices": SMPL_VERTS, "joints": f"{SMPL_JOINTS} -> {SMPL_KEPT}",
          "faces": SMPL_FACES, "cpu_poses_compared": SMPL_CPU_POSES,
          **out, "same_bits_twice": True,
          "seconds": time.perf_counter() - t0})


def smpl_mocaps():
    """MIX_MOCAPS seeded mocaps of MIX_MOCAP_FRAMES 156-wide axis-angle
    poses at 60 fps (small motions around a root turned a quarter about
    x, a slow yaw), alternately female and male."""
    rng = np.random.default_rng(SEED + 32)
    poses = []
    for i in range(MIX_MOCAPS):
        p = rng.normal(scale=0.1, size=(MIX_MOCAP_FRAMES, 156))
        p[:, 0] += np.pi / 2
        p[:, 2] += np.linspace(0, 0.02 * i, MIX_MOCAP_FRAMES)
        poses.append(p)
    return poses, [("female", "male")[i % 2] for i in range(MIX_MOCAPS)]


def phase_amass_subsets(model):
    """``amass_subset`` of the mocaps on the card against the CPU: the
    projections within XY_TOL_PX, every other array within SMPL_BAR, the
    metas equal; the build's clips a second (host clock, copies in and
    out included). Returns the card's subset."""
    from pedestrians_video_2_carla_torch.data.smpl.amass import amass_subset

    t0 = time.perf_counter()
    poses, genders = smpl_mocaps()

    def build(device):
        return amass_subset(poses, genders, CLIP, CLIP,
                            body_model=lambda gender: model, device=device)
    build("cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    card = build("cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    cpu = build("cpu")
    cpu_s = time.perf_counter() - t
    n = len(card[0])
    if n != MIX_MOCAPS * (MIX_MOCAP_FRAMES // (2 * CLIP) - 1):
        raise AssertionError(f"{n} clips")
    errs = {"projection_2d": float(np.abs(card[0] - cpu[0]).max())}
    if not (np.isfinite(card[0]).all() and errs["projection_2d"]
            <= XY_TOL_PX):
        raise AssertionError(f"projections: card vs CPU {errs}")
    for k, v in cpu[1].items():
        errs[k] = float(np.abs(card[1][k] - v).max())
        if not (np.isfinite(card[1][k]).all() and errs[k] <= SMPL_BAR):
            raise AssertionError(f"{k}: card vs CPU {errs[k]}")
    for k, v in cpu[2].items():
        if not np.array_equal(np.asarray(card[2][k]), np.asarray(v)):
            raise AssertionError(f"meta {k} differs")
    emit({"phase": "amass_subsets", "mocaps": MIX_MOCAPS,
          "frames_60fps": MIX_MOCAP_FRAMES, "clips": n, "L": CLIP,
          "clip_offset": CLIP, "max_err": errs,
          "card_clips_per_s": n / card_s, "cpu_clips_per_s": n / cpu_s,
          "card_s": card_s, "cpu_s": cpu_s,
          "projection_px_range": [float(card[0].min()),
                                  float(card[0].max())],
          "seconds": time.perf_counter() - t0})
    return card


def subset_rows(subset, rows):
    """Rows ``rows`` (a slice) of a (projection_2d, targets, meta) subset."""
    proj, targets, meta = subset
    return (proj[rows], {k: v[rows] for k, v in targets.items()},
            {k: v[rows] for k, v in meta.items()})


def mix_sources(dm, seed):
    """(the member of each of ``dm``'s train batches, the members as
    ``_mix`` draws them from numpy's ``default_rng(1234 + seed)`` for the
    members' batch counts, those counts). A batch's member is told by a
    target key only that member has (not NaN in the batch); a member
    without one owns the batches where no other member's key is set."""
    keys = [[dm.mappings.get(k, k) for k in next(iter(
        m.train_batches(seed)))[1]] for m in dm.members]
    own = []
    for i, mine in enumerate(keys):
        others = set().union(*(set(k) for j, k in enumerate(keys) if j != i))
        own.append(next((k for k in mine if k not in others), None))
    got = []
    for _, targets, _ in dm.train_batches(seed):
        set_ = [i for i, k in enumerate(own) if k is not None
                and not torch.isnan(targets[k].float()).all()]
        got.append(set_[0] if len(set_) == 1 else own.index(None))
    counts = [sum(1 for _ in m.train_batches(seed)) for m in dm.members]
    props = dm.requested_train_proportions
    weights = np.asarray([max(p, 0) if p >= 0 else 1.0 for p in props])
    weights = weights / weights.sum()
    rng = np.random.default_rng(1234 + seed)
    left, alive, want = list(counts), [c > 0 for c in counts], []
    while any(alive):
        choices = np.nonzero(alive)[0]
        i = int(rng.choice(choices, p=weights[choices]
                           / weights[choices].sum()))
        want.append(i)
        left[i] -= 1
        alive[i] = left[i] > 0
    return got, want, counts


def phase_config2_carlarec_amass(amass):
    """BASELINE config 2 (Seq2SeqEmbeddings, pose_2d, loc_2d, B=256,
    L=16) on CarlaRecAMASS: the CARLA member from ``recorded_subset``, the
    AMASS member from phase 2's subset, MIX_PROPORTIONS. The interleave
    against numpy's draws; a Trainer.fit fused twice (the same losses,
    rows 12-13's launches exact) and plain (within LOSS_RTOL)."""
    from pedestrians_video_2_carla_torch.data.mixed.mixed import \
        CarlaRecAMASSDataModule

    t0 = time.perf_counter()
    dm = CarlaRecAMASSDataModule(
        batch_size=AE_BATCH, clip_length=CLIP, seed=SEED,
        outputs_dir=tempfile.gettempdir(),
        train_proportions=MIX_PROPORTIONS)
    carla, smpl = dm.members
    recorded = recorded_clips(MIX_CARLA_TRAIN + MIX_CARLA_VAL, SEED + 33)
    carla.add_subset("train", *subset_rows(recorded,
                                           slice(0, MIX_CARLA_TRAIN)))
    carla.add_subset("val", *subset_rows(recorded,
                                         slice(MIX_CARLA_TRAIN, None)))
    n = len(amass[0])
    smpl.add_subset("train", *subset_rows(amass, slice(0, n - MIX_AMASS_VAL)))
    smpl.add_subset("val", *subset_rows(amass, slice(n - MIX_AMASS_VAL, None)))
    got, want, counts = mix_sources(dm, SEED)
    if got != want:
        raise AssertionError(f"interleave {got} against numpy's {want}")
    batches = AE_TRAIN_STEPS + AE_VAL_BATCHES
    fused = {"dense_lstm_scan": AE_LAYERS * batches,
             "dense_lstm_scan_bwd": AE_LAYERS * AE_TRAIN_STEPS}
    fits = {"fused": fit_autoencoder(make_ae_flow("fused"), dm, "mix", fused),
            "fused_again": fit_autoencoder(make_ae_flow("fused"), dm,
                                           "mix_again", fused),
            "plain": fit_autoencoder(make_ae_flow("plain"), dm, "mix_plain",
                                     {})}
    if fits["fused"]["losses"] != fits["fused_again"]["losses"]:
        raise AssertionError("the fused fit did not repeat its losses")
    worst = max(abs(a - b) / abs(b) for a, b in zip(
        fits["fused"]["losses"], fits["plain"]["losses"]))
    if worst > LOSS_RTOL:
        raise AssertionError(f"fused vs plain losses {worst}")
    emit({"phase": "config2_carlarec_amass", "B": AE_BATCH, "L": CLIP,
          "proportions": MIX_PROPORTIONS, "member_train_batches": counts,
          "interleave_first_steps": got[:AE_TRAIN_STEPS],
          "interleave_equals_numpy": True,
          "steps": AE_TRAIN_STEPS, "val_batches": AE_VAL_BATCHES,
          "launches": fits["fused"]["counts"],
          "fit_seconds": {r: v["fit_s"] for r, v in fits.items()},
          # the second fused fit's: the first pays the first use of the
          # process's kernels and allocations
          "fit_ms_per_step": {r: 1e3 * fits[r]["fit_s"] / AE_TRAIN_STEPS
                              for r in ("fused_again", "plain")},
          "train_loss_primary": {r: fits[r]["losses"]
                                 for r in ("fused", "plain")},
          "fused_vs_plain_max_rel": worst, "same_bits_twice": True,
          "val": {r: fits[r]["val"] for r in ("fused", "plain")},
          "seconds": time.perf_counter() - t0})
    return fits["fused"]["counts"]


def phase_gconvgru_jaad_carlarec():
    """Config 3's GConvGRU (B=256, L=16, H=128, k=2) on JAADCarlaRec: the
    JAAD member's BODY_25 clips from ``openpose_clips``, the CARLA
    member's from ``recorded_subset``, both mapped to CARLA; the recorded
    clips' ``frame.pedestrian.is_crossing`` reaches ``crossing``; a
    MIX_CLS_STEPS-step fit with dropout 0 fused (rows 10-11's launches
    exact) and plain, their losses within LOSS_RTOL."""
    from pedestrians_video_2_carla_torch.data.mixed.mixed import \
        JAADCarlaRecDataModule

    t0 = time.perf_counter()
    dm = JAADCarlaRecDataModule(
        batch_size=CLS_BATCH, clip_length=CLIP, seed=SEED,
        outputs_dir=tempfile.gettempdir(),
        train_proportions=MIX_PROPORTIONS)
    jaad, carla = dm.members
    rng = np.random.default_rng(SEED + 34)
    sizes = {"train": MIX_CLS_TRAIN_BATCHES * CLS_BATCH,
             "val": MIX_CLS_VAL_BATCHES * CLS_BATCH}
    recorded = recorded_clips(sum(sizes.values()), SEED + 35)
    start = 0
    for name, n in sizes.items():
        detections, _, targets, meta = openpose_clips(rng, n)
        jaad.add_subset(name, detections, targets, meta)
        carla.add_subset(name, *subset_rows(recorded, slice(start,
                                                            start + n)))
        start += n
    got, want, counts = mix_sources(dm, SEED)
    if got != want:
        raise AssertionError(f"interleave {got} against numpy's {want}")
    # the recorded batches' labels are the subset's, under "crossing"
    seen = []
    for (inputs, targets, _), member in zip(dm.train_batches(SEED), got):
        if "frame.pedestrian.is_crossing" in targets \
                or not torch.isfinite(targets["crossing"].float()).all():
            raise AssertionError("the crossing label is not mapped")
        if inputs.shape[2] != CLS_J:
            raise AssertionError(f"inputs {tuple(inputs.shape)}")
        if member == 1:
            seen.append(targets["crossing"].reshape(-1).cpu().numpy())
    labels = recorded[1]["frame.pedestrian.is_crossing"][:sizes["train"]]
    if not np.array_equal(np.sort(np.concatenate(seen)), np.sort(labels)):
        raise AssertionError("the recorded clips' labels did not reach "
                             "crossing")
    batches = MIX_CLS_STEPS + VAL_BATCHES
    fits = {}
    for route, expected in (
            ("fused", {"graph_gru_scan": 2 * batches,
                       "graph_gru_scan_bwd": 2 * MIX_CLS_STEPS}),
            ("plain", {})):
        counts_, losses, epochs, fit_s, _ = fit_classifier(
            make_cls_flow(p_dropout=0.0, graph_kernel=route), dm,
            MIX_CLS_STEPS, VAL_BATCHES, f"mix_cls_{route}", expected)
        fits[route] = {"counts": {k: v for k, v in counts_.items() if v},
                       "losses": losses, "fit_s": fit_s,
                       "val": {k: v for k, v in epochs[-1].items()
                               if k.startswith("val_") and not any(
                                   c in k for c in ("Matrix", "ROC",
                                                    "Curve"))}}
    worst = max(abs(a - b) / abs(b) for a, b in zip(
        fits["fused"]["losses"], fits["plain"]["losses"]))
    if worst > LOSS_RTOL:
        raise AssertionError(f"fused vs plain losses {worst}")
    emit({"phase": "gconvgru_jaad_carlarec", "B_L_J_H_k": CLS_MAIN,
          "proportions": MIX_PROPORTIONS, "member_train_batches": counts,
          "interleave_first_steps": got[:MIX_CLS_STEPS],
          "interleave_equals_numpy": True, "crossing_mapped": True,
          "steps": MIX_CLS_STEPS, "val_batches": VAL_BATCHES,
          "launches": fits["fused"]["counts"],
          "train_loss_primary": {r: v["losses"] for r, v in fits.items()},
          "fused_vs_plain_max_rel": worst,
          "fit_seconds": {r: v["fit_s"] for r, v in fits.items()},
          "val": {r: v["val"] for r, v in fits.items()},
          "seconds": time.perf_counter() - t0})
    return fits["fused"]["counts"]


def group_smpl_mixed(card, hbm_rate):
    """The SMPL body model and AMASS's subset build on the card against
    the CPU (no TPU kernel: the JAX package runs them outside Pallas),
    then config 2 on CarlaRecAMASS (rows 12-13) and GConvGRU on
    JAADCarlaRec (rows 10-11): the rows' launches on these paths, by
    wrapper name."""
    t0 = time.perf_counter()
    reset_kernel_counts()
    with tempfile.TemporaryDirectory() as tmp:
        model = smpl_body_model(tmp)
    phase_smpl_body_model(model)
    amass = phase_amass_subsets(model)
    if kernel_counts() != expected_counts():
        raise AssertionError(f"the body model launched {kernel_counts()}")
    config2 = phase_config2_carlarec_amass(amass)
    del amass
    torch.cuda.empty_cache()
    gconv = phase_gconvgru_jaad_carlarec()
    torch.cuda.empty_cache()
    emit({"phase": "group_smpl_mixed", "card": card,
          "seconds": time.perf_counter() - t0})
    return {**{name: {"launches_mixed_carlarec_amass": n}
               for name, n in config2.items()},
            **{name: {"launches_mixed_jaad_carlarec": n}
               for name, n in gconv.items()}}


#: CARLA control and the orchestration scripts (group_carla_control): the
#: clips the CARLA path drives (CARLA_CLIPS of the request's B=1024), the
#: fake world's frame size, the bars: the round trip of a rotation through
#: CARLA's angles on the card (float32 asin loses up to sqrt(2 * 2**-24),
#: 3.5e-4 rad, where |M[0, 2]| -> 1; 2.9e-5 on the CPU at B=64) and the
#: CARLA route's points against the kernel's projection_2d (the JAX
#: package's two routes agree within 1.2e-4 px on the CPU,
#: tests/test_torch_carla_control.py holds them at 1e-3 px; 2.4e-4 px on
#: the CPU at B=64)
CARLA_CLIPS, CARLA_FRAME = 4, (80, 60)
CARLA_RT_BAR, CARLA_PX_BAR = 1e-3, 1e-2
#: the sensitivity study's joint and fits (config 3's GConvGRU at B=256,
#: L=16, H=128, k=2, dropout 0), the sweep's trials and the cuts of the
#: sweep's and the compare variant's runs (epochs 5 -> 1, the sets 512 ->
#: 256 clips, the train epoch LIMIT_STEPS batches)
SENS_JOINT, SENS_STEPS, SENS_VAL = "crl_hand__L", 3, 256
SWEEP_TRIALS, LIMIT_STEPS = 2, 4
#: configs/sweep/carla2d3d_linear_ae.yaml and
#: configs/compare/carla2d3d_models.yaml as dicts (the card's machine has
#: no PyYAML)
SWEEP_CONFIG = {
    "method": "random",
    "metric": {"goal": "maximize", "name": "hp/PCKhn@01"},
    "parameters": {
        "mode": {"value": "train"}, "flow": {"value": "autoencoder"},
        "data_module_name": {"value": "Carla2D3D"},
        "movements_model_name": {"value": "LinearAE2D"},
        "max_epochs": {"value": 5}, "batch_size": {"value": 256},
        "clip_length": {"value": 16}, "val_set_size": {"value": 512},
        "test_set_size": {"value": 512}, "renderers": {"value": ["none"]},
        "lr": {"min": 0.0005, "max": 0.01, "distribution": "log_uniform"},
        "transform": {"value": "hips_neck_bbox"},
        "noise": {"value": "gaussian"}, "noise_param": {"value": 1.0},
        "missing_joint_probabilities_0": {"value": 0.1}}}
COMPARE_CONFIG = {
    "common_params": {
        "flow": "pose_lifting", "mode": "train",
        "data_module_name": "Carla2D3D", "batch_size": 256,
        "clip_length": 16, "max_epochs": 5, "loss_modes": ["loc_2d_3d"],
        "renderers": ["none"], "logs_dir": "compare_logs"},
    "compare_params": {
        "movements_model_name": ["LinearAE", "LSTM", "Seq2SeqEmbeddings"],
        "noise": ["zero", "gaussian"]},
    "compare_model": {"LSTM": {"hidden_size": [64, 128]}},
    "common_model": {"Seq2SeqEmbeddings": {"single_joint_embeddings_size":
                                           64}}}


class FakeCarla:
    """A stand-in of the carla package with a world that records what the
    renderer does to it: the mock's types, a bone control, a client."""

    class Location:
        def __init__(self, x=0.0, y=0.0, z=0.0):
            self.x, self.y, self.z = float(x), float(y), float(z)

    class Rotation:
        def __init__(self, pitch=0.0, yaw=0.0, roll=0.0):
            self.pitch, self.yaw, self.roll = (float(pitch), float(yaw),
                                               float(roll))

    class Transform:
        def __init__(self, location=None, rotation=None):
            self.location = location or FakeCarla.Location()
            self.rotation = rotation or FakeCarla.Rotation()

    class WalkerBoneControlIn:
        bone_transforms = None

    class World:
        pass


class FakeActor:
    """A walker or a camera of the fake world."""

    def __init__(self, world, attributes, transform):
        self.world, self.attributes = world, attributes
        self.transform, self.callback = transform, None

    def get_transform(self):
        return self.transform

    def set_transform(self, t):
        self.transform = t
        loc, rot = t.location, t.rotation
        self.world.log.append(("set_transform", loc.x, loc.y, loc.z,
                               rot.pitch, rot.yaw, rot.roll))

    def set_bones(self, control):
        self.world.log.append(("set_bones", [
            (name, t.location.x, t.location.y, t.location.z,
             t.rotation.pitch, t.rotation.yaw, t.rotation.roll)
            for name, t in control.bone_transforms]))

    def listen(self, callback):
        self.callback = callback

    def stop(self):
        self.callback = None

    def set_simulate_physics(self, enabled=True):
        pass

    def blend_pose(self, blend):
        pass

    def destroy(self):
        pass


class FakeBlueprint(dict):
    def get_attribute(self, name):
        return self.get(name)

    def has_attribute(self, name):
        return name in self

    def set_attribute(self, name, value):
        self[name] = value


class FakeWorld:
    """Records set_bones, set_transform and tick; each tick hands every
    listening camera a seeded BGRA frame of its blueprint's size."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.log, self.cameras = [], []

    def tick(self):
        self.log.append(("tick",))
        for camera in self.cameras:
            if camera.callback is not None:
                w = int(camera.attributes["image_size_x"])
                h = int(camera.attributes["image_size_y"])
                camera.callback(type("Image", (), {
                    "width": w, "height": h, "raw_data": self.rng.integers(
                        0, 256, (h, w, 4), dtype=np.uint8).tobytes()})())
        return len(self.log)

    def get_blueprint_library(self):
        class Library:
            def filter(self, pattern):
                return [FakeBlueprint(age=a, gender=g, is_invincible="true")
                        for a in ("adult", "child")
                        for g in ("female", "male")]

            def find(self, name):
                return FakeBlueprint(name=name)
        return Library()

    def get_random_location_from_navigation(self):
        return FakeCarla.Location(*self.rng.uniform(-50, 50, 3).tolist())

    def try_spawn_actor(self, bp, transform):
        return FakeActor(self, bp, transform)

    def spawn_actor(self, bp, transform):
        camera = FakeActor(self, bp, transform)
        self.cameras.append(camera)
        return camera


def angle_gap(a, b):
    """The largest difference of two arrays of degrees, wrapped to
    [-180, 180)."""
    d = (np.asarray(a, np.float64) - np.asarray(b, np.float64)
         + 180.0) % 360.0 - 180.0
    return float(np.abs(d).max())


def phase_carla_control_request():
    """BASELINE config 1's serving request (LinearAE, seeded init,
    Carla2D3D B=1024, L=16, projection_kernel="fused"): one row-1 launch;
    its relative_pose_rot as CARLA rotations by the batched conversion on
    the card against the same function on the CPU (the largest gap in
    degrees printed; both sets back to matrices on the CPU within
    CARLA_RT_BAR of each other) and back to matrices on the card within
    CARLA_RT_BAR of the request's; the conversion and its one copy to the
    host timed against a conversion and a copy a frame (the JAX package's
    loop) for CARLA_CLIPS clips."""
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule
    from pedestrians_video_2_carla_torch.ops.rotations import (
        carla_rotation_to_matrix, matrix_to_carla_rotation)
    from pedestrians_video_2_carla_torch.renderers.carla_renderer import \
        carla_rotations
    from pedestrians_video_2_carla_torch.serving import make_inference_fn

    t0 = time.perf_counter()
    flow, _ = make_flows()
    dm = Carla2D3DDataModule(batch_size=BATCH, clip_length=CLIP,
                             test_set_size=BATCH, seed=SEED)
    inputs, targets, meta = next(iter(dm.test_batches()))
    infer = make_inference_fn(flow, flow.init_params())
    reset_kernel_counts()
    preds = infer(inputs, meta["age_gender_idx"])
    torch.cuda.synchronize()
    counts = kernel_counts()
    if counts != expected_counts(fused_projection=1):
        raise AssertionError(f"the CARLA-control request launched {counts}")
    rot = preds["relative_pose_rot"]
    if rot.shape != (BATCH, CLIP, 26, 3, 3) or not torch.isfinite(rot).all():
        raise AssertionError(f"relative_pose_rot {tuple(rot.shape)}")
    pyr = matrix_to_carla_rotation(rot)
    pyr_cpu = matrix_to_carla_rotation(rot.cpu())
    gap_deg = angle_gap(pyr.cpu().numpy(), pyr_cpu.numpy())
    round_trip = float((carla_rotation_to_matrix(pyr) - rot).abs().max())
    same_rotations = float((carla_rotation_to_matrix(pyr.cpu().double())
                            - carla_rotation_to_matrix(pyr_cpu.double())
                            ).abs().max())
    if not (round_trip <= CARLA_RT_BAR and same_rotations <= CARLA_RT_BAR):
        raise AssertionError(f"CARLA rotations: round trip {round_trip}, "
                             f"card vs CPU {same_rotations}")
    clips = rot[:CARLA_CLIPS]

    def batched():
        return carla_rotations(clips)

    def per_frame():
        return [matrix_to_carla_rotation(clips[c, t]).cpu().numpy()
                for c in range(CARLA_CLIPS) for t in range(CLIP)]
    times = {}
    for name, fn in (("batched_ms", batched), ("per_frame_ms", per_frame)):
        fn()
        runs = []
        for _ in range(TIMING_RUNS):
            t = time.perf_counter()
            fn()
            runs.append(1e3 * (time.perf_counter() - t))
        times[name] = statistics.median(runs)
    emit({"phase": "carla_control_request", "B": BATCH, "L": CLIP,
          "launches": counts["fused_projection"],
          "max_gap_deg_card_vs_cpu": gap_deg,
          "round_trip_max_abs_err": round_trip,
          "card_vs_cpu_rotations_max_abs_err": same_rotations,
          "max_abs_m02": float(rot[..., 0, 2].abs().max()),
          "bar": CARLA_RT_BAR, "clips": CARLA_CLIPS,
          "host_ms_median": times, "seconds": time.perf_counter() - t0})
    return preds, meta, counts["fused_projection"]


def render_on_fake_world(rot, world_loc):
    """CarlaRenderer.render_clip of each clip on a fake world bound as
    ``carla``: the worlds' logs and the clips' frames."""
    from pedestrians_video_2_carla_torch.renderers.carla_renderer import \
        CarlaRenderer
    from pedestrians_video_2_carla_torch.walker_control import carla_utils

    renderer = CarlaRenderer(image_size=CARLA_FRAME)
    saved = carla_utils.carla
    carla_utils.carla = FakeCarla
    try:
        worlds, frames = [], []
        for c in range(len(rot)):
            world = FakeWorld(SEED + c)
            frames.append(renderer.render_clip(
                world, None, rot[c], world_loc[c], None, "adult", "female"))
            worlds.append(world)
    finally:
        carla_utils.carla = saved
    return worlds, frames


def phase_carla_fake_world(preds, meta):
    """The CARLA path on CARLA_CLIPS clips of the request: render_clip on a
    fake world with the card's tensors and with their CPU copies (the
    same bone transforms within 1e-4 degrees, the same teleports, ticks
    and frames); each frame's bones the clip's rotations; then
    PoseProjection.current_pose_to_points of each frame's pose on the
    card against the kernel's projection_2d (CARLA_PX_BAR)."""
    from pedestrians_video_2_carla_torch.ops.rotations import \
        matrix_to_carla_rotation
    from pedestrians_video_2_carla_torch.skeletons.carla import (
        AGE_GENDER_KEYS, BONE_NAMES)
    from pedestrians_video_2_carla_torch.walker_control import carla_utils
    from pedestrians_video_2_carla_torch.walker_control.controlled_pedestrian \
        import ControlledPedestrian
    from pedestrians_video_2_carla_torch.walker_control.pose_projection \
        import PoseProjection

    t0 = time.perf_counter()
    rot = preds["relative_pose_rot"][:CARLA_CLIPS]
    world_loc = torch.from_numpy(np.random.default_rng(SEED + 40).uniform(
        -0.05, 0.05, (CARLA_CLIPS, CLIP, 3)).cumsum(1).astype(
        np.float32)).to(rot.device)
    t = time.perf_counter()
    card_worlds, card_frames = render_on_fake_world(rot, world_loc)
    render_s = time.perf_counter() - t
    cpu_worlds, cpu_frames = render_on_fake_world(rot.cpu(), world_loc.cpu())
    bones_gap = moves_gap = 0.0
    pyr_ref = matrix_to_carla_rotation(rot.cpu()).numpy()
    for c, (a, b) in enumerate(zip(card_worlds, cpu_worlds)):
        if [e[0] for e in a.log] != [e[0] for e in b.log]:
            raise AssertionError(f"clip {c}: the fake worlds' calls differ")
        bones = [e[1] for e in a.log if e[0] == "set_bones"]
        # ticks: the spawn, the bind's pose, the camera, then one a frame
        ticks = sum(e[0] == "tick" for e in a.log)
        if len(bones) != 1 + CLIP or ticks != 3 + CLIP:
            raise AssertionError(f"clip {c}: {len(bones)} poses, {ticks} "
                                 f"ticks")
        for ea, eb in zip(a.log, b.log):
            if ea[0] == "set_bones":
                bones_gap = max(bones_gap, angle_gap(
                    [r[4:] for r in ea[1]], [r[4:] for r in eb[1]]))
                if [r[:4] for r in ea[1]] != [r[:4] for r in eb[1]]:
                    raise AssertionError("bone names or locations differ")
            elif ea[0] == "set_transform":
                moves_gap = max(moves_gap, float(np.abs(
                    np.subtract(ea[1:], eb[1:])).max()))
        # frame i's bones are the clip's rotations at frame i (the hips
        # and the root carry the root<->hips transform)
        for i, frame_bones in enumerate(bones[1:]):
            got = {r[0]: r[4:] for r in frame_bones}
            for j, name in enumerate(BONE_NAMES):
                if name not in ("crl_root", "crl_hips__C") and angle_gap(
                        got[name], pyr_ref[c, i, j]) > 1e-4:
                    raise AssertionError(f"clip {c} frame {i} {name}")
        if not np.array_equal(card_frames[c], cpu_frames[c]) \
                or card_frames[c].shape != (CLIP, CARLA_FRAME[1],
                                            CARLA_FRAME[0], 3):
            raise AssertionError(f"clip {c}: frames differ")
    teleports = sum(e[0] == "set_transform" for e in card_worlds[0].log)
    if bones_gap > 1e-4 or moves_gap > 1e-5 or teleports != CLIP:
        raise AssertionError(f"card vs CPU route: bones {bones_gap} deg, "
                             f"teleports {moves_gap} m, {teleports}")

    # the CARLA route's points against the kernel's projection_2d
    pyr = matrix_to_carla_rotation(rot).cpu().numpy()
    px_gap, t = 0.0, time.perf_counter()
    for c in range(CARLA_CLIPS):
        key = AGE_GENDER_KEYS[int(meta["age_gender_idx"][c])]
        ped = ControlledPedestrian(None, *key.split("_"))
        projection = PoseProjection(ped, device=rot.device)
        kernel = preds["projection_2d"][c, :, :, :2].cpu().numpy()
        for i in range(CLIP):
            pose = ped.current_pose.relative
            for j, name in enumerate(BONE_NAMES):
                pose[name].rotation = carla_utils.carla.Rotation(
                    *pyr[c, i, j].tolist())
            ped.current_pose.relative = pose
            px_gap = max(px_gap, float(np.abs(
                projection.current_pose_to_points() - kernel[i]).max()))
    points_s = time.perf_counter() - t
    if not px_gap <= CARLA_PX_BAR:
        raise AssertionError(f"CARLA route vs the kernel: {px_gap} px")
    emit({"phase": "carla_fake_world", "clips": CARLA_CLIPS, "L": CLIP,
          "frame": CARLA_FRAME, "bones_gap_deg_card_vs_cpu": bones_gap,
          "teleport_gap_m_card_vs_cpu": moves_gap,
          "frames_equal": True, "poses_per_clip": 1 + CLIP,
          "render_seconds": render_s,
          "points_vs_kernel_max_gap_px": px_gap, "px_bar": CARLA_PX_BAR,
          "points_seconds": points_s,
          "seconds": time.perf_counter() - t0})


def phase_sensitivity(tmp):
    """missing_joints_sensitivity.main with --joints SENS_JOINT: the
    baseline and one joint missing, two CLI fits of config 3's GConvGRU
    on the card; rows 10-11's launches counted, the metrics finite, the
    joint missing from the second fit's deformed points and present in
    the first's."""
    from pedestrians_video_2_carla_torch import \
        missing_joints_sensitivity as sens
    from pedestrians_video_2_carla_torch.skeletons.carla import BONE_NAMES

    t0 = time.perf_counter()
    fits = []
    run = sens.modeling_main

    def keep(args):
        fits.append(run(args))
        return fits[-1]
    sens.modeling_main = keep
    reset_kernel_counts()
    try:
        metrics = sens.main([
            "--data_module_name=Carla2D3D",
            "--classification_model_name=GConvGRU",
            f"--hidden_size={CLS_H}", f"--k={CLS_K}", "--p_dropout=0.0",
            "--graph_kernel=fused", f"--batch_size={CLS_BATCH}",
            f"--clip_length={CLIP}", "--max_epochs=1",
            f"--limit_train_batches={SENS_STEPS}",
            f"--val_set_size={SENS_VAL}", "--skip_initial_metrics=true",
            f"--root_dir={tmp}", "--joints", SENS_JOINT])
    finally:
        sens.modeling_main = run
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernel_counts().items() if v}
    if set(counts) != {"graph_gru_scan", "graph_gru_scan_bwd"}:
        raise AssertionError(f"the sensitivity fits launched {counts}")
    if list(metrics) != ["baseline", SENS_JOINT] or not all(
            np.isfinite(v) for m in metrics.values() for v in m.values()):
        raise AssertionError(f"sensitivity metrics {metrics}")
    hand = BONE_NAMES.index(SENS_JOINT)
    for results, missing in zip(fits, (False, True)):
        points = next(iter(results["dm"].train_batches(0)))[1][
            "projection_2d_deformed"]
        if bool((points[..., hand, :] == 0).all()) is not missing:
            raise AssertionError(f"{SENS_JOINT} missing: {not missing}")
    emit({"phase": "sensitivity", "joint": SENS_JOINT, "fits": len(fits),
          "B_L_J_H_k": CLS_MAIN, "steps": SENS_STEPS,
          "val_clips": SENS_VAL, "launches": counts,
          "val_F1Score": {k: m.get("val_F1Score") for k, m in
                          metrics.items()},
          "seconds": time.perf_counter() - t0})
    return counts


def start_compare(tmp, pool):
    """The first compare.work variant of configs/compare/carla2d3d_models
    .yaml (LinearAE, noise zero), cut (epochs 5 -> 1, validation 512 ->
    256 clips, LIMIT_STEPS steps), started on ``pool``: the CLI in a
    subprocess on the card, beside the phases that follow."""
    from pedestrians_video_2_carla_torch import compare

    variant = compare.variants_for(COMPARE_CONFIG, tmp)[0]
    logs_dir = compare.logs_dir_for(COMPARE_CONFIG, tmp)
    variant.update(max_epochs=1, val_set_size=256,
                   limit_train_batches=LIMIT_STEPS, logs_dir=logs_dir)
    os.makedirs(os.path.join(logs_dir, "stdout"))
    return variant, time.perf_counter(), pool.submit(compare.work, variant,
                                                     logs_dir)


def phase_sweep_compare(tmp, compare_run):
    """A SWEEP_TRIALS-trial sweep of configs/sweep/carla2d3d_linear_ae.yaml
    in process on the card, cut (epochs 5 -> 1, sets 512 -> 256 clips,
    LIMIT_STEPS steps): the trials' parameters those of the sampler on the
    CPU for the seed, the objectives and the results file finite; then
    the compare variant's output file (start_compare): the CLI's finite
    validation metrics."""
    from pedestrians_video_2_carla_torch import compare, sweep

    t0 = time.perf_counter()
    config = json.loads(json.dumps(SWEEP_CONFIG))
    cuts = {"max_epochs": 1, "val_set_size": 256, "test_set_size": 256}
    for k, v in cuts.items():
        config["parameters"][k] = {"value": v}
    logs = os.path.join(tmp, "sweeps")
    best, history = sweep.run_sweep(
        config, count=SWEEP_TRIALS, seed=SEED, logs_dir=logs,
        extra_args=(f"--limit_train_batches={LIMIT_STEPS}",
                    f"--root_dir={tmp}"))
    suggest = sweep.make_sampler(config, 1.0, SEED)
    want = [suggest([]) for _ in range(SWEEP_TRIALS)]
    with open(os.path.join(logs, "sweep_results.jsonl")) as f:
        written = [json.loads(line) for line in f]
    if [h["params"] for h in history] != want or len(written) \
            != SWEEP_TRIALS or not all(np.isfinite(r.get("objective", np.nan))
                                       for r in written):
        raise AssertionError(f"sweep {written}, expected params {want}")
    sweep_s = time.perf_counter() - t0

    variant, started, future = compare_run
    with open(future.result()) as f:
        out = f.read()
    compare_s = time.perf_counter() - started
    values = {line.split()[0]: line.split()[-1] for line in out.splitlines()
              if line.strip().startswith("val_")}
    if "val metrics:" not in out or "val_MPJPE" not in values:
        raise AssertionError(f"compare output: {out[-2000:]}")
    emit({"phase": "sweep_compare", "trials": SWEEP_TRIALS,
          "cuts": {**cuts, "limit_train_batches": LIMIT_STEPS},
          "params": want, "objectives": [h["objective"] for h in history],
          "sweep_seconds": sweep_s,
          "compare_variant": compare._arg_list(variant),
          "compare_val_lines": len(values),
          "compare_seconds_from_its_start": compare_s,
          "seconds": time.perf_counter() - t0})


def group_carla_control(card, hbm_rate):
    """CARLA control (row 1 in its request), the sensitivity study (rows
    10-11) and the sweep and compare scripts: the rows' launches on these
    paths, by wrapper name."""
    t0 = time.perf_counter()
    # the compare variant's CLI subprocess runs beside the group's phases
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        compare_run = start_compare(tmp, pool)
        preds, meta, launches = phase_carla_control_request()
        phase_carla_fake_world(preds, meta)
        del preds
        torch.cuda.empty_cache()
        sensitivity = phase_sensitivity(tmp)
        phase_sweep_compare(tmp, compare_run)
    torch.cuda.empty_cache()
    emit({"phase": "group_carla_control", "card": card,
          "seconds": time.perf_counter() - t0})
    return {"fused_projection": {"launches_carla_control": launches},
            **{name: {"launches_sensitivity": n}
               for name, n in sensitivity.items()}}


#: group_parallel: config 1's resident epoch at world 1 over NCCL (steps:
#: 2 eager warm-up steps, then replays), the steps timed a route in the
#: two gloo ranks and in one process, the bars of the two ranks' step
#: against one process's (tests/test_torch_parallel.py's against JAX)
PAR_STEPS, PAR_TIMED = 6, 3
#: the seconds a gloo rank waits for phase 59 to end before its steps
PAR_WAIT_S = 600
PAR_LOSS_RTOL, PAR_GRAD_ATOL, PAR_PARAM_ATOL = 1e-5, 1e-4, 1e-5


def parallel_cases():
    """Check (ii)'s cases: (flow maker, batch) on the card: LinearAE
    ``fused_train`` at config 1's batch (B=1024, L=16), GConvGRU at
    config 3's (B=256, L=16, H=128, k=2), each a seeded Carla2D3D batch
    (the same on every rank and in the parent)."""
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule

    lifting = Carla2D3DDataModule(batch_size=BATCH, clip_length=CLIP,
                                  seed=SEED)
    cls = Carla2D3DDataModule(batch_size=CLS_BATCH, clip_length=CLIP,
                              seed=SEED)
    return {"fused_train": (lambda: make_train_flow("fused_train"),
                            next(lifting.train_batches(SEED + 40))),
            "gconvgru": (lambda: make_cls_flow(p_dropout=0.0,
                                               graph_kernel="fused"),
                         next(cls.train_batches(SEED + 41)))}


def parallel_step(flow, batch, mesh=None):
    """One training step of ``flow`` from its seeded init on ``batch``
    (this rank's rows under ``mesh``): the loss, the gradients and the
    parameters after it (on the host), the kernels it launched; then
    PAR_TIMED more steps, host clock to ``synchronize`` (ms each), and
    over ``mesh`` the gradient all-reduce alone on the same gradients
    (ms each)."""
    from pedestrians_video_2_carla_torch.flows.base import (optimizer_update,
                                                            trained)
    from pedestrians_video_2_carla_torch.parallel.mesh import (all_reduce_,
                                                               shard_batch)

    def host(tree):
        return {f"{n}.{k}": v.detach().cpu().clone()
                for n, t in tree.items() for k, v in t.items()}
    state = flow.init_state(flow.init_params())
    local = shard_batch(mesh, batch)
    reset_kernel_counts()
    logs = flow.backward_step(state, local)
    grads = {f"{n}.{k}": v.grad.detach().cpu().clone()
             for n, t in state.params.items() for k, v in t.items()
             if v.grad is not None}
    optimizer_update(state, logs["train_loss/primary"])
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernel_counts().items() if v}
    out = {"loss": float(logs["train_loss/primary"]), "grads": grads,
           "params": host(state.params), "launches": counts}
    step_ms, reduce_ms = [], []
    for _ in range(PAR_TIMED):
        t = time.perf_counter()
        flow.training_step(state, local)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
    if mesh is not None:
        grads = [p.grad for tree in state.params.values()
                 for p in trained(tree) if p.grad is not None]
        for _ in range(PAR_TIMED):
            torch.cuda.synchronize()
            t = time.perf_counter()
            all_reduce_(grads, mesh.data_group)
            torch.cuda.synchronize()
            reduce_ms.append(1e3 * (time.perf_counter() - t))
        out["grad_bytes"] = sum(g.numel() * g.element_size() for g in grads)
    out.update(step_ms=step_ms, all_reduce_ms=reduce_ms)
    return out


def parallel_rank(tmp, t0):
    """A rank of check (ii): its group and cases made, it waits for
    ``tmp/go`` (the end of phase 59, so that the card runs one phase at a
    time while the rank's start hides behind it), then both cases' steps
    on its half of the batch; its results to ``tmp``."""
    from pedestrians_video_2_carla_torch.parallel import MeshConfig, make_mesh

    started = time.time() - t0
    torch.backends.cuda.matmul.allow_tf32 = False  # as phase_device
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(MeshConfig())
    cases = parallel_cases()
    ready = time.time() - t0
    go = os.path.join(tmp, "go")
    while not os.path.exists(go):
        if time.time() - t0 > PAR_WAIT_S:
            raise TimeoutError("phase 59 did not end")
        time.sleep(0.05)
    out = {"mesh": repr(mesh), "device": str(torch.cuda.current_device()),
           "started_s": started, "ready_s": ready,
           "go_s": time.time() - t0}
    for name, (make, batch) in cases.items():
        out[name] = parallel_step(make(), batch, mesh)
    out["done_s"] = time.time() - t0
    torch.save(out, os.path.join(tmp, f"rank{mesh.rank}.pt"))


def step_errors(got, ref):
    """The largest relative loss gap, gradient gap and parameter gap
    (the parameters where the gradient is not tiny against its leaf's
    largest: Adam's first step is about lr * sign(g), so a tiny g's sign,
    which rounding can flip, moves a parameter by up to 2 lr; those are
    held to 2 lr + 1e-6) of two steps."""
    loss = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    grad = param = 0.0
    for k, g in ref["grads"].items():
        grad = max(grad, float((got["grads"][k] - g).abs().max()))
        diff = (got["params"][k] - ref["params"][k]).abs()
        big = g.abs() > 1e-3 * g.abs().max()
        param = max(param, float(diff[big].max()) if big.any() else 0.0)
        if bool((diff[~big] > 2 * LR + 1e-6).any()):
            raise AssertionError(f"{k}: a tiny gradient's parameter moved "
                                 f"over 2 lr")
    return {"loss_rel": loss, "grad_abs": grad, "param_abs": param}


def phase_parallel_nccl_world1(card):
    """Check (i): config 1's graphed resident epoch (PAR_STEPS steps of
    B=1024, L=16 on CarlaRecorded-format subsets) in a process group of
    one over NCCL, whose graphs capture the gradient all-reduce, against
    the same epoch with no group: the same step records and parameters,
    bit for bit; the all-reduce called under the capture; rows 2-3
    counted from the replays; replays timed with and without the
    group."""
    import torch.distributed as dist

    subsets = {"train": recorded_clips(PAR_STEPS * BATCH, SEED + 30),
               "val": recorded_clips(BATCH, SEED + 31)}
    dm = recorded_datamodule(subsets, resident=True)
    rows = {"fused_projection_train_fwd": ROW2_KERNELS,
            "fused_projection_train_bwd": ROW3_KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        alone, alone_counts, alone_steps, alone_epochs = fit_route(
            "resident_graphed", dm, os.path.join(tmp, "alone"),
            validate=False)
        if alone.mesh is not None:
            raise AssertionError("a trainer alone built a mesh")
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        # each all-reduce the port calls, and whether a capture was on
        calls, all_reduce = [], dist.all_reduce

        def counted(*args, **kwargs):
            calls.append(torch.cuda.is_current_stream_capturing())
            return all_reduce(*args, **kwargs)
        dist.all_reduce = counted
        try:
            try:
                grouped, counts, steps, epochs = fit_route(
                    "resident_graphed", dm, os.path.join(tmp, "group"),
                    validate=False)
            finally:
                dist.all_reduce = all_reduce
            runner = grouped.runner
            if grouped.mesh is None or grouped.mesh.backend != "nccl" \
                    or not runner.graphs or runner.mesh is not grouped.mesh:
                raise AssertionError(f"not the graphed NCCL route: "
                                     f"{grouped.mesh}, {runner.graphs}")
            if not (params_equal(grouped.state.params, alone.state.params)
                    and steps == alone_steps and counts == alone_counts
                    and len(steps) == PAR_STEPS):
                raise AssertionError("the world-1 NCCL graphed epoch differs "
                                     "from the epoch with no group")
            replays, warmup = runner.replays, runner.warmup
            graphed = {w: replays * runner.captured.get((w, "launches"), 0)
                       for w in rows}
            if sum(graphed.values()) != 2 * (PAR_STEPS - runner.warmup):
                raise AssertionError(f"graphed launches {graphed}")
            # one all-reduce a step (the gradients, one dtype): eager in
            # the warm-up steps, then once under the capture, none after
            if calls != [False] * warmup + [True]:
                raise AssertionError(f"all-reduces (capturing?): {calls}")
            # replays a step with and without the group, in alternating
            # pairs (NCCL over one rank copies on the device, no kernel)
            replay_ms = {"no_group": [], "nccl_world1": []}
            for _ in range(PAR_TIMED):
                for key, trainer in (("no_group", alone),
                                     ("nccl_world1", grouped)):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    trainer.runner(trainer.state, 0, 2)
                    torch.cuda.synchronize()
                    replay_ms[key].append(
                        1e3 * (time.perf_counter() - t) / 2)
            # the all-reduce alone, NCCL at world 1, on the step's
            # gradients
            from pedestrians_video_2_carla_torch.flows.base import trained
            from pedestrians_video_2_carla_torch.parallel.mesh import \
                all_reduce_
            grads = [p.grad for tree in grouped.state.params.values()
                     for p in trained(tree) if p.grad is not None]
            reduce_ms = []
            for _ in range(PAR_TIMED):
                torch.cuda.synchronize()
                t = time.perf_counter()
                all_reduce_(grads, grouped.mesh.data_group)
                torch.cuda.synchronize()
                reduce_ms.append(1e3 * (time.perf_counter() - t))
        finally:
            dist.destroy_process_group()
        del grouped, alone, runner
    emit({"phase": "parallel_nccl_world1", "card": card, "B": BATCH,
          "L": CLIP, "steps": PAR_STEPS, "warmup_steps": warmup,
          "replays": replays, "graphed_launches": graphed,
          "graphed_equal_no_group_bits": True,
          "all_reduce_calls_eager_captured": [calls.count(False),
                                              calls.count(True)],
          "replay_ms_per_step_pairs": replay_ms,
          "replay_ms_per_step_median": {
              k: statistics.median(v) for k, v in replay_ms.items()},
          "epoch_ms_per_step": {
              "no_group": 1e3 * alone_epochs[-1]["epoch_time_s"] / PAR_STEPS,
              "nccl_world1": 1e3 * epochs[-1]["epoch_time_s"] / PAR_STEPS},
          "grad_all_reduce_ms": reduce_ms,
          "method": "epoch ms a step: the one epoch (2 eager warm-up steps "
                    "and the capture included; the first fit of the phase "
                    "pays the cold start), host clock to its last logs "
                    "read; replays: 2 a call after both fits, the two "
                    "trainers in alternating pairs, host clock to "
                    "synchronize; the all-reduce: host clock around it "
                    "and synchronize, NCCL at world 1"})
    return graphed


def start_gloo_ranks(tmp):
    """Check (ii)'s two processes on the one card over gloo, started on
    a thread (they wait for ``tmp/go``): the future of their launch."""
    from pedestrians_video_2_carla_torch.parallel import launch

    pool = ThreadPoolExecutor(1)
    future = pool.submit(launch, parallel_rank, 2, (tmp, time.time()),
                         backend="gloo", devices=[0, 0],
                         init_method=f"file://{tmp}/store")
    pool.shutdown(wait=False)
    return future


def phase_parallel_gloo_two_ranks(card, tmp, ranks_done):
    """Check (ii): the two gloo ranks (``start_gloo_ranks``; the rows of
    each rank's half through the host), each running LinearAE
    ``fused_train`` and GConvGRU steps; rank 0's step held against one
    process's on the whole batch; both ranks' kernel launches."""
    ranks_done.result()
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    report, launches = {}, {}
    for name, (make, batch) in parallel_cases().items():
        one = parallel_step(make(), batch)
        errs = step_errors(ranks[0][name], one)
        if not (errs["loss_rel"] <= PAR_LOSS_RTOL
                and errs["grad_abs"] <= PAR_GRAD_ATOL
                and errs["param_abs"] <= PAR_PARAM_ATOL):
            raise AssertionError(f"{name}: two gloo ranks against one "
                                 f"process: {errs}")
        if ranks[1][name]["params"].keys() != ranks[0][name]["params"].keys() \
                or any(not torch.equal(v, ranks[1][name]["params"][k])
                       for k, v in ranks[0][name]["params"].items()):
            raise AssertionError(f"{name}: the ranks' parameters differ")
        for r in ranks:
            if r[name]["launches"] != one["launches"] \
                    or not one["launches"]:
                raise AssertionError(f"{name}: a rank launched "
                                     f"{r[name]['launches']}, one process "
                                     f"{one['launches']}")
            for w, n in r[name]["launches"].items():
                launches[w] = launches.get(w, 0) + n
        report[name] = {
            **errs, "launches_a_rank": one["launches"],
            "step_ms_two_ranks": [statistics.median(r[name]["step_ms"])
                                  for r in ranks],
            "step_ms_one_process": statistics.median(one["step_ms"]),
            "grad_all_reduce_ms": [statistics.median(r[name]
                                                     ["all_reduce_ms"])
                                   for r in ranks],
            "grad_bytes": ranks[0][name]["grad_bytes"]}
    emit({"phase": "parallel_gloo_two_ranks", "card": card,
          "ranks": [r["mesh"] for r in ranks],
          "rank_devices": [r["device"] for r in ranks],
          "rank_seconds": [{k: r[k] for k in ("started_s", "ready_s",
                                              "go_s", "done_s")}
                           for r in ranks], "cases": report,
          "bars": [PAR_LOSS_RTOL, PAR_GRAD_ATOL, PAR_PARAM_ATOL],
          "method": "ms: median of 3 steps (host clock to synchronize) "
                    "after the checked one; the all-reduce: the gradients "
                    "of the last step, gloo through the host, median of 3; "
                    "rank seconds since the launch: the rank's function "
                    "started, its group and cases made, phase 59 over, its "
                    "steps done"})
    return launches


def group_parallel(card, hbm_rate):
    """Multi-card training on the one card (phases 59-60) -> the launches
    of rows 2, 3, 10 and 11."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # the gloo ranks start beside phase 59 and step after it
        ranks_done = start_gloo_ranks(tmp)
        try:
            graphed = phase_parallel_nccl_world1(card)
        finally:
            open(os.path.join(tmp, "go"), "w").close()
        torch.cuda.empty_cache()
        gloo = phase_parallel_gloo_two_ranks(card, tmp, ranks_done)
    emit({"phase": "group_parallel", "seconds": time.perf_counter() - t0})
    out = {w: {"launches_parallel_nccl_graphed": n}
           for w, n in graphed.items()}
    for w, n in gloo.items():
        out.setdefault(w, {})["launches_parallel_gloo"] = n
    return out


def kernel_entry(name, source, replaces, launches, max_err, times):
    """One entry of the kernels line; ``replaces`` is the TPU kernel's
    ``file:line`` under the JAX package's ops/pallas/."""
    return {"name": name, "route": "cuda",
            "source": f"pedestrians_video_2_carla_torch/csrc/{source}",
            "replaces": f"pedestrians_video_2_carla_tpu/ops/pallas/{replaces}",
            "launches": launches, "max_abs_err": max_err,
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
            "library_ms": times.get("library_ms"),
            **{k: v for k, v in times.items() if k.startswith(
                ("shape_", "graph_form_", "keep_", "bound_ms_", "paired_",
                 "k1_"))}}


def group_lifting(card, hbm_rate):
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule

    flow_f, flow_p = make_flows()
    max_err = phase_kernel(flow_f.projection.camera)
    err_fwd, err_bwd = phase_kernel_train(flow_f.projection.camera)

    dm = Carla2D3DDataModule(batch_size=BATCH, clip_length=CLIP,
                             test_set_size=REQUESTS * BATCH,
                             val_set_size=VAL_BATCHES * BATCH, seed=SEED)
    batches = list(dm.test_batches())
    params, launches = phase_serve(flow_f, flow_p, batches)
    train_counts = phase_train(dm)
    times = phase_timing(flow_f, flow_p, params, batches, card, hbm_rate)
    train_times = phase_timing_train(dm, card, hbm_rate)
    return [
        kernel_entry("fused_projection", "fused_projection.cu",
                     "fused_projection.py:328", launches, max_err, times),
        kernel_entry("fused_projection_train_fwd",
                     "fused_projection_train.cu", "fused_projection.py:458",
                     train_counts["fused_projection_train_fwd"], err_fwd,
                     train_times["fwd"]),
        kernel_entry("fused_projection_train_bwd",
                     "fused_projection_train.cu", "fused_projection.py:538",
                     train_counts["fused_projection_train_bwd"], err_bwd,
                     train_times["bwd"])]


def group_poseformer(card, hbm_rate):
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule

    err_spatial = phase_kernel_spatial()
    err_temporal = phase_kernel_temporal()
    pf_dm = Carla2D3DDataModule(batch_size=PF_BATCH, clip_length=CLIP,
                                test_set_size=REQUESTS * PF_BATCH, seed=SEED)
    pf_batches = list(pf_dm.test_batches())
    pf_flow, pf_params, pf_counts = phase_serve_poseformer(pf_batches)
    pf_times = phase_timing_poseformer(pf_flow, pf_params, pf_batches, card,
                                       hbm_rate)
    del pf_flow, pf_params, pf_batches
    phase_f6_poseformer(pf_dm)
    del pf_dm
    err_spatial_bwd = phase_kernel_spatial_bwd()
    err_temporal_bwd = phase_kernel_temporal_bwd()
    dm = Carla2D3DDataModule(batch_size=BATCH, clip_length=CLIP,
                             val_set_size=VAL_BATCHES * BATCH, seed=SEED)
    pf_train_counts = phase_train_poseformer(dm)
    pf_train_times = phase_timing_poseformer_train(dm, card, hbm_rate)
    keep = pf_train_times.pop("spatial_keep")
    pf_times["spatial"].update(keep_ms_b1024=keep["ms"],
                               keep_bound_ms_b1024=keep["bound_ms"],
                               keep_bound_by_b1024=keep["bound_by"])
    phase_profile_poseformer_train(dm, card)
    del dm
    torch.cuda.empty_cache()
    phase_poseformer_rf81()
    return [
        kernel_entry("fused_spatial_stack", "fused_spatial_transformer.cu",
                     "fused_spatial_transformer.py:398",
                     pf_counts["fused_spatial_stack"], err_spatial,
                     pf_times["spatial"]),
        kernel_entry("fused_temporal_block", "fused_temporal_transformer.cu",
                     "fused_temporal_transformer.py:947 and :524",
                     pf_counts["fused_temporal_block"], err_temporal,
                     pf_times["temporal"]),
        kernel_entry("fused_spatial_stack_bwd", "fused_spatial_transformer.cu",
                     "fused_spatial_transformer.py:415",
                     pf_train_counts["fused_spatial_stack_bwd"],
                     err_spatial_bwd, pf_train_times["spatial"]),
        kernel_entry("fused_temporal_block_bwd",
                     "fused_temporal_transformer.cu",
                     "fused_temporal_transformer.py:974 and :566",
                     pf_train_counts["fused_temporal_block_bwd"],
                     err_temporal_bwd, pf_train_times["temporal"])]


def group_classification(card, hbm_rate):
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule

    errs = {"gru_fwd": phase_kernel_graph("gru"),
            "lstm_fwd": phase_kernel_graph("lstm"),
            "dense_lstm_fwd": phase_kernel_dense_lstm(),
            "gru_bwd": phase_kernel_graph_bwd("gru"),
            "lstm_bwd": phase_kernel_graph_bwd("lstm"),
            "dense_lstm_bwd": phase_kernel_dense_lstm_bwd()}
    torch.cuda.empty_cache()
    dm = Carla2D3DDataModule(batch_size=CLS_BATCH, clip_length=CLIP,
                             test_set_size=REQUESTS * CLS_BATCH,
                             val_set_size=VAL_BATCHES * CLS_BATCH, seed=SEED)
    counts = phase_train_classification(dm)
    phase_serve_classification(dm)
    phase_f6_graph(dm)
    times = phase_timing_classification(dm, card, hbm_rate)
    phase_profile_classification_train(dm, card)
    names = {"gru_fwd": ("graph_gru_scan", 251),
             "gru_bwd": ("graph_gru_scan_bwd", 291),
             "lstm_fwd": ("graph_lstm_scan", 442),
             "lstm_bwd": ("graph_lstm_scan_bwd", 486),
             "dense_lstm_fwd": ("dense_lstm_scan", 442),
             "dense_lstm_bwd": ("dense_lstm_scan_bwd", 486)}
    return [kernel_entry(name, "fused_dense_lstm.cu" if name.startswith(
                             "dense") else "fused_graph_gru.cu",
                         f"fused_graph_gru.py:{line}", counts[name],
                         errs[key], times[key])
            for key, (name, line) in names.items()]


def main():
    card, hbm_rate = phase_device()
    phase_build()
    kernels = []
    for group in (group_lifting, group_poseformer, group_bf16,
                  group_classification):
        kernels += group(card, hbm_rate)
        torch.cuda.empty_cache()
    launches = group_autoencoder(card, hbm_rate)
    for entry in kernels:
        entry.update(launches.get(entry["name"], {}))
    group_lifters(card, hbm_rate)
    # config 3 on real-format labels: rows 10-11's launches on its path
    # join their entries' counts
    for name, extra in group_openpose(card, hbm_rate).items():
        entry = next(e for e in kernels if e["name"] == name)
        entry["launches"] += extra["launches_openpose_train"] \
            + extra["launches_openpose_serve"]
        entry.update(extra)
    # the forward entries' launches through the exported artifacts
    for name, extra in group_serving(card, hbm_rate).items():
        entry = next(e for e in kernels if e["name"] == name)
        entry["launches"] += extra["launches_serving_artifacts"]
        entry.update(extra)
    # rows 2, 3, 10 and 11 launched from the resident epoch's graphs
    for name, extra in group_recorded(card, hbm_rate).items():
        entry = next(e for e in kernels if e["name"] == name)
        entry["launches"] += extra["launches_recorded_graphed"]
        entry.update(extra)
    # rows 2 and 3 in the CLI's profiled fits
    for name, extra in group_m7(card).items():
        entry = next(e for e in kernels if e["name"] == name)
        entry["launches"] += extra["launches_cli_profiled"]
        entry.update(extra)
    group_pose_estimation(card, hbm_rate)
    # rows 10-13 on the mixed data modules' paths
    for name, extra in group_smpl_mixed(card, hbm_rate).items():
        entry = next(e for e in kernels if e["name"] == name)
        entry["launches"] += sum(extra.values())
        entry.update(extra)
    # row 1 in the CARLA-control request, rows 10-11 in the sensitivity
    # study's fits
    for name, extra in group_carla_control(card, hbm_rate).items():
        entry = next(e for e in kernels if e["name"] == name)
        entry["launches"] += sum(extra.values())
        entry.update(extra)
    # rows 2-3 from the world-1 NCCL graphed epoch's replays, rows 2, 3,
    # 10 and 11 in the two gloo ranks' steps
    for name, extra in group_parallel(card, hbm_rate).items():
        entry = next(e for e in kernels if e["name"] == name)
        entry["launches"] += sum(extra.values())
        entry.update(extra)

    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
